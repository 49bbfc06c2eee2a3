"""Logging with source-location capture.

Counterpart of the reference's spdlog wrapper (reference:
src/rovaca_logger/rovaca_logger.h:20-50, pattern set in rovaca_main.cpp:14):
timestamped records with file:function:line, a startup parameter banner, and
teardown counter summaries.
"""

import logging
import sys

_FORMAT = ("[%(asctime)s] [%(levelname)s] "
           "[%(filename)s:%(funcName)s:%(lineno)d] %(message)s")

logger = logging.getLogger("rovaca_tpu")


def init(level="INFO", stream=None):
    if logger.handlers:
        return logger
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, "%Y-%m-%d %H:%M:%S"))
    logger.addHandler(handler)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.propagate = False
    return logger


def banner(args_dict):
    """Startup parameter banner (haplotypecaller.cpp:230-265)."""
    logger.info("---- run parameters ----")
    for key, value in args_dict.items():
        logger.info("  %-24s %s", key, value)
    logger.info("------------------------")


def teardown_counters(stats):
    """Final counters (reads_filter_hc.h:31, RegionManager.h:69-88 style)."""
    for key, value in stats.items():
        logger.info("counter %-16s %s", key, value)
