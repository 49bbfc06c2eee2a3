"""Corpus and diff helpers of the port (counterparts of scripts/ and
tests/simdata.py): ``golden_e2e`` (generate, diff), ``simdata`` (what
generate calls), ``race_e2e`` (depth_masked_diff) and ``golden_flows`` (the
flows whose rovaca_tpu outputs tests/golden_torch/ commits)."""
