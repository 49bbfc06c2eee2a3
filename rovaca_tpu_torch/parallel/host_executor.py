"""Host-side process parallelism for region preparation (``-t``).

Counterpart of rovaca_tpu/parallel/host_executor.py, whose ``HostExecutor``
(keyed futures over a spawn-based pool, or two prep threads in one process)
is kept; only the worker's initialisation is the port's. rovaca_tpu's calls
``force_cpu``, which imports jax to keep a worker off the TPU. Here a worker
builds rovaca_tpu's ``RegionCaller``, whose ``prepare_region`` is host-only,
and imports neither jax nor torch, so it never creates a CUDA context: the
main process alone launches kernels.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

from rovaca_tpu.parallel import host_executor as _ref


def _worker_init(config, contig_lengths):
    from rovaca_tpu.pipeline.hc_engine import RegionCaller
    _ref._WORKER_CALLER = RegionCaller(config, contig_lengths)


class HostExecutor(_ref.HostExecutor):
    """Fan region prep out to ``workers`` spawned processes when workers > 1;
    otherwise rovaca_tpu's in-process prep."""

    def __init__(self, workers, config, contig_lengths):
        if not (workers and workers > 1):
            super().__init__(workers, config, contig_lengths)
            return
        self.workers = workers
        self._threads = None
        self._pool = ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init, initargs=(config, contig_lengths))
