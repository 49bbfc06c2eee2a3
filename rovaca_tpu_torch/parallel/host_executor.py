"""Host-side process parallelism for region preparation/genotyping.

The reference's host parallelism is a shared thread pool over per-region jobs
(reference: src/haplotypecaller/haplotypecaller.cpp:97,117-146). Python's GIL
pushes the equivalent to processes: region *preparation* (finalize, assemble,
trim — pure host CPU) fans out to a spawn-based pool while the main process
keeps exclusive ownership of the card for scoring. Output order is preserved
by keying futures, mirroring the reference writer's source_id reordering.

Counterpart of rovaca_tpu/parallel/host_executor.py, carried over without
its ``force_cpu`` (which imports jax to keep a worker off the TPU): a worker
builds this package's ``RegionCaller``, whose module imports no torch, and
only calls its host-only ``prepare_region``, so it never creates a CUDA
context.
"""

import os
from concurrent.futures import ProcessPoolExecutor

_WORKER_CALLER = None


def _worker_init(config, contig_lengths):
    global _WORKER_CALLER
    from ..pipeline.hc_engine import RegionCaller
    _WORKER_CALLER = RegionCaller(config, contig_lengths)


def _worker_prepare(task):
    region, reads, ref_window, contig = task
    return _WORKER_CALLER.prepare_region(region, reads, ref_window, contig)


class HostExecutor:
    """Fan region prep out to worker processes; None workers = inline.

    In the default single-process mode a small THREAD pool still overlaps
    region preps: the fused native finalize+assemble call (the bulk of a
    prep) releases the GIL, so two threads keep one core on native
    assembly while the other runs the Python trim/pack stages — the same
    overlap the reference gets from its region thread pool
    (haplotypecaller.cpp:117-146) without process-spawn/pickle costs."""

    def __init__(self, workers, config, contig_lengths):
        self.workers = workers
        self._pool = None
        self._threads = None
        if workers and workers > 1:
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
            self._pool = ProcessPoolExecutor(
                max_workers=workers, mp_context=ctx,
                initializer=_worker_init,
                initargs=(config, contig_lengths))
        else:
            nt = int(os.environ.get("ROVACA_PREP_THREADS")
                     or min(2, os.cpu_count() or 1))
            if getattr(config, "assemble_output_path", None):
                nt = 1      # the golden dump file is append-ordered
            if nt > 1:
                from concurrent.futures import ThreadPoolExecutor
                self._threads = ThreadPoolExecutor(max_workers=nt)

    def map_prepare(self, caller, tasks):
        """tasks: [(key, region, reads, ref_window, contig)].
        Returns {key: PreparedRegion-or-calls} preserving input association.
        """
        out = {}
        if self._pool is not None:
            futures = {}
            for key, region, reads, ref_window, contig in tasks:
                if isinstance(reads, tuple) and len(reads) == 3 and \
                        reads[0] == "cols":
                    # materialize before pickling to the worker process —
                    # shipping the whole column slab set per task would
                    # dwarf the prep work itself
                    reads = reads[1].materialize(reads[2])
                futures[key] = self._pool.submit(
                    _worker_prepare, (region, reads, ref_window, contig))
            for key, fut in futures.items():
                out[key] = fut.result()
            return out
        if self._threads is not None and len(tasks) > 1:
            futures = {}
            for key, region, reads, ref_window, contig in tasks:
                futures[key] = self._threads.submit(
                    caller.prepare_region, region, reads, ref_window,
                    contig)
            for key, fut in futures.items():
                out[key] = fut.result()
            return out
        for key, region, reads, ref_window, contig in tasks:
            out[key] = caller.prepare_region(region, reads, ref_window,
                                             contig)
        return out

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()
        if self._threads is not None:
            self._threads.shutdown()
