"""rovaca_tpu_torch — the PyTorch/CUDA port of rovaca_tpu.

The JAX package ``rovaca_tpu`` stays the reference. This package mirrors its
module paths and owns everything it runs: the modules that reach JAX are
ported (the PairHMM and banded-SW kernels, the scheduler, the caller seams,
the parallel layer), and the jax-free host layer (IO, read filters, BQSR,
activity, assembly, genotyping, reference confidence, the block combiner,
the VCF writer and the g++ native libraries) is carried over as copies at
the same relative paths. Nothing here imports jax or rovaca_tpu.

- ``ops.pairhmm``: compact PairHMM batches, the indexed and dense PairHMM
  forward as plain torch versions and as hand-written CUDA kernels
  (``csrc/pairhmm_indexed.cu``, ``csrc/pairhmm_dense.cu``), and host-side
  scoring with float64 rescue; ``ops.sw``: the banded SW kernel.
- ``pipeline``: the flush-group scheduler (launches round-robin over the
  cards), the region engine and the caller.
- ``parallel``: ``--shards``, ``-t`` workers, ``torch.distributed`` ranks
  and the sharded K1/K2 steps over a device list.
- ``native``: the g++ libraries, built at first use into ``build/native/``.
- ``tools``: the corpus generator, the VCF diffs and the measuring tools
  (``golden_e2e``, ``race_e2e``, ``host_profile``, ``kernel_bench``,
  ``scaling_bench``, ``accuracy_eval``), each ``python -m
  rovaca_tpu_torch.tools.<name>``.
- ``cli``: ``python -m rovaca_tpu_torch.cli HaplotypeCaller ...``;
  ``entry``: the counterparts of ``__graft_entry__``'s entry points.
"""

__version__ = "0.1.0"
