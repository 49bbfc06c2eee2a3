"""rovaca_tpu_torch — the PyTorch/CUDA port of rovaca_tpu.

The JAX package ``rovaca_tpu`` stays the reference. This package mirrors its
module paths and ports only the modules that reach JAX on the caller's main
path; the jax-free host layer (IO, read filters, activity, assembly,
genotyping, the VCF writer and the g++ native libraries) is imported from
``rovaca_tpu`` unchanged. Nothing here imports jax.

- ``ops.pairhmm``: compact PairHMM batches, the indexed PairHMM forward as a
  plain torch version and as a hand-written CUDA kernel
  (``csrc/pairhmm_indexed.cu``), and host-side scoring with float64 rescue.
- ``pipeline``: the flush-group scheduler (launches round-robin over the
  cards) and the caller seams.
- ``parallel``: ``--shards``, ``-t`` workers, ``torch.distributed`` ranks
  and the sharded K1/K2 steps over a device list.
- ``cli``: ``python -m rovaca_tpu_torch.cli HaplotypeCaller ...``;
  ``entry``: the counterparts of ``__graft_entry__``'s entry points.
"""

__version__ = "0.1.0"
