"""Entry points of the port: a single-card forward step and the multi-device
dryrun.

Counterparts of __graft_entry__.py's ``entry`` and ``dryrun_multichip``
(:46-72), which import jax.

    python -m rovaca_tpu_torch.entry
"""

import numpy as np
import torch

from .ops.pairhmm import prep
from .ops.pairhmm.dense import pairhmm_dense
from .parallel.pipeline_shard import pipeline_dryrun
from .utils import platform


def _example_batch(gr=1, gh=1, lr=64, lh=128, seed=0):
    """A dense ``prep.PairBatch`` of random reads and haps, as
    (trans, rbase, rlen, hbase, hlen) CPU tensors."""
    rng = np.random.default_rng(seed)

    class _R:
        def __init__(self, bases, quals, mq=60):
            self.bases = bases
            self.quals = quals
            self.mapping_quality = mq

    reads = []
    for _ in range(gr * 128):
        L = int(rng.integers(lr // 2, lr))
        bases = "".join(rng.choice(list("ACGT"), size=L))
        reads.append(_R(bases, rng.integers(10, 40, size=L)))
    haps = ["".join(rng.choice(list("ACGT"),
                               size=int(rng.integers(lh // 2, lh))))
            for _ in range(gh * 8)]
    batch = prep.build_pair_batch(reads, haps,
                                  len_buckets=(lr,), hap_len_buckets=(lh,))
    return tuple(torch.from_numpy(x) for x in
                 (batch.trans, batch.rbase, batch.rlen, batch.hbase,
                  batch.hlen))


def entry(device=None):
    """(fn, example_args): the dense PairHMM forward (K2) and an example
    dense batch on ``device`` (the card of ``platform.device()`` by default;
    raises without one). On CPU tensors fn runs its plain version."""
    dev = platform.device() if device is None else torch.device(device)
    return pairhmm_dense, tuple(t.to(dev) for t in _example_batch())


def dryrun_multichip(n_devices, devices=None):
    """Run the FULL pipeline over ``n_devices`` shards: regions -> assembly
    -> sharded PairHMM (one K1 launch per shard, round-robin over
    ``devices``, every card by default) -> genotyping -> coordinate-ordered
    record merge; raises unless the merged records equal an unsharded run
    of the same pipeline. Returns the number of records."""
    n_records = pipeline_dryrun(n_devices, devices=devices)
    if n_records <= 0:
        raise AssertionError("the dryrun called no record")
    return n_records


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape))
    dryrun_multichip(len(platform.devices()))
    print("dryrun ok")
