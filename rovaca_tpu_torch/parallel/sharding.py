"""Interval-sharded data parallelism over a list of devices.

Counterpart of rovaca_tpu/parallel/sharding.py, which imports jax at module
top. Genomic intervals are sharded data-parallel with boundary padding so
active regions never span a shard cut; each shard's PairHMM batch runs on its
own device and the per-shard results merge in shard (== genome) order.

The JAX mesh becomes a plain list of devices. ``shard_map`` becomes one
kernel launch per shard on ``devices[s % len(devices)]``, ``pmax`` a max over
the shards' results, and ``all_gather`` a shard-ordered ``torch.stack`` on
``devices[0]``.
"""

import torch

from .. import constants as C
from ..ops.pairhmm.dense import pairhmm_dense
from ..utils import platform


def data_devices(devices=None):
    """The devices shards go round-robin over: the given ones, or every card
    of ``platform.devices()`` (raises without one)."""
    return list(platform.devices() if devices is None else devices)


def local_device_count():
    """Visible CUDA cards (0 on a CPU-only host)."""
    return torch.cuda.device_count()


def shard_intervals(intervals, n_shards,
                    boundary_pad=C.REGION_MAX_SIZE + C.REGION_PADDING):
    """Split (contig, start, end) intervals into n_shards contiguous shards.

    Splits are balanced by total base count. Each shard keeps `boundary_pad`
    extra context on cut edges (reads near a cut are processed by the shard
    that owns the region midpoint, so regions never straddle shards — the
    sharded analogue of the reference's per-chromosome sequential semantics).

    Returns a list of n_shards lists of (contig, start, end, core_start,
    core_end) where [core_start, core_end) is the half-open ownership span.
    """
    total = sum(e - s for _, s, e in intervals)
    per_shard = max(1, -(-total // n_shards))
    shards = [[] for _ in range(n_shards)]
    shard_idx, filled = 0, 0
    for contig, start, end in intervals:
        pos = start
        while pos < end:
            take = min(end - pos, per_shard - filled)
            core_s, core_e = pos, pos + take
            pad_s = max(start, core_s - boundary_pad)
            pad_e = min(end, core_e + boundary_pad)
            shards[min(shard_idx, n_shards - 1)].append(
                (contig, pad_s, pad_e, core_s, core_e))
            pos += take
            filled += take
            if filled >= per_shard and shard_idx < n_shards - 1:
                shard_idx += 1
                filled = 0
    return shards


def per_shard(devices, stacked, launch):
    """Run ``launch(*shard_inputs)`` once per shard: shard ``s`` takes
    ``x[s]`` of every stacked [S, ...] input, on ``devices[s % len]``.
    Returns the shard results gathered in shard order on ``devices[0]``,
    [S, ...]."""
    devices = data_devices(devices)
    n_shards = stacked[0].shape[0]
    outs = []
    for s in range(n_shards):
        dev = devices[s % len(devices)]
        outs.append(launch(*(torch.as_tensor(x[s]).to(dev).contiguous()
                             for x in stacked)))
    return torch.stack([o.to(devices[0]) for o in outs])


def sharded_pairhmm_step(devices, trans, rbase, rlen, hbase, hlen):
    """One data-parallel PairHMM scoring step over a device list.

    Inputs carry a leading shard dim S:
      trans (S, GR, Lr, 8, 128), rbase (S, GR, Lr, 128), rlen (S, GR, 1, 128),
      hbase (S, GH, Lh, 8, 128), hlen (S, GH, 8, 1).
    Each shard is one launch of the dense forward (K2, ``pairhmm_dense``;
    its plain version on CPU tensors). Returns (raw results (S, GH, GR, 8,
    128) in shard/coordinate order on ``devices[0]``, the global best raw
    likelihood over all shards).
    """
    gathered = per_shard(devices, (trans, rbase, rlen, hbase, hlen),
                         pairhmm_dense)
    return gathered, gathered.amax()


def ordered_merge(per_shard_records):
    """Host-side coordinate-ordered merge of per-shard record lists.

    Each element is a list of records already sorted within its shard; shards
    are genome-ordered, so the merge is concatenation with cross-boundary
    dedup by ownership span (records outside a shard's core span are dropped
    by the producer, so plain concatenation is exact)."""
    out = []
    for records in per_shard_records:
        out.extend(records)
    return out
