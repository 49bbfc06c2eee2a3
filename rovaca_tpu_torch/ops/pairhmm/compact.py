"""Compact PairHMM batches: small integers on the wire, channels on device.

Counterpart of rovaca_tpu/ops/pairhmm/compact.py, which imports jax at module
top. The pure-numpy batch builder is carried over unchanged and calls this
package's ``prep`` (the copy of rovaca_tpu's) for the quality caps, the
PCR/STR model and ``BASE_CODE``. The (128,) probability tables come from
``ops.gatk_math``, the same numpy tables the JAX package feeds its kernel;
together with the compact batches they are the state both packages are fed
from.
"""

import dataclasses
import functools

import numpy as np
import torch

from ... import constants as C
from .. import gatk_math
from . import prep


@functools.lru_cache(maxsize=None)
def _np_tables(np_dtype):
    ph2pr = np.asarray(gatk_math.ph2pr_table(np_dtype))
    m2m = np.asarray(gatk_math.match_to_match_table(np_dtype))
    return ph2pr, m2m[np.arange(128), np.arange(128)]  # ins gop == del gop


@functools.lru_cache(maxsize=None)
def tables(device, dtype=torch.float32):
    """(ph2pr, match-to-match diagonal) as (128,) tensors on ``device``."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    ph2pr, m2m = _np_tables(np_dtype)
    return (torch.from_numpy(ph2pr.copy()).to(device),
            torch.from_numpy(m2m.copy()).to(device))


def materialize_channels(q, gi, gc, dtype=torch.float32):
    """(..., Lr, 128) uint8 quals/gap-open/gap-cont -> (..., Lr, 8, 128)
    channels in prep.py order [mm, gapm, mi, ii, md, dd, distm, one_distm]."""
    ph2pr, m2m = tables(q.device, dtype)
    qi, gii, gci = q.long(), gi.long(), gc.long()
    p_gi = ph2pr[gii]
    p_gc = ph2pr[gci]
    p_q = ph2pr[qi]
    return torch.stack([
        m2m[gii],       # mm
        1.0 - p_gc,     # gapm
        p_gi,           # mi
        p_gc,           # ii
        p_gi,           # md (del gop aliases ins gop)
        p_gc,           # dd
        p_q / 3.0,      # distm
        1.0 - p_q,      # one_distm
    ], dim=-2)


def broadcast_haps(hcode):
    """(..., Lh, 8) int8 hap codes -> (..., Lh, 8, 128) int32 lane-broadcast
    view (no copy)."""
    return hcode.int()[..., None].expand(*hcode.shape, prep.READ_TILE)


def to_device(arrays, device):
    """numpy arrays -> tensors on ``device``, same dtypes and shapes."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


@dataclasses.dataclass
class CompactPairBatch:
    """Integer-typed, tiled PairHMM inputs (the kernel builds channels).

    Shapes: q/gi/gc: (GR, Lr, 128) u8; rbase: (GR, Lr, 128) i8;
    rlen: (GR, 1, 128) i32; hcode: (GH, Lh, 8) i8; hlen: (GH, 8, 1) i32.
    """
    q: np.ndarray
    gi: np.ndarray
    gc: np.ndarray
    rbase: np.ndarray
    rlen: np.ndarray
    hcode: np.ndarray
    hlen: np.ndarray
    n_reads: int
    n_haps: int

    @property
    def gr(self):
        return self.q.shape[0]

    @property
    def gh(self):
        return self.hcode.shape[0]

    @property
    def max_read_len(self):
        return self.q.shape[1]

    @property
    def max_hap_len(self):
        return self.hcode.shape[1]

    def arrays(self):
        """The seven kernel inputs, in the kernel's argument order."""
        return (self.q, self.gi, self.gc, self.rbase, self.rlen, self.hcode,
                self.hlen)

    def result_matrix(self, raw):
        """(GH, GR, 8, 128) kernel output -> (n_haps, n_reads) float32."""
        raw = np.asarray(raw)
        gh, gr = raw.shape[0], raw.shape[1]
        full = raw.transpose(0, 2, 1, 3).reshape(gh * prep.HAP_TILE,
                                                 gr * prep.READ_TILE)
        return full[: self.n_haps, : self.n_reads]


def build_pair_batch_compact(reads, haps, pcr_model="CONSERVATIVE",
                             min_quality_threshold=C.MIN_QUALITY_THRESHOLD,
                             len_buckets=(64, 128, 192, 256, 384, 512),
                             hap_len_buckets=(128, 256, 384, 512, 768, 1024)):
    """Compact analogue of prep.build_pair_batch (same semantics/buckets)."""
    n_reads = len(reads)
    n_haps = len(haps)
    hap_bytes = [h.encode() if isinstance(h, str) else bytes(h) for h in haps]

    max_rl = max(len(r.bases) for r in reads)
    max_hl = max(len(h) for h in hap_bytes)
    Lr = next((b for b in len_buckets if b >= max_rl),
              prep._round_up(max_rl, 128))
    Lh = next((b for b in hap_len_buckets if b >= max_hl),
              prep._round_up(max_hl, 128))
    GR = prep._round_up(n_reads, prep.READ_TILE) // prep.READ_TILE
    GH = prep._round_up(n_haps, prep.HAP_TILE) // prep.HAP_TILE

    q_a = np.zeros((GR, Lr, prep.READ_TILE), dtype=np.uint8)
    gi_a = np.zeros((GR, Lr, prep.READ_TILE), dtype=np.uint8)
    gc_a = np.zeros((GR, Lr, prep.READ_TILE), dtype=np.uint8)
    rbase = np.zeros((GR, Lr, prep.READ_TILE), dtype=np.int8)
    rlen = np.zeros((GR, 1, prep.READ_TILE), dtype=np.int32)
    hcode = np.zeros((GH, Lh, prep.HAP_TILE), dtype=np.int8)
    hlen = np.zeros((GH, prep.HAP_TILE, 1), dtype=np.int32)

    base_bytes = [r.bases.encode() if isinstance(r.bases, str)
                  else bytes(r.bases) for r in reads]
    gap_list = []
    for r, bb in zip(reads, base_bytes):
        ig = getattr(r, "ins_quals", None)
        if ig is None:
            ig = np.full(len(bb), C.DEFAULT_GAP_OPEN_PHRED, dtype=np.uint8)
        else:
            ig = np.asarray(ig, dtype=np.uint8).copy()
        gap_list.append(ig)
    prep.apply_pcr_error_model_batch(base_bytes, gap_list, pcr_model)

    for idx, read in enumerate(reads):
        g, lane = divmod(idx, prep.READ_TILE)
        bb = base_bytes[idx]
        L = len(bb)
        q = prep.modify_read_quals(read.quals, read.mapping_quality,
                                   min_quality_threshold)
        gcp = getattr(read, "gcp", None)
        if gcp is None:
            gcp = np.full(L, C.GAP_CONTINUATION_PHRED, dtype=np.uint8)
        q_a[g, :L, lane] = q & 127
        gi_a[g, :L, lane] = gap_list[idx] & 127
        gc_a[g, :L, lane] = np.asarray(gcp, dtype=np.uint8) & 127
        rbase[g, :L, lane] = prep.BASE_CODE[
            np.frombuffer(bb, dtype=np.uint8)]
        rlen[g, 0, lane] = L

    for idx, h in enumerate(hap_bytes):
        g, sub = divmod(idx, prep.HAP_TILE)
        hcode[g, : len(h), sub] = prep.BASE_CODE[
            np.frombuffer(h, dtype=np.uint8)]
        hlen[g, sub, 0] = len(h)

    return CompactPairBatch(q=q_a, gi=gi_a, gc=gc_a, rbase=rbase, rlen=rlen,
                            hcode=hcode, hlen=hlen,
                            n_reads=n_reads, n_haps=n_haps)
