"""End-to-end PairHMM scoring: float32 forward, float64 rescue, filtering.

Counterpart of rovaca_tpu/ops/pairhmm/api.py. The best-4.5 cap and the
poorly-modelled-read filter are imported unchanged. ``log10_with_rescue`` is
the port's own: rovaca_tpu's version falls back to a jax float64 forward
when the native library is missing, and this package never imports jax.
``pairhmm_raw`` scores a dense ``prep.PairBatch`` on the dense kernel (K2),
its plain version or the native engine; ``compute_likelihoods``, the
library entry, runs it and then ``finish_scores``.
"""

import numpy as np
import torch

from rovaca_tpu import constants as C
from rovaca_tpu.native import pairhmm_native
from rovaca_tpu.ops.pairhmm import prep
from rovaca_tpu.ops.pairhmm.api import normalize_likelihoods, \
    poorly_modelled_mask

from ...utils import platform
from . import compact
from .dense import pairhmm_dense
from .indexed import pairhmm_indexed_compact_torch

ENGINES = ("cuda", "torch", "native")


def resolve_engine(engine):
    """'auto' is 'cuda'; an unknown name raises."""
    engine = "cuda" if engine == "auto" else engine
    if engine not in ENGINES:
        raise ValueError(f"unknown pairhmm engine: {engine} "
                         f"(choose from auto, {', '.join(ENGINES)})")
    return engine


def engine_device(engine):
    """Device the compact path runs on: the card for 'cuda' (raises without
    one), the CPU for 'torch'."""
    return platform.device() if engine == "cuda" else torch.device("cpu")


def all_pairs(batch):
    """(hidx, ridx) covering every (hap tile, read tile) of one batch, in
    (GH, GR) row-major order."""
    hidx, ridx = np.meshgrid(np.arange(batch.gh, dtype=np.int32),
                             np.arange(batch.gr, dtype=np.int32),
                             indexing="ij")
    return hidx.ravel(), ridx.ravel()


def _rescue_f64_torch(rescued, reads, hap_bytes, pcr_model,
                      min_quality_threshold):
    """Raw float64 forward of each rescued (hap, read) pair with the plain
    torch version on the CPU. Each pair gets its own read lane and hap slot,
    and only the tile pairs holding a pair are swept."""
    pair_reads = [reads[r] for _, r in rescued]
    pair_haps = [hap_bytes[h] for h, _ in rescued]
    b = compact.build_pair_batch_compact(
        pair_reads, pair_haps, pcr_model=pcr_model,
        min_quality_threshold=min_quality_threshold)
    k = np.arange(len(rescued))
    h_tile, h_sub = np.divmod(k, prep.HAP_TILE)
    r_tile, r_lane = np.divmod(k, prep.READ_TILE)
    tile_pairs = sorted(set(zip(h_tile.tolist(), r_tile.tolist())))
    slot = {p: i for i, p in enumerate(tile_pairs)}
    hidx = torch.tensor([p[0] for p in tile_pairs], dtype=torch.int32)
    ridx = torch.tensor([p[1] for p in tile_pairs], dtype=torch.int32)
    raw = pairhmm_indexed_compact_torch(
        *compact.to_device(b.arrays(), "cpu"), hidx, ridx,
        dtype=torch.float64).numpy()
    g = np.array([slot[p] for p in zip(h_tile.tolist(), r_tile.tolist())])
    return raw[g, h_sub, r_lane]


def log10_with_rescue(raw_matrix, reads, haps, pcr_model="CONSERVATIVE",
                      min_quality_threshold=C.MIN_QUALITY_THRESHOLD):
    """float32 log10 with float64 rescue below MIN_ACCEPTED_F32
    (pairhmm_internal.cpp:674-689).

    raw_matrix: (n_haps, n_reads) f32 raw forward probabilities.
    Returns (n_haps, n_reads) float64 log10 likelihoods. The rescue runs the
    native float64 engine when it built (as rovaca_tpu does), otherwise the
    plain torch forward in float64 on the CPU.
    """
    raw = np.asarray(raw_matrix, dtype=np.float32)
    out = np.empty(raw.shape, dtype=np.float64)
    ok = raw >= np.float32(C.MIN_ACCEPTED_F32)
    logf = np.full(raw.shape, np.nan, dtype=np.float32)
    np.log10(raw, out=logf, where=ok)
    out[ok] = (logf[ok]
               - np.float32(C.LOG10_INITIAL_CONSTANT_F32)).astype(np.float64)

    rescued = list(zip(*np.nonzero(~ok)))
    if not rescued:
        return out
    hap_bytes = [h.encode() if isinstance(h, str) else bytes(h) for h in haps]
    if pairhmm_native.rescue_available():
        ch_cache, hap_cache = {}, {}
        raws = []
        for h_idx, r_idx in rescued:
            if r_idx not in ch_cache:
                read = reads[r_idx]
                ch_cache[r_idx] = prep.prepare_read_channels(
                    read.bases, read.quals, read.mapping_quality,
                    ins_gops=getattr(read, "ins_quals", None),
                    gcp=getattr(read, "gcp", None),
                    pcr_model=pcr_model,
                    min_quality_threshold=min_quality_threshold,
                    dtype=np.float64)
            if h_idx not in hap_cache:
                hap_cache[h_idx] = prep.BASE_CODE[
                    np.frombuffer(hap_bytes[h_idx], dtype=np.uint8)]
            codes, ch = ch_cache[r_idx]
            raws.append(pairhmm_native.forward_f64(ch, codes,
                                                   hap_cache[h_idx]))
    else:
        raws = _rescue_f64_torch(rescued, reads, hap_bytes, pcr_model,
                                 min_quality_threshold)
    for (h_idx, r_idx), rd in zip(rescued, raws):
        out[h_idx, r_idx] = np.log10(rd) - C.LOG10_INITIAL_CONSTANT_F64
    return out


def finish_scores(raw_matrix, reads, haps, pcr_model, min_quality_threshold):
    """(n_haps, n_reads) raw float32 forward -> (likelihoods, kept_indices):
    log10 with rescue, the best-4.5 cap, then poorly-modelled reads
    removed."""
    lik_hr = log10_with_rescue(raw_matrix, reads, haps, pcr_model=pcr_model,
                               min_quality_threshold=min_quality_threshold)
    lik_rh = normalize_likelihoods(lik_hr.T)
    drop = poorly_modelled_mask([len(r.bases) for r in reads], lik_rh)
    kept = np.nonzero(~drop)[0]
    return lik_rh[kept].T.copy(), kept


def pairhmm_raw(batch, engine="auto"):
    """Forward over a dense ``prep.PairBatch`` -> (GH, GR, 8, 128) np.f32:
    the dense CUDA kernel ('cuda'), its plain version on the CPU ('torch'),
    or the host C++ engine ('native')."""
    engine = resolve_engine(engine)
    inputs = (batch.trans, batch.rbase, batch.rlen, batch.hbase, batch.hlen)
    if engine == "native":
        if not pairhmm_native.available():
            raise RuntimeError("native pairhmm engine unavailable "
                               "(g++ build failed?)")
        return pairhmm_native.pairhmm_dense(*inputs)
    out = pairhmm_dense(*compact.to_device(inputs, engine_device(engine)))
    return out.cpu().numpy()


def compute_likelihoods(reads, haps, pcr_model="CONSERVATIVE",
                        min_quality_threshold=C.MIN_QUALITY_THRESHOLD,
                        engine="auto"):
    """Score all (read, hap) pairs with engine cuda, torch or native: a
    dense batch, ``pairhmm_raw``, then ``finish_scores``.

    Returns (likelihoods, kept_indices): likelihoods is an
    (n_haps, n_kept_reads) float64 log10 matrix; kept_indices maps its read
    columns back into `reads` after poorly-modelled-read removal.
    """
    b = prep.build_pair_batch(reads, haps, pcr_model=pcr_model,
                              min_quality_threshold=min_quality_threshold)
    raw = b.result_matrix(pairhmm_raw(b, engine))
    return finish_scores(raw, reads, haps, pcr_model, min_quality_threshold)
