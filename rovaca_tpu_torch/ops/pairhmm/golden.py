"""Scalar numpy PairHMM forward — correctness oracle and f64 rescue path.

Implements the GATK "logless" forward recurrence exactly as the reference's
engines do (reference: src/haplotypecaller/pairhmm/rovaca/avx_512_float.cc:
29-183 for the float semantics; the double rescue mirrors the old-engine
double path, pairhmm_internal.cpp:674-689):

    M[i][j] = prior * (M[i-1][j-1]*mm + (I[i-1][j-1] + D[i-1][j-1])*gapm)
    I[i][j] = M[i-1][j]*mi + I[i-1][j]*ii
    D[i][j] = M[i][j-1]*md + D[i][j-1]*dd

with boundary row D[0][j] = 2^120/hapLen (float) or 2^1020/hapLen (double),
final result sum_j(M[L][j] + I[L][j]).

Note: the reference's AVX kernel evaluates M as ((M*mm + I*gapm) + D*gapm);
we factor (I+D)*gapm everywhere (golden, XLA, Pallas alike) — a ~1 ulp/cell
reassociation well inside the float->double rescue guard band.
"""

import numpy as np

from ... import constants as C
from . import prep


def _initial_constant(dtype):
    return (np.float32(C.INITIAL_CONSTANT_F32) if dtype == np.float32
            else np.float64(C.INITIAL_CONSTANT_F64))


def forward_from_channels(codes, channels, hap_codes, dtype=np.float32):
    """Forward probability from prepared per-read channels.

    codes: (Lr,) int32 read base codes; channels: (8, Lr) transition/emission
    channels (any float dtype; cast here); hap_codes: (Lh,) int32.
    Returns the raw (scaled) forward probability as a dtype scalar.
    """
    dtype = np.dtype(dtype).type
    codes = np.asarray(codes, dtype=np.int32)
    hap = np.asarray(hap_codes, dtype=np.int32)
    mm, gapm, mi, ii, md, dd, distm, one_distm = [
        np.asarray(channels[k], dtype=dtype) for k in range(8)]
    Lr, Lh = codes.shape[0], hap.shape[0]

    init_d = dtype(_initial_constant(dtype) / dtype(Lh))
    Mp = np.zeros(Lh + 1, dtype=dtype)
    Ip = np.zeros(Lh + 1, dtype=dtype)
    Dp = np.full(Lh + 1, init_d, dtype=dtype)

    match = (codes[:, None] & hap[None, :]) != 0  # (Lr, Lh)

    for i in range(Lr):
        prior = np.where(match[i], one_distm[i], distm[i]).astype(dtype)
        Mrow = np.zeros(Lh + 1, dtype=dtype)
        Irow = np.zeros(Lh + 1, dtype=dtype)
        Drow = np.zeros(Lh + 1, dtype=dtype)
        Mrow[1:] = prior * (Mp[:-1] * mm[i] + (Ip[:-1] + Dp[:-1]) * gapm[i])
        Irow[1:] = Mp[1:] * mi[i] + Ip[1:] * ii[i]
        a, b = dd[i], md[i]
        d = Drow[0]
        for j in range(1, Lh + 1):
            d = b * Mrow[j - 1] + a * d
            Drow[j] = d
        Mp, Ip, Dp = Mrow, Irow, Drow

    return dtype(np.sum(Mp[1:], dtype=dtype) + np.sum(Ip[1:], dtype=dtype))


def compute_full_prob(bases, quals, mapping_quality, hap,
                      ins_gops=None, gcp=None, dtype=np.float32,
                      pcr_model="CONSERVATIVE",
                      min_quality_threshold=C.MIN_QUALITY_THRESHOLD):
    """Raw forward probability from raw read data (applies qual caps + PCR)."""
    codes, ch = prep.prepare_read_channels(
        bases, quals, mapping_quality, ins_gops=ins_gops, gcp=gcp,
        pcr_model=pcr_model, min_quality_threshold=min_quality_threshold,
        dtype=dtype)
    if isinstance(hap, str):
        hap = hap.encode()
    hap_codes = prep.BASE_CODE[np.frombuffer(bytes(hap), dtype=np.uint8)]
    return forward_from_channels(codes, ch, hap_codes, dtype=dtype)


def log10_likelihood(bases, quals, mapping_quality, hap, **kw):
    """Float-with-double-rescue log10 likelihood for one (read, hap) pair
    (reference: pairhmm_internal.cpp:674-689)."""
    rf = compute_full_prob(bases, quals, mapping_quality, hap,
                           dtype=np.float32, **kw)
    if rf < C.MIN_ACCEPTED_F32:
        rd = compute_full_prob(bases, quals, mapping_quality, hap,
                               dtype=np.float64, **kw)
        return float(np.log10(rd) - C.LOG10_INITIAL_CONSTANT_F64)
    return float(np.float32(np.log10(rf)) - np.float32(C.LOG10_INITIAL_CONSTANT_F32))
