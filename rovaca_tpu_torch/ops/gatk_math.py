"""GATK-compatible numeric tables and log-space helpers.

Mirrors the semantics of the reference's PairHMM context tables
(reference: src/haplotypecaller/pairhmm/rovaca/context.h:26-155) and
math utils (reference: src/haplotypecaller/common/utils/math_utils.h:38-95).
Tables are built once in numpy and shared by host prep and device kernels.
"""

import functools

import numpy as np

MAX_QUAL = 254
MAX_JACOBIAN_TOLERANCE = 8.0
JACOBIAN_LOG_TABLE_STEP = 0.0001
JACOBIAN_LOG_TABLE_SIZE = int(MAX_JACOBIAN_TOLERANCE / JACOBIAN_LOG_TABLE_STEP) + 1

LOG10_E = np.log10(np.e)


@functools.lru_cache(maxsize=None)
def jacobian_log_table(dtype=np.float64):
    """log10(1 + 10^-(k*step)) for k in [0, 80001); context.h:44-49.

    Built with scalar libm calls (math.log10/**), not numpy's vectorized
    transcendentals — numpy's SIMD pow/log10 differ from glibc libm by an
    ulp on some inputs, and the reference builds its table with
    std::log10/std::pow (math_utils.h:236-241), so bit-equivalence of the
    downstream GL/PL arithmetic requires libm here.
    """
    import math
    step = JACOBIAN_LOG_TABLE_STEP
    tbl = np.empty(JACOBIAN_LOG_TABLE_SIZE, dtype=np.float64)
    for i in range(JACOBIAN_LOG_TABLE_SIZE):
        tbl[i] = math.log10(1.0 + 10.0 ** (-step * i))
    return tbl.astype(dtype)


def approximate_log10_sum_log10(a, b, dtype=np.float64):
    """Jacobian-table approximation of log10(10^a + 10^b); context.h:66-89.

    Vectorized over numpy arrays; uses the hard-rounding table lookup the
    reference uses so downstream tables match bit-for-bit at table resolution.
    """
    a = np.asarray(a, dtype=dtype)
    b = np.asarray(b, dtype=dtype)
    small = np.minimum(a, b)
    big = np.maximum(a, b)
    diff = big - small
    tbl = jacobian_log_table(dtype)
    # fastRound(diff * inv_step): round-half-away-from-zero on positive values
    finite_diff = np.where(np.isfinite(diff), diff, dtype(0.0))
    idx = (finite_diff * dtype(1.0 / JACOBIAN_LOG_TABLE_STEP)
           + dtype(0.5)).astype(np.int64)
    idx = np.clip(idx, 0, JACOBIAN_LOG_TABLE_SIZE - 1)
    approx = big + tbl[idx]
    out = np.where(diff >= dtype(MAX_JACOBIAN_TOLERANCE), big, approx)
    return np.where(np.isinf(small) | np.isinf(big), big, out)


@functools.lru_cache(maxsize=None)
def ph2pr_table(dtype=np.float32):
    """phred -> probability: 10^(-q/10) for q in [0,128); context.h:106-110."""
    q = np.arange(128, dtype=dtype)
    return np.power(dtype(10.0), -q / dtype(10.0)).astype(dtype)


@functools.lru_cache(maxsize=None)
def match_to_match_table(dtype=np.float32):
    """P(match->match) = 1 - (P(insOpen) + P(delOpen)) as a (128,128) table.

    Mirrors initializeMatchToMatchProb (context.h:52-63): the log10 sum uses
    the Jacobian approximation in the target dtype, the outer 1-10^x math in
    double, and the result is stored in the target dtype. Expanded to a full
    square table (the reference packs the triangular half; set_mm_prob at
    context.h:128-141 symmetrizes by min/max).
    """
    q = np.arange(128, dtype=np.float64)
    i, j = np.meshgrid(q, q, indexing="ij")
    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    log10_sum = approximate_log10_sum_log10(
        (-0.1 * hi).astype(dtype), (-0.1 * lo).astype(dtype), dtype=dtype
    ).astype(np.float64)
    with np.errstate(divide="ignore"):  # q=(0,0) legitimately yields -inf -> 0
        m2m_log10 = np.log1p(-np.minimum(1.0, np.power(10.0, log10_sum))) / np.log(10.0)
    return np.power(10.0, m2m_log10).astype(dtype)


def log10_sum_log10(values, axis=None):
    """Exact log10(sum(10^v)) (math_utils.h:38-60 semantics, done exactly)."""
    values = np.asarray(values, dtype=np.float64)
    m = np.max(values, axis=axis, keepdims=True)
    safe_m = np.where(np.isfinite(m), m, 0.0)
    s = np.sum(np.power(10.0, values - safe_m), axis=axis, keepdims=True)
    out = safe_m + np.log10(s)
    out = np.where(np.isfinite(m), out, m)
    if axis is not None:
        out = np.squeeze(out, axis=axis)
    else:
        out = out.reshape(())
    return out


def log10_one_minus_pow10(a):
    """log10(1 - 10^a) for a <= 0 (log1mexp in log10 space)."""
    a = np.asarray(a, dtype=np.float64)
    x = a * np.log(10.0)  # natural-log argument
    out = np.where(
        x > -np.log(2.0),
        np.log(-np.expm1(x)),
        np.log1p(-np.exp(x)),
    )
    return out / np.log(10.0)


def normalize_log10(values, axis=-1):
    """Shift a log10 vector so it sums to 1 in linear space."""
    values = np.asarray(values, dtype=np.float64)
    total = log10_sum_log10(values, axis=axis)
    return values - np.expand_dims(total, axis)


def phred_scaled(log10_prob):
    """-10 * log10(p), the standard phred scaling."""
    return -10.0 * np.asarray(log10_prob, dtype=np.float64)
