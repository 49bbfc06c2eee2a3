"""Genotype likelihoods from per-read allele likelihoods.

Counterpart of the reference's GenotypeLikelihoodCalculator (reference:
src/haplotypecaller/genotype/genotype_likelihood_calculator.cpp; GATK
semantics): for genotype G with allele counts {a: c_a},

    GL(G) = sum_reads log10( sum_a c_a * 10^lik[a][read] / P )

computed in log space, vectorized over reads.
"""

import numpy as np

from ..ops import gatk_math
from . import genotype_alleles as ga


def _approx_sum_seq(values):
    """Sequential max-anchored Jacobian-table sum over a small vector
    (MathUtils::approximate_log10sum_log10(values, begin, end),
    math_utils.cpp:245-263): start at the max element, then fold every
    other element into the RUNNING sum in index order via the quantized
    table. Order-dependent by design."""
    import math
    mi = int(np.argmax(values))
    approx = float(values[mi])
    tbl = gatk_math.jacobian_log_table()
    for i, v in enumerate(values):
        v = float(v)
        if i == mi or v == -math.inf:
            continue
        diff = approx - v
        if diff < gatk_math.MAX_JACOBIAN_TOLERANCE:
            approx += tbl[int(math.floor(
                diff * (1.0 / gatk_math.JACOBIAN_LOG_TABLE_STEP) + 0.5))]
    return approx


def genotype_log10_likelihoods(ploidy, lik_matrix):
    """lik_matrix: (n_alleles, n_reads) float64 log10 likelihoods.

    Returns (n_genotypes,) float64 log10 GLs in canonical order.

    Bit-exact transcription of the reference's calculator
    (genotype_likelihood_calculator.cpp:80-141 + .h:126-147):
    per-(allele,count) component = lik + log10(count); per-read genotype
    value = the QUANTIZED Jacobian-table log10-sum of its components
    (exact log-sum-exp lands a few 1e-4 phred away and flips PL rounding
    — round-5 adversarial STR deletion chr22:79771 GQ 43 vs 42); read
    sum is sequential; the ploidy denominator is subtracted at the end.
    """
    import math
    lik = np.asarray(lik_matrix, dtype=np.float64)
    n_alleles, n_reads = lik.shape
    log10_ploidy = math.log10(ploidy)
    counts = ga.allele_count_maps(ploidy, n_alleles)
    denominator = n_reads * log10_ploidy

    def seq_sum(per_read):
        return float(np.cumsum(per_read)[-1]) if n_reads else 0.0

    out = np.empty(len(counts))
    for gi, count_pairs in enumerate(counts):
        if len(count_pairs) == 1:
            a, c = count_pairs[0]
            per_read = lik[a] + log10_ploidy   # freq == ploidy component
        elif len(count_pairs) == 2:
            (a0, c0), (a1, c1) = count_pairs
            per_read = gatk_math.approximate_log10_sum_log10(
                lik[a0] + math.log10(c0), lik[a1] + math.log10(c1))
        else:
            comp = np.stack([lik[a] + math.log10(c)
                             for a, c in count_pairs])
            per_read = np.array([_approx_sum_seq(comp[:, r])
                                 for r in range(n_reads)])
        out[gi] = seq_sum(per_read) - denominator
    return out


def gls_to_pls(gls):
    """Normalized phred-scaled integer PLs (best = 0)."""
    gls = np.asarray(gls, dtype=np.float64)
    adjusted = gls - gls.max()
    pls = np.round(-10.0 * adjusted).astype(np.int64)
    return np.minimum(pls, np.iinfo(np.int32).max).astype(np.int32)


def gq_from_pls(pls):
    """GQ = second-smallest PL (difference from best which is 0)."""
    if len(pls) < 2:
        return 0
    s = np.sort(np.asarray(pls))
    return int(min(s[1] - s[0], 99))
