"""Variant annotations: INFO and FORMAT fields.

Counterpart of the reference's annotation suite (reference:
src/haplotypecaller/genotype/annotation/info/* and format/*,
variant_annotator_engine.cpp:49-87). VCF-mode INFO set: BaseQRankSum,
ChromosomeCounts (AC/AF/AN), DP, ExcessHet, FS, MQRankSum, QD, MQ,
ReadPosRankSum, SOR; GVCF-mode swaps FS/QD/SOR/AC out and emits RAW_MQandDP.
FORMAT: AD, DP (informative reads), SB (gvcf).

Rank-sum z-values follow the reference's MannWhitneyU exactly
(mann_whitney_u.cpp:44-78): normal approximation with tie + continuity
correction when either group has >= 10 values, exact permutation test with
a mid-p rule and z = Phi^-1(p) when both are smaller. (QD matches the
reference, which itself dropped GATK's random jitter for determinism.)
"""

import math

import numpy as np

from .variant import NON_REF, SPAN_DEL


def is_usable_read(read):
    return read.mapping_quality != 0 and read.mapping_quality != 255


def classify_reads(likelihoods):
    """best-allele classification of informative reads.

    Returns (best_idx, informative) arrays over likelihoods.reads."""
    best_idx, _, _, informative = likelihoods.best_allele_per_read()
    return best_idx, informative


# --- FORMAT-level -----------------------------------------------------------

def depth_per_allele(call_alleles, likelihoods):
    """AD (DepthPerAlleleBySample): informative reads per best allele.

    The reference marginalizes the annotation container down to the
    CALL's alleles first (annotate_with_likelihoods,
    depth_per_allele_by_sample.h) — best/informativeness are recomputed
    over the subset, so a read whose overall best is a dropped spanning
    allele still counts toward its best CALL allele."""
    sub = likelihoods.subset_to_alleles(call_alleles)
    best_idx, informative = classify_reads(sub)
    counts = [0] * len(call_alleles)
    for r in range(sub.n_reads):
        if informative[r]:
            counts[int(best_idx[r])] += 1
    return counts


def depth_per_sample(call_alleles, likelihoods):
    """DP (DepthPerSampleHC): informative-read count over the container
    marginalized to the CALL's alleles (depth_per_sample_hc.cpp:31-44) —
    like AD, not over the full annotation allele set."""
    sub = likelihoods.subset_to_alleles(call_alleles)
    _, informative = classify_reads(sub)
    return int(np.sum(informative))


def strand_bias_by_sample(call_alleles, likelihoods):
    """SB: [refFwd, refRev, altFwd, altRev]."""
    best_idx, informative = classify_reads(likelihoods)
    table = [0, 0, 0, 0]
    ref_index = 0
    for r, read in enumerate(likelihoods.reads):
        if not informative[r]:
            continue
        a = int(best_idx[r])
        allele = likelihoods.alleles[a]
        if allele == NON_REF or allele == SPAN_DEL:
            continue
        if a != ref_index and not any(allele == c for c in call_alleles):
            continue  # dropped allele: not ref, not one of the call's alts
        alt = 2 if a != ref_index else 0
        rev = 1 if read.is_reverse else 0
        table[alt + rev] += 1
    return table


# --- INFO-level -------------------------------------------------------------

def chromosome_counts(variant):
    """AC, AF, AN from called genotypes."""
    an = 0
    ac = [0] * len(variant.alts)
    for g in variant.genotypes:
        for a in g.alleles:
            if a.bases == b".":
                continue
            an += 1
            for i, alt in enumerate(variant.alts):
                if a == alt:
                    ac[i] += 1
    af = [(c / an if an else 0.0) for c in ac]
    return ac, af, an


def coverage(likelihoods):
    """DP (Coverage): total reads in the likelihood container."""
    return likelihoods.n_reads


def qual_by_depth(variant, likelihoods):
    """QD: QUAL / depth over het/hom-var genotypes, AD-restricted when any
    genotype shows real alt depth, capped at 35 — matching the reference,
    which also dropped GATK's random jitter (qual_by_depth.cpp:15-80)."""
    depth = 0
    ad_restricted = 0
    for g in variant.genotypes:
        if not g.is_called or g.is_hom_ref():
            continue
        if g.ad is not None and sum(g.ad) != 0:
            total = sum(g.ad)
            if total - g.ad[0] > 1:
                ad_restricted += total
            depth += total
            continue
        depth += likelihoods.n_reads
    if ad_restricted > 0:
        depth = ad_restricted
    if depth == 0:
        return None
    qd = variant.qual / depth
    return min(qd, 35.0)


def rms_mapping_quality(likelihoods, raw=False):
    """MQ (RMSMappingQuality): sqrt(mean of squared MQs) over all reads;
    raw form returns (sum_sq, depth)."""
    mqs = np.array([r.mapping_quality for r in likelihoods.reads],
                   dtype=np.float64)
    if mqs.size == 0:
        return None
    sum_sq = float(np.sum(mqs ** 2))
    if raw:
        return sum_sq, int(mqs.size)
    return math.sqrt(sum_sq / mqs.size)


def _strand_table(variant, likelihoods, min_count=0):
    """2x2 [ [refFwd, refRev], [altFwd, altRev] ] over informative reads.

    `min_count` is the per-sample gate (strand_bias_test.cpp:53-57,76-78):
    a sample whose four cells total <= min_count contributes nothing.
    FisherStrand passes 2, StrandOddsRatio 0."""
    best_idx, informative = classify_reads(likelihoods)
    table = np.zeros((2, 2), dtype=np.int64)
    for r, read in enumerate(likelihoods.reads):
        if not informative[r] or not is_usable_read(read):
            continue
        a = int(best_idx[r])
        allele = likelihoods.alleles[a]
        if allele == NON_REF or allele == SPAN_DEL:
            continue
        # update_table (strand_bias_test.cpp:85-96): a best allele must be
        # the ref or one of THIS VARIANT's alts to count — the annotation
        # container can hold alleles the call dropped
        if a != 0 and not variant.has_allele(allele):
            continue
        row = 0 if a == 0 else 1
        col = 1 if read.is_reverse else 0
        table[row, col] += 1
    if table.sum() <= min_count:
        table[:] = 0
    return table


# --- exact Fisher test via saddle-point binomial log-pmf --------------------
# Clean-room implementation of the reference's hypergeometric machinery
# (utils/saddle_point_expansion.cpp, hypergeometric_distribution.cpp, both
# commons-math style) so FS matches the binary bit-for-bit at any depth with
# no scipy dependency.

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
# exact Stirling errors for z = 0, 0.5, ..., 15 (saddle_point_expansion.cpp)
_EXACT_STIRLING = (
    0.0, 0.1534264097200273452913848, 0.0810614667953272582196702,
    0.0548141210519176538961390, 0.0413406959554092940938221,
    0.03316287351993628748511048, 0.02767792568499833914878929,
    0.02374616365629749597132920, 0.02079067210376509311152277,
    0.01848845053267318523077934, 0.01664469118982119216319487,
    0.01513497322191737887351255, 0.01387612882307074799874573,
    0.01281046524292022692424986, 0.01189670994589177009505572,
    0.01110455975820691732662991, 0.010411265261972096497478567,
    0.009799416126158803298389475, 0.009255462182712732917728637,
    0.008768700134139385462952823, 0.008330563433362871256469318,
    0.007934114564314020547248100, 0.007573675487951840794972024,
    0.007244554301320383179543912, 0.006942840107209529865664152,
    0.006665247032707682442354394, 0.006408994188004207068439631,
    0.006171712263039457647532867, 0.005951370112758847735624416,
    0.005746216513010115682023589, 0.005554733551962801371038690)


def _stirling_error(z):
    if z < 15.0:
        z2 = 2.0 * z
        if math.floor(z2) == z2:
            return _EXACT_STIRLING[int(z2)]
        return (math.lgamma(z + 1.0) - (z + 0.5) * math.log(z) + z
                - _HALF_LOG_2PI)
    z2 = z * z
    return (0.083333333333333333333 -
            (0.00277777777777777777778 -
             (0.00079365079365079365079365 -
              (0.000595238095238095238095238 -
               0.0008417508417508417508417508 / z2) / z2) / z2) / z2) / z


def _deviance_part(x, mu):
    if abs(x - mu) < 0.1 * (x + mu):
        d = x - mu
        v = d / (x + mu)
        s1 = v * d
        s = None
        ej = 2.0 * x * v
        v *= v
        j = 1
        while s1 != s:
            s = s1
            ej *= v
            s1 = s + ej / (j * 2 + 1)
            j += 1
        return s1
    return x * math.log(x / mu) + mu - x


def _log_binomial_probability(x, n, p, q):
    if x == 0:
        if p < 0.1:
            return -_deviance_part(n, n * q) - n * p
        return n * math.log(q)
    if x == n:
        if q < 0.1:
            return -_deviance_part(n, n * p) - n * q
        return n * math.log(p)
    ret = (_stirling_error(n) - _stirling_error(x) - _stirling_error(n - x)
           - _deviance_part(x, n * p) - _deviance_part(n - x, n * q))
    f = (2.0 * math.pi * x * (n - x)) / n
    return -0.5 * math.log(f) + ret


def _hypergeom_log_pmf(x, population, successes, sample):
    lo = max(0, sample - (population - successes))
    hi = min(sample, successes)
    if x < lo or x > hi:
        return -math.inf
    p = sample / population
    q = (population - sample) / population
    return (_log_binomial_probability(x, successes, p, q)
            + _log_binomial_probability(sample - x, population - successes,
                                        p, q)
            - _log_binomial_probability(sample, population, p, q))


_FS_TARGET_TABLE_SIZE = 200    # fisher_strand.cpp:15
_FS_REL_ERR = 1 - 10e-7        # fisher_strand.cpp:13
# log10(Double.MIN_VALUE) (quality_utils.cpp:11); the literal guards
# against DAZ environments where the denormal 4.9e-324 reads as zero
_MIN_LOG10_SCALED_QUAL = -323.3062153431158


def _fisher_two_sided_pvalue(table):
    """Two-sided Fisher exact p exactly as fisher_strand.cpp:35-63: sum of
    hypergeometric probabilities whose log-pmf <= log-pmf(observed) scaled
    by (1 - 1e-6), accumulated in log10 space."""
    m = int(table[0, 0] + table[0, 1])
    n = int(table[1, 0] + table[1, 1])
    k = int(table[0, 0] + table[1, 0])
    lo, hi = max(0, k - n), min(k, m)
    if hi - lo + 1 <= 1:
        return 1.0
    logds = [_hypergeom_log_pmf(i, m + n, m, k) for i in range(lo, hi + 1)]
    threshold = logds[int(table[0, 0]) - lo] * _FS_REL_ERR
    log10ds = np.array([d for d in logds if d <= threshold]) / math.log(10.0)
    if log10ds.size == 0:
        return 1.0
    mx = log10ds.max()
    p = float(10.0 ** mx * np.sum(10.0 ** (log10ds - mx)))
    return min(1.0, p)


def fisher_strand(variant, likelihoods):
    """FS: phred-scaled two-sided Fisher exact p on the strand table
    (fisher_strand.cpp:21-85; saddle-point hypergeometric, table normalized
    to ~200 entries at high depth, per-sample min-count 2)."""
    table = _strand_table(variant, likelihoods, min_count=2)
    total = int(table.sum())
    if total > _FS_TARGET_TABLE_SIZE * 2:
        norm = total / _FS_TARGET_TABLE_SIZE
        table = (table / norm).astype(np.int64)
    p = _fisher_two_sided_pvalue(table)
    log10p = math.log10(max(p, 1e-320))
    return round(abs(-10.0 * max(log10p, _MIN_LOG10_SCALED_QUAL)), 3)


def strand_odds_ratio(variant, likelihoods):
    """SOR (StrandOddsRatio): symmetric odds ratio with pseudocounts."""
    t = _strand_table(variant, likelihoods).astype(np.float64) + 1.0
    ratio = (t[0, 0] * t[1, 1]) / (t[0, 1] * t[1, 0]) + \
            (t[0, 1] * t[1, 0]) / (t[0, 0] * t[1, 1])
    ref_ratio = min(t[0, 0], t[0, 1]) / max(t[0, 0], t[0, 1])
    alt_ratio = min(t[1, 0], t[1, 1]) / max(t[1, 0], t[1, 1])
    ratio = ratio * ref_ratio / alt_ratio
    return round(math.log(ratio), 3)


_MWU_NORMAL_MIN_N = 10  # mann_whitney_u.cpp:12 s_minimum_normal_n


def _tied_ranks(alt_values, ref_values):
    """Tie-averaged 1-based ranks of alt+ref pooled, plus the ties-for-sigma
    term sum(c^3-c) over tie groups not spanning the whole pool
    (mann_whitney_u.cpp:119-179)."""
    combined = np.concatenate([alt_values, ref_values]).astype(np.float64)
    order = np.argsort(combined, kind="mergesort")
    ranks = np.empty_like(combined)
    sorted_vals = combined[order]
    n = len(combined)
    nties_sigma = 0.0
    i = 0
    while i < n:
        j = i
        # the reference groups ties with |a-b| < 1e-6 (cigar_op_is_equal)
        while j + 1 < n and abs(sorted_vals[j + 1] - sorted_vals[i]) < 1e-6:
            j += 1
        count = j - i + 1
        avg_rank = (2 * (i + 1) + (count - 1)) / 2.0
        for k in range(i, j + 1):
            ranks[order[k]] = avg_rank
        if count > 1 and count != n:
            nties_sigma += count ** 3 - count
        i = j + 1
    return ranks, nties_sigma


def _mann_whitney_z(alt_values, ref_values):
    """Mann-Whitney U z-score (FIRST_DOMINATES: series1=alt), matching
    mann_whitney_u.cpp:44-78. Normal approximation with continuity
    correction when either n >= 10; exact permutation mid-p otherwise."""
    n1, n2 = len(alt_values), len(ref_values)
    if n1 == 0 or n2 == 0:
        return None
    ranks, nties = _tied_ranks(alt_values, ref_values)
    u1 = float(np.sum(ranks[:n1])) - n1 * (n1 + 1) / 2.0
    if n1 >= _MWU_NORMAL_MIN_N or n2 >= _MWU_NORMAL_MIN_N:
        z = _mwu_z_normal(u1, n1, n2, nties)
    else:
        p = _mwu_permutation_p(ranks, n1, n2, u1)
        # inverse normal CDF (mann_whitney_u.cpp:27-30)
        z = math.sqrt(2.0) * _erf_inv(2.0 * p - 1.0)
    return round(z, 3)


def _erf_inv(y):
    """Inverse error function: Winitzki initial guess + Newton refinement
    against math.erf (~1e-15 over (-1,1); the reference delegates to
    boost::math::erf_inv, mann_whitney_u.cpp:29)."""
    if y <= -1.0:
        return -math.inf
    if y >= 1.0:
        return math.inf
    if y == 0.0:
        return 0.0
    a = 0.147
    ln1my2 = math.log(1.0 - y * y)
    t1 = 2.0 / (math.pi * a) + ln1my2 / 2.0
    x = math.copysign(math.sqrt(math.sqrt(t1 * t1 - ln1my2 / a) - t1), y)
    two_over_sqrtpi = 2.0 / math.sqrt(math.pi)
    for _ in range(3):
        err = math.erf(x) - y
        deriv = two_over_sqrtpi * math.exp(-x * x)
        if deriv == 0.0:
            break
        x -= err / deriv
    return x


def _mwu_z_normal(u, n1, n2, nties):
    """Normal z with tie-adjusted sigma and continuity correction
    (mann_whitney_u.cpp:181-201, FIRST_DOMINATES)."""
    m = n1 * n2 / 2.0
    correction = -0.5 if nties != 0 else 0.0
    n = n1 + n2
    sigma = math.sqrt((n1 * n2 / 12.0) * ((n + 1) - nties / (n * (n - 1))))
    if sigma == 0:
        return 0.0
    return (u - m - correction) / sigma


def _mwu_permutation_p(ranks, n1, n2, u_obs):
    """Exact permutation p over all C(n1+n2, n1) rank assignments, mid-p on
    the observed bin (mann_whitney_u.cpp:203-264).

    The reference enumerates subsets; the same exact histogram falls out
    of a 0/1-knapsack DP over doubled rank sums (ranks have .5
    granularity, so 2*rank is integral): dp[k][s] = #subsets of size k
    with doubled-rank-sum s. ~1000x faster than enumeration at n=19 with
    bit-identical counts."""
    r2 = np.rint(np.asarray(ranks, dtype=np.float64) * 2).astype(np.int64)
    total_sum = int(r2.sum())
    dp = np.zeros((n1 + 1, total_sum + 1), dtype=np.float64)
    dp[0, 0] = 1.0
    for r in r2:
        if r:
            dp[1:, r:] += dp[:-1, :-r]
        else:
            dp[1:, :] += dp[:-1, :]
    counts = dp[n1]                      # counts[s] over doubled sums
    # key = 2*u = s - 2*base with 2*base = n1*(n1+1)
    key_obs = round(2 * u_obs)
    s_obs = key_obs + n1 * (n1 + 1)
    total = counts.sum()
    smaller = (counts[s_obs] / 2.0 if 0 <= s_obs <= total_sum else 0.0)
    smaller += counts[:max(0, min(s_obs, total_sum + 1))].sum()
    return smaller / total


def _read_pos_element(read, variant):
    """min distance of the variant site from either read end, counting
    hard-clipped bases (read_pos_rank_sum_test.cpp:21-57)."""
    from ..reads.cigar import CigarOp
    if read.pos == variant.stop + 1:
        # variant immediately left of the read: insertion leading the read
        # counts as position 0 (read_pos_rank_sum_test.cpp:27-42)
        for op, _n in read.cigar:
            if op in (CigarOp.S, CigarOp.H):
                continue
            if op == CigarOp.I:
                return 0.0
            break
    offset, _op = read.index_at_ref_coord(variant.start)
    if offset is None:
        return None
    elems = read.cigar.elements
    lead_h = elems[0][1] if elems and elems[0][0] == CigarOp.H else 0
    trail_h = elems[-1][1] if elems and elems[-1][0] == CigarOp.H else 0
    left = read.hard_left + lead_h + offset
    right = (len(read.bases) - 1 - offset) + read.hard_right + trail_h
    return float(min(left, right))


def _per_read_values(variant, likelihoods, kind):
    """(alt_values, ref_values) for rank-sum tests."""
    best_idx, informative = classify_reads(likelihoods)
    alt_vals, ref_vals = [], []
    loc = variant.start
    for r, read in enumerate(likelihoods.reads):
        if not informative[r] or not is_usable_read(read):
            continue
        allele = likelihoods.alleles[int(best_idx[r])]
        if not allele.is_ref and not variant.has_allele(allele):
            # reference: a non-ref best allele counts toward alt_quals iff
            # it is one of the variant's alleles (rank_sum_test.cpp:51-56)
            # — * and <NON_REF> qualify when the call carries them
            continue
        if kind == "mq":
            value = float(read.mapping_quality)
        elif kind == "baseq":
            offset, is_del = read.read_pos_at_ref_pos(loc)
            if offset is None:
                continue
            value = float(read.quals[offset])
        else:  # readpos
            value = _read_pos_element(read, variant)
            if value is None:
                continue
        (ref_vals if int(best_idx[r]) == 0 else alt_vals).append(value)
    return np.array(alt_vals), np.array(ref_vals)


def rank_sum(variant, likelihoods, kind):
    alt_vals, ref_vals = _per_read_values(variant, likelihoods, kind)
    return _mann_whitney_z(alt_vals, ref_vals)


def excess_het(variant):
    """ExcessHet: phred-scaled p of excess heterozygosity (exact test,
    Wigginton 2005), matching the reference's variant exactly
    (annotation/info/excess_het.cpp:33-131). NOTE: the reference diverges
    from GATK here — GATK halves the observed bin (mid-p); the reference
    takes the full bin (excess_het.cpp:123), so 1 het sample gives p=1 →
    ExcessHet=0, not GATK's 3.0103."""
    het = hom_ref = hom_alt = 0
    for g in variant.genotypes:
        if not g.is_called or g.ploidy != 2:
            continue
        a, b = g.alleles
        if a.is_ref and b.is_ref:
            hom_ref += 1
        elif a.is_ref != b.is_ref or a != b:
            het += 1
        else:
            hom_alt += 1
    n = het + hom_ref + hom_alt
    if n == 0:
        return None
    p = _exact_het_p(het, hom_ref, hom_alt)
    if p < 10e-60:  # excess_het.cpp:42-44 phred cap
        return 160.00
    return round(-10.0 * math.log10(p), 4)


# probabilities below this add nothing printable (excess_het.cpp:15)
_EH_MIN_NEEDED = 10.0e-16


def _exact_het_p(obs_het, obs_hom_ref, obs_hom_alt):
    """P(het >= observed) under HWE (one-sided upper, full observed bin —
    excess_het.cpp:63-131)."""
    n = obs_het + obs_hom_ref + obs_hom_alt
    rare = 2 * min(obs_hom_ref, obs_hom_alt) + obs_het
    probs = np.zeros(rare + 1)
    # mode midpoint uses the 2n-1 denominator (excess_het.cpp:75)
    mid = int(math.floor(rare * (2.0 * n - rare) / (2.0 * n - 1.0)))
    if mid % 2 != rare % 2:
        mid += 1
    probs[mid] = 1.0
    total = 1.0
    het = mid
    hom_r = (rare - mid) // 2
    hom_c = n - het - hom_r
    while het >= 2:
        p = (probs[het] * het * (het - 1.0)
             / (4.0 * (hom_r + 1.0) * (hom_c + 1.0)))
        if p < _EH_MIN_NEEDED:
            break
        probs[het - 2] = p
        total += p
        het -= 2
        hom_r += 1
        hom_c += 1
    het = mid
    hom_r = (rare - mid) // 2
    hom_c = n - het - hom_r
    while het <= rare - 2:
        p = (probs[het] * 4.0 * hom_r * hom_c
             / ((het + 2.0) * (het + 1.0)))
        if p < _EH_MIN_NEEDED:
            break
        probs[het + 2] = p
        total += p
        het += 2
        hom_r -= 1
        hom_c -= 1
    right_pval = probs[obs_het] / total
    if obs_het == rare:
        return max(0.0, min(1.0, right_pval))
    above = float(np.sum(probs[obs_het + 1:]))
    return max(0.0, min(1.0, right_pval + above / total))


def annotate_variant(variant, likelihoods, gvcf_mode=False):
    """Apply the annotation suite in place; returns variant."""
    info = variant.attributes

    for g in variant.genotypes:
        g.ad = depth_per_allele(variant.alleles, likelihoods)
        g.dp = depth_per_sample(variant.alleles, likelihoods)
        if gvcf_mode:
            g.attributes["SB"] = strand_bias_by_sample(variant.alleles,
                                                       likelihoods)

    bq = rank_sum(variant, likelihoods, "baseq")
    if bq is not None:
        info["BaseQRankSum"] = bq
    mqrs = rank_sum(variant, likelihoods, "mq")
    if mqrs is not None:
        info["MQRankSum"] = mqrs
    rprs = rank_sum(variant, likelihoods, "readpos")
    if rprs is not None:
        info["ReadPosRankSum"] = rprs

    info["DP"] = coverage(likelihoods)
    # ExcessHet belongs to both VCF and GVCF sets
    # (variant_annotator_engine.cpp:53,72)
    eh = excess_het(variant)
    if eh is not None:
        info["ExcessHet"] = eh

    if gvcf_mode:
        raw = rms_mapping_quality(likelihoods, raw=True)
        if raw is not None:
            info["RAW_MQandDP"] = [int(raw[0]), raw[1]]
    else:
        ac, af, an = chromosome_counts(variant)
        info["AC"] = ac
        info["AF"] = [round(x, 3) for x in af]
        info["AN"] = an
        mq = rms_mapping_quality(likelihoods)
        if mq is not None:
            info["MQ"] = round(mq, 2)
        qd = qual_by_depth(variant, likelihoods)
        if qd is not None:
            info["QD"] = round(qd, 2)
        info["FS"] = fisher_strand(variant, likelihoods)
        sor = strand_odds_ratio(variant, likelihoods)
        if sor is not None:
            info["SOR"] = sor
    return variant
