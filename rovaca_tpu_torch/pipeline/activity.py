"""Per-base activity model + band-pass profile + region cutting.

Window-vectorized reimplementation of the reference's streaming activity
pipeline (reference: src/haplotypecaller/ActiveRegion/HcActiveBase.cpp:96-296,
ActiveRegionEngine.cpp:23-260). Instead of per-read ring buffers and a
coordinate ring buffer spread across threads, each genomic window is processed
as dense arrays:

1. CIGAR walks classify each read base as variant (alt/indel-adjacent/
   softclip-adjacent) or reference evidence, histogrammed per position/qual.
2. Ref-vs-any genotype likelihoods come from one tensordot against a
   precomputed (status, qual, genotype) cache, then PL quantization and the
   biallelic non-ref posterior — all vectorized over positions.
3. The Gaussian band-pass (half-width 50, sigma 17) is a single correlate()
   with per-site smear widths handled by bucketing sites by repeat factor.
4. Region cutting thresholds at 0.002 and cuts [min 50, max 300] regions,
   splitting oversized runs at the best local minimum.
"""

import dataclasses
import math

import numpy as np

from .. import constants as C
from ..ops import gatk_math
from ..reads.cigar import CigarOp

# constants from HcActiveBase.cpp:1-12
REF_MODEL_DELETION_QUAL = 30
MIN_BASE_QUAL = 10
HQ_SOFTCLIP_QUAL_THRESHOLD = 28
HQ_BASES_THRESHOLD = 6.0
MAX_PROB_DISTANCE = 100.0
RC_SNP_P = 0.01
RC_REF_P = 10.0
MAX_QUAL_BIN = 64

_LOG10_E = math.log10(math.e)


def _log10_binom(n, k):
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1)) * _LOG10_E


def genotype_cache(ploidy=2):
    """(2, 64, ploidy+1) cache of per-base genotype log-likelihood terms
    (HcActiveBase.h:152-179). Status 0 = variant evidence, 1 = reference.

    Built with SCALAR libm arithmetic that transcribes the reference
    bit-for-bit (quality_utils.cpp:19-31: error log10 is ``q * -0.1`` —
    not ``-q/10.0``, which differs by an ulp for some q — and the prob
    cache is ``std::log10(1 - std::pow(10, q/-10.0))``; the het term is
    the QUANTIZED Jacobian-table sum, math_utils.cpp:280-291, step 1e-4 —
    NOT an exact log-sum-exp, whose few-1e-4-phred skew flips GVCF PL
    rounding at integer boundaries; round-4 divergence seed 867530)."""
    third = math.log10(1.0 / 3.0)
    lp = math.log10(ploidy)

    cache = np.zeros((2, MAX_QUAL_BIN, ploidy + 1))
    for status in range(2):
        for q in range(MAX_QUAL_BIN):
            err_prob = 10.0 ** (q / -10.0)
            prob_log10 = math.log10(1.0 - err_prob) if err_prob < 1.0 \
                else -300.0
            err_log10 = q * -0.1
            if status == 0:  # variant base
                ref_lik = err_log10 + third
                nonref_lik = prob_log10
            else:            # reference base
                ref_lik = prob_log10
                nonref_lik = err_log10 + third
            cache[status, q, 0] = ref_lik + lp
            cache[status, q, ploidy] = nonref_lik + lp
            for g in range(1, ploidy):
                a = ref_lik + math.log10(ploidy - g)
                b = nonref_lik + math.log10(g)
                cache[status, q, g] = float(
                    gatk_math.approximate_log10_sum_log10(a, b))
    return cache


_MASKED_CACHE = {}


def _masked_genotype_cache(ploidy):
    """genotype_cache with quals <= MIN_BASE_QUAL rows zeroed."""
    if ploidy not in _MASKED_CACHE:
        c = genotype_cache(ploidy).copy()
        c[:, : MIN_BASE_QUAL + 1, :] = 0.0
        _MASKED_CACHE[ploidy] = c
    return _MASKED_CACHE[ploidy]


_PRIOR_CACHE = {}


def _genotype_prior(ploidy):
    """log10 prior term added per genotype
    (compute_biallelic_non_ref_posterior, HcActiveBase.cpp:265-283)."""
    if ploidy not in _PRIOR_CACHE:
        g = np.arange(ploidy + 1, dtype=np.float64)
        prior = np.array([
            _log10_binom(ploidy, int(i))
            + (math.lgamma(i + RC_SNP_P) + math.lgamma(ploidy - i + RC_REF_P))
            * _LOG10_E
            for i in g])
        _PRIOR_CACHE[ploidy] = prior
    return _PRIOR_CACHE[ploidy]


def high_quality_soft_clips(read):
    """Count of soft-clipped bases with qual > 28 (HcActiveBase.cpp:14-34)."""
    n = 0
    qpos = 0
    for op, length in read.cigar:
        if op == CigarOp.S:
            n += int(np.sum(read.quals[qpos:qpos + length]
                            > HQ_SOFTCLIP_QUAL_THRESHOLD))
        if op in (CigarOp.M, CigarOp.I, CigarOp.S, CigarOp.EQ, CigarOp.X):
            qpos += length
    return n


def adaptor_boundary(read):
    """Mate-adaptor boundary, or None (HcActiveBase.cpp:48-68)."""
    r = read
    if (r.tlen == 0 or not r.is_paired or (r.flag & 0x8) or r.is_unmapped
            or (r.is_reverse == bool(r.flag & 0x20))):
        return None
    if r.is_reverse:
        if r.end <= r.mate_pos:
            return None
        return r.mate_pos  # 0-based mate start
    else:
        if r.pos > r.mate_pos + r.tlen:
            return None
        return r.pos + 1 + abs(r.tlen)


def _base_inside_adaptor(read, pos1, boundary):
    """pos1 is 1-based (HcActiveBase.cpp:36-42)."""
    if boundary is None or read.tlen > 100:
        return False
    if read.is_reverse:
        return pos1 <= boundary
    return pos1 >= boundary


@dataclasses.dataclass
class ActivityWindow:
    """Histograms + soft-clip stats over [start, end) for one contig."""
    start: int
    end: int
    hist: np.ndarray       # (2, L, 64) int32: [variant/ref][pos][qual]
    hq_sum: np.ndarray     # (L,) float64: sum of hq-softclip counts
    hq_n: np.ndarray       # (L,) int64


def accumulate_read(win, read, ref):
    """Classify each base of `read` into the window histograms
    (process_bam_to_slot, HcActiveBase.cpp:96-188), vectorized per cigar
    block. `ref` is the full contig sequence (bytes or RefWindow)."""
    bound = adaptor_boundary(read)
    hq_soft = None  # computed lazily
    pos = read.pos
    qpos = 0
    L = win.end - win.start
    elems = read.cigar.elements
    n_elems = len(elems)
    quals = read.quals
    rbases = np.frombuffer(read.bases, dtype=np.uint8)
    for ci, (op, length) in enumerate(elems):
        consumes_ref = op in (CigarOp.M, CigarOp.D, CigarOp.N, CigarOp.EQ,
                              CigarOp.X)
        consumes_query = op in (CigarOp.M, CigarOp.I, CigarOp.S, CigarOp.EQ,
                                CigarOp.X)
        if consumes_ref:
            prev_op = elems[ci - 1][0] if ci > 0 else None
            next_op = elems[ci + 1][0] if ci < n_elems - 1 else None
            offs = np.arange(pos - win.start, pos - win.start + length)
            in_win = (offs >= 0) & (offs < L)
            if bound is not None and read.tlen <= 100:
                p1 = offs + win.start + 1  # 1-based positions
                if read.is_reverse:
                    in_win &= p1 > bound
                else:
                    in_win &= p1 < bound
            if op == CigarOp.D:
                np.add.at(win.hist[0, :, REF_MODEL_DELETION_QUAL],
                          offs[in_win], 1)
            else:
                bq = np.minimum(quals[qpos:qpos + length].astype(np.int64),
                                MAX_QUAL_BIN - 1)
                # clamp the ref fetch to the view: a RefWindow may not cover
                # the read's full span, but positions outside the view are
                # also outside the activity window in every pipeline use
                # (views carry >=600bp margin vs the <=~150bp read overhang),
                # so masking them out of in_win preserves the histogram
                vlo = getattr(ref, "offset", 0)
                clo = max(pos, vlo)
                refslice = np.frombuffer(ref[clo:max(clo, pos + length)],
                                         dtype=np.uint8)
                chi = clo + len(refslice)
                variant = np.ones(length, dtype=bool)
                variant[clo - pos:chi - pos] = (
                    rbases[qpos + clo - pos:qpos + chi - pos] != refslice)
                if clo > pos or chi < pos + length:
                    covered = (offs + win.start >= clo) & \
                              (offs + win.start < chi)
                    in_win &= covered
                # edge rules exactly as HcActiveBase.cpp:158-186
                hq_first = prev_op == CigarOp.S
                hq_last = length > 1 and next_op == CigarOp.S
                if hq_first or prev_op in (CigarOp.I, CigarOp.D) or (
                        length == 1 and next_op in (CigarOp.I, CigarOp.D)):
                    variant[0] = True
                if length > 1 and (hq_last
                                   or next_op in (CigarOp.I, CigarOp.D)):
                    variant[-1] = True
                np.add.at(win.hist[0], (offs[in_win & variant],
                                        bq[in_win & variant]), 1)
                np.add.at(win.hist[1], (offs[in_win & ~variant],
                                        bq[in_win & ~variant]), 1)
                # high-quality soft-clip stats at clip-adjacent edges
                for edge_idx, active in ((0, hq_first), (length - 1, hq_last)):
                    if not active or not in_win[edge_idx]:
                        continue
                    if int(quals[qpos + edge_idx]) > MIN_BASE_QUAL:
                        if hq_soft is None:
                            hq_soft = high_quality_soft_clips(read)
                        win.hq_sum[offs[edge_idx]] += hq_soft
                        win.hq_n[offs[edge_idx]] += 1
        if consumes_ref:
            pos += length
        if consumes_query:
            qpos += length


_SIMPLE_OPS = frozenset((CigarOp.M, CigarOp.EQ, CigarOp.X, CigarOp.S,
                         CigarOp.H))
_ALIGNED_OPS = frozenset((CigarOp.M, CigarOp.EQ, CigarOp.X))


def _simple_layout(read):
    """(ref_start, query_off, mlen, lead_s, trail_s) for reads whose cigar
    is a single aligned block with optional soft/hard clips, else None."""
    mlen = 0
    lead_s = trail_s = False
    qoff = 0
    seen_aligned = False
    for op, length in read.cigar.elements:
        if op not in _SIMPLE_OPS:
            return None
        if op in _ALIGNED_OPS:
            if seen_aligned:
                return None
            seen_aligned = True
            mlen = length
        elif op == CigarOp.S:
            if seen_aligned:
                trail_s = True
            else:
                lead_s = True
                qoff += length
    if not seen_aligned:
        return None
    return read.pos, qoff, mlen, lead_s, trail_s


def accumulate_reads(win, reads, ref):
    """Window-batched accumulate_read: the native batch accumulator when
    available (one C pass over all reads), else one histogram bincount for
    all simple-cigar reads (single aligned block, optional clips, no adaptor
    overlap) with a per-read fallback for the rest. Bit-identical to calling
    accumulate_read over every read."""
    L = win.end - win.start
    if isinstance(ref, (bytes, bytearray, np.ndarray)):
        ref_arr, ref_off = np.frombuffer(bytes(ref), dtype=np.uint8), 0
    else:  # RefWindow view
        ref_arr, ref_off = np.frombuffer(ref.data, dtype=np.uint8), ref.offset

    import os
    from ..io.bamcols import BamColumns
    if isinstance(reads, BamColumns):
        from ..native import activity_native
        if activity_native.available() and \
                not os.environ.get("ROVACA_NO_NATIVE_ACTIVITY"):
            activity_native.accumulate_cols(win, reads, ref_arr, ref_off)
        else:
            activity_native_fallback = reads.materialize(
                np.arange(reads.n))
            accumulate_reads(win, activity_native_fallback, ref)
        return
    if not os.environ.get("ROVACA_NO_NATIVE_ACTIVITY"):
        from ..native import activity_native
        if activity_native.available():
            activity_native.accumulate(win, reads, ref_arr, ref_off)
            return

    starts, qoffs, lens = [], [], []
    base_parts, qual_parts = [], []
    bounds, revs = [], []            # adaptor boundary (-1 = none) per read
    edge_first, edge_last = [], []   # (concat_index, read) pairs
    n_acc = 0
    for read in reads:
        lay = _simple_layout(read)
        if lay is None:
            accumulate_read(win, read, ref)
            continue
        bound = (adaptor_boundary(read) if read.tlen <= 100 else None)
        pos, qoff, mlen, lead_s, trail_s = lay
        if pos + mlen <= win.start or pos >= win.end \
                or pos - ref_off < 0 or pos + mlen - ref_off > len(ref_arr):
            if pos + mlen <= win.start or pos >= win.end:
                continue                     # fully outside the window
            accumulate_read(win, read, ref)  # ref view too small: slow path
            continue
        starts.append(pos)
        qoffs.append(qoff)
        lens.append(mlen)
        bounds.append(-1 if bound is None else bound)
        revs.append(read.is_reverse)
        base_parts.append(np.frombuffer(read.bases, dtype=np.uint8)
                          [qoff:qoff + mlen])
        qual_parts.append(read.quals[qoff:qoff + mlen])
        if lead_s:
            edge_first.append((n_acc, read))
        if trail_s and mlen > 1:
            edge_last.append((n_acc + mlen - 1, read))
        n_acc += mlen

    if not starts:
        return
    lens_a = np.asarray(lens, dtype=np.int64)
    starts_a = np.asarray(starts, dtype=np.int64)
    ends = np.cumsum(lens_a)
    row0 = ends - lens_a
    within = np.arange(n_acc, dtype=np.int64) - np.repeat(row0, lens_a)
    offs = np.repeat(starts_a - win.start, lens_a) + within
    ridx = np.repeat(starts_a - ref_off, lens_a) + within
    bases = np.concatenate(base_parts)
    quals = np.concatenate(qual_parts)
    variant = bases != ref_arr[ridx]
    for idx, _ in edge_first:
        variant[idx] = True
    for idx, _ in edge_last:
        variant[idx] = True
    in_win = (offs >= 0) & (offs < L)
    # short-insert adaptor masking, batched (HcActiveBase.cpp:96-188 via
    # accumulate_read lines above): keep p1 < bound on forward strands,
    # p1 > bound on reverse; bound -1 = no adaptor overlap (a real bound
    # can be 0 when the mate maps at the contig start)
    bnd = np.repeat(np.asarray(bounds, dtype=np.int64), lens_a)
    if (bnd >= 0).any():
        rev = np.repeat(np.asarray(revs, dtype=bool), lens_a)
        p1 = offs + win.start + 1
        in_win &= (bnd < 0) | np.where(rev, p1 > bnd, p1 < bnd)
    bq = np.minimum(quals.astype(np.int64), MAX_QUAL_BIN - 1)
    # hist layout (2, L, 64): state 0 = variant evidence, 1 = reference
    key = ((np.where(variant, 0, 1)[in_win] * L + offs[in_win])
           * MAX_QUAL_BIN + bq[in_win])
    win.hist += np.bincount(key, minlength=2 * L * MAX_QUAL_BIN).astype(
        np.int32).reshape(2, L, MAX_QUAL_BIN)
    # high-quality soft-clip stats at clip-adjacent aligned edges
    for idx, read in edge_first + edge_last:
        if in_win[idx] and int(quals[idx]) > MIN_BASE_QUAL:
            win.hq_sum[offs[idx]] += high_quality_soft_clips(read)
            win.hq_n[offs[idx]] += 1


def compute_activity(win, ploidy=C.SAMPLE_PLOIDY):
    """Per-position non-ref posterior + smear repeat factor.

    Returns (activity (L,) float64, repeat (L,) int32). Vectorized
    reimplementation of compute_genotype_PL / compute_biallelic_non_ref_
    posterior / compute_extension_length (HcActiveBase.cpp:190-296).

    Positions with no variant-state base above MIN_BASE_QUAL provably
    yield activity 0 (all their GL mass sits on hom-ref, and argmax ties
    already resolve to genotype 0), so the dense per-position math runs
    only on the candidate subset — a large win on 1Mbp windows where
    <5% of positions carry any variant evidence."""
    hist = win.hist
    L = hist.shape[1]
    from ..native import activity_native
    cand_gls = activity_native.pileup_gls_cand(
        hist, _masked_genotype_cache(ploidy), MIN_BASE_QUAL, ploidy)
    if cand_gls is not None:
        # single native pass: candidate detection + their GL rows
        ci, gl, icounts = cand_gls
        activity = np.zeros(L, dtype=np.float64)
        repeat = np.zeros(L, dtype=np.int64)
        if ci.size:
            a, r = _activity_from_gls(gl, icounts.astype(np.float64),
                                      win.hq_sum[ci], win.hq_n[ci], ploidy)
            activity[ci] = a
            repeat[ci] = r
        return activity, repeat
    cand = hist[0, :, MIN_BASE_QUAL + 1:].any(axis=1)
    ci = np.nonzero(cand)[0]
    if ci.size == L:
        return _compute_activity_dense(win, ploidy)
    activity = np.zeros(L, dtype=np.float64)
    repeat = np.zeros(L, dtype=np.int64)
    if ci.size:
        import types
        sub = types.SimpleNamespace(
            hist=np.ascontiguousarray(hist[:, ci]),
            hq_sum=win.hq_sum[ci], hq_n=win.hq_n[ci])
        a, r = _compute_activity_dense(sub, ploidy)
        activity[ci] = a
        repeat[ci] = r
    return activity, repeat


def _compute_activity_dense(win, ploidy=C.SAMPLE_PLOIDY):
    """Full per-position activity math over every row of win.hist."""
    # quals <= MIN_BASE_QUAL are excluded (compute_genotype_PL min_qual);
    # zeroing the cache rows instead of a float64 histogram copy is
    # bit-identical (0-valued partial products in the same order) and
    # avoids materializing the (2, L, 64) float array
    cache = _masked_genotype_cache(ploidy)
    hist = win.hist
    from ..native import activity_native
    ng = activity_native.pileup_gls(hist, cache, MIN_BASE_QUAL, ploidy)
    if ng is not None:
        gl, icounts = ng
        counts = icounts.astype(np.float64)
    else:
        counts = hist[:, :, MIN_BASE_QUAL + 1:].sum(
            axis=(0, 2), dtype=np.int64).astype(np.float64)  # (L,)
        gl = np.einsum("sLq,sqg->Lg", hist, cache)          # (L, ploidy+1)
        gl -= counts[:, None] * math.log10(ploidy)
    return _activity_from_gls(gl, counts, win.hq_sum, win.hq_n, ploidy)


def _activity_from_gls(gl, counts, hq_sum, hq_n, ploidy):
    """PL quantization, prior, posterior, and smear factor from GL rows."""
    # PL quantization
    best = gl.max(axis=1, keepdims=True)
    pls = np.round(-10.0 * (gl - best))
    gl = pls / -10.0

    hom_ref_best = np.argmax(gl, axis=1) == 0

    gl = gl + _genotype_prior(ploidy)[None, :]
    hom_ref_best |= np.argmax(gl, axis=1) == 0

    # normalize in linear space: activity = 1 - P(hom ref)
    m = gl.max(axis=1, keepdims=True)
    lin = 10.0 ** (gl - m)
    post0 = lin[:, 0] / lin.sum(axis=1)
    activity = np.where(hom_ref_best | (counts == 0), 0.0, 1.0 - post0)

    hq_mean = np.divide(hq_sum, hq_n,
                        out=np.zeros_like(hq_sum), where=hq_n > 0)
    repeat = np.where(
        (activity > 0) & (hq_mean > HQ_BASES_THRESHOLD),
        2 * np.minimum(MAX_PROB_DISTANCE, hq_mean).astype(np.int64) + 1,
        1).astype(np.int64)
    repeat = np.where(activity == 0, 0, repeat)
    return activity, repeat


def gaussian_kernel(filter_size=C.ACTIVITY_FILTER_SIZE,
                    sigma=C.ACTIVITY_SIGMA):
    """Normalized Gaussian taps (ActiveRegionEngine.cpp:23-31)."""
    x = np.arange(2 * filter_size + 1, dtype=np.float64) - filter_size
    k = np.exp(-x * x / (2.0 * sigma * sigma)) / (math.sqrt(2 * math.pi) * sigma)
    return k / k.sum()


def smooth_activity(activity, repeat, target_mask=None,
                    filter_size=C.ACTIVITY_FILTER_SIZE,
                    sigma=C.ACTIVITY_SIGMA):
    """Band-pass: each site contributes repeat*value*kernel to +-filter_size
    neighbors (incorporate_status, ActiveRegionEngine.cpp:75-122).

    In WES mode (target_mask given) the smear stops at the first off-target
    position walking out from the site in each direction.
    """
    kernel = gaussian_kernel(filter_size, sigma)
    weighted = activity * repeat
    if target_mask is None:
        return np.convolve(weighted, kernel, mode="same")

    L = activity.shape[0]
    out = np.zeros(L)
    for i in np.nonzero(weighted > 0)[0]:
        w = weighted[i]
        # walk left then right, stopping at off-target positions
        out[i] += w * kernel[filter_size]
        for d in range(1, filter_size + 1):
            j = i - d
            if j < 0 or not target_mask[j]:
                break
            out[j] += w * kernel[filter_size - d]
        for d in range(1, filter_size + 1):
            j = i + d
            if j >= L or not target_mask[j]:
                break
            out[j] += w * kernel[filter_size + d]
    return out


@dataclasses.dataclass
class RawRegion:
    contig: str
    start: int        # 0-based inclusive
    end: int          # 0-based inclusive (reference convention)
    is_active: bool

    @property
    def span(self):
        return self.end - self.start + 1


def _find_best_cut(probs, start, pos, min_size, max_size, track_end):
    """Best local-minimum split for an oversized active run
    (find_best_suite, ActiveRegionEngine.cpp:124-137). `probs` indexed by
    absolute position - track offset handled by caller; here probs is the
    full window array and positions are window-relative."""
    min_p = np.inf
    min_i = max_size - 1
    j = 0
    for i in range(max_size - 1, min_size - 2, -1):
        p = pos - j
        curr = probs[p]
        nxt = probs[p + 1] if p + 1 <= track_end else np.inf
        prv = probs[p - 1] if p - 1 >= 0 else np.inf
        if curr < min_p and p + 1 <= track_end and curr <= nxt and curr < prv:
            min_i = i
            min_p = curr
        j += 1
    return min_i


def cut_regions(probs, contig, window_start, emit_inactive,
                target_mask=None,
                threshold=C.ACTIVE_PROB_THRESHOLD,
                min_size=C.REGION_MIN_SIZE,
                max_size=C.REGION_MAX_SIZE):
    """Threshold + cut the smoothed track into regions
    (pop_active_region, ActiveRegionEngine.cpp:195-260).

    emit_inactive=True (GVCF / force_non_active) also emits inactive runs.
    Returns a list of RawRegion with absolute coordinates.
    """
    L = probs.shape[0]
    is_active = probs > threshold
    track_end = L - 1
    regions = []
    cur_start = None
    cur_active = None
    pos = 0
    while pos < L:
        a = bool(is_active[pos])
        in_target = target_mask is None or target_mask[pos]
        if not in_target:
            if cur_start is not None:
                regions.append(RawRegion(contig, window_start + cur_start,
                                         window_start + pos - 1, cur_active))
                cur_start = None
        elif cur_start is None:
            if emit_inactive or a:
                cur_start, cur_active = pos, a
        elif a != cur_active:
            regions.append(RawRegion(contig, window_start + cur_start,
                                     window_start + pos - 1, cur_active))
            cur_start, cur_active = (pos, a) if emit_inactive or a else (None, None)
        else:
            run = pos - cur_start + 1
            if run >= max_size:
                if cur_active:
                    split = _find_best_cut(probs, cur_start, pos, min_size,
                                           max_size, track_end)
                    split += cur_start
                    if split < pos:
                        regions.append(RawRegion(
                            contig, window_start + cur_start,
                            window_start + split, True))
                        cur_start = split + 1
                    else:
                        regions.append(RawRegion(
                            contig, window_start + cur_start,
                            window_start + pos, True))
                        cur_start = None
                else:
                    regions.append(RawRegion(contig, window_start + cur_start,
                                             window_start + pos, False))
                    cur_start = None
        pos += 1
    if cur_start is not None:
        regions.append(RawRegion(contig, window_start + cur_start,
                                 window_start + L - 1, cur_active))
    return regions


def find_active_regions(reads, ref, contig, start, end, emit_inactive=False,
                        target_mask=None, ploidy=C.SAMPLE_PLOIDY):
    """End-to-end: reads + reference window -> list of RawRegion."""
    L = end - start
    win = ActivityWindow(start=start, end=end,
                         hist=np.zeros((2, L, MAX_QUAL_BIN), dtype=np.int32),
                         hq_sum=np.zeros(L), hq_n=np.zeros(L, dtype=np.int64))
    accumulate_reads(win, reads, ref)
    activity, repeat = compute_activity(win, ploidy)
    probs = smooth_activity(activity, repeat, target_mask)
    return cut_regions(probs, contig, start, emit_inactive, target_mask)
