"""GVCF reference-confidence model.

Counterpart of the reference's ReferenceConfidenceModel (reference:
src/haplotypecaller/genotype/reference_confidence_model.cpp:44-300): per
non-variant position, genotype likelihoods of ref-vs-any from the base-qual
pileup (quals > 6), plus an indel-informativeness model (reads with no
plausible indel of size <= 10 contribute qual-45 ref evidence); the
less-confident of the SNP and indel GLs is emitted.

The indel-informativeness algorithm reproduces the reference bit-for-bit
(read_has_no_plausible_ideals_of_size, reference_confidence_model.cpp:
244-392): per read, one-to-one gapped arrays (deletions filled with '-',
insertions removed — alignment_utils.cpp:726-788), suffix mismatch-qual
sums against the REGION-BOUNDED reference haplotype for each indel size
1..10 in both directions, then the front-flip with the reference-was-
shorter edge case. The informative bitset is computed once per (read,
flank) at the first queried offset and reused for later positions, exactly
like the reference's per-read cache that is cleared after each
calculate_ref_confidence call.
"""

import math

import numpy as np

from .. import constants as C
from ..genotype.variant import Allele, Genotype, NON_REF, Variant
from ..ops import gatk_math
from ..reads.cigar import CigarOp, CONSUMES_QUERY, CONSUMES_REF
from .activity import genotype_cache

BASE_QUAL_THRESHOLD = 6          # assembly_based_caller_utils.h:20

_MASKED_CACHE = {}


def _masked_genotype_cache(ploidy):
    """genotype_cache with quals <= BASE_QUAL_THRESHOLD rows zeroed."""
    if ploidy not in _MASKED_CACHE:
        c = genotype_cache(ploidy).copy()
        c[:, : BASE_QUAL_THRESHOLD + 1, :] = 0.0
        _MASKED_CACHE[ploidy] = c
    return _MASKED_CACHE[ploidy]
INDEL_QUAL = 45                  # genotype_likelihoods_cache.cpp:34-35
REF_MODEL_DELETION_QUAL = C.REF_MODEL_DELETION_QUAL
MAX_INDEL_SIZE = C.MAX_INDEL_SIZE

GAP_BASE = 45                    # '-', alignment_utils.h:14
GAP_QUAL = 0                     # alignment_utils.h:13
ADAPTOR_SIZE = 100               # s_default_adaptor_size, a_b_c_utils.cpp:27

# nucleotide one-hot mask: N matches everything, non-ACGTN always mismatches
# (reference_confidence_model.cpp:30-43)
_MASK = np.zeros(256, dtype=np.uint8)
_MASK[ord("A")] = 1
_MASK[ord("C")] = 2
_MASK[ord("G")] = 4
_MASK[ord("T")] = 8
_MASK[ord("N")] = 15


def _indel_gl_table(ploidy=2, max_n=C.MAX_N_INDEL_INFORMATIVE_READS):
    """GLs for n indel-informative reads (genotype_likelihoods_cache.cpp)."""
    no_indel = math.log10(1.0 - 10.0 ** (-INDEL_QUAL / 10.0))
    indel = -INDEL_QUAL / 10.0
    table = np.zeros((max_n + 1, ploidy + 1))
    for n in range(1, max_n + 1):
        table[n, 0] = n * no_indel
        for g in range(1, ploidy + 1):
            a = no_indel + math.log10(ploidy - g) if g < ploidy else -np.inf
            b = indel + math.log10(g)
            # quantized Jacobian-table sum, exactly as the reference builds
            # this cache (genotype_likelihoods_cache.cpp:63-66 →
            # math_utils.cpp:280-291)
            s = float(gatk_math.approximate_log10_sum_log10(a, b))
            table[n, g] = n * (s - math.log10(ploidy))
    return table


_INDEL_TABLE = None


def indel_gls(n_informative, ploidy=2):
    global _INDEL_TABLE
    if _INDEL_TABLE is None:
        _INDEL_TABLE = _indel_gl_table(ploidy)
    n = min(n_informative, C.MAX_N_INDEL_INFORMATIVE_READS)
    return _INDEL_TABLE[n]


class PositionObs:
    """Per-position pileup summary over [start, end)."""

    __slots__ = ("hist", "indel_informative", "depth")

    def __init__(self, length):
        # hist[status][pos][qual]: status 0 = non-ref, 1 = ref
        self.hist = np.zeros((2, length, 64), dtype=np.int32)
        self.indel_informative = np.zeros(length, dtype=np.int32)
        self.depth = np.zeros((2, length), dtype=np.int32)


# --------------------------------------------------------------------------
# one-to-one gapped read arrays (get_bases_and_base_qualities_aligned_
# one_to_one, alignment_utils.cpp:726-788)
# --------------------------------------------------------------------------
def one_to_one(read):
    """(gapped_bases, gapped_quals) uint8 arrays.

    No-indel fast path: the raw sequence/quals (soft clips included).
    Indel path: ref-consuming bases copied in place, deletions filled with
    the gap char '-' / qual 0, insertion bases dropped, soft-clip bases
    dropped but still counted in the array LENGTH (the reference leaves the
    tail uninitialized pool memory — we zero-fill deterministically; the
    simulator never emits indel+soft-clip reads so the tail is never read).
    Memoized on the read object."""
    cached = getattr(read, "_one2one_cache", None)
    if cached is not None:
        return cached
    elements = list(read.cigar)
    saw_indel = any(op in (CigarOp.I, CigarOp.D) for op, _ in elements)
    if not saw_indel:
        gb = np.frombuffer(read.bases, dtype=np.uint8)
        gq = np.asarray(read.quals, dtype=np.uint8)
    else:
        glen = sum(n for op, n in elements
                   if op in CONSUMES_REF or op == CigarOp.S)
        gb = np.zeros(glen, dtype=np.uint8)
        gq = np.zeros(glen, dtype=np.uint8)
        raw_b = np.frombuffer(read.bases, dtype=np.uint8)
        raw_q = np.asarray(read.quals, dtype=np.uint8)
        lit = pad = 0
        for op, n in elements:
            if op in CONSUMES_QUERY:
                if op in CONSUMES_REF:
                    gb[pad:pad + n] = raw_b[lit:lit + n]
                    gq[pad:pad + n] = raw_q[lit:lit + n]
                    pad += n
                lit += n            # I and S bases are skipped
            elif op in CONSUMES_REF:
                gb[pad:pad + n] = GAP_BASE
                gq[pad:pad + n] = GAP_QUAL
                pad += n
    out = (gb, gq)
    try:
        read._one2one_cache = out
    except AttributeError:
        pass
    return out


def _suffix_sum(arr):
    return arr[::-1].cumsum()[::-1]


def informative_set(read, read_start, ref_bytes, ref_start):
    """GATK-exact indel-informativeness bitset for one read, computed at the
    first queried (read_start, ref_start) against the region-bounded
    reference (read_has_no_plausible_ideals_of_size). Index space: gapped
    (cigar-modified) offsets; array length: the RAW read length — gapped
    offsets beyond it read False (the reference's bitset is sized by
    seq_length and test() is bounds-guarded)."""
    raw_len = len(read.bases)
    K = MAX_INDEL_SIZE
    ref_len = len(ref_bytes)
    if raw_len - read_start < K or ref_len - ref_start < K:
        return np.zeros(raw_len, dtype=bool)
    secondary = raw_len - K
    gb, gq = one_to_one(read)
    glen = len(gb)
    if glen - read_start <= K:
        return np.zeros(raw_len, dtype=bool)

    if glen < ref_len - ref_start + read_start + 1:
        last_rel = glen - K
        ref_shorter = False
    else:
        last_rel = ref_len - ref_start + read_start - K + 1
        ref_shorter = True

    n = min(glen - read_start, ref_len - ref_start)
    gqi = gq.astype(np.int64)
    mrow = _MASK[gb]

    def mism_quals(r_lo, f_lo, m):
        """mismatch-qual array over m aligned positions starting at gapped
        r_lo vs ref f_lo (mask match, gap char never mismatches)."""
        rm = mrow[r_lo:r_lo + m]
        fm = _MASK[np.asarray(ref_bytes[f_lo:f_lo + m], dtype=np.uint8)]
        bad = ((rm & fm) == 0) & (gb[r_lo:r_lo + m] != GAP_BASE)
        return np.where(bad, gqi[r_lo:r_lo + m], 0)

    baseline = _suffix_sum(mism_quals(read_start, ref_start, n))

    marked = np.zeros(glen, dtype=bool)
    sites_all = np.arange(glen - read_start)
    abs_all = read_start + sites_all
    site_ok_base = ((gb[read_start:] != GAP_BASE)
                    & (abs_all < last_rel) & (abs_all <= secondary))
    for size in range(1, K + 1):
        # deletion of `size` ref bases: compare (rs+j) vs (fs+j+size)
        nb = min(glen - read_start, ref_len - ref_start - size)
        if nb > 0:
            s = _suffix_sum(mism_quals(read_start, ref_start + size, nb))
            ok = (baseline[:nb] >= s) & site_ok_base[:nb]
            marked[read_start:read_start + nb][ok] = True
        # insertion of `size` read bases: compare (rs+j+size) vs (fs+j)
        nb = min(glen - read_start - size, ref_len - ref_start)
        if nb > 0:
            s = _suffix_sum(mism_quals(read_start + size, ref_start, nb))
            ok = (baseline[:nb] >= s) & site_ok_base[:nb]
            marked[read_start:read_start + nb][ok] = True

    # flip the front: marks so far said "plausible indel found" (i.e.
    # uninformative); the bitset semantics are informative=True
    if last_rel <= secondary:
        marked[:last_rel] = ~marked[:last_rel]
        if ref_shorter and last_rel >= 1:
            marked[last_rel - 1] = False
    else:
        hi = min(secondary + 1, glen)
        marked[:hi] = ~marked[:hi]

    if glen >= raw_len:
        return marked[:raw_len]
    out = np.zeros(raw_len, dtype=bool)
    out[:glen] = marked
    return out


# --------------------------------------------------------------------------
# per-read pileup layout
# --------------------------------------------------------------------------
def _pileup_layout(read):
    """Arrays over the read's ref-consuming positions, in genomic order:
    (pos, gapped_off, query_off, is_del, skip) where gapped_off is the
    cigar-modified offset (ref-consuming + soft clips,
    get_cigar_modified_offset) and skip = is_del | before_del_start |
    before_insertion (calc_nreads_with_no_plausible_indels_reads).
    Memoized on the read."""
    cached = getattr(read, "_pileup_layout_cache", None)
    if cached is not None:
        return cached
    items = list(read.cigar)
    pos_l, goff_l, qoff_l, del_l, skip_l = [], [], [], [], []
    pos, q, g = read.pos, 0, 0
    for idx, (op, length) in enumerate(items):
        in_q = op in CONSUMES_QUERY
        in_r = op in CONSUMES_REF
        if in_r:
            pos_l.append(np.arange(pos, pos + length))
            goff_l.append(np.arange(g, g + length))
            qoff_l.append(np.arange(q, q + length) if in_q
                          else np.full(length, q))
            is_del = not in_q
            del_l.append(np.full(length, is_del))
            sk = np.full(length, is_del)
            # last base of the element: before-deletion-start looks at the
            # next ON-GENOME element; before-insertion at the immediate next
            if not is_del:
                for op2, len2 in items[idx + 1:]:
                    if len2 and op2 in CONSUMES_REF:
                        if op2 in (CigarOp.D, CigarOp.N):
                            sk[-1] = True
                        break
            if idx + 1 < len(items) and items[idx + 1][0] == CigarOp.I \
                    and items[idx + 1][1]:
                sk[-1] = True
            skip_l.append(sk)
            pos += length
            g += length
            if in_q:
                q += length
        elif in_q:
            if op == CigarOp.S:
                g += length
            q += length
    cat = (lambda parts, dt: np.concatenate(parts)
           if parts else np.empty(0, dtype=dt))
    out = (cat(pos_l, np.int64), cat(goff_l, np.int64),
           cat(qoff_l, np.int64), cat(del_l, bool), cat(skip_l, bool))
    try:
        read._pileup_layout_cache = out
    except AttributeError:
        pass
    return out


def _adaptor_exclusion(read, pos):
    """Boolean mask of positions excluded as adaptor read-through
    (dont_include_read_in_pileup, assembly_based_caller_utils.cpp:256-264;
    boundary: read_record.cpp:320-345)."""
    isize = read.insert_size
    if isize > ADAPTOR_SIZE:
        return None
    # has_well_defined_fragment_size
    if (isize == 0 or not read.is_paired or read.is_unmapped
            or read.mate_is_unmapped
            or read.is_reverse == read.mate_is_reverse):
        return None
    if read.is_reverse:
        # get_stop() is inclusive; our .end is exclusive
        if not read.end - 1 > read.mate_pos:
            return None
        boundary = read.mate_pos - 1
        return pos <= boundary
    else:
        if not read.pos <= read.mate_pos + isize:
            return None
        boundary = read.pos + abs(isize)
        return pos >= boundary


def build_position_obs(reads, padded_ref, padded_start, start, end):
    """Pileup histograms + indel informativeness over flank [start, end),
    bounded by the padded-region reference slice `padded_ref` (the
    informativeness reference haplotype — get_pileups_over_reference +
    calc_nreads_with_no_plausible_indels_reads)."""
    L = end - start
    obs = PositionObs(L)
    padded_ref = np.asarray(padded_ref, dtype=np.uint8)

    import os
    if not os.environ.get("ROVACA_NO_NATIVE_POSOBS"):
        from ..native import posobs_native
        if posobs_native.available():
            posobs_native.build_position_obs(obs, reads, padded_ref,
                                             padded_start, start, end)
            return obs

    flat_hist = []   # (status*L + off)*64 + qual entries, across reads
    info_offs = []   # flank offsets receiving an informative count
    for read in reads:
        pos, goff, qoff, is_del, skip = _pileup_layout(read)
        if pos.size == 0:
            continue
        inb = (pos >= start) & (pos < end)
        excl = _adaptor_exclusion(read, pos)
        if excl is not None:
            inb &= ~excl
        if not inb.any():
            continue
        off = pos - start

        # histogram: deletions at qual 30 / non-ref; matches vs padded ref
        d = inb & is_del
        if d.any():
            flat_hist.append((0 * np.int64(L) + off[d]) * 64
                             + REF_MODEL_DELETION_QUAL)
        m = inb & ~is_del
        if m.any():
            quals = np.asarray(read.quals, dtype=np.uint8)[qoff[m]]
            bases = np.frombuffer(read.bases, dtype=np.uint8)[qoff[m]]
            refb = padded_ref[pos[m] - padded_start]
            keep = quals > BASE_QUAL_THRESHOLD
            status = (bases == refb).astype(np.int64)
            bq = np.minimum(quals, 63).astype(np.int64)
            sel = np.nonzero(keep)[0]
            if sel.size:
                flat_hist.append(
                    (status[sel] * np.int64(L) + off[m][sel]) * 64 + bq[sel])

        # indel informativeness: first non-skipped covered position seeds
        # the per-read set; later positions reuse it
        q = inb & ~skip
        if q.any():
            first = int(np.argmax(q))
            info = informative_set(read, int(goff[first]), padded_ref,
                                   int(pos[first]) - padded_start)
            valid = q & (goff < len(info))
            if valid.any():
                take = info[goff[valid]]
                info_offs.append(off[valid][take])

    if flat_hist:
        flat = np.concatenate(flat_hist)
        hist = np.bincount(flat, minlength=2 * L * 64).astype(
            np.int32).reshape(2, L, 64)
        obs.hist += hist
        obs.depth += hist.sum(axis=2, dtype=np.int32)
    if info_offs:
        flat = np.concatenate(info_offs)
        obs.indel_informative += np.bincount(flat, minlength=L).astype(
            np.int32)
    return obs


class HomRefSpan:
    """A contiguous run of hom-ref positions as arrays (no per-position
    Variant objects — the block combiner consumes runs directly; materialize
    via expand() only for debugging). Fields are per-position arrays over
    [start, start+len)."""

    __slots__ = ("contig", "start", "pls", "gq", "dp", "ref_bytes",
                 "sample", "ploidy")

    def __init__(self, contig, start, pls, gq, dp, ref_bytes, sample,
                 ploidy=2):
        self.contig = contig
        self.start = start
        self.pls = pls
        self.gq = gq
        self.dp = dp
        self.ref_bytes = ref_bytes
        self.sample = sample
        self.ploidy = ploidy

    def __len__(self):
        return len(self.gq)

    def clip(self, lo, hi):
        """Sub-span intersecting genomic [lo, hi); None if empty."""
        s = max(self.start, lo) - self.start
        e = min(self.start + len(self), hi) - self.start
        if e <= s:
            return None
        if s == 0 and e == len(self):
            return self
        return HomRefSpan(self.contig, self.start + s, self.pls[s:e],
                          self.gq[s:e], self.dp[s:e], self.ref_bytes[s:e],
                          self.sample, self.ploidy)

    def expand(self):
        """Per-position hom-ref Variants (debug / non-combiner sinks)."""
        out = []
        for i in range(len(self)):
            ref_allele = Allele(bytes([int(self.ref_bytes[i])]), is_ref=True)
            g = Genotype(alleles=[ref_allele] * self.ploidy,
                         pl=self.pls[i].tolist(), gq=int(self.gq[i]),
                         dp=int(self.dp[i]), sample=self.sample)
            out.append(Variant(contig=self.contig, start=self.start + i,
                               stop=self.start + i,
                               alleles=[ref_allele, NON_REF], genotypes=[g]))
        return out


def reference_confidence_records(obs, ref, contig, start, calls_by_pos,
                                 ploidy=2, sample="SAMPLE"):
    """Per-position hom-ref VCs (or the overlapping real call)
    (calculate_ref_confidence). The GL math is batched over all positions;
    the loop only builds output objects."""
    cache = _masked_genotype_cache(ploidy)
    L = obs.hist.shape[1]

    # quals <= BASE_QUAL_THRESHOLD excluded by zeroing the CACHE rows
    # instead of a float64 histogram copy — bit-identical (0-valued
    # partial products in the same positions) and avoids materializing
    # the (2, L, 64) float array per region (same trick as
    # activity._masked_genotype_cache)
    from ..native import activity_native
    ng = activity_native.pileup_gls(obs.hist, cache, BASE_QUAL_THRESHOLD,
                                    ploidy)
    if ng is not None:
        gl, icounts = ng
        counts = icounts.astype(np.float64)
    else:
        counts = obs.hist[:, :, BASE_QUAL_THRESHOLD + 1:].sum(
            axis=(0, 2), dtype=np.int64).astype(np.float64)   # (L,)
        # note cache status 0 = variant evidence == our hist status 0 ✓
        gl = np.einsum("spq,sqg->pg", obs.hist, cache)  # (L, G)
        gl -= counts[:, None] * math.log10(ploidy)
    # cap alt GLs by hom-ref GL (get_genotype_likelihoods_capped_...)
    snp_gls = np.minimum(gl, gl[:, 0:1])
    snp_gls[:, 0] = gl[:, 0]
    indel_gls(0, ploidy)  # ensure table
    ind_gls = _INDEL_TABLE[
        np.minimum(obs.indel_informative, C.MAX_N_INDEL_INFORMATIVE_READS)]

    # std::round = half away from zero; values are >= 0 here so floor(x+.5)
    # (gls_to_pls, genotype_likelihoods.cpp:71-79)
    snp_pls = np.floor(0.5 + -10.0 * (
        snp_gls - snp_gls.max(axis=1, keepdims=True))).astype(int)
    ind_pls = np.floor(0.5 + -10.0 * (
        ind_gls - ind_gls.max(axis=1, keepdims=True))).astype(int)

    # the less-confident model wins, compared on RAW double GLs:
    # gq_log10 = -(GL[0] - max others); pick indel iff strictly worse,
    # ties -> snp (get_gl_with_worst_gq, reference_confidence_model.cpp:394)
    snp_conf = snp_gls[:, 0] - np.max(snp_gls[:, 1:], axis=1)
    ind_conf = ind_gls[:, 0] - np.max(ind_gls[:, 1:], axis=1)
    use_snp = snp_conf <= ind_conf
    pls_all = np.where(use_snp[:, None], snp_pls, ind_pls)

    def gq_rows(pls):
        """second-smallest minus smallest, uncapped per site
        (calculate_gq_from_pls; the 99 cap applies only at band selection
        and emission)."""
        s = np.partition(pls, 1, axis=1)
        return s[:, 1] - s[:, 0]

    gq_all = gq_rows(pls_all)
    # DP counts only histogram entries with qual > BASE_QUAL_THRESHOLD —
    # ref_depth/non_ref_depth increment inside the qual loop that starts at
    # threshold+1 (reference_confidence_model.cpp:121-140)
    dp_all = counts.astype(np.int64)

    if isinstance(ref, np.ndarray):
        ref_bytes_all = ref
    else:
        ref_bytes_all = None  # indexable (bytes / RefWindow) — slice lazily

    def span_ref_bytes(p0, p1):
        if ref_bytes_all is not None:
            return np.asarray(ref_bytes_all[start + p0:start + p1],
                              dtype=np.uint8)
        return np.frombuffer(
            bytes(ref[start + p0:start + p1]), dtype=np.uint8)

    out = []

    def hom_ref_span(run_start, end_pos):
        return HomRefSpan(
            contig=contig, start=start + run_start,
            pls=pls_all[run_start:end_pos],
            gq=gq_all[run_start:end_pos],
            dp=dp_all[run_start:end_pos],
            ref_bytes=span_ref_bytes(run_start, end_pos),
            sample=sample, ploidy=ploidy)

    # the reference walks EVERY pileup position and splices a call in at
    # its start; positions inside the call's ref span still get hom-ref
    # records (suppressed downstream by the combiner's next-available
    # horizon) — two overlapping events both emit (calculate_ref_
    # confidence, reference_confidence_model.cpp:62-72; suppression:
    # block_combiner.cpp:147-156). Walking only the call positions and
    # emitting the hom-ref stretches between them yields the identical
    # record sequence without a per-position Python loop.
    prev = 0
    for gpos in sorted(calls_by_pos) if calls_by_pos else ():
        p = gpos - start
        if p < 0 or p >= L:
            continue
        if p > prev:
            out.append(hom_ref_span(prev, p))
        out.append(calls_by_pos[gpos])
        prev = p + 1
    if prev < L:
        out.append(hom_ref_span(prev, L))
    return out


def _filter_non_passing(reads, mapping_quality_threshold):
    """filter_non_passing_reads2 (adapter_utils.cpp:240-251): unclipped
    length, mapping quality, mate contig."""
    out = []
    for r in reads:
        mate_ok = (not r.is_paired or r.mate_is_unmapped
                   or (not r.is_unmapped and r.ref_id == r.mate_ref_id))
        if (r.unclipped_length >= C.MIN_READ_LENGTH_AFTER_TRIMMING
                and r.mapping_quality >= mapping_quality_threshold
                and mate_ok):
            out.append(r)
    return out


def reference_model_for_no_variation(region, reads, ref, contig,
                                     padded_span=None,
                                     mapping_quality_threshold=20,
                                     sample="SAMPLE"):
    """Hom-ref records for a whole non-variant region
    (GermlineGenotyingEngine::reference_model_for_no_variation): pileups
    over the ACTIVE span, informativeness bounded by the PADDED span."""
    if padded_span is None:
        padded_span = (region.start, region.end)
    p0, p1 = padded_span
    padded_ref = np.frombuffer(bytes(ref[p0:p1 + 1]), dtype=np.uint8)

    from ..native.finalize_native import PackedFinalized
    if isinstance(reads, PackedFinalized):
        # packed fast path (inactive regions): finalize arrays flow into
        # the native accumulator without ReadRecord materialization
        from ..native import posobs_native
        obs = PositionObs(region.end + 1 - region.start)
        posobs_native.build_position_obs_filtered(
            obs, reads, mapping_quality_threshold,
            padded_ref, p0, region.start, region.end + 1)
        return reference_confidence_records(obs, ref, contig, region.start,
                                            {}, sample=sample)

    usable = _filter_non_passing(reads, mapping_quality_threshold)
    obs = build_position_obs(usable, padded_ref, p0,
                             region.start, region.end + 1)
    return reference_confidence_records(obs, ref, contig, region.start, {},
                                        sample=sample)


def calculate_ref_confidence_with_calls(region, reads, ref, contig, calls,
                                        genotype_reads, variant_span,
                                        variant_padded_span=None,
                                        padded_span=None,
                                        mapping_quality_threshold=20,
                                        sample="SAMPLE",
                                        region_padding=C.REGION_PADDING,
                                        contig_length=None):
    """Variant region in GVCF mode (call_non_active_site,
    germline_genotying_engine.cpp:185-228): left flank + variant middle +
    right flank, each with its own read set and reference bound.

    - left/right flanks: `reads` (the finalized region reads) hard-clipped
      to the padded flank (flank expanded by the assembly-region padding,
      intersected with the region's padded span —
      adapter_utils.cpp:64-90), pileups over the flank's active span;
    - middle: `genotype_reads` (realigned PairHMM survivors) over the
      variant span, bounded by the trimmed variant PADDED span, with real
      calls spliced in at their start positions.
    """
    from .trimming import trim_reads

    if padded_span is None:
        padded_span = (region.start, region.end)
    if contig_length is None:
        contig_length = 1 << 60
    pad0, pad1 = padded_span
    var0, var1 = variant_span
    if variant_padded_span is None:
        variant_padded_span = (max(pad0, var0 - region_padding),
                               min(pad1, var1 + region_padding))
    calls_by_pos = {c.start: c for c in calls}
    out = []

    def flank(active0, active1):
        f_pad0 = max(max(0, active0 - region_padding), pad0)
        f_pad1 = min(min(contig_length - 1, active1 + region_padding), pad1)
        clipped = trim_reads(reads, f_pad0, f_pad1, min_length=1)
        usable = _filter_non_passing(clipped, mapping_quality_threshold)
        padded_ref = np.frombuffer(bytes(ref[f_pad0:f_pad1 + 1]),
                                   dtype=np.uint8)
        obs = build_position_obs(usable, padded_ref, f_pad0,
                                 active0, active1 + 1)
        return reference_confidence_records(obs, ref, contig, active0, {},
                                            sample=sample)

    # left flank: [region.start, var0 - 1]
    if region.start < var0:
        out.extend(flank(region.start, var0 - 1))

    # middle: variant span with calls spliced in, over genotype reads
    vp0, vp1 = variant_padded_span
    padded_ref = np.frombuffer(bytes(ref[vp0:vp1 + 1]), dtype=np.uint8)
    obs = build_position_obs(list(genotype_reads), padded_ref, vp0,
                             var0, var1 + 1)
    out.extend(reference_confidence_records(obs, ref, contig, var0,
                                            calls_by_pos, sample=sample))

    # right flank: [var1 + 1, region.end]
    if var1 < region.end:
        out.extend(flank(var1 + 1, region.end))
    return out
