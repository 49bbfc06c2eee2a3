"""Local assembly driver: region reads -> candidate haplotypes.

Counterpart of the reference's AssembleEngine::local_assemble / hc_apply_main
(reference: src/haplotypecaller/apply/assemble_engine.cpp:14,
assemble/hc_assemble_main.c:27-136, hc_assemble_reads.c:35-124):

1. finalize reads: revert (well-paired) or hard-clip soft clips, hard-clip
   low-quality tails (<=9), clip mate-adaptor overruns, hard-clip to the
   padded region span
2. adjust overlapping mate quals (agreeing bases capped at 20, disagreeing
   zeroed)
3. build read-threading graphs for kmers {10, 25}, retrying +10 up to 6
   times if every size fails
4. prune, check cycles/complexity, convert to a zipped seq graph, K-best
   haplotype search, cigar vs the reference window
"""

import dataclasses

import numpy as np

from .. import constants as C
from ..reads import clipping
from ..reads.cigar import Cigar, CigarOp
from . import cigar_calc
from .graph import MAX_HAPLOTYPES, ReadThreadingGraph, find_k_best_haplotypes

PCR_SNV_ERROR_QUAL = 20   # hc_assemble_utils.c:17
MAX_KMER = (C.ASSEMBLY_KMER_SIZES[-1]
            + C.ASSEMBLY_KMER_STEP * C.ASSEMBLY_MAX_KMER_ITERATIONS)


@dataclasses.dataclass
class Haplotype:
    bases: bytes
    is_ref: bool
    score: float
    cigar: Cigar                  # vs the padded reference window
    window_start: int             # genome pos (0-based) of the window
    kmer_size: int = 0

    @property
    def length(self):
        return len(self.bases)

    def __hash__(self):
        return hash(self.bases)

    def __repr__(self):
        return (f"Hap({'ref' if self.is_ref else 'alt'} len={len(self.bases)}"
                f" cigar={self.cigar} score={self.score:.3f})")


def usable_for_assembly(base, qual):
    """base != N and qual >= 10 (hc_assemble_graph_usable_for_assembly)."""
    return base != ord("N") and qual >= C.MIN_BASE_QUALITY_TO_USE_IN_ASSEMBLY


def sequences_for_assembly(read, kmer_size):
    """Split a read into maximal stretches of usable bases at least
    kmer_size long (hc_assemble_graph_add_read). Vectorized run-finding —
    this is called once per (read, kmer-size) in the assembly hot loop."""
    bases, quals = read.bases, read.quals
    n = len(bases)
    b = np.frombuffer(bases, dtype=np.uint8, count=n)
    q = np.asarray(quals)
    good = (b != ord("N")) & (q >= C.MIN_BASE_QUALITY_TO_USE_IN_ASSEMBLY)
    if good.all():
        return [bases] if n >= kmer_size else []
    d = np.diff(np.concatenate(([0], good.view(np.int8), [0])))
    starts = np.nonzero(d == 1)[0]
    ends = np.nonzero(d == -1)[0]
    return [bases[s:e] for s, e in zip(starts, ends) if e - s >= kmer_size]


def prepare_region_native(reads, span_start, span_end, ref_window,
                          window_start, packed=None, src_cols=None,
                          lazy_records=False):
    """Fused native finalize + overlap-adjust + assembly (one C call, no
    Python round-trip between stages). Returns (finalized_reads,
    haplotypes) or None when unavailable (caller uses the split path).
    With lazy_records=True finalized_reads is a memoized thunk (see
    prepare_native.prepare_region)."""
    import os
    if (os.environ.get("ROVACA_NO_NATIVE_ASSEMBLY")
            or os.environ.get("ROVACA_NO_NATIVE_FINALIZE")):
        return None
    from ..native import prepare_native
    if not prepare_native.available():
        return None
    if isinstance(ref_window, str):
        ref_window = ref_window.encode()
    out = prepare_native.prepare_region(
        reads, span_start, span_end, ref_window, C.ASSEMBLY_KMER_SIZES,
        C.ASSEMBLY_KMER_STEP, C.ASSEMBLY_MAX_KMER_ITERATIONS,
        packed=packed, src_cols=src_cols, lazy_records=lazy_records)
    if out is None:
        return None
    fin, results = out
    ref_hap = Haplotype(bases=ref_window, is_ref=True, score=0.0,
                        cigar=Cigar([(0, len(ref_window))]),
                        window_start=window_start)
    return fin, _finish_region_haplotypes(results, ref_hap, ref_window,
                                          window_start)


def finalize_and_adjust(reads, span_start, span_end):
    """finalize_region_reads + adjust_overlapping_pair_quals, through the
    native finalizer when available (tests assert record-level identity)."""
    import os
    if not os.environ.get("ROVACA_NO_NATIVE_FINALIZE"):
        from ..native import finalize_native
        if finalize_native.available():
            fin = finalize_native.finalize_region(reads, span_start,
                                                  span_end)
            if fin is not None:
                return fin
    fin = finalize_region_reads(reads, span_start, span_end)
    adjust_overlapping_pair_quals(fin)
    return fin


def finalize_region_reads(reads, span_start, span_end):
    """Clip reads for assembly (hc_assemble_finalize_region) and sort by
    coordinate. Returns new ReadRecord list."""
    out = []
    for read in reads:
        if _has_well_defined_fragment(read):
            # well-defined fragment: reuse soft-clipped bases as evidence
            r = clipping.revert_soft_clips(read)
        else:
            r = clipping.hard_clip_soft_clips(read)
        if not len(r.bases) or r.cigar.is_empty:
            continue
        r = clipping.clip_low_qual_ends(r)
        if not len(r.bases) or r.cigar.is_empty:
            continue
        if not r.is_unmapped:
            r = clipping.hard_clip_adaptor_sequence(r)
            if not len(r.bases) or r.cigar.is_empty:
                continue
        r = clipping.hard_clip_to_region(r, span_start, span_end)
        if not len(r.bases) or r.cigar.is_empty:
            continue
        if r is read:
            # the reference copies every read into the region's BamDataPool
            # (RegionManager.cpp:11-108): downstream steps (overlap qual
            # zeroing) mutate quals, which must stay region-local
            r = read.copy()
        out.append(r)
    out.sort(key=lambda r: (r.ref_id, r.pos, r.is_reverse, r.name, r.flag))
    return out


def _has_well_defined_fragment(read):
    """hc_apply_utils_has_well_defined_fragment_size (GATK
    hasWellDefinedFragmentSize) — apply-side +1 convention, see
    clipping.has_well_defined_fragment."""
    return clipping.has_well_defined_fragment(read)


def adjust_overlapping_pair_quals(reads):
    """For overlapping mates: agreeing bases capped at qual 20, disagreeing
    zeroed, in place (hc_assemble_utils_adjust_overlapping_paired_qual)."""
    by_name = {}
    for read in reads:
        mate_start = read.mate_pos
        if (not read.is_paired or (read.flag & 0x8) or mate_start < 0
                or mate_start + 1 > read.end):
            continue
        other = by_name.pop(read.name, None)
        if other is None:
            by_name[read.name] = read
            continue
        _adjust_pair(other, read)


def _adjust_pair(a, b):
    """Mirror hc_assemble_utils_adjust_overlapping_paired_qual
    (hc_assemble_utils.c:308-364): the overlap window is bounded by the
    ALIGNED spans of both reads (soft-start index walk; the comparison
    never runs into trailing soft clips), the second read's own leading
    soft clips offset its start index, and a deletion boundary at the
    overlap start is allowed (only S/H bail)."""
    # reference tie-break: strict <, so equal soft starts make the
    # SECOND argument (the currently iterated read) the "first" read
    first, second = (a, b) if a.unclipped_start < b.unclipped_start \
        else (b, a)
    # first_end/second_end: last aligned reference position, inclusive
    first_end = first.end - 1
    second_end = second.end - 1
    if first_end < second.pos or first.ref_id != second.ref_id:
        return
    off1, op = first.index_at_ref_coord(second.pos)
    if off1 is None or op in (CigarOp.S, CigarOp.H):
        return
    first_end_base, _ = first.index_at_ref_coord(first_end)
    second_end_base, _ = second.index_at_ref_coord(second_end)
    off2, _ = second.index_at_ref_coord(second.pos)
    if first_end_base is None or second_end_base is None or off2 is None:
        return
    n = min(first_end_base - off1, second_end_base - off2) + 1
    # quals can be views over the BAM buffer or the pre-clip read; the
    # records here are region-local (finalize copies), but their arrays
    # may still alias shared storage — always mutate a private copy
    for r in (first, second):
        if not getattr(r, "_quals_private", False):
            r.quals = np.array(r.quals)
            r._quals_private = True
    for i in range(n):
        if first.bases[off1 + i] == second.bases[off2 + i]:
            first.quals[off1 + i] = min(first.quals[off1 + i],
                                        PCR_SNV_ERROR_QUAL)
            second.quals[off2 + i] = min(second.quals[off2 + i],
                                         PCR_SNV_ERROR_QUAL)
        else:
            first.quals[off1 + i] = 0
            second.quals[off2 + i] = 0


def assemble_with_kmer(reads, ref_window, kmer_size,
                       allow_low_complexity=False, first_kbest=True):
    """One ReadThreadingGraph build; returns (paths, ran_kbest) where paths
    is [(seq, score, is_ref)] — possibly empty — or None on build failure
    (hc_assemble_graph_build). ran_kbest reports whether the K-best search
    executed: the reference's dijkstra pre-inserts the ref haplotype on its
    first run per region, shifting the result cap for every later run (see
    find_k_best_haplotypes results_start)."""
    if len(ref_window) < kmer_size:
        return None, False
    g = ReadThreadingGraph(kmer_size)
    if not allow_low_complexity and g.ref_has_non_unique_kmers(ref_window):
        return None, False

    read_seqs = []
    for read in reads:
        read_seqs.extend(sequences_for_assembly(read, kmer_size))
    g.determine_non_unique_kmers([ref_window] + read_seqs)

    g.thread_sequence(ref_window, is_ref=True)
    for seq in read_seqs:
        g.thread_sequence(seq, is_ref=False)

    g.prune_low_weight_chains()
    if g.has_cycle():
        return None, False
    if not allow_low_complexity and g.is_low_quality():
        return None, False
    g.recover_dangling_tails()
    g.recover_dangling_heads()
    g.remove_paths_not_connected_to_ref()
    if g.ref_source is None or g.ref_sink is None:
        return None, False

    sg = g.to_sequence_graph()
    sg.zip_linear_chains()
    sg.remove_singleton_orphans()
    sg.remove_vertices_not_connected_to_ref_undirected()
    sg.simplify()
    # the reference re-identifies the ref source/sink from edge flags and
    # fails the build if either is gone, then simplifies a SECOND time
    # (hc_assemble_read_threading_assembler.c:119-129); the dijkstra stage
    # re-derives them once more (hc_assemble_seq_path_finder.c:47-62)
    sg.rederive_ref_endpoints()
    if sg.ref_source is None or sg.ref_sink is None:
        return None, False
    sg.simplify()
    sg.rederive_ref_endpoints()
    if sg.ref_source is None:
        # find_best_paths returns before dijkstra; the build still counts
        # as a success with zero new haplotypes
        return [], False
    paths = find_k_best_haplotypes(sg,
                                   results_start=1 if first_kbest else 0)
    return paths, True


def assemble_region(reads, ref_window, window_start,
                    kmer_sizes=C.ASSEMBLY_KMER_SIZES):
    """Full assembly for one active region.

    `ref_window` is the padded reference bytes starting at genome pos
    `window_start`. Returns haplotypes (ref haplotype first, then alts sorted
    by sequence), each with a cigar vs ref_window.
    """
    if isinstance(ref_window, str):
        ref_window = ref_window.encode()

    ref_hap = Haplotype(bases=ref_window, is_ref=True, score=0.0,
                        cigar=Cigar([(0, len(ref_window))]),
                        window_start=window_start)

    import os
    if not os.environ.get("ROVACA_NO_NATIVE_ASSEMBLY"):
        from ..native import assemble_native
        if assemble_native.available():
            results = assemble_native.assemble_region_paths(
                reads, ref_window, kmer_sizes, C.ASSEMBLY_KMER_STEP,
                C.ASSEMBLY_MAX_KMER_ITERATIONS)
            if results is not None:
                return _finish_region_haplotypes(results, ref_hap,
                                                 ref_window, window_start)

    results = {}
    any_success = False
    first_kbest = True
    for k in kmer_sizes:
        paths, ran = assemble_with_kmer(reads, ref_window, k,
                                        first_kbest=first_kbest)
        first_kbest &= not ran
        if paths is None:
            continue
        any_success = True
        _merge_paths(results, paths, k)

    if not any_success:
        k = kmer_sizes[-1]
        for _ in range(C.ASSEMBLY_MAX_KMER_ITERATIONS):
            k += C.ASSEMBLY_KMER_STEP
            paths, ran = assemble_with_kmer(
                reads, ref_window, k,
                allow_low_complexity=(k >= MAX_KMER),
                first_kbest=first_kbest)
            first_kbest &= not ran
            if paths is not None:
                _merge_paths(results, paths, k)
                break

    return _finish_region_haplotypes(results, ref_hap, ref_window,
                                     window_start)


def _finish_region_haplotypes(results, ref_hap, ref_window, window_start):
    haplotypes = [ref_hap]
    for seq in sorted(results):
        if seq == ref_window:
            continue
        score, k = results[seq]
        cigar = cigar_calc.calculate_haplotype_cigar(ref_window, seq)
        if cigar is None:
            continue
        haplotypes.append(Haplotype(bases=seq, is_ref=False, score=score,
                                    cigar=cigar, window_start=window_start,
                                    kmer_size=k))
    # no final cap: the reference's 128-limit lives inside the per-kmer
    # K-best search (collect <=129, hc_assemble_dijkstra_shortest_path.c:53);
    # the cross-kmer merged set is emitted whole (fake_assembler output
    # shows 130-hap regions) — verified by the golden assembly diff
    return haplotypes


def _merge_paths(results, paths, kmer_size):
    """First occurrence wins across kmer sizes — the reference's cross-call
    result list dedupes by sequence and keeps the existing entry
    (hc_assemble_dijkstra_reset_ref, :119-147; only an all-ref-edge path
    overrides the stored score, which never changes emitted haplotypes)."""
    for seq, score, _is_ref in paths:
        if seq not in results:
            results[seq] = (score, kmer_size)
