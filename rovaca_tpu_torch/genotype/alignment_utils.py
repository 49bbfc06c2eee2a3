"""Read-to-reference realignment through the best haplotype.

Counterpart of the reference's realign_reads_to_their_best_haplotype +
AlignmentUtils cigar composition (reference: src/haplotypecaller/genotype/
utils/assembly_based_caller_utils.cpp:146, alignment_utils.cpp): each read is
SW-aligned to its best-supported haplotype (ties favor the reference
haplotype), and its alignment is projected through the haplotype's own
alignment into reference coordinates, giving final cigars/positions for
annotations and output.

Counterpart of rovaca_tpu/genotype/alignment_utils.py, whose cigar
composition (``hap_to_ref_map``, ``left_align_indels``,
``realign_read_to_haplotype``) is carried over unchanged. The SW batch of
``realign_reads_to_their_best_haplotype`` runs through the port's banded
kernel when ``use_banded_sw()`` says so, on the device it is given, or else
on the native SW batch. The banded module (and with it torch) is imported
only when the gate is on, so a host-only caller imports no torch.
"""

import os

import numpy as np

from ..assembly.sw import (READ_TO_HAPLOTYPE_PARAMS, OverhangStrategy,
                           SWResult, sw_align)
from ..native import sw_native
from ..reads.cigar import Cigar, CigarOp, CONSUMES_QUERY, CONSUMES_REF
from .likelihoods import INFORMATIVE_THRESHOLD


def hap_to_ref_map(hap):
    """hap base index -> ref genome pos (int64 array; -1 for inserted
    bases, the realign composer's "no reference position" sentinel)."""
    parts = []
    ref_pos = hap.window_start
    for op, length in hap.cigar:
        in_q = op in CONSUMES_QUERY
        in_r = op in CONSUMES_REF
        if in_q and in_r:
            parts.append(np.arange(ref_pos, ref_pos + length,
                                   dtype=np.int64))
            ref_pos += length
        elif in_q:
            parts.append(np.full(length, -1, dtype=np.int64))
        elif in_r:
            ref_pos += length
    return (np.concatenate(parts) if parts
            else np.empty(0, dtype=np.int64))


def _normalize_alleles(seqs, bounds, max_shift, trim):
    """Port of AlignmentUtils::normalize_alleles
    (alignment_utils.cpp:376-413). `bounds` are mutable [start, end) pairs,
    one per sequence; returns (start_shift, end_shift)."""
    def _same(offsets):
        vals = []
        for seq, idx in zip(seqs, offsets):
            if idx < 0:
                return False
            vals.append(seq[idx])
        return all(v == vals[0] for v in vals)

    def last_right_same():
        return _same([b[1] - 1 for b in bounds])

    def first_left_same():
        return _same([b[0] for b in bounds])

    def next_left_same():
        return _same([b[0] - 1 for b in bounds])

    start_shift = end_shift = 0
    min_size = min(b[1] - b[0] for b in bounds)
    while trim and min_size > 0 and last_right_same():
        for b in bounds:
            b[1] -= 1
        min_size -= 1
        end_shift += 1
    while trim and min_size > 0 and first_left_same():
        for b in bounds:
            b[0] += 1
        min_size -= 1
        start_shift -= 1
    while start_shift < max_shift and next_left_same() and last_right_same():
        for b in bounds:
            b[0] -= 1
            b[1] -= 1
        start_shift += 1
        end_shift += 1
    return start_shift, end_shift


_ALIGN_OPS = (CigarOp.M, CigarOp.EQ, CigarOp.X)


def left_align_indels(elems, ref_bases, read_bases, read_start):
    """Port of AlignmentUtils::left_align_indels
    (alignment_utils.cpp:415-526): shift indels of a clip-free read-to-ref
    cigar leftmost, trimming shared flanks into matches. `ref_bases` is the
    reference-haplotype sequence, `read_start` the read's start index on
    it. Returns (elements, leading_deletion_bases_removed)."""
    elems = list(elems)
    if not any(op in (CigarOp.I, CigarOp.D) for op, _ in elems):
        return elems, 0

    ref_len = sum(n for op, n in elems if op in CONSUMES_REF)
    ref_range = [read_start + ref_len, read_start + ref_len]
    read_range = [len(read_bases), len(read_bases)]
    bounds = [ref_range, read_range]
    seqs = (ref_bases, read_bases)
    rtl = []  # (op, len) right-to-left

    for n_idx in range(len(elems) - 1, -1, -1):
        op, length = elems[n_idx]
        on_ref = length if op in CONSUMES_REF else 0
        on_read = length if op in CONSUMES_QUERY else 0
        if op in (CigarOp.I, CigarOp.D):
            ref_range[0] -= on_ref
            read_range[0] -= on_read
        elif (ref_range[1] - ref_range[0] == 0
              and read_range[1] - read_range[0] == 0):
            rtl.append((op, length))
            ref_range[0] -= on_ref
            ref_range[1] -= on_ref
            read_range[0] -= on_read
            read_range[1] -= on_read
        else:
            max_shift = length if op in _ALIGN_OPS else 0
            ss, es = _normalize_alleles(seqs, bounds, max_shift, True)
            rtl.append((CigarOp.M, es))
            emit_indel = (n_idx == 0 or ss < max_shift
                          or op not in _ALIGN_OPS)
            new_match_left = -ss if ss < 0 else 0
            remaining_left = length if ss < 0 else length - ss
            if emit_indel:
                rtl.append((CigarOp.D, ref_range[1] - ref_range[0]))
                rtl.append((CigarOp.I, read_range[1] - read_range[0]))
                ref_range[1] = ref_range[0]
                read_range[1] = read_range[0]
                dref = new_match_left + (remaining_left
                                         if op in CONSUMES_REF else 0)
                dread = new_match_left + (remaining_left
                                          if op in CONSUMES_QUERY else 0)
                ref_range[0] -= dref
                ref_range[1] -= dref
                read_range[0] -= dread
                read_range[1] -= dread
            rtl.append((CigarOp.M, new_match_left))
            rtl.append((op, remaining_left))

    rtl.append((CigarOp.D, ref_range[1] - ref_range[0]))
    rtl.append((CigarOp.I, read_range[1] - read_range[0]))

    # CigarBuilder make_and_record_deletions_removed: drop zero-length,
    # merge adjacent, strip leading/trailing deletions (count leading)
    merged = []
    for op, length in reversed(rtl):
        if length == 0:
            continue
        if merged and merged[-1][0] == op:
            merged[-1][1] += length
        else:
            merged.append([op, length])
    leading_del = 0
    while merged and merged[0][0] == CigarOp.D:
        leading_del += merged[0][1]
        merged.pop(0)
    while merged and merged[-1][0] == CigarOp.D:
        merged.pop()
    return [(op, length) for op, length in merged], leading_del


def realign_read_to_haplotype(read, hap, h2r=None, sw_result=None,
                              ref_hap=None):
    """New ReadRecord aligned to the reference through `hap`, or the
    original read if the SW alignment is unusable
    (AlignmentUtils::create_read_aligned_to_ref,
    alignment_utils.cpp:563-658): compose read->hap->ref, left-align
    indels against the reference haplotype, reattach clips."""
    if h2r is None:
        h2r = hap_to_ref_map(hap)
    if sw_result is not None:
        res = sw_result
    else:
        try:
            res = sw_align(hap.bases, read.bases, READ_TO_HAPLOTYPE_PARAMS,
                           OverhangStrategy.SOFTCLIP)
        except ValueError:
            return read
    if res.alignment_offset < 0:
        return read

    # fast path: exact all-M placement on the (all-M) reference haplotype.
    # The full compose provably reduces to pos = window_start + offset with
    # an n-M cigar: h2r is the identity, no gaps/clips exist, start_rel
    # equals the SW offset for a single-M hap cigar, and left-aligning an
    # indel-free cigar is a no-op.
    n_read = len(read.bases)
    res_el = res.cigar.elements
    if (getattr(hap, "is_ref", False)
            and len(res_el) == 1 and res_el[0][0] == CigarOp.M
            and res_el[0][1] == n_read
            and len(hap.cigar.elements) == 1
            and hap.cigar.elements[0][0] == CigarOp.M
            and getattr(hap, "window_start", None) is not None):
        return read.copy(pos=hap.window_start + res.alignment_offset,
                         cigar=Cigar([(CigarOp.M, n_read)]))

    # read base -> hap base index; SW soft clips (read overhangs the hap)
    # stay soft clips, hap-inserted bases become insertions.  Built as
    # per-base arrays (hap index, or -1 with a clip flag), then composed
    # through h2r run-wise — same elements the per-base loop produced,
    # one list entry per run instead of per base.
    n_read = len(read.bases)
    hap_idx = np.empty(n_read, dtype=np.int64)
    sw_clip = np.zeros(n_read, dtype=bool)
    q = 0
    h = res.alignment_offset
    for op, length in res.cigar:
        if op in (CigarOp.M, CigarOp.EQ, CigarOp.X):
            if q + length > n_read:
                return read
            hap_idx[q:q + length] = np.arange(h, h + length)
            q += length
            h += length
        elif op in (CigarOp.I, CigarOp.S):
            if q + length > n_read:
                return read
            hap_idx[q:q + length] = -1
            sw_clip[q:q + length] = (op == CigarOp.S)
            q += length
        elif op in (CigarOp.D, CigarOp.N):
            h += length
    if q != n_read:
        return read

    # compose: read base -> ref pos (h2r maps hap base -> ref pos or None)
    n_hap = len(h2r)
    h2r_arr = np.asarray(h2r, dtype=np.int64)
    ref_pos = np.full(n_read, -1, dtype=np.int64)
    inhap = (hap_idx >= 0) & (hap_idx < n_hap)
    ref_pos[inhap] = h2r_arr[hap_idx[inhap]]
    valid = ref_pos >= 0
    vq = np.nonzero(valid)[0]
    if vq.size == 0:
        return read
    # start via read_start_on_reference_haplotype (alignment_utils.cpp:
    # 189-212): count ref bases consumed by the hap->ref cigar BEFORE the
    # element containing the SW offset, with a <=-boundary rule. When the
    # offset lands exactly on an M|D boundary this lands BEFORE the
    # deletion — the reference's trim + CigarBuilder then silently drop
    # the leading D without compensating the start (trim_cigar,
    # alignment_utils.cpp:242-278 make_and_record_deletions_removed), so
    # such reads sit `dlen` left of their per-base ref positions with a
    # pure-M cigar. Using the first valid base's position instead loses
    # those reads from annotation overlap (round-5 seed-424243 SOR/
    # ReadPosRankSum divergence at chr20:172444).
    start_rel = None
    if res.alignment_offset == 0:
        start_rel = 0
    else:
        hap_consumed = 0
        ref_before = 0
        for op, length in hap.cigar:
            in_r = op in CONSUMES_REF
            if in_r:
                ref_before += length
            if op in CONSUMES_QUERY:
                hap_consumed += length
            if hap_consumed >= res.alignment_offset:
                excess = (hap_consumed - res.alignment_offset) if in_r \
                    else 0
                start_rel = ref_before - excess
                break
    new_pos = (hap.window_start + start_rel if start_rel is not None
               else int(ref_pos[vq[0]]))

    # element runs: split wherever the per-base op changes or a deletion
    # must be injected before a valid base (ref gap vs the previous one)
    opc = np.where(valid, 0, np.where(sw_clip, 2, 1))   # 0=M 1=I 2=S
    vrefs = ref_pos[vq]
    gap_before = np.zeros(n_read, dtype=np.int64)
    if vq.size > 1:
        gaps = vrefs[1:] - vrefs[:-1] - 1
        gap_before[vq[1:][gaps > 0]] = gaps[gaps > 0]
    change = np.nonzero((opc[1:] != opc[:-1])
                        | (gap_before[1:] > 0))[0] + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [n_read]))
    _OPS_MAP = (CigarOp.M, CigarOp.I, CigarOp.S)
    elems = []
    for s, e in zip(starts.tolist(), ends.tolist()):
        g = gap_before[s]
        if g > 0:
            elems.append([CigarOp.D, int(g)])
        elems.append([_OPS_MAP[opc[s]], int(e - s)])
    elems = [[op, length] for op, length in Cigar(elems).normalized()]

    # split off soft clips; left-align the clip-free core against the
    # reference haplotype, then reattach the clips
    lead = []
    while elems and elems[0][0] in (CigarOp.S, CigarOp.H):
        lead.append(tuple(elems.pop(0)))
    trail = []
    while elems and elems[-1][0] in (CigarOp.S, CigarOp.H):
        trail.insert(0, tuple(elems.pop()))
    n_lead = sum(n for op, n in lead if op == CigarOp.S)
    n_trail = sum(n for op, n in trail if op == CigarOp.S)
    core_bases = read.bases[n_lead:len(read.bases) - n_trail]

    if ref_hap is not None and getattr(ref_hap, "window_start", None) \
            is not None:
        read_start = new_pos - ref_hap.window_start
        if 0 <= read_start:
            elems, lead_del = left_align_indels(
                [tuple(e) for e in elems], ref_hap.bases, core_bases,
                read_start)
            new_pos += lead_del

    cigar = Cigar(lead + [tuple(e) for e in elems] + trail).normalized()
    if cigar.query_length != len(read.bases):
        return read
    return read.copy(pos=new_pos, cigar=cigar)


def use_banded_sw():
    """Route realignment SW through the banded kernel? ROVACA_BANDED_REALIGN
    set to anything but 0/false/empty forces it; unset or off, realignment
    stays on the native SW batch (rovaca_tpu's default off a TPU)."""
    env = os.environ.get("ROVACA_BANDED_REALIGN")
    return env is not None and env not in ("0", "false", "")


def _best_haplotype(col, prio):
    """Index of a read's best haplotype: argmax, re-picked among every hap
    within INFORMATIVE_THRESHOLD of the best by priority (is_ref, then the
    simplest cigar) when the best is a near tie."""
    best = 0
    best_lik = col[0]
    second_lik = -np.inf
    for a in range(1, len(col)):
        if col[a] > best_lik:
            second_lik = best_lik
            best = a
            best_lik = col[a]
        elif col[a] > second_lik:
            second_lik = col[a]
    if best_lik - second_lik < INFORMATIVE_THRESHOLD:
        best_priority = prio[best]
        for a in range(len(col)):
            if a == best or best_lik - col[a] > INFORMATIVE_THRESHOLD:
                continue
            if prio[a] > best_priority:
                best = a
                best_priority = prio[a]
    return best


def realign_reads_to_their_best_haplotype(likelihoods, device=None):
    """Replace evidence reads with realigned versions (per-read best
    haplotype, ties to the reference haplotype). Mutates
    ``likelihoods.reads``. With the banded gate on, the reads that are not
    exact substrings of their haplotype go through one banded batch on
    ``device`` (default: the card, resolved only when a batch runs, so it
    raises then without one; "cpu" runs the plain versions). Returns (banded
    batches run, alignments that fell back to the host SW)."""
    haps = likelihoods.alleles
    if not haps:
        return 0, 0
    m = likelihoods.matrix
    ref_idx = next((i for i, h in enumerate(haps)
                    if getattr(h, "is_ref", False)), 0)
    prio = np.array([(1.0 if getattr(h, "is_ref", False) else 0.0)
                     + (1.0 - len(h.cigar.elements)) for h in haps])
    maps = {}
    best_haps = []
    for r in range(len(likelihoods.reads)):
        hap = haps[_best_haplotype(m[:, r], prio)]
        if id(hap) not in maps:
            maps[id(hap)] = hap_to_ref_map(hap)
        best_haps.append(hap)

    batches = fallbacks = 0
    sw_results = [None] * len(likelihoods.reads)
    if sw_native.available():
        batch_idx = []
        pairs = []
        for r, read in enumerate(likelihoods.reads):
            hap = best_haps[r]
            idx = hap.bases.rfind(read.bases)
            if idx != -1:       # exact substring: sw_align's fast path
                sw_results[r] = SWResult(
                    Cigar([(CigarOp.M, len(read.bases))]), idx)
            else:
                batch_idx.append(r)
                pairs.append((hap.bases, read.bases))
        if batch_idx and use_banded_sw():
            from ..ops.sw import sw_align_banded_batch
            # diagonals seeded from the read's offset in its hap's window
            diags = [max(0, likelihoods.reads[r].pos
                         - getattr(best_haps[r], "window_start",
                                   likelihoods.reads[r].pos))
                     for r in batch_idx]
            banded = sw_align_banded_batch(
                pairs, READ_TO_HAPLOTYPE_PARAMS,
                overhang=OverhangStrategy.SOFTCLIP, diagonals=diags,
                device=device)
            batches = 1
            fallbacks = sum(br.fell_back for br in banded)
            for r, br in zip(batch_idx, banded):
                sw_results[r] = br.result
        else:
            for r, res in zip(batch_idx, sw_native.align_batch(
                    pairs, READ_TO_HAPLOTYPE_PARAMS,
                    int(OverhangStrategy.SOFTCLIP))):
                if res is not None:
                    ops, lens, offset = res
                    sw_results[r] = SWResult(Cigar(zip(ops, lens)), offset)

    ref_hap = haps[ref_idx]
    likelihoods.reads = [
        realign_read_to_haplotype(read, best_haps[r],
                                  maps[id(best_haps[r])],
                                  sw_result=sw_results[r], ref_hap=ref_hap)
        for r, read in enumerate(likelihoods.reads)]
    return batches, fallbacks
