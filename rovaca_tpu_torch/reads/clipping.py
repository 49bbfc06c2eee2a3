"""Read clipping operations.

Counterpart of the reference's read_clipper/clipping_op and the assembler's
finalization clips (reference: src/haplotypecaller/genotype/read_clipper.cpp,
apply/hc_assemble_utils.c:219-249, apply/assemble/hc_assemble_reads.c:71-102).

Implementation: reads are exploded into per-query-base events carrying the
aligned reference position (None for insertions/soft clips), sliced, and the
cigar is rebuilt from ref-position gaps — deletions fall out of the gaps, and
edge deletions vanish naturally, matching hard-clip semantics.
"""

import numpy as np

from .cigar import Cigar, CigarOp
from .record import ReadRecord

MIN_TAIL_QUALITY = 9  # reference: apply/assemble/hc_assemble.h:8

# insertion sentinel for the vectorized event arrays (distinct from genuine
# negative reference positions produced by reverted soft clips at pos < 0)
_INS = np.int64(-(1 << 62))
_NEG = np.int64(-(1 << 62)) - 1


def _explode(read):
    """Per-query-base event arrays (ref positions, is_softclip) using
    unclipped coords for soft-clipped bases. Insertions carry _INS."""
    refs = []
    scs = []
    pos = read.pos
    # leading soft clips get positions before read.pos
    first = True
    for op, length in read.cigar:
        if op == CigarOp.H:
            continue
        if op in (CigarOp.M, CigarOp.EQ, CigarOp.X):
            refs.append(np.arange(pos, pos + length, dtype=np.int64))
            scs.append(np.zeros(length, dtype=bool))
            pos += length
            first = False
        elif op == CigarOp.I:
            refs.append(np.full(length, _INS, dtype=np.int64))
            scs.append(np.zeros(length, dtype=bool))
            first = False
        elif op == CigarOp.S:
            if first:
                refs.append(np.arange(pos - length, pos, dtype=np.int64))
            else:
                refs.append(np.arange(pos, pos + length, dtype=np.int64))
                pos += length
            scs.append(np.ones(length, dtype=bool))
            first = False
        elif op in (CigarOp.D, CigarOp.N):
            pos += length
    if not refs:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool))
    return np.concatenate(refs), np.concatenate(scs)


def _rebuild(read, events, keep):
    """New ReadRecord from kept per-base events (indices into bases)."""
    ref_all, sc_all = events
    keep = np.asarray(keep, dtype=np.int64)
    if keep.size == 0:
        return read.copy(bases=b"", quals=np.zeros(0, dtype=np.uint8),
                         cigar=Cigar())
    n_all = ref_all.size
    hard_left = read.hard_left + int(keep[0])
    hard_right = read.hard_right + int(n_all - 1 - keep[-1])
    bases = np.frombuffer(read.bases, dtype=np.uint8)[keep].tobytes()
    quals = np.asarray(read.quals)[keep]
    r = ref_all[keep]
    s = sc_all[keep]
    opc = np.where(s, np.int8(4), np.where(r == _INS, np.int8(1),
                                           np.int8(0)))  # S / I / M
    m = opc == 0
    # D gap before an M base = ref jump vs the previous kept M base
    acc = np.maximum.accumulate(np.where(m, r, _NEG))
    prev = np.concatenate(([_NEG], acc[:-1]))
    gap = np.where(m & (prev != _NEG), r - prev - 1, 0)
    boundary = np.empty(opc.shape, dtype=bool)
    boundary[0] = True
    boundary[1:] = opc[1:] != opc[:-1]
    boundary |= gap > 0
    starts = np.nonzero(boundary)[0]
    ends = np.append(starts[1:], opc.size)
    ops = (CigarOp.M, CigarOp.I, CigarOp.D, CigarOp.N, CigarOp.S)
    elems = []
    for st, en in zip(starts, ends):
        g = int(gap[st])
        if g > 0:
            elems.append((CigarOp.D, g))
        elems.append((ops[opc[st]], int(en - st)))
    # leading insertions before any aligned base anchor at the first ref pos
    new_pos = int(r[m][0]) if m.any() else read.pos
    cigar = Cigar.from_raw(elems).normalized()
    return read.copy(bases=bases, quals=quals, cigar=cigar, pos=new_pos,
                     hard_left=hard_left, hard_right=hard_right)


def _sms_layout(read):
    """(leftS, mlen, rightS) when the cigar is exactly [S] M [S] (no
    H/I/D/N/EQ/X), else None. Such reads cover contiguous unclipped
    positions, so every clip is a plain slice."""
    leftS = mlen = rightS = 0
    state = 0  # 0: expect leading S/M, 1: after M, 2: after trailing S
    for op, length in read.cigar.elements:
        if op == CigarOp.S:
            if state == 0 and leftS == 0 and mlen == 0:
                leftS = length
            elif state == 1 and rightS == 0:
                rightS = length
                state = 2
            else:
                return None
        elif op == CigarOp.M:
            if mlen or state != 0:
                return None
            mlen = length
            state = 1
        else:
            return None
    if mlen == 0:
        return None
    return leftS, mlen, rightS


def _slice_sms(read, lay, lo, hi):
    """read[lo:hi) for an [S]M[S] read; matches _rebuild semantics."""
    n = len(read.bases)
    if hi <= lo:
        return read.copy(bases=b"", quals=np.zeros(0, dtype=np.uint8),
                         cigar=Cigar())
    if lo == 0 and hi == n:
        return read
    leftS, mlen, _rightS = lay
    nS_l = max(0, min(hi, leftS) - lo)
    nM = max(0, min(hi, leftS + mlen) - max(lo, leftS))
    nS_r = max(0, hi - max(lo, leftS + mlen))
    elems = [(op, ln) for op, ln in
             ((CigarOp.S, nS_l), (CigarOp.M, nM), (CigarOp.S, nS_r)) if ln]
    new_pos = read.pos + max(lo, leftS) - leftS if nM else read.pos
    return read.copy(bases=read.bases[lo:hi],
                     quals=np.asarray(read.quals)[lo:hi].copy(),
                     cigar=Cigar.from_raw(elems).normalized(), pos=new_pos,
                     hard_left=read.hard_left + lo,
                     hard_right=read.hard_right + (n - hi))


def revert_soft_clips(read):
    """Turn soft clips back into matches, shifting pos left for leading clips
    (hc_assemble_utils_revert_soft_clip)."""
    if read.cigar.left_soft_clip == 0 and read.cigar.right_soft_clip == 0:
        return read
    elems = []
    pos = read.pos - read.cigar.left_soft_clip
    for op, length in read.cigar:
        if op == CigarOp.H:
            continue
        elems.append((CigarOp.M if op == CigarOp.S else op, length))
    new_pos = max(0, pos)
    if pos < 0:
        # clamp: drop bases hanging off the contig start
        events_read = read.copy(cigar=Cigar(elems).normalized(), pos=pos)
        events = _explode(events_read)
        ref, _ = events
        keep = np.nonzero((ref == _INS) | (ref >= 0))[0]
        return _rebuild(events_read, events, keep)
    del new_pos
    return read.copy(cigar=Cigar(elems).normalized(), pos=pos)


def hard_clip_soft_clips(read):
    """Remove soft-clipped bases entirely (hc_assemble_utils_soft_clip_to_hard)."""
    left = read.cigar.left_soft_clip
    right = read.cigar.right_soft_clip
    if left == 0 and right == 0:
        return read
    n = len(read.bases)
    bases = read.bases[left:n - right]
    quals = read.quals[left:n - right]
    elems = [(op, ln) for op, ln in read.cigar
             if op not in (CigarOp.S, CigarOp.H)]
    return read.copy(bases=bases, quals=quals,
                     cigar=Cigar(elems).normalized(),
                     hard_left=read.hard_left + left,
                     hard_right=read.hard_right + right)


def clip_low_qual_ends(read, threshold=MIN_TAIL_QUALITY):
    """Hard-clip terminal bases with qual <= threshold
    (hc_assemble_utils_clip_low_qual_ends)."""
    n = len(read.bases)
    if n == 0:
        return read
    q = np.asarray(read.quals)
    good = q > threshold
    if not good.any():
        return read.copy(bases=b"", quals=np.zeros(0, dtype=np.uint8),
                         cigar=Cigar())
    clip_start = int(np.argmax(good))
    clip_end = n - 1 - int(np.argmax(good[::-1]))
    if clip_start == 0 and clip_end == n - 1:
        return read
    if clip_end <= clip_start:
        return read.copy(bases=b"", quals=np.zeros(0, dtype=np.uint8),
                         cigar=Cigar())
    lay = _sms_layout(read)
    if lay is not None:
        return _slice_sms(read, lay, clip_start, clip_end + 1)
    events = _explode(read)
    keep = np.arange(clip_start, clip_end + 1)
    return _rebuild(read, events, keep)


def hard_clip_to_region(read, region_start, region_end):
    """Keep only query bases aligned within [region_start, region_end]
    (0-based inclusive; hc_assemble_utils_hard_clip_to_region). Insertions
    attach to their left neighbor's position."""
    # fast path: the whole unclipped span sits inside the region, so every
    # event anchor is kept (soft-clip virtual positions extend at most to
    # the unclipped bounds; leading-insertion anchors of pos-1 survive the
    # ins keep-bound of region_start-1) — identical to the slow paths'
    # keep-all returns
    cig = read.cigar
    if (read.pos - cig.left_soft_clip >= region_start
            and read.end + cig.right_soft_clip <= region_end + 1):
        return read
    lay = _sms_layout(read)
    if lay is not None:
        leftS, _mlen, _rightS = lay
        u0 = read.pos - leftS
        n = len(read.bases)
        lo = max(0, region_start - u0)
        hi = min(n, region_end + 1 - u0)
        return _slice_sms(read, lay, lo, hi)
    events = _explode(read)
    ref, _sc = events
    n = ref.size
    # insertions anchor at the nearest real position to their left
    # (read.pos - 1 before any aligned base)
    is_ins = ref == _INS
    idx = np.arange(n)
    last_real = np.maximum.accumulate(np.where(is_ins, -1, idx))
    anchor = np.where(
        is_ins,
        np.where(last_real >= 0, ref[np.maximum(last_real, 0)],
                 np.int64(read.pos - 1)),
        ref)
    # the reference's left clip removes query bases only up to the base AT
    # region_start-1 (clip_by_reference_coordinates left tail,
    # read_clipper.cpp:79-85): an insertion between start-1 and start
    # SURVIVES the clip — so insertion keep-bound is anchor >= start-1
    lo = np.where(is_ins, region_start - 1, region_start)
    keep = np.nonzero((anchor >= lo) & (anchor <= region_end))[0]
    if keep.size == n:
        return read
    return _rebuild(read, events, keep)


def has_well_defined_fragment(read):
    """hc_apply_utils_has_well_defined_fragment_size
    (hc_assemble_utils.c:67-87).  The apply-side reference compares against
    MPOS = mpos + 1 (the 1-based mate start), so both strand branches carry
    a +1 relative to the naive 0-based forms — and differ by that +1 from
    the activity-profile variant (HcActiveBase.cpp:48-68).  read.end here
    is 0-based exclusive, numerically equal to bam_endpos."""
    if read.tlen == 0 or not read.is_paired:
        return False
    if read.is_unmapped or (read.flag & 0x8):
        return False
    if read.is_reverse == bool(read.flag & 0x20):
        return False
    if read.is_reverse:
        return read.end > read.mate_pos + 1       # bam_endpos > MPOS
    return read.pos <= read.mate_pos + read.tlen + 1  # pos <= MPOS + isize


def hard_clip_adaptor_sequence(read):
    """Clip bases beyond the mate-adaptor boundary
    (hc_apply_utils_hard_clip_adaptor_sequence, hc_assemble_utils.c:93-107).
    The reference computes the boundary and the in-span gate in its 1-based
    pos_start space (verified against a per-read finalize trace of the
    binary); translated to 0-based:  reverse boundary = mate start, gated
    to (pos, end]; clip keeps ref >= mate start.  Forward boundary =
    pos + |isize|, gated to |isize| < ref-consumed length; clip keeps
    ref <= pos + |isize| - 1."""
    if not has_well_defined_fragment(read):
        return read
    if read.is_reverse:
        bound = read.mate_pos
        if not (read.pos < bound <= read.end):
            return read
        return hard_clip_to_region(read, bound, 1 << 60)
    bound = read.pos + abs(read.tlen)
    if bound >= read.end:
        return read
    return hard_clip_to_region(read, -(1 << 60), bound - 1)
