"""GATK-exact Smith-Waterman alignment.

Reimplements the reference's GATK-derived SW (reference: src/haplotypecaller/
apply/assemble/hc_assemble_gatk_sw.c:104-434; itself GATK's
SWPairwiseAlignment): affine gaps tracked with incrementally-maintained
best-gap arrays, diag > right > down tie-breaking, four overhang strategies,
and backtrack producing a cigar plus alignment offset.

Dispatches to the native C++ implementation (rovaca_tpu.native.sw) when the
shared library is available; the pure-Python path is the oracle and fallback.
"""

import dataclasses
from enum import IntEnum

import numpy as np

from .. import constants as C
from ..reads.cigar import Cigar, CigarOp

MATRIX_MIN_CUTOFF = int(-1.0e8)
LOW_INIT_VALUE = -(2 ** 30)


class OverhangStrategy(IntEnum):
    SOFTCLIP = 0
    INDEL = 1
    LEADING_INDEL = 2
    IGNORE = 3


@dataclasses.dataclass(frozen=True)
class SWParams:
    match: int
    mismatch: int
    gap_open: int
    gap_extend: int


# reference: src/rovaca_tool_args.h:40-42
DANGLING_END_PARAMS = SWParams(*C.SW_DANGLING_END)
HAPLOTYPE_TO_REFERENCE_PARAMS = SWParams(*C.SW_HAPLOTYPE_TO_REFERENCE)
READ_TO_HAPLOTYPE_PARAMS = SWParams(*C.SW_READ_TO_HAPLOTYPE)


@dataclasses.dataclass
class SWResult:
    cigar: Cigar
    alignment_offset: int


def sw_align(ref, alt, params, overhang=OverhangStrategy.SOFTCLIP):
    """Align `alt` against `ref`; returns SWResult (cigar ops over alt)."""
    if isinstance(ref, str):
        ref = ref.encode()
    if isinstance(alt, str):
        alt = alt.encode()
    if not ref or not alt:
        raise ValueError("empty sequence")

    if overhang in (OverhangStrategy.SOFTCLIP, OverhangStrategy.IGNORE):
        idx = ref.rfind(alt)
        if idx != -1:
            return SWResult(Cigar([(CigarOp.M, len(alt))]), idx)

    from ..native import sw_native
    if sw_native.available():
        ops, lens, offset = sw_native.align(ref, alt, params, int(overhang))
        return SWResult(Cigar(zip(ops, lens)), offset)
    return _sw_align_python(ref, alt, params, overhang)


def _sw_align_python(ref, alt, params, overhang):
    n, m = len(ref), len(alt)
    w_match, w_mismatch = params.match, params.mismatch
    w_open, w_extend = params.gap_open, params.gap_extend

    sw = np.zeros((n + 1, m + 1), dtype=np.int64)
    btrack = np.zeros((n + 1, m + 1), dtype=np.int64)

    if overhang in (OverhangStrategy.INDEL, OverhangStrategy.LEADING_INDEL):
        sw[0, 1:] = w_open + np.arange(m) * w_extend
        sw[1:, 0] = w_open + np.arange(n) * w_extend

    best_gap_v = np.full(m + 1, LOW_INIT_VALUE, dtype=np.int64)
    gap_size_v = np.zeros(m + 1, dtype=np.int64)
    best_gap_h = np.full(n + 1, LOW_INIT_VALUE, dtype=np.int64)
    gap_size_h = np.zeros(n + 1, dtype=np.int64)

    for i in range(1, n + 1):
        a = ref[i - 1]
        for j in range(1, m + 1):
            b = alt[j - 1]
            step_diag = sw[i - 1, j - 1] + (w_match if a == b else w_mismatch)

            prev_gap = sw[i - 1, j] + w_open
            best_gap_v[j] += w_extend
            if prev_gap > best_gap_v[j]:
                best_gap_v[j] = prev_gap
                gap_size_v[j] = 1
            else:
                gap_size_v[j] += 1
            step_down = best_gap_v[j]
            kd = gap_size_v[j]

            prev_gap = sw[i, j - 1] + w_open
            best_gap_h[i] += w_extend
            if prev_gap > best_gap_h[i]:
                best_gap_h[i] = prev_gap
                gap_size_h[i] = 1
            else:
                gap_size_h[i] += 1
            step_right = best_gap_h[i]
            ki = gap_size_h[i]

            if step_diag < step_down or step_diag < step_right:
                if step_right >= step_down:
                    sw[i, j] = max(MATRIX_MIN_CUTOFF, step_right)
                    btrack[i, j] = -ki
                else:
                    sw[i, j] = max(MATRIX_MIN_CUTOFF, step_down)
                    btrack[i, j] = kd
            else:
                sw[i, j] = max(MATRIX_MIN_CUTOFF, step_diag)
                btrack[i, j] = 0

    return _calculate_cigar(sw, btrack, n, m, overhang)


def _calculate_cigar(sw, btrack, n, m, overhang):
    """Backtrack (hc_assemble_gatk_sw.c:286-434)."""
    segment_length = 0
    if overhang == OverhangStrategy.INDEL:
        p1, p2 = n, m
    else:
        p1, p2 = 0, m
        maxscore = -np.inf
        for i in range(1, n + 1):
            if sw[i, m] >= maxscore:
                p1 = i
                maxscore = sw[i, m]
        if overhang != OverhangStrategy.LEADING_INDEL:
            for j in range(1, m + 1):
                cur = sw[n, j]
                if cur > maxscore or (cur == maxscore
                                      and abs(n - j) < abs(p1 - p2)):
                    p1, p2 = n, j
                    maxscore = cur
                    segment_length = m - j

    elements = []  # built in reverse
    if segment_length > 0 and overhang == OverhangStrategy.SOFTCLIP:
        elements.append((CigarOp.S, segment_length))
        segment_length = 0

    state = CigarOp.M
    while True:
        btr = btrack[p1, p2]
        if btr > 0:
            new_state, step = CigarOp.D, int(btr)
        elif btr < 0:
            new_state, step = CigarOp.I, int(-btr)
        else:
            new_state, step = CigarOp.M, 1
        if new_state == CigarOp.M:
            p1 -= 1
            p2 -= 1
        elif new_state == CigarOp.I:
            p2 -= step
        else:
            p1 -= step
        if new_state == state:
            segment_length += step
        else:
            if segment_length > 0:
                elements.append((state, segment_length))
            segment_length = step
            state = new_state
        if not (p1 > 0 and p2 > 0):
            break

    if overhang == OverhangStrategy.SOFTCLIP:
        elements.append((state, segment_length))
        if p2 > 0:
            elements.append((CigarOp.S, p2))
        offset = p1
    elif overhang == OverhangStrategy.IGNORE:
        elements.append((state, segment_length + p2))
        offset = p1 - p2
    else:  # INDEL / LEADING_INDEL
        elements.append((state, segment_length))
        if p1 > 0:
            elements.append((CigarOp.D, p1))
        elif p2 > 0:
            elements.append((CigarOp.I, p2))
        offset = 0

    return SWResult(Cigar(reversed(elements)), offset)
