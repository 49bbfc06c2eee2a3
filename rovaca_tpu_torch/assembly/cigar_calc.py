"""Haplotype-vs-reference cigar determination.

Mirrors the reference's cigar calculation for assembled haplotypes
(reference: src/haplotypecaller/apply/assemble/hc_assemble_cigar_cacl.c:32-460;
GATK CigarUtils.calculateCigar): N-pad both sequences, run SW with the
haplotype-to-reference parameter set, reject alignments that soft-clip or
don't start at the pad, trim the pads off the cigar, left-align indels, and
restore boundary deletions.
"""

from ..reads.cigar import Cigar, CigarOp, CONSUMES_QUERY, CONSUMES_REF
from .sw import HAPLOTYPE_TO_REFERENCE_PARAMS, OverhangStrategy, sw_align

SW_PAD = b"NNNNNNNNNN"  # hc_assemble_dijkstra_shortest_path.h:7


def trim_cigar_by_bases(cigar, start, end):
    """Trim to query (read-base) range [start, end] inclusive.

    Returns (trimmed Cigar, leading_del_bases_removed,
    trailing_del_bases_removed) — deletions dropped at the boundaries
    (AlignmentUtils.trimCigarByBases semantics)."""
    elems = []
    leading_d = trailing_d = 0
    q = 0
    for op, length in cigar:
        if op in CONSUMES_QUERY:
            lo = max(q, start)
            hi = min(q + length - 1, end)
            if lo <= hi:
                elems.append((op, hi - lo + 1))
            q += length
        elif op in (CigarOp.D, CigarOp.N):
            # deletion sits between query bases q-1 and q
            if q <= start:
                leading_d += length
            elif q > end:
                trailing_d += length
            else:
                elems.append((op, length))
        # H/P dropped
    return Cigar(elems).normalized(), leading_d, trailing_d


def left_align_indels(cigar, ref, read, read_start_on_ref):
    """Shift each indel to its leftmost position across repeats
    (hc_assemle_cigar_cacl_left_align_indels; AlignmentUtils.leftAlignIndels).

    `ref` is the window the cigar aligns to, `read` the query sequence,
    `read_start_on_ref` the ref offset of the first aligned base.
    """
    elems = [list(e) for e in cigar.elements]
    # precompute walk positions per element
    changed = True
    while changed:
        changed = False
        ref_pos = read_start_on_ref
        read_pos = 0
        for idx, (op, length) in enumerate(elems):
            if op in (CigarOp.I, CigarOp.D) and idx > 0 \
                    and elems[idx - 1][0] == CigarOp.M and length > 0:
                prev_len = elems[idx - 1][1]
                shift = 0
                while shift < prev_len:
                    if op == CigarOp.D:
                        left = ref_pos - 1 - shift
                        right = ref_pos + length - 1 - shift
                        if left < 0 or ref[left] != ref[right]:
                            break
                    else:
                        left = read_pos - 1 - shift
                        right = read_pos + length - 1 - shift
                        if left < 0 or read[left] != read[right]:
                            break
                    shift += 1
                if shift:
                    elems[idx - 1][1] -= shift
                    nxt = idx + 1
                    if nxt < len(elems) and elems[nxt][0] == CigarOp.M:
                        elems[nxt][1] += shift
                    else:
                        elems.insert(nxt, [CigarOp.M, shift])
                    changed = True
                    break
            if op in CONSUMES_REF:
                ref_pos += length
            if op in CONSUMES_QUERY:
                read_pos += length
        if changed:
            elems = [e for e in elems if e[1] > 0]
    return Cigar(elems).normalized()


def calculate_haplotype_cigar(ref_window, hap_seq, aligner=sw_align):
    """Cigar of a haplotype against its reference window, or None if the SW
    alignment is unusable (hap dropped, as the reference does)."""
    if isinstance(ref_window, str):
        ref_window = ref_window.encode()
    if isinstance(hap_seq, str):
        hap_seq = hap_seq.encode()

    if len(hap_seq) == 0:
        return Cigar([(CigarOp.D, len(ref_window))])

    # equal length + <=2 mismatches is trivially all-M
    if len(hap_seq) == len(ref_window):
        mismatches = sum(1 for a, b in zip(hap_seq, ref_window) if a != b)
        if mismatches <= 2:
            return Cigar([(CigarOp.M, len(hap_seq))])

    pad_ref = SW_PAD + ref_window + SW_PAD
    pad_hap = SW_PAD + hap_seq + SW_PAD
    res = aligner(pad_ref, pad_hap, HAPLOTYPE_TO_REFERENCE_PARAMS,
                  OverhangStrategy.SOFTCLIP)

    # SW failure: must start at base 0 and contain no soft clips
    if res.alignment_offset > 0 or any(op == CigarOp.S for op, _ in res.cigar):
        return None

    npad = len(SW_PAD)
    trimmed, lead_d, trail_d = trim_cigar_by_bases(
        res.cigar, npad, len(pad_hap) - npad - 1)

    # restore trailing deletions before left-aligning (cigar_cacl.c:91-95)
    elems = list(trimmed.elements)
    if trail_d > 0:
        elems.append((CigarOp.D, trail_d))
    aligned = left_align_indels(Cigar(elems).normalized(), ref_window,
                                hap_seq, lead_d)

    # left-alignment may push deletions to the edges; strip + re-count them
    elems = list(aligned.elements)
    extra_lead = extra_trail = 0
    while elems and elems[0][0] == CigarOp.D:
        extra_lead += elems[0][1]
        elems.pop(0)
    while elems and elems[-1][0] == CigarOp.D:
        extra_trail += elems[-1][1]
        elems.pop()

    total_lead = lead_d + extra_lead
    total_trail = extra_trail
    out = []
    if total_lead:
        out.append((CigarOp.D, total_lead))
    out.extend(elems)
    if total_trail:
        out.append((CigarOp.D, total_trail))
    return Cigar(out).normalized()
