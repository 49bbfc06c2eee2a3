"""Active-region trimming to the variant span.

Counterpart of the reference's AdapterUtils (reference: src/haplotypecaller/
genotype/utils/adapter_utils.cpp:64-214): compute the union of haplotype
events overlapping the region, pad SNPs by 20 / indels by 75 (+ longest
tandem-repeat run when present), intersect with the padded region, and trim
haplotypes/reads to the new span.
"""

import dataclasses

from .. import constants as C
from ..genotype import event_map
from ..reads import clipping
from ..reads.cigar import Cigar, CigarOp, CONSUMES_QUERY, CONSUMES_REF


def find_repeated_substring(seq):
    """Smallest unit that tiles seq exactly (GATK findRepeatedSubstring)."""
    n = len(seq)
    for ulen in range(1, n + 1):
        if n % ulen:
            continue
        unit = seq[:ulen]
        if unit * (n // ulen) == seq:
            return unit
    return seq


def _count_leading_repeats(unit, seq):
    n = 0
    i = 0
    while seq[i:i + len(unit)] == unit:
        n += 1
        i += len(unit)
    return n


def tandem_repeat_padding(vc, ref, ref_start):
    """Indel padding: 75 + longest repeat run when the allele is a tandem
    expansion/contraction of its context, else plain 75
    (adapter_utils.cpp:127-146 over
    rovaca_variant_context_utils.cpp:415-483 getNumTandemRepeatUnits:
    anchor base stripped, repeat counts measured against ref+context with
    the in-ref count subtracted, and BOTH ref and alt counts must be
    nonzero for every alt or the whole lookup fails)."""
    base = C.INDEL_PADDING_FOR_GENOTYPING
    ref_nb = vc.ref.bases[1:]
    remaining = ref[vc.start + 1 - ref_start:]
    lengths = []
    unit = b""
    for alt in vc.alts:
        if alt.is_symbolic:
            continue
        alt_nb = alt.bases[1:]
        long_b = alt_nb if len(alt_nb) > len(ref_nb) else ref_nb
        unit = find_repeated_substring(long_b)
        if not unit:
            return base
        reps_in_ref = _count_leading_repeats(unit, ref_nb)
        l_ref = _count_leading_repeats(unit, ref_nb + remaining) \
            - reps_in_ref
        l_alt = _count_leading_repeats(unit, alt_nb + remaining) \
            - reps_in_ref
        if l_ref == 0 or l_alt == 0:
            return base
        if not lengths:
            lengths.append(l_ref)
        lengths.append(l_alt)
    if not lengths or not unit:
        return base
    return C.STR_PADDING_FOR_GENOTYPING + max(lengths) * len(unit)


@dataclasses.dataclass
class TrimResult:
    variant_span: tuple       # (start, stop) inclusive, or None
    padded_span: tuple        # (start, stop) inclusive


def trim_region(haplotypes, ref, ref_start, region_start, region_stop,
                padded_start, padded_stop, max_mnp_distance=0):
    """Variant span + padded span from haplotype events
    (adapter_utils.cpp:92-155). Returns None when no variation overlaps."""
    event_map.build_event_maps_for_haplotypes(haplotypes, ref, ref_start,
                                              max_mnp_distance)
    variants = []
    seen = set()
    for h in haplotypes:
        for vc in h.event_map.events.values():
            key = (vc.start, vc.stop,
                   tuple(a.bases for a in vc.alleles))
            if key in seen:
                continue
            seen.add(key)
            if vc.start <= region_stop and vc.stop >= region_start:
                variants.append(vc)
    if not variants:
        return None

    min_start = min(vc.start for vc in variants)
    max_end = max(vc.stop for vc in variants)
    var_span = (max(min_start, region_start), min(max_end, region_stop))

    pad_min, pad_max = min_start, max_end
    for vc in variants:
        # event-map variants are biallelic; indel iff alt length differs
        # from ref (variant.cpp:225-241 type_of_biallelic_variant — the
        # indel branch must fire for deletions too)
        alt_lens = [len(a) for a in vc.alts if not a.is_symbolic]
        if alt_lens and any(l != len(vc.ref) for l in alt_lens):
            padding = tandem_repeat_padding(vc, ref, ref_start)
        else:
            padding = C.SNP_PADDING_FOR_GENOTYPING
        pad_min = min(pad_min, max(vc.start - padding, 1))
        pad_max = max(pad_max, vc.stop + padding)
    padded = (max(pad_min, padded_start), min(pad_max, padded_stop))
    return TrimResult(variant_span=var_span, padded_span=padded)


def trim_haplotype(hap, ref, span_start, span_stop):
    """New (bases, cigar, window_start) covering [span_start, span_stop]
    (trim_haplotype_by_region). Coordinates are genome positions."""
    ref_pos = hap.window_start
    q = 0
    keep = []          # query indices kept
    elems = []
    for op, length in hap.cigar:
        in_q = op in CONSUMES_QUERY
        in_r = op in CONSUMES_REF
        if in_q and in_r:
            for k in range(length):
                if span_start <= ref_pos + k <= span_stop:
                    keep.append(q + k)
                    elems.append((op, 1))
            ref_pos += length
            q += length
        elif in_r:  # deletion
            if span_start <= ref_pos and ref_pos + length - 1 <= span_stop:
                if elems:
                    elems.append((op, length))
            ref_pos += length
        elif in_q:  # insertion
            if span_start < ref_pos <= span_stop and elems:
                for k in range(length):
                    keep.append(q + k)
                    elems.append((op, 1))
            q += length
    if not keep:
        return None
    # drop trailing deletions
    while elems and elems[-1][0] in (CigarOp.D, CigarOp.N):
        elems.pop()
    bases = bytes(hap.bases[i] for i in keep)
    cigar = Cigar(elems).normalized()
    new_start = max(hap.window_start, span_start)
    return bases, cigar, new_start


def trim_haplotypes(haplotypes, ref, span_start, span_stop):
    """Trimmed, deduplicated haplotype list (ref haplotype kept first)."""
    from ..assembly.assembler import Haplotype

    out = []
    seen = {}
    for h in haplotypes:
        t = trim_haplotype(h, ref, span_start, span_stop)
        if t is None:
            continue
        bases, cigar, new_start = t
        if bases in seen:
            seen[bases].is_ref |= h.is_ref
            continue
        nh = Haplotype(bases=bases, is_ref=h.is_ref, score=h.score,
                       cigar=cigar, window_start=new_start,
                       kmer_size=h.kmer_size)
        seen[bases] = nh
        out.append(nh)
    # less_bases orders by LENGTH first, then lexicographically
    # (allele.cpp:224-236; trim_haplotype_by_region's HaplotypeLess,
    # adapter_utils.cpp:180-226): a deletion haplotype sorts before
    # same-prefix longer ones, which fixes the event-collection order at
    # spanning-deletion sites
    out.sort(key=lambda h: (not h.is_ref, len(h.bases), h.bases))
    return out


def trim_reads(reads, span_start, span_stop,
               min_length=C.MIN_READ_LENGTH_AFTER_TRIMMING):
    """Hard-clip reads to the padded span (trim_reads_by_region)."""
    out = []
    for r in reads:
        t = clipping.hard_clip_to_region(r, span_start, span_stop)
        if len(t.bases) >= min_length and not t.cigar.is_empty:
            out.append(t)
    return out
