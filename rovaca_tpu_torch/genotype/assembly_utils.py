"""Merging events and mapping alleles to supporting haplotypes.

Counterpart of the reference's AssemblyBasedCallerUtils /
ROVACAVariantContextUtils merging pieces (reference: src/haplotypecaller/
genotype/utils/assembly_based_caller_utils.cpp:31-145,
rovaca_variant_context_utils.cpp simple_merge/create_allele_mapping).
"""

from .variant import Allele, SPAN_DEL, Variant


def get_variant_contexts_from_active_haplotypes(loc, haplotypes,
                                                include_spanning_events):
    """Unique events overlapping loc across haplotypes, in encounter order
    (assembly_based_caller_utils.cpp:104-125)."""
    seen = set()
    out = []
    for h in haplotypes:
        for vc in h.event_map.get_overlapping_events(loc):
            if not include_spanning_events and vc.start != loc:
                continue
            key = (vc.start, vc.stop,
                   tuple((a.bases, a.is_ref) for a in vc.alleles))
            if key not in seen:
                seen.add(key)
                out.append(vc)
    return out


def replace_span_dels(events, ref_allele, loc):
    """Events starting before loc become ref/* placeholders
    (germline_genotying_engine.cpp:237-258)."""
    out = []
    for vc in events:
        if vc.start == loc:
            out.append(vc)
        else:
            out.append(Variant(contig=vc.contig, start=loc, stop=loc,
                               alleles=[ref_allele, SPAN_DEL],
                               source_id=vc.source_id))
    return out


def extend_allele(alt, vc_ref, merged_ref):
    """Remap an alt allele when the merged ref is longer than its VC's ref
    (create_allele_mapping): append the merged ref's extra suffix."""
    if alt.is_symbolic:
        return alt
    suffix = merged_ref.bases[len(vc_ref.bases):]
    return Allele(alt.bases + suffix)


def simple_merge(events):
    """Merge same-start biallelic events into one multi-allelic VC
    (rovaca_variant_context_utils simple_merge; GATK simpleMerge).

    The longest ref allele wins; shorter-ref alts are suffix-extended.
    Alleles keep first-encounter order.
    """
    if not events:
        return None
    start = events[0].start
    assert all(vc.start == start for vc in events)
    merged_ref = max((vc.ref for vc in events), key=lambda a: len(a.bases))
    stop = max(vc.stop for vc in events)

    alts = []
    seen = set()
    for vc in events:
        for alt in vc.alts:
            ext = extend_allele(alt, vc.ref, merged_ref)
            if ext.bases not in seen:
                seen.add(ext.bases)
                alts.append(ext)
    return Variant(contig=events[0].contig, start=start, stop=stop,
                   alleles=[merged_ref] + alts,
                   source_id=events[0].source_id)


def create_allele_mapper(haplotypes, merged, loc, emit_spanning_dels):
    """{merged allele -> [supporting haplotypes]}
    (assembly_based_caller_utils.cpp:31-102)."""
    ref = merged.ref
    result = {a: [] for a in merged.alleles}
    merged_ref_len = len(ref)

    for h in haplotypes:
        spanning_events = h.event_map.get_overlapping_events(loc)
        if not spanning_events:
            result[ref].append(h)
            continue
        for vc in spanning_events:
            if vc.start == loc:
                span_ref_len = len(vc.ref)
                if span_ref_len == merged_ref_len:
                    alt = vc.alts[0]
                    if alt in result:
                        result[alt].append(h)
                elif span_ref_len < merged_ref_len:
                    remapped = extend_allele(vc.alts[0], vc.ref, ref)
                    if remapped in result:
                        result[remapped].append(h)
                # longer span ref cannot happen post-merge
            else:
                if emit_spanning_dels:
                    result.setdefault(SPAN_DEL, []).append(h)
                else:
                    result[ref].append(h)
                break
    return result
