"""Per-haplotype event maps: SNP/indel events from the haplotype cigar.

Mirrors the reference's EventMap (reference: src/haplotypecaller/genotype/
event_map.cpp:17-300): walk the haplotype cigar vs its reference window,
propose SNPs (per-mismatch, MNP-merged within max_mnp_distance), insertions
and deletions anchored on the preceding ref base, skip irregular bases and
edge insertions, and merge same-start events into blocks.
"""

from ..reads.cigar import CigarOp
from .variant import Allele, Variant

REGULAR_BASES = frozenset(b"ACGT")


def _regular(b):
    return b in REGULAR_BASES


class EventMap:
    """Sorted {start -> Variant} for one haplotype."""

    def __init__(self, source_index=0):
        self.events = {}
        self.source_index = source_index

    # --- construction ---
    @classmethod
    def from_haplotype(cls, hap, ref, ref_start, max_mnp_distance=0,
                       source_index=0):
        """hap: assembler.Haplotype (cigar vs ref window); ref: window bytes;
        ref_start: genome pos of window start."""
        em = cls(source_index)
        em._process_cigar(hap, ref, ref_start, max_mnp_distance)
        return em

    def _process_cigar(self, hap, ref, ref_start, max_mnp_distance):
        ref_pos = 0
        aln_pos = 0
        alignment = hap.bases
        proposed = []
        contig = None  # filled by caller via variant contig below

        for op, op_len in hap.cigar:
            if op == CigarOp.I:
                if ref_pos > 0:
                    ref_byte = ref[ref_pos - 1]
                    insertion_start = ref_start + ref_pos - 1
                    ins = alignment[aln_pos:aln_pos + op_len]
                    if (_regular(ref_byte)
                            and all(_regular(b) for b in ins)):
                        ref_allele = Allele(bytes([ref_byte]), is_ref=True)
                        alt_allele = Allele(bytes([ref_byte]) + ins)
                        proposed.append(Variant(
                            contig=contig, start=insertion_start,
                            stop=insertion_start,
                            alleles=[ref_allele, alt_allele],
                            source_id=self.source_index))
                aln_pos += op_len
            elif op == CigarOp.S:
                aln_pos += op_len
            elif op == CigarOp.D:
                if ref_pos > 0:
                    del_bases = ref[ref_pos - 1:ref_pos + op_len]
                    del_start = ref_start + ref_pos - 1
                    ref_byte = ref[ref_pos - 1]
                    if (_regular(ref_byte)
                            and all(_regular(b) for b in del_bases)):
                        proposed.append(Variant(
                            contig=contig, start=del_start,
                            stop=del_start + op_len,
                            alleles=[Allele(del_bases, is_ref=True),
                                     Allele(bytes([ref_byte]))],
                            source_id=self.source_index))
                ref_pos += op_len
            elif op in (CigarOp.M, CigarOp.EQ, CigarOp.X):
                mismatches = [
                    off for off in range(op_len)
                    if (ref[ref_pos + off] != alignment[aln_pos + off]
                        and _regular(ref[ref_pos + off])
                        and _regular(alignment[aln_pos + off]))]
                i = 0
                while i < len(mismatches):
                    start = end = mismatches[i]
                    i += 1
                    while (i < len(mismatches)
                           and mismatches[i] - end <= max_mnp_distance):
                        end = mismatches[i]
                        i += 1
                    ref_b = ref[ref_pos + start:ref_pos + end + 1]
                    alt_b = alignment[aln_pos + start:aln_pos + end + 1]
                    proposed.append(Variant(
                        contig=contig, start=ref_start + ref_pos + start,
                        stop=ref_start + ref_pos + end,
                        alleles=[Allele(ref_b, is_ref=True), Allele(alt_b)],
                        source_id=self.source_index))
                ref_pos += op_len
                aln_pos += op_len
            else:
                raise ValueError(f"unsupported cigar op in haplotype: {op}")

        for vc in proposed:
            self.add_variant(vc)

    def add_variant(self, vc):
        """Insert; same-start events merge into blocks
        (event_map.cpp:78-133)."""
        key = vc.start
        if key in self.events:
            self.events[key] = make_block(self.events[key], vc)
        else:
            self.events[key] = vc

    # --- queries ---
    @property
    def start_positions(self):
        return sorted(self.events)

    def get_overlapping_events(self, loc):
        """Events overlapping loc, dropping a deletion that ends exactly at
        loc when an insertion starts there (event_map.cpp:43-76)."""
        overlapping = [vc for start, vc in sorted(self.events.items())
                       if start <= loc and vc.stop >= loc]
        dels_ending = [vc for vc in overlapping
                       if vc.is_simple_deletion and vc.stop == loc]
        has_ins = any(vc.is_simple_insertion for vc in overlapping)
        if dels_ending and has_ins:
            overlapping.remove(dels_ending[0])
        return overlapping


def make_block(vc1, vc2):
    """Merge two same-start biallelic events (event_map.cpp:78-133)."""
    assert vc1.start == vc2.start
    new_stop = None
    if vc1.is_snp:
        if vc1.ref.same_bases(vc2.ref):
            # SNP + insertion: alt gets the SNP's substituted base
            ref = vc1.ref
            alt = Allele(vc1.alts[0].bases[:1] + vc2.alts[0].bases[1:])
        else:
            # SNP + deletion: patch ref from the deletion
            ref = vc2.ref
            alt = vc1.alts[0]
            new_stop = vc2.stop
    else:
        insertion = vc1 if vc1.is_simple_insertion else vc2
        deletion = vc1 if vc1.is_simple_deletion else vc2
        ref = deletion.ref
        alt = insertion.alts[0]
        new_stop = deletion.stop
    return Variant(contig=vc1.contig, start=vc1.start,
                   stop=new_stop if new_stop is not None else vc1.stop,
                   alleles=[ref, alt], source_id=vc1.source_id)


def build_event_maps_for_haplotypes(haplotypes, ref, ref_start,
                                    max_mnp_distance=0):
    """Attach .event_map to each haplotype; return sorted start positions
    (event_map.cpp:17-41)."""
    starts = set()
    for idx, hap in enumerate(haplotypes):
        em = EventMap.from_haplotype(hap, ref, ref_start,
                                     max_mnp_distance, idx)
        hap.event_map = em
        starts.update(em.events.keys())
    return sorted(starts)
