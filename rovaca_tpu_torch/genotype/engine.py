"""Germline genotyping engine: haplotype likelihoods -> variant calls.

Faithful reimplementation of the reference's GermlineGenotyingEngine
(reference: src/haplotypecaller/genotype/germline_genotying_engine.cpp:
93-600): per event start — collect events from haplotype event maps, replace
spanning deletions, merge into one VariantContext, map alleles to haplotypes,
marginalize read likelihoods, genotype with the exact-AF model, threshold,
subset output alleles, annotate, and track upstream deletions.
"""

import dataclasses

import numpy as np

from .. import constants as C
from . import annotations, assembly_utils, event_map, subsetting
from . import genotype_alleles as ga
from .af_calc import AlleleFrequencyCalculator
from .likelihood_calc import genotype_log10_likelihoods, gls_to_pls
from .variant import Allele, Genotype, NO_CALL, NON_REF, SPAN_DEL, Variant

PRACTICAL_ALLELE_COUNT_TWO_PLOIDY = 44   # germline_genotying_engine.cpp:34
MAX_GENOTYPEABLE_ALLELES = 50            # GenotypeLikelihoods cap
TOO_LONG_PL = 100000


@dataclasses.dataclass
class GenotypingArgs:
    """Mirrors GenotypeArgument defaults (genotype_argument.h:15-83)."""
    sample_ploidy: int = C.SAMPLE_PLOIDY
    max_alternate_alleles: int = C.MAX_ALTERNATE_ALLELES
    max_mnp_distance: int = C.MAX_MNP_DISTANCE
    snp_heterozygosity: float = C.SNP_HETEROZYGOSITY
    indel_heterozygosity: float = C.INDEL_HETEROZYGOSITY
    heterozygosity_stdev: float = C.HETEROZYGOSITY_STDEV
    informative_read_overlap_margin: int = C.INFORMATIVE_READ_OVERLAP_MARGIN
    disable_spanning_event_genotyping: bool = False
    gvcf_mode: bool = False
    sample_name: str = "SAMPLE"
    contig_length: int = 1 << 60

    @property
    def standard_confidence(self):
        return (C.STANDARD_CONFIDENCE_GVCF if self.gvcf_mode
                else C.STANDARD_CONFIDENCE_VCF)

    @property
    def annotate_all_sites_with_pls(self):
        return self.gvcf_mode


class GermlineGenotypingEngine:
    def __init__(self, args=None):
        self.args = args or GenotypingArgs()
        self.af_calculator = AlleleFrequencyCalculator.make_calculator(
            self.args.sample_ploidy, self.args.snp_heterozygosity,
            self.args.indel_heterozygosity, self.args.heterozygosity_stdev)
        self.upstream_deletions = []  # (contig, start, stop) spans

    # ------------------------------------------------------------------
    def assign_genotype_likelihoods(self, hap_likelihoods, ref, ref_start,
                                    active_start, active_stop,
                                    filtered_reads=()):
        """hap_likelihoods: AlleleLikelihoods over (haplotypes x reads);
        ref: padded window bytes at genome pos ref_start; active region
        [active_start, active_stop] inclusive. `filtered_reads` are the
        non-passing reads fed back into annotation DP/AD with 0.0
        likelihood (germline_genotying_engine.cpp:606-641). Returns
        (calls, called_haplotypes)."""
        args = self.args
        haplotypes = hap_likelihoods.alleles
        starts = event_map.build_event_maps_for_haplotypes(
            haplotypes, ref, ref_start, args.max_mnp_distance)

        calls = []
        called_haplotypes = []
        for loc in starts:
            if loc < active_start or loc > active_stop:
                continue
            events = assembly_utils.get_variant_contexts_from_active_haplotypes(
                loc, haplotypes,
                include_spanning_events=(args.max_mnp_distance == 0))
            ref_allele = Allele(bytes([ref[loc - ref_start]]), is_ref=True)
            events = assembly_utils.replace_span_dels(events, ref_allele, loc)
            merged = assembly_utils.simple_merge(events)
            if merged is None:
                continue
            merged.contig = getattr(hap_likelihoods.reads[0], "contig", None) \
                if hap_likelihoods.reads else None

            n_before_trim = merged.n_alleles
            mapper = assembly_utils.create_allele_mapper(
                haplotypes, merged, loc,
                emit_spanning_dels=not args.disable_spanning_event_genotyping)
            if len(mapper) > PRACTICAL_ALLELE_COUNT_TWO_PLOIDY:
                continue  # remove_alt_alleles_if_too_many_genotypes -> null

            # mapper may have introduced SPAN_DEL not in merged alleles
            alleles = list(merged.alleles)
            for a in mapper:
                if a not in alleles:
                    alleles.append(a)
            merged.alleles = alleles

            ra_lik = hap_likelihoods.marginalize(merged.alleles, mapper)
            overlap_start = max(0, merged.start
                                - args.informative_read_overlap_margin)
            overlap_stop = min(args.contig_length - 1,
                               merged.stop
                               + args.informative_read_overlap_margin)
            ra_lik.retain_overlapping(overlap_start, overlap_stop)

            if args.gvcf_mode:
                merged.alleles = list(merged.alleles) + [NON_REF]
                ra_lik.add_non_reference_allele()
                n_before_trim += 1

            merged.genotypes = [self._calculate_gls(ra_lik)]
            call = self.calculate_genotypes(merged)
            if call is None:
                continue

            for a in call.alleles:
                for h in mapper.get(a, ()):
                    if h not in called_haplotypes:
                        called_haplotypes.append(h)

            anno_lik = self._annotation_likelihoods(
                ra_lik, call, filtered_reads, overlap_start, overlap_stop)
            annotations.annotate_variant(call, anno_lik,
                                         gvcf_mode=args.gvcf_mode)
            calls.append(call)

        if args.gvcf_mode:  # do_not_run_physical_phasing unless GVCF
            from .phasing import phase_calls
            calls = phase_calls(calls, called_haplotypes)
        return calls, called_haplotypes

    # ------------------------------------------------------------------
    def _calculate_gls(self, ra_lik):
        """Per-sample genotype from read-allele likelihoods
        (calculate_gls_for_this_event)."""
        ploidy = self.args.sample_ploidy
        gls = genotype_log10_likelihoods(ploidy, ra_lik.matrix)
        gls = gls - np.max(gls)
        pls = gls_to_pls(gls)
        # the reference's Genotype stores ONLY the integer PLs; every later
        # consumer (AF calculator/QUAL, allele subsetting) reconstructs
        # log10 likelihoods as pl / -10 (genotype.cpp:12,
        # germline_genotying_engine.cpp:390) — so QUAL is computed from
        # PL-quantized likelihoods, not the raw GLs
        return Genotype(alleles=[NO_CALL] * ploidy, pl=list(pls),
                        sample=self.args.sample_name)

    def _annotation_likelihoods(self, ra_lik, call, filtered_reads=(),
                                overlap_start=None, overlap_stop=None):
        """Subset likelihoods to the call's alleles for annotation, then
        append filtered (non-passing) reads overlapping the variant-calling
        interval with 0.0 likelihood for every allele so depth annotations
        see them (prepare_read_allele_likelihoods_for_annotation +
        overlapping_filtered_reads + add_evidence,
        germline_genotying_engine.cpp:606-663,
        allele_likelihoods.hpp:328-344)."""
        # the reference KEEPS the full allele set (incl. spanning '*') in
        # the annotation container — reads whose best allele is a dropped
        # spanning deletion stay out of the SOR/FS/rank-sum pools instead
        # of being reassigned to a call allele; only the NON_REF row is
        # refreshed when the call dropped alleles. Per-allele subsetting
        # happens inside AD (round-5 seed-424243 SOR/ReadPosRankSum
        # divergence at chr20:172444).
        if len(call.alleles) != ra_lik.n_alleles:
            ra_lik.update_non_ref_likelihoods(call.alleles)
        reads = list(ra_lik.reads)
        matrix = ra_lik.matrix
        extra = [r for r in filtered_reads
                 if overlap_start is None
                 or r.overlaps(overlap_start, overlap_stop + 1)]
        if extra and len(matrix):
            matrix = np.concatenate(
                [matrix, np.zeros((matrix.shape[0], len(extra)))], axis=1)
            reads += extra
        from .likelihoods import AlleleLikelihoods
        return AlleleLikelihoods(list(ra_lik.alleles), reads, matrix)

    # ------------------------------------------------------------------
    def calculate_genotypes(self, vc):
        """The reference's calculate_genotypes
        (germline_genotying_engine.cpp:258-370)."""
        args = self.args
        if vc.n_alleles > MAX_GENOTYPEABLE_ALLELES:
            return None
        if not any(g.has_likelihoods for g in vc.genotypes):
            return None

        ploidy = args.sample_ploidy
        reduced = vc
        if len(vc.alts) > args.max_alternate_alleles:
            keep = subsetting.calculate_most_likely_alleles(
                vc.alleles, vc.genotypes, ploidy, args.max_alternate_alleles)
            if len(keep) == 1:
                genotypes = subsetting.subset_to_ref_only(vc.genotypes,
                                                          ploidy, vc.ref)
            else:
                genotypes = subsetting.subset_alleles(
                    vc.genotypes, ploidy, vc.alleles, keep,
                    assignment="BEST_MATCH_TO_ORIGINAL")
            reduced = Variant(contig=vc.contig, start=vc.start, stop=vc.stop,
                              alleles=keep, genotypes=genotypes,
                              source_id=vc.source_id)

        af_result = self.af_calculator.calculate(reduced.alleles,
                                                 reduced.genotypes, ploidy)

        out_alts, mle_counts, site_is_monomorphic = \
            self._output_allele_subset(af_result, reduced)

        log10_confidence = (
            af_result.log10_prob_only_ref_allele_exists() + 0.0
            if not site_is_monomorphic or args.annotate_all_sites_with_pls
            else af_result.log10_prob_variant_present() + 0.0)
        phred_confidence = -10.0 * log10_confidence + 0.0

        passes = ((not site_is_monomorphic)
                  and phred_confidence >= args.standard_confidence)
        first_is_non_ref = bool(out_alts) and out_alts[0] == NON_REF
        if not passes and not first_is_non_ref:
            return None
        if len(out_alts) == 1 and out_alts[0] == SPAN_DEL:
            return None

        output_alleles = [reduced.ref] + out_alts
        self._record_deletions(reduced, output_alleles)

        if len(output_alleles) == 1:
            genotypes = subsetting.subset_to_ref_only(reduced.genotypes,
                                                      ploidy, reduced.ref)
        else:
            genotypes = subsetting.subset_alleles(
                reduced.genotypes, ploidy, reduced.alleles, output_alleles,
                assignment="USE_PLS_TO_ASSIGN")

        call = Variant(contig=reduced.contig, start=reduced.start,
                       stop=reduced.start + len(reduced.ref) - 1,
                       alleles=output_alleles, genotypes=genotypes,
                       log10_error=log10_confidence,
                       source_id=reduced.source_id)
        if mle_counts:
            an = sum(1 for g in genotypes for a in g.alleles
                     if a.bases != b".")
            call.attributes["MLEAC"] = mle_counts
            call.attributes["MLEAF"] = [
                min(1.0, c / an) if an else float("nan")
                for c in mle_counts]
        return call

    def _output_allele_subset(self, af_result, vc):
        """calculate_output_allele_subset
        (germline_genotying_engine.cpp:469-504)."""
        args = self.args
        out = []
        mle = []
        site_is_monomorphic = True
        alts = [a for a in af_result.alleles if not a.is_ref]
        for a in alts:
            is_lone_non_ref = len(alts) == 1 and a == NON_REF
            is_plausible = af_result.passes_threshold(
                a, args.standard_confidence)
            is_spurious_span_del = (a == SPAN_DEL
                                    and not self._covered_by_deletion(vc))
            force_keep = a == NON_REF or args.gvcf_mode
            to_output = ((is_plausible or force_keep or is_lone_non_ref)
                         and not is_spurious_span_del)
            site_is_monomorphic &= not (is_plausible
                                        and not is_spurious_span_del)
            if to_output:
                out.append(a)
                mle.append(af_result.mle_count(a))
        return out, mle, site_is_monomorphic

    def _record_deletions(self, vc, alleles):
        """Track deletion spans for downstream * allele validity
        (record_deletions)."""
        self.upstream_deletions = [
            (c, s, e) for (c, s, e) in self.upstream_deletions
            if c == vc.contig and e >= vc.start]
        ref_len = len(vc.ref)
        for a in alleles:
            if not a.is_symbolic and ref_len > len(a):
                self.upstream_deletions.append(
                    (vc.contig, vc.start, vc.start + ref_len - len(a)))

    def _covered_by_deletion(self, vc):
        return any(c == vc.contig and s < vc.start <= e
                   for (c, s, e) in self.upstream_deletions)

    def clear_upstream_deletions(self):
        self.upstream_deletions = []
