"""Exact allele-frequency posterior calculator.

Faithful reimplementation of the reference's AlleleFrequencyCalculator
(reference: src/haplotypecaller/genotype/allele_frequency_calculator.cpp:
24-270; GATK AlleleFrequencyCalculator): expectation propagation over
Dirichlet effective allele counts, then per-allele absence posteriors.
"""

import dataclasses
import math

import numpy as np

from .. import constants as C
from ..ops import gatk_math
from . import genotype_alleles as ga
from .variant import SPAN_DEL

THRESHOLD = 0.1  # allele-count convergence
HOM_REF_INDEX = 0


@dataclasses.dataclass
class AFCalculationResult:
    log10_p_no_variant: float             # log10 P(site has only ref allele)
    log10_p_ref_by_allele: dict           # alt allele -> log10 P(absent)
    alt_allele_mle_counts: list           # ints, one per alt
    alleles: list                         # the alleles used in genotyping

    def log10_prob_only_ref_allele_exists(self):
        return self.log10_p_no_variant

    def log10_prob_variant_present(self):
        return gatk_math.log10_one_minus_pow10(
            np.array(self.log10_p_no_variant)).item()

    def passes_threshold(self, allele, phred_conf_threshold):
        """log10 P(allele absent) + eps < -threshold/10
        (af_calculation_result.cpp:30-33). The 1e-10 epsilon matters: for
        an unsupported allele the posterior-of-absent is a tiny negative
        log10 (~-1e-12), which without the epsilon reads as "plausible" and
        stops the site from being monomorphic."""
        return (self.log10_p_ref_by_allele[allele] + 1.0e-10
                + phred_conf_threshold / 10.0) < 0

    def mle_count(self, allele):
        idx = self.alleles.index(allele) - 1
        return self.alt_allele_mle_counts[idx]


class AlleleFrequencyCalculator:
    def __init__(self, ref_pseudocount, snp_pseudocount, indel_pseudocount,
                 default_ploidy=C.SAMPLE_PLOIDY):
        self.ref_pseudocount = ref_pseudocount
        self.snp_pseudocount = snp_pseudocount
        self.indel_pseudocount = indel_pseudocount
        self.default_ploidy = default_ploidy

    @classmethod
    def make_calculator(cls, ploidy=C.SAMPLE_PLOIDY,
                        snp_heterozygosity=C.SNP_HETEROZYGOSITY,
                        indel_heterozygosity=C.INDEL_HETEROZYGOSITY,
                        het_stdev=C.HETEROZYGOSITY_STDEV):
        ref_pseudo = snp_heterozygosity / het_stdev ** 2
        return cls(ref_pseudo, snp_heterozygosity * ref_pseudo,
                   indel_heterozygosity * ref_pseudo, ploidy)

    def calculate(self, alleles, genotypes, default_ploidy=None):
        """alleles: [ref, alts...]; genotypes: list of Genotype with
        log10 likelihoods in canonical order."""
        default_ploidy = default_ploidy or self.default_ploidy
        n_alleles = len(alleles)
        ref_length = len(alleles[0])
        assert n_alleles > 1

        prior_pseudo = np.array([
            self.ref_pseudocount if a.is_ref
            else (self.snp_pseudocount
                  if (0 if a.is_symbolic else len(a)) == ref_length
                  else self.indel_pseudocount)
            for a in alleles])

        allele_counts = np.zeros(n_alleles)
        log10_af = np.full(n_alleles, -math.log10(n_alleles))

        usable = [g for g in genotypes if g.has_likelihoods]
        diff = np.inf
        while diff > THRESHOLD:
            new_counts = self._effective_allele_counts(usable, log10_af,
                                                       n_alleles)
            diff = np.max(np.abs(allele_counts - new_counts))
            allele_counts = new_counts
            posterior_pseudo = prior_pseudo + allele_counts
            log10_af = np.log10(posterior_pseudo / posterior_pseudo.sum())

        log10_p_no_variant = 0.0
        log10_p_zero_by_allele = np.zeros(n_alleles)
        span_del_present = any(a == SPAN_DEL for a in alleles)
        span_del_index = (alleles.index(SPAN_DEL) if span_del_present
                          else -1)

        for g in usable:
            ploidy = g.ploidy or default_ploidy
            posts = self._log10_genotype_posteriors(g, ploidy, n_alleles,
                                                    log10_af)
            if not span_del_present:
                log10_p_no_variant += posts[HOM_REF_INDEX]
            else:
                idxs = [ga.allele_counts_to_index(
                    [0, ploidy - n, span_del_index, n])
                    for n in range(ploidy + 1)]
                log10_p_no_variant += min(
                    0.0, gatk_math.log10_sum_log10(posts[idxs], axis=0))

            if n_alleles == 2 and not span_del_present:
                continue

            absent = ga.absent_allele_indices(ploidy, n_alleles)
            buckets = [[] for _ in range(n_alleles)]
            for gi, absent_alleles in enumerate(absent):
                for a in absent_alleles:
                    buckets[a].append(posts[gi])
            log10_p_no_allele = np.array([
                min(0.0, gatk_math.log10_sum_log10(np.array(b), axis=0))
                if b else 0.0
                for b in buckets])
            log10_p_zero_by_allele += log10_p_no_allele

        if n_alleles == 2 and not span_del_present:
            log10_p_zero_by_allele[1] = log10_p_no_variant

        mle = [int(round(x)) for x in allele_counts[1:]]
        by_allele = {alleles[i]: float(log10_p_zero_by_allele[i])
                     for i in range(1, n_alleles)}
        return AFCalculationResult(float(log10_p_no_variant), by_allele, mle,
                                   list(alleles))

    def _effective_allele_counts(self, genotypes, log10_af, n_alleles):
        counts = np.zeros(n_alleles)
        for g in genotypes:
            ploidy = g.ploidy or self.default_ploidy
            posts = self._log10_genotype_posteriors(g, ploidy, n_alleles,
                                                    log10_af)
            posts_linear = np.power(10.0, posts)
            for gi, pairs in enumerate(ga.allele_count_maps(ploidy,
                                                            n_alleles)):
                for a, count in pairs:
                    counts[a] += posts_linear[gi] * count
        return counts

    @staticmethod
    def _log10_genotype_posteriors(g, ploidy, n_alleles, log10_af):
        log10_lik = np.asarray(g.get_log10_likelihoods(), dtype=np.float64)
        comb = np.array(ga.log10_combination_counts(ploidy, n_alleles))
        af_term = np.array([
            sum(count * log10_af[a] for a, count in pairs)
            for pairs in ga.allele_count_maps(ploidy, n_alleles)])
        log10_posts = comb + log10_lik + af_term
        total = gatk_math.log10_sum_log10(log10_posts, axis=0)
        return log10_posts - total


def make_default_calculator():
    return AlleleFrequencyCalculator.make_calculator()
