"""Allele subsetting: reduce allele sets and re-derive genotypes.

Counterpart of the reference's AlleleSubsettingUtils (reference:
src/haplotypecaller/genotype/allele_subsetting_utils.cpp; GATK
AlleleSubsettingUtils): most-likely-allele selection when too many alts,
likelihood subsetting to a new allele list, and genotype (GT/PL/GQ)
assignment.
"""

import numpy as np

from . import genotype_alleles as ga
from .likelihood_calc import gls_to_pls, gq_from_pls
from .variant import NO_CALL, NON_REF, Genotype

PL_INDEX_OF_HOM_REF = 0


def calculate_most_likely_alleles(alleles, genotypes, ploidy,
                                  max_alt_alleles):
    """Keep ref + the top alts by likelihood support
    (AlleleSubsettingUtils::calculate_most_likely_alleles)."""
    n_alleles = len(alleles)
    sums = np.zeros(n_alleles)
    for g in genotypes:
        if not g.has_likelihoods:
            continue
        gls = np.asarray(g.get_log10_likelihoods())
        best = int(np.argmax(gls))
        if best == PL_INDEX_OF_HOM_REF:
            continue
        diff = gls[best] - gls[PL_INDEX_OF_HOM_REF]
        for a, _count in ga.allele_count_maps(ploidy, n_alleles)[best]:
            if a != 0:
                sums[a] += diff

    alt_order = sorted(range(1, n_alleles),
                       key=lambda a: (-sums[a], a))
    # NON_REF is always kept last if present
    keep_alts = []
    non_ref = None
    for a in alt_order:
        if alleles[a] == NON_REF:
            non_ref = a
            continue
        if len(keep_alts) < max_alt_alleles:
            keep_alts.append(a)
    keep = [0] + sorted(keep_alts)
    if non_ref is not None:
        keep.append(non_ref)
    return [alleles[i] for i in keep]


def subsetted_pl_indices(ploidy, original_alleles, new_alleles):
    """For each new genotype, the old genotype index with matching allele
    counts."""
    old_index = {id(a): i for i, a in enumerate(original_alleles)}
    by_eq = {}
    for i, a in enumerate(original_alleles):
        by_eq.setdefault((a.bases, a.is_ref), i)
    mapping = []
    for a in new_alleles:
        idx = old_index.get(id(a))
        if idx is None:
            idx = by_eq[(a.bases, a.is_ref)]
        mapping.append(idx)
    out = []
    for g in ga.enumerate_genotypes(ploidy, len(new_alleles)):
        old_tuple = tuple(sorted(mapping[a] for a in g))
        out.append(ga.genotype_index(old_tuple))
    return out


def subset_alleles(genotypes, ploidy, original_alleles, new_alleles,
                   assignment="USE_PLS_TO_ASSIGN", sample="SAMPLE"):
    """New genotypes over new_alleles with subsetted likelihoods
    (AlleleSubsettingUtils::subset_alleles)."""
    indices = subsetted_pl_indices(ploidy, original_alleles, new_alleles)
    out = []
    for g in genotypes:
        if not g.has_likelihoods:
            out.append(g)
            continue
        old = np.asarray(g.get_log10_likelihoods())
        new = old[indices]
        new = new - new.max()
        pls = gls_to_pls(new)
        if assignment == "USE_PLS_TO_ASSIGN":
            best = int(np.argmax(new))
            gt = [new_alleles[a]
                  for a in ga.enumerate_genotypes(ploidy,
                                                  len(new_alleles))[best]]
        else:  # BEST_MATCH_TO_ORIGINAL / SET_TO_NO_CALL
            gt = [NO_CALL] * ploidy
        ad = None
        if g.ad is not None:
            old_ad_idx = [original_alleles.index(a) for a in new_alleles]
            ad = [g.ad[i] for i in old_ad_idx]
        out.append(Genotype(alleles=gt, pl=list(pls),
                            gq=gq_from_pls(pls),
                            ad=ad, dp=g.dp,
                            sample=g.sample, attributes=dict(g.attributes)))
    return out


def subset_to_ref_only(genotypes, ploidy, ref_allele):
    """All-ref genotypes with no likelihoods
    (ROVACAVariantContextUtils::subset_to_ref_only)."""
    return [Genotype(alleles=[ref_allele] * ploidy, sample=g.sample)
            for g in genotypes]
