"""Canonical genotype (allele-count) enumeration and index math.

Counterpart of the reference's GenotypeAlleleCounts / caches (reference:
src/haplotypecaller/genotype/genotype_allele_counts.cpp,
genotype_allele_counts_manger.hpp, genotype_num_likelihoods_cache.hpp):
genotypes of ploidy P over A alleles in VCF canonical order, with
log10 combination counts and allele-count <-> index conversions.
"""

import functools
import math
from math import comb, lgamma

LOG10_E = math.log10(math.e)


@functools.lru_cache(maxsize=None)
def genotype_count(ploidy, n_alleles):
    """Number of genotypes = C(P + A - 1, P)."""
    return comb(ploidy + n_alleles - 1, ploidy)


@functools.lru_cache(maxsize=None)
def enumerate_genotypes(ploidy, n_alleles):
    """All genotypes in VCF canonical order as sorted allele tuples.

    Order: recursively, genotypes whose max allele is m come after all
    genotypes with max allele < m (e.g. P=2,A=3: 0/0, 0/1, 1/1, 0/2, 1/2,
    2/2) — the PL ordering of the VCF spec and GATK.
    """
    if ploidy == 0:
        return ((),)
    out = []
    for m in range(n_alleles):
        for g in enumerate_genotypes(ploidy - 1, m + 1):
            out.append(g + (m,))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def genotype_index(allele_tuple):
    """Canonical index of a genotype given as a sorted allele tuple:
    sum_k C(a_k + k, k + 1) for k = 0..P-1."""
    return sum(comb(a + k, k + 1) for k, a in enumerate(allele_tuple))


def allele_counts_to_index(allele_count_pairs):
    """From flat [allele, count, allele, count, ...] pairs
    (GenotypeLikelihoodCalculator::allele_counts_to_index)."""
    alleles = []
    for i in range(0, len(allele_count_pairs), 2):
        a, c = allele_count_pairs[i], allele_count_pairs[i + 1]
        alleles.extend([a] * c)
    return genotype_index(tuple(sorted(alleles)))


@functools.lru_cache(maxsize=None)
def allele_count_maps(ploidy, n_alleles):
    """Per genotype: tuple of (allele, count) pairs, distinct alleles."""
    out = []
    for g in enumerate_genotypes(ploidy, n_alleles):
        counts = {}
        for a in g:
            counts[a] = counts.get(a, 0) + 1
        out.append(tuple(sorted(counts.items())))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def log10_combination_counts(ploidy, n_alleles):
    """log10 multinomial coefficient P! / prod(count!) per genotype."""
    out = []
    for counts in allele_count_maps(ploidy, n_alleles):
        v = lgamma(ploidy + 1)
        for _, c in counts:
            v -= lgamma(c + 1)
        out.append(v * LOG10_E)
    return tuple(out)


def absent_allele_indices(ploidy, n_alleles):
    """Per genotype: alleles NOT present (for_each_absent_allele_index)."""
    out = []
    for counts in allele_count_maps(ploidy, n_alleles):
        present = {a for a, _ in counts}
        out.append(tuple(a for a in range(n_alleles) if a not in present))
    return out
