"""Read-vs-allele likelihood container and marginalization.

Counterpart of the reference's AlleleLikelihoods (reference:
src/haplotypecaller/genotype/allele_likelihoods.hpp:189-379): a
(alleles x reads) log10 matrix with marginalization from haplotypes to
alleles (per-read max over supporting haplotypes), overlap-based evidence
retention, NON_REF augmentation (per-read max of the non-best alleles), and
tie-broken best-allele queries.
"""

import dataclasses

import numpy as np

from .variant import NON_REF

INFORMATIVE_THRESHOLD = 0.2  # log10 margin for best-allele informativeness


@dataclasses.dataclass
class AlleleLikelihoods:
    alleles: list            # Allele or Haplotype objects
    reads: list              # ReadRecord
    matrix: np.ndarray       # (n_alleles, n_reads) float64 log10
    filtered_reads: list = dataclasses.field(default_factory=list)

    @property
    def n_alleles(self):
        return len(self.alleles)

    @property
    def n_reads(self):
        return len(self.reads)

    def index_of(self, allele):
        return self.alleles.index(allele)

    def marginalize(self, new_alleles, allele_to_old):
        """Per-read max over the old alleles (haplotypes) mapped to each new
        allele (allele_likelihoods.hpp:189)."""
        old_index = {id(a): i for i, a in enumerate(self.alleles)}
        rows = []
        for allele in new_alleles:
            olds = allele_to_old[allele]
            idxs = [old_index[id(o)] for o in olds]
            if idxs:
                rows.append(self.matrix[idxs].max(axis=0))
            else:
                rows.append(np.full(self.n_reads, -np.inf))
        return AlleleLikelihoods(list(new_alleles), list(self.reads),
                                 np.array(rows))

    def retain_evidence(self, predicate):
        """Keep reads where predicate(read) is true
        (allele_likelihoods.hpp:224 retain by overlap)."""
        keep = [i for i, r in enumerate(self.reads) if predicate(r)]
        self.reads = [self.reads[i] for i in keep]
        self.matrix = self.matrix[:, keep] if keep else self.matrix[:, :0]

    def retain_overlapping(self, start, stop):
        """Reads overlapping [start, stop] (0-based inclusive)."""
        self.retain_evidence(lambda r: r.pos <= stop and r.end - 1 >= start)

    def add_non_reference_allele(self):
        """NON_REF likelihood per read = MEDIAN of the allele likelihoods
        STRICTLY below the read's best; if none qualify, the best
        likelihood itself when >=2 concrete alleles exist, else NaN
        (add_non_reference_allele + update_non_ref_allele_likelihoods +
        evaluate, allele_likelihoods.hpp:255-403). With two concrete
        alleles this reduces to the second-best value; at multiallelic
        sites (e.g. ref/*/alt in GVCF) the median over the below-best
        pair differs from a plain second-best."""
        if any(a is NON_REF or a == NON_REF for a in self.alleles):
            return
        if self.n_reads == 0 or self.n_alleles == 0:
            self.alleles = list(self.alleles) + [NON_REF]
            self.matrix = np.vstack([self.matrix,
                                     np.full((1, self.n_reads), -np.inf)])
            return
        m = self.matrix
        n_concrete = self.n_alleles
        best_lik = m.max(axis=0)
        non_ref = np.empty(self.n_reads)
        for r in range(self.n_reads):
            qualified = m[:, r][m[:, r] < best_lik[r]]
            if qualified.size:
                non_ref[r] = np.median(qualified)
            elif n_concrete > 1:
                non_ref[r] = best_lik[r]
            else:
                non_ref[r] = np.nan
        self.alleles = list(self.alleles) + [NON_REF]
        self.matrix = np.vstack([m, non_ref[None, :]])

    def update_non_ref_likelihoods(self, alleles_to_consider):
        """Refresh the NON_REF row considering only `alleles_to_consider`
        (update_non_ref_allele_likelihoods(AlleleListPtr),
        allele_likelihoods.hpp:278-318): per read, NON_REF = median of
        the CONSIDERED concrete-allele likelihoods strictly below the
        read's best; fallback best (>=2 concrete alleles) else NaN.
        No-op when the container has no NON_REF allele (VCF mode)."""
        nr = next((i for i, a in enumerate(self.alleles) if a == NON_REF),
                  None)
        if nr is None or self.n_reads == 0:
            return
        m = self.matrix
        consider = np.array(
            [i for i, a in enumerate(self.alleles)
             if i != nr and any(a == c for c in alleles_to_consider)],
            dtype=np.int64)
        n_concrete = self.n_alleles - 1
        best = np.nanmax(m, axis=0)
        for r in range(self.n_reads):
            vals = m[consider, r] if consider.size else np.empty(0)
            vals = vals[~np.isnan(vals) & (vals < best[r])]
            if vals.size:
                m[nr, r] = np.median(vals)
            elif n_concrete <= 1:
                m[nr, r] = np.nan
            else:
                m[nr, r] = best[r]

    def subset_to_alleles(self, call_alleles):
        """New container whose rows are the call's alleles, each mapped to
        its own likelihood row (the marginalize inside AD's
        annotate_with_likelihoods, depth_per_allele_by_sample.h) — drops
        non-call alleles (e.g. spanning '*') so best/informativeness are
        recomputed over the subset."""
        rows = []
        for a in call_alleles:
            i = next((j for j, b in enumerate(self.alleles) if b == a),
                     None)
            rows.append(self.matrix[i] if i is not None
                        else np.full(self.n_reads, -np.inf))
        return AlleleLikelihoods(list(call_alleles), list(self.reads),
                                 np.array(rows) if rows
                                 else self.matrix[:0])

    def best_allele_per_read(self):
        """(best_index, best_lik, second_lik, informative) per read
        (best_alleles_breaking_ties, allele_likelihoods.hpp:346-379);
        ties broken in favor of the reference allele (index 0)."""
        m = self.matrix
        n_reads = self.n_reads
        best_idx = np.zeros(n_reads, dtype=np.int64)
        best = np.full(n_reads, -np.inf)
        second = np.full(n_reads, -np.inf)
        for a in range(self.n_alleles):
            row = m[a]
            better = row > best
            tie = (row == best) & (best_idx != 0)
            second = np.where(better, best, np.maximum(second, row))
            best_idx = np.where(better, a, best_idx)
            best = np.where(better, row, best)
            del tie
        informative = (best - second) > INFORMATIVE_THRESHOLD
        return best_idx, best, second, informative

    def sample_matrix(self):
        return self.matrix
