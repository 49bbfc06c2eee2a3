"""Variant-calling domain model: Allele, Variant, Genotype.

Counterpart of the reference's pool-allocated object model (reference:
src/haplotypecaller/genotype/allele.{h,cpp}, variant.{h,cpp},
genotype.{h,cpp}, genotypes_context.hpp). Coordinates are 0-based internally,
start/stop inclusive (matching the reference's conventions); the VCF writer
converts to 1-based.
"""

import dataclasses
import functools


@functools.total_ordering
class Allele:
    __slots__ = ("bases", "is_ref", "is_symbolic")

    def __init__(self, bases, is_ref=False):
        if isinstance(bases, str):
            bases = bases.encode()
        self.bases = bytes(bases)
        self.is_ref = is_ref
        self.is_symbolic = self.bases.startswith(b"<") or self.bases in (b"*",)

    def __eq__(self, other):
        return (isinstance(other, Allele) and self.bases == other.bases
                and self.is_ref == other.is_ref)

    def __lt__(self, other):
        return (not self.is_ref, self.bases) < (not other.is_ref, other.bases)

    def __hash__(self):
        return hash((self.bases, self.is_ref))

    def __len__(self):
        return len(self.bases)

    def __repr__(self):
        return f"{self.bases.decode()}{'*' if self.is_ref else ''}"

    def same_bases(self, other):
        return self.bases == other.bases


SPAN_DEL = Allele(b"*")
NON_REF = Allele(b"<NON_REF>")
NO_CALL = Allele(b".")


def is_informative_allele(a):
    return not a.is_symbolic and a.bases != b"."


@dataclasses.dataclass
class Genotype:
    """Single-sample genotype call."""
    alleles: list                    # of Allele (NO_CALL when uncalled)
    pl: list = None                  # phred-scaled int likelihoods
    gq: int = None
    ad: list = None                  # depth per allele
    dp: int = None
    sample: str = "SAMPLE"
    phased: bool = False
    attributes: dict = dataclasses.field(default_factory=dict)
    log10_likelihoods: list = None   # raw GLs (pl = round(-10*gl) normalized)

    @property
    def ploidy(self):
        return len(self.alleles)

    @property
    def has_likelihoods(self):
        return self.pl is not None or self.log10_likelihoods is not None

    @property
    def is_called(self):
        return any(a is not NO_CALL and a.bases != b"." for a in self.alleles)

    def is_hom_ref(self):
        return self.is_called and all(a.is_ref for a in self.alleles)

    def is_het(self):
        return self.is_called and len({a.bases for a in self.alleles}) > 1

    def get_log10_likelihoods(self):
        if self.log10_likelihoods is not None:
            return self.log10_likelihoods
        return [p / -10.0 for p in self.pl]


@dataclasses.dataclass
class Variant:
    contig: str
    start: int                       # 0-based inclusive
    stop: int                        # 0-based inclusive
    alleles: list                    # [ref, alt...]
    genotypes: list = dataclasses.field(default_factory=list)
    attributes: dict = dataclasses.field(default_factory=dict)
    log10_error: float = 1.0         # log10(P(error)); qual = -10*log10_error
    source_id: int = 0
    id: str = "."

    @property
    def ref(self):
        return self.alleles[0]

    @property
    def alts(self):
        return self.alleles[1:]

    @property
    def n_alleles(self):
        return len(self.alleles)

    @property
    def qual(self):
        return -10.0 * self.log10_error

    @property
    def is_biallelic(self):
        return len(self.alleles) == 2

    def has_allele(self, allele):
        return any(a == allele for a in self.alleles)

    @property
    def is_snp(self):
        return (len(self.ref) == 1 and len(self.alts) >= 1
                and all(len(a) == 1 and not a.is_symbolic for a in self.alts))

    @property
    def is_simple_insertion(self):
        return (self.is_biallelic and len(self.ref) == 1
                and not self.alts[0].is_symbolic and len(self.alts[0]) > 1)

    @property
    def is_simple_deletion(self):
        return (self.is_biallelic and len(self.alts[0]) == 1
                and not self.alts[0].is_symbolic and len(self.ref) > 1)

    def overlaps_position(self, pos):
        return self.start <= pos <= self.stop

    def __repr__(self):
        alts = ",".join(a.bases.decode() for a in self.alts)
        return (f"Variant({self.contig}:{self.start + 1} "
                f"{self.ref.bases.decode()}>{alts})")
