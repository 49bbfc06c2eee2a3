"""CIGAR representation and arithmetic.

Covers the roles of the reference's cigar_builder/cigar_utils
(reference: src/haplotypecaller/genotype/cigar_builder.cpp,
genotype/utils/cigar_utils.cpp): parsing, lengths, clipping arithmetic and
validation used across assembly and genotyping.
"""

import re
from enum import IntEnum


class CigarOp(IntEnum):
    M = 0
    I = 1  # noqa: E741
    D = 2
    N = 3
    S = 4
    H = 5
    P = 6
    EQ = 7
    X = 8


OP_CHARS = "MIDNSHP=X"
CHAR_TO_OP = {c: CigarOp(i) for i, c in enumerate(OP_CHARS)}

CONSUMES_QUERY = frozenset(
    {CigarOp.M, CigarOp.I, CigarOp.S, CigarOp.EQ, CigarOp.X})
CONSUMES_REF = frozenset(
    {CigarOp.M, CigarOp.D, CigarOp.N, CigarOp.EQ, CigarOp.X})
CLIP_OPS = frozenset({CigarOp.S, CigarOp.H})
ALIGNMENT_OPS = frozenset({CigarOp.M, CigarOp.EQ, CigarOp.X})

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


class Cigar:
    """An immutable list of (CigarOp, length) elements."""

    __slots__ = ("elements", "_ref_len")

    def __init__(self, elements=()):
        self.elements = tuple((CigarOp(op), int(n)) for op, n in elements)
        self._ref_len = None

    @classmethod
    def from_raw(cls, elements):
        """Trusted (CigarOp, int) tuples — skips validation/conversion."""
        c = cls.__new__(cls)
        c.elements = tuple(elements)
        c._ref_len = None
        return c

    @classmethod
    def from_string(cls, s):
        if s == "*" or not s:
            return cls()
        parsed = _CIGAR_RE.findall(s)
        if sum(len(n) + 1 for n, _ in parsed) != len(s):
            raise ValueError(f"bad cigar: {s!r}")
        return cls((CHAR_TO_OP[c], int(n)) for n, c in parsed)

    def __str__(self):
        return "".join(f"{n}{OP_CHARS[op]}" for op, n in self.elements) or "*"

    def __repr__(self):
        return f"Cigar({self})"

    def __len__(self):
        return len(self.elements)

    def __iter__(self):
        return iter(self.elements)

    def __getitem__(self, i):
        return self.elements[i]

    def __eq__(self, other):
        return isinstance(other, Cigar) and self.elements == other.elements

    def __hash__(self):
        return hash(self.elements)

    @property
    def query_length(self):
        return sum(n for op, n in self.elements if op in CONSUMES_QUERY)

    @property
    def reference_length(self):
        # memoized: read.end is evaluated millions of times in region loops
        if self._ref_len is None:
            self._ref_len = sum(n for op, n in self.elements
                                if op in CONSUMES_REF)
        return self._ref_len

    @property
    def is_empty(self):
        return not self.elements

    def count(self, op):
        return sum(n for o, n in self.elements if o == op)

    @property
    def left_soft_clip(self):
        for op, n in self.elements:
            if op == CigarOp.H:
                continue
            return n if op == CigarOp.S else 0
        return 0

    @property
    def right_soft_clip(self):
        for op, n in reversed(self.elements):
            if op == CigarOp.H:
                continue
            return n if op == CigarOp.S else 0
        return 0

    def normalized(self):
        """Merge adjacent same-op elements, drop zero-length elements."""
        out = []
        for op, n in self.elements:
            if n == 0:
                continue
            if out and out[-1][0] == op:
                out[-1] = (op, out[-1][1] + n)
            else:
                out.append((op, n))
        return Cigar(out)

    def without_clips(self):
        return Cigar((op, n) for op, n in self.elements if op not in CLIP_OPS)

    def is_valid(self):
        """Structural validity per SAM spec (the is_good_cigar-style checks,
        reference: src/common/reads_filter_lib.h)."""
        if not self.elements:
            return True
        ops = [op for op, _ in self.elements]
        n = len(ops)
        for i, op in enumerate(ops):
            if op == CigarOp.H and i not in (0, n - 1):
                return False
            if op == CigarOp.S:
                before = [o for o in ops[:i] if o not in CLIP_OPS]
                after = [o for o in ops[i + 1:] if o not in CLIP_OPS]
                if before and after:
                    return False
        if all(op in CLIP_OPS for op in ops):
            return True
        body = [op for op in ops if op not in CLIP_OPS]
        if body[0] == CigarOp.D or body[-1] == CigarOp.D:
            return False
        return True


def cigar_from_array(ops, lens):
    return Cigar(zip(ops, lens))
