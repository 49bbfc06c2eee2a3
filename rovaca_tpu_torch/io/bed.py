"""BED interval handling (WES target regions).

Counterpart of the reference's BedLoader (reference: src/IOStream/
bed_loader.h:13-48): per-contig sorted interval lists, a merged union, and a
padded union (user padding plus the fixed WES pre-padding of 100).
"""

import numpy as np

from .. import constants as C


def merge_intervals(intervals):
    """Merge overlapping/adjacent (start, end) pairs; returns sorted list."""
    if not intervals:
        return []
    ivs = sorted(intervals)
    out = [list(ivs[0])]
    for s, e in ivs[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


class BedFile:
    def __init__(self, path=None, contig_dict=None, padding=0):
        """contig_dict bounds-clamps padded intervals; must come from the
        FASTA dict (the reference asserts it is initialized after FASTA,
        bed_loader.h:25-27)."""
        self.contig_dict = contig_dict or {}
        self.padding = padding
        self.by_contig = {}
        if path:
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line or line.startswith(("#", "track", "browser")):
                        continue
                    f = line.split("\t")
                    self.by_contig.setdefault(f[0], []).append(
                        (int(f[1]), int(f[2])))
        for contig in self.by_contig:
            self.by_contig[contig] = merge_intervals(self.by_contig[contig])

    @classmethod
    def from_intervals(cls, intervals, contig_dict=None, padding=0):
        bed = cls(contig_dict=contig_dict, padding=padding)
        for contig, s, e in intervals:
            bed.by_contig.setdefault(contig, []).append((s, e))
        for contig in bed.by_contig:
            bed.by_contig[contig] = merge_intervals(bed.by_contig[contig])
        return bed

    def intervals(self, contig):
        return self.by_contig.get(contig, [])

    def padded_intervals(self, contig, extra=C.WES_PREPADDING):
        """User padding + fixed WES pre-padding, merged and clamped
        (bed_loader.h:29-48)."""
        length = self.contig_dict.get(contig)
        pad = self.padding + extra
        out = []
        for s, e in self.intervals(contig):
            ps, pe = s - pad, e + pad
            ps = max(0, ps)
            if length is not None:
                pe = min(length, pe)
            out.append((ps, pe))
        return merge_intervals(out)

    def mask(self, contig, start, end, padded=False):
        """Boolean array over [start, end) marking in-target positions
        (the BED bitset of ActiveMainThread.cpp:211-256)."""
        m = np.zeros(end - start, dtype=bool)
        ivs = (self.padded_intervals(contig) if padded
               else self.intervals(contig))
        for s, e in ivs:
            lo, hi = max(s, start), min(e, end)
            if lo < hi:
                m[lo - start:hi - start] = True
        return m

    def overlaps(self, contig, start, end):
        for s, e in self.intervals(contig):
            if s < end and e > start:
                return True
        return False

    def __bool__(self):
        return bool(self.by_contig)
