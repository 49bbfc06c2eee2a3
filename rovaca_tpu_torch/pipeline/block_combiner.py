"""GVCF hom-ref block combiner.

Counterpart of the reference's BlockCombiner/HomRefBlock (reference:
src/haplotypecaller/genotype/block_combiner.{h,cpp},
hom_ref_block.{h,cpp}): consecutive hom-ref sites whose GQ falls in the same
band merge into one record with END=, MIN_DP, median DP, and the minimum PLs.
Variant records flush the open block and pass through.
"""

import numpy as np

from ..genotype.variant import NON_REF


class _GqStub:
    """gq fallback holder (used only when min_pls is None); module-level
    so from_run doesn't build a class per band row."""

    __slots__ = ("gq",)

    def __init__(self, gq):
        self.gq = gq


class HomRefBlock:
    def __init__(self, first_vc, band_lo, band_hi):
        g = first_vc.genotypes[0]
        self.contig = first_vc.contig
        self.start = first_vc.start
        self.stop = first_vc.stop
        self.ref = first_vc.ref
        self.sample = g.sample
        self.band_lo = band_lo
        self.band_hi = band_hi
        self.dp_chunks = [np.array([g.dp or 0])]
        self.min_pls = np.asarray(g.pl) if g.pl is not None else None
        self.genotype = g

    @classmethod
    def from_run(cls, contig, start, stop, ref_allele, sample, band_lo,
                 band_hi, dps, min_pls, gq):
        """Open a block directly from a hom-ref run's arrays."""
        blk = cls.__new__(cls)
        blk.contig = contig
        blk.start = start
        blk.stop = stop
        blk.ref = ref_allele
        blk.sample = sample
        blk.band_lo = band_lo
        blk.band_hi = band_hi
        blk.dp_chunks = [np.asarray(dps)]
        blk.min_pls = (np.asarray(min_pls) if min_pls is not None
                       else None)
        blk.genotype = _GqStub(gq)
        return blk

    def accepts(self, vc, band_lo):
        return (vc.contig == self.contig and vc.start == self.stop + 1
                and band_lo == self.band_lo)

    def accepts_run(self, contig, start, band_lo):
        return (contig == self.contig and start == self.stop + 1
                and band_lo == self.band_lo)

    def extend_run(self, stop, dps, run_min_pls):
        self.stop = stop
        self.dp_chunks.append(np.asarray(dps))
        if run_min_pls is not None:
            if self.min_pls is None:
                self.min_pls = np.asarray(run_min_pls)
            else:
                self.min_pls = np.minimum(self.min_pls, run_min_pls)

    def add(self, vc):
        g = vc.genotypes[0]
        self.stop = vc.stop
        self.dp_chunks.append(np.array([g.dp or 0]))
        if g.pl is not None:
            if self.min_pls is None:
                self.min_pls = np.asarray(g.pl)
            else:
                self.min_pls = np.minimum(self.min_pls, g.pl)

    def dp_median_min(self):
        # multiset median: odd -> middle; even -> round-half-away of the two
        # middle values (hom_ref_block.cpp:88-100 median_dp)
        s = np.sort(np.concatenate(self.dp_chunks))
        n = len(s)
        dp = (int(s[n // 2]) if n & 1
              else (int(s[n // 2]) + int(s[n // 2 - 1]) + 1) // 2)
        return dp, int(s[0])

    def to_variant(self):
        from ..genotype.variant import Genotype, Variant
        dp, min_dp = self.dp_median_min()
        pls = (self.min_pls.tolist() if self.min_pls is not None else None)
        g = Genotype(alleles=[self.ref, self.ref],
                     pl=pls, dp=dp,
                     gq=self.genotype.gq if pls is None else _gq(pls),
                     sample=self.sample,
                     attributes={"MIN_DP": min_dp})
        v = Variant(contig=self.contig, start=self.start, stop=self.stop,
                    alleles=[self.ref, NON_REF], genotypes=[g],
                    log10_error=1.0)
        if self.stop > self.start:
            v.attributes["END"] = self.stop + 1  # 1-based inclusive END
        else:
            v.attributes["END"] = self.stop + 1
        return v


def _gq(pls):
    """second-smallest PL minus smallest, capped at 99 at emission
    (rovaca_variant_context_utils.cpp:600-623, adapter_utils.cpp:324)."""
    s = sorted(pls)
    return min(int(s[1] - s[0]), 99)


class BlockCombiner:
    """Submit records in coordinate order; writes banded hom-ref blocks and
    passthrough variants (block_combiner.cpp; GQ bands from
    haplotypecaller.cpp:217-228)."""

    def __init__(self, gq_bands, writer):
        self.partitions = sorted(set(int(b) for b in gq_bands))
        self.writer = writer
        self.block = None

    def _band(self, gq):
        """(lo, hi) band containing gq; bands are [prev, band)."""
        gq = min(max(int(gq), 0), 99)
        prev = 0
        for b in self.partitions:
            if gq < b:
                return prev, b
            prev = b
        return prev, 100

    def submit(self, vc):
        is_hom_ref_block_site = (
            len(vc.alts) == 1 and vc.alts[0] == NON_REF
            and vc.genotypes and vc.genotypes[0].is_hom_ref())
        if not is_hom_ref_block_site:
            self._flush_block()
            self.writer.write(vc)
            return
        g = vc.genotypes[0]
        lo, hi = self._band(g.gq or 0)
        if self.block is not None and self.block.accepts(vc, lo):
            self.block.add(vc)
        else:
            self._flush_block()
            self.block = HomRefBlock(vc, lo, hi)

    def submit_span(self, span):
        """Banded block merging over a HomRefSpan's arrays — equivalent to
        per-position submit() of hom-ref records, without the objects.

        Bulk path: all segments strictly inside the span become finished
        band rows serialized in ONE writer call; only the first segment
        (may extend the open block) and the last (stays open for the next
        span) go through HomRefBlock objects. At 1Mb scale this is the
        GVCF wall-clock hot loop (~270k rows)."""
        L = len(span)
        if L == 0:
            return
        parts = np.asarray(self.partitions)
        gq = np.clip(np.asarray(span.gq), 0, 99)
        band_idx = np.searchsorted(parts, gq, side="right")
        cut = np.nonzero(np.diff(band_idx))[0] + 1
        starts = np.concatenate(([0], cut))
        ends = np.concatenate((cut, [L]))
        n_seg = starts.size
        from ..genotype.variant import Allele

        def open_run(s, e):
            bi = int(band_idx[s])
            lo = int(parts[bi - 1]) if bi > 0 else 0
            hi = int(parts[bi]) if bi < parts.size else 100
            gstart = span.start + s
            run_min_pls = span.pls[s:e].min(axis=0)
            dps = span.dp[s:e]
            if (self.block is not None
                    and self.block.accepts_run(span.contig, gstart, lo)):
                self.block.extend_run(gstart + (e - s) - 1, dps,
                                      run_min_pls)
                return
            self._flush_block()
            ref_allele = Allele(bytes([int(span.ref_bytes[s])]),
                                is_ref=True)
            self.block = HomRefBlock.from_run(
                span.contig, gstart, gstart + (e - s) - 1, ref_allele,
                span.sample, lo, hi, dps, run_min_pls,
                gq=int(span.gq[s]))

        fast = getattr(self.writer, "write_hom_ref_rows", None)
        if n_seg <= 2 or fast is None:
            for s, e in zip(starts.tolist(), ends.tolist()):
                open_run(s, e)
            return

        # first segment through the object path (open-block merge)
        open_run(int(starts[0]), int(ends[0]))
        self._flush_block()

        # middle segments: vectorized per-segment stats -> bulk rows
        mid_s, mid_e = starts[1:-1], ends[1:-1]
        # reduceat's final slice runs to the array end — append the last
        # segment's start as a sentinel boundary and drop its row
        seg_pls = np.minimum.reduceat(
            span.pls, np.concatenate([mid_s, starts[-1:]]), axis=0)[:-1]
        # GQ from min-PLs: second-smallest minus smallest, capped 99
        part = np.partition(seg_pls, 1, axis=1)
        seg_gq = np.minimum(part[:, 1] - part[:, 0], 99)
        dp_list = span.dp.tolist()
        ref_list = span.ref_bytes.tolist()
        pls_list = seg_pls.tolist()
        gq_list = seg_gq.tolist()
        s_list, e_list = mid_s.tolist(), mid_e.tolist()
        rows = []
        base = span.start
        contig = span.contig
        for k in range(len(s_list)):
            s, e = s_list[k], e_list[k]
            dps = sorted(dp_list[s:e])
            n = len(dps)
            dp = dps[n // 2] if n & 1 else (dps[n // 2]
                                            + dps[n // 2 - 1] + 1) // 2
            pls = pls_list[k]
            rows.append(
                f"{contig}\t{base + s + 1}\t.\t{chr(ref_list[s])}\t"
                f"<NON_REF>\t.\t.\tEND={base + e}\tGT:DP:GQ:MIN_DP:PL\t"
                f"0/0:{dp}:{gq_list[k]}:{dps[0]}:"
                f"{pls[0]},{pls[1]},{pls[2]}\n")
        fast(rows)

        # last segment stays open for the next span
        open_run(int(starts[-1]), int(ends[-1]))

    def _flush_block(self):
        if self.block is None:
            return
        b = self.block
        self.block = None
        fast = getattr(self.writer, "write_hom_ref_block", None)
        if fast is not None and b.min_pls is not None:
            dp, min_dp = b.dp_median_min()
            fast(b.contig, b.start, b.stop, b.ref.bases.decode(), dp,
                 _gq(b.min_pls.tolist()), min_dp, b.min_pls)
        else:
            self.writer.write(b.to_variant())

    def flush_batch(self):
        """RegionSource batch boundary: the reference calls force_output
        after every batch (haplotypecaller_engine.cpp:288-291), closing the
        open hom-ref block even when the next site would extend it."""
        self._flush_block()

    def flush_contig(self):
        self._flush_block()

    def finish(self):
        self._flush_block()
