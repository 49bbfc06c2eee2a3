"""VCF reading/writing.

Counterpart of the reference's htslib-backed writer (reference:
src/haplotypecaller/writer/writer.cpp:147-207) and the dbSNP VcfLoader
(src/IOStream/vcf_loader.h). Text VCF (optionally bgzipped) with the GATK
HaplotypeCaller header set; coordinate conversion from the internal 0-based
model happens here.
"""

import gzip

from ..genotype.variant import NON_REF

INFO_HEADERS = [
    ('AC', 'A', 'Integer', 'Allele count in genotypes, for each ALT allele, in the same order as listed'),
    ('AF', 'A', 'Float', 'Allele Frequency, for each ALT allele, in the same order as listed'),
    ('AN', '1', 'Integer', 'Total number of alleles in called genotypes'),
    ('BaseQRankSum', '1', 'Float', 'Z-score from Wilcoxon rank sum test of Alt Vs. Ref base qualities'),
    ('DP', '1', 'Integer', 'Approximate read depth; some reads may have been filtered'),
    ('END', '1', 'Integer', 'Stop position of the interval'),
    ('ExcessHet', '1', 'Float', 'Phred-scaled p-value for exact test of excess heterozygosity'),
    ('FS', '1', 'Float', "Phred-scaled p-value using Fisher's exact test to detect strand bias"),
    ('InbreedingCoeff', '1', 'Float', 'Inbreeding coefficient as estimated from the genotype likelihoods per-sample'),
    ('MLEAC', 'A', 'Integer', 'Maximum likelihood expectation (MLE) for the allele counts (not necessarily the same as the AC), for each ALT allele, in the same order as listed'),
    ('MLEAF', 'A', 'Float', 'Maximum likelihood expectation (MLE) for the allele frequency (not necessarily the same as the AF), for each ALT allele, in the same order as listed'),
    ('MQ', '1', 'Float', 'RMS Mapping Quality'),
    ('MQRankSum', '1', 'Float', 'Z-score From Wilcoxon rank sum test of Alt vs. Ref read mapping qualities'),
    ('QD', '1', 'Float', 'Variant Confidence/Quality by Depth'),
    ('RAW_MQandDP', '2', 'Integer', 'Raw data (sum of squared MQ and total depth) for improved RMS Mapping Quality calculation.'),
    ('ReadPosRankSum', '1', 'Float', 'Z-score from Wilcoxon rank sum test of Alt vs. Ref read position bias'),
    ('SOR', '1', 'Float', 'Symmetric Odds Ratio of 2x2 contingency table to detect strand bias'),
]

FORMAT_HEADERS = [
    ('GT', '1', 'String', 'Genotype'),
    ('AD', 'R', 'Integer', 'Allelic depths for the ref and alt alleles in the order listed'),
    ('DP', '1', 'Integer', 'Approximate read depth (reads with MQ=255 or with bad mates are filtered)'),
    ('GQ', '1', 'Integer', 'Genotype Quality'),
    ('MIN_DP', '1', 'Integer', 'Minimum DP observed within the GVCF block'),
    ('PGT', '1', 'String', 'Physical phasing haplotype information, describing how the alternate alleles are phased in relation to one another; will always be heterozygous and is not intended to describe called alleles'),
    ('PID', '1', 'String', 'Physical phasing ID information, where each unique ID within a given sample (but not across samples) connects records within a phasing group'),
    ('PL', 'G', 'Integer', 'Normalized, Phred-scaled likelihoods for genotypes as defined in the VCF specification'),
    ('PS', '1', 'Integer', 'Phasing set (typically the position of the first variant in the set)'),
    ('SB', '4', 'Integer', "Per-sample component statistics which comprise the Fisher's Exact Test to detect strand bias."),
]

INFO_ORDER = [name for name, *_ in INFO_HEADERS]


class _BgzfRaw:
    """Minimal io.RawIOBase-ish adapter over bgzf.Writer for TextIOWrapper."""

    def __init__(self, writer):
        self._w = writer

    def writable(self):
        return True

    def write(self, data):
        self._w.write(bytes(data))
        return len(data)

    def flush(self):
        pass

    def close(self):
        self._w.close()

    closed = False
    def readable(self):
        return False

    def seekable(self):
        return False


def _fmt(value):
    if isinstance(value, float):
        value += 0.0  # normalize -0.0
        if value == int(value) and abs(value) < 1e15:
            return f"{value:.2f}"
        return f"{value:g}" if abs(value) >= 1e-3 else f"{value:.3e}"
    if isinstance(value, (list, tuple)):
        return ",".join(_fmt(v) for v in value)
    return str(value)


class VcfWriter:
    def __init__(self, path, contig_dict, sample="SAMPLE", gvcf=False,
                 gq_bands=None, command_line=None, append=False,
                 compression_level=6):
        self.gvcf = gvcf
        self.path = path
        if path.endswith(".gz"):
            # BGZF (not plain gzip) so tabix/htslib tooling can index it;
            # append continues BGZF blocks before a fresh EOF marker
            # (resume support, utils/checkpoint.py)
            import io as _io

            from . import bgzf
            self._fh = _io.TextIOWrapper(
                _BgzfRaw(bgzf.Writer(path, compression_level,
                                     append=append)))
        else:
            self._fh = open(path, "at" if append else "wt")
        self.sample = sample
        if not append:
            self._write_header(contig_dict, gq_bands or [], command_line)
        self.records_written = 0

    def _write_header(self, contig_dict, gq_bands, command_line):
        w = self._fh.write
        w("##fileformat=VCFv4.2\n")
        if self.gvcf:
            w('##ALT=<ID=NON_REF,Description="Represents any possible '
              'alternative allele not already represented at this location '
              'by REF and ALT alleles">\n')
            prev = 0
            for band in gq_bands:
                w(f"##GVCFBlock{prev}-{band}=minGQ={prev}(inclusive),"
                  f"maxGQ={band}(exclusive)\n")
                prev = band
        for name, number, typ, desc in FORMAT_HEADERS:
            w(f'##FORMAT=<ID={name},Number={number},Type={typ},'
              f'Description="{desc}">\n')
        for name, number, typ, desc in INFO_HEADERS:
            w(f'##INFO=<ID={name},Number={number},Type={typ},'
              f'Description="{desc}">\n')
        if command_line:
            w(f"##rovaca_tpuCommandLine={command_line}\n")
        for contig, length in contig_dict.items():
            w(f"##contig=<ID={contig},length={length}>\n")
        w("##source=rovaca_tpu HaplotypeCaller\n")
        w("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
          f"{self.sample}\n")

    def write(self, variant):
        v = variant
        alts = ",".join(a.bases.decode() for a in v.alts) or "."
        qual = "." if v.log10_error >= 0 else f"{v.qual:.2f}"
        info_items = []
        for key in INFO_ORDER:
            if key in v.attributes:
                info_items.append(f"{key}={_fmt(v.attributes[key])}")
        for key in sorted(v.attributes):
            if key not in INFO_ORDER:
                info_items.append(f"{key}={_fmt(v.attributes[key])}")
        info = ";".join(info_items) or "."

        fmt_keys = ["GT"]
        g = v.genotypes[0] if v.genotypes else None
        sample_fields = []
        if g is not None:
            allele_index = {}
            for i, a in enumerate(v.alleles):
                allele_index.setdefault((a.bases, a.is_ref), i)
            gt_idx = []
            for a in g.alleles:
                if a.bases == b".":
                    gt_idx.append(".")
                else:
                    gt_idx.append(str(allele_index.get((a.bases, a.is_ref),
                                                       ".")))
            sep = "|" if g.phased else "/"
            sample_fields.append(sep.join(gt_idx))
            if g.ad is not None:
                fmt_keys.append("AD")
                sample_fields.append(",".join(str(x) for x in g.ad))
            if g.dp is not None:
                fmt_keys.append("DP")
                sample_fields.append(str(g.dp))
            if g.gq is not None:
                fmt_keys.append("GQ")
                sample_fields.append(str(g.gq))
            if "MIN_DP" in g.attributes:
                fmt_keys.append("MIN_DP")
                sample_fields.append(str(g.attributes["MIN_DP"]))
            if "PGT" in g.attributes:
                fmt_keys.append("PGT")
                sample_fields.append(str(g.attributes["PGT"]))
                fmt_keys.append("PID")
                sample_fields.append(str(g.attributes["PID"]))
            if g.pl is not None:
                fmt_keys.append("PL")
                sample_fields.append(",".join(str(int(x)) for x in g.pl))
            if "PS" in g.attributes:
                fmt_keys.append("PS")
                sample_fields.append(str(g.attributes["PS"]))
            if "SB" in g.attributes:
                fmt_keys.append("SB")
                sample_fields.append(",".join(str(x)
                                              for x in g.attributes["SB"]))

        row = [v.contig, str(v.start + 1), v.id, v.ref.bases.decode(), alts,
               qual, ".", info]
        if g is not None:
            row.append(":".join(fmt_keys))
            row.append(":".join(sample_fields))
        self._fh.write("\t".join(row) + "\n")
        self.records_written += 1

    def write_hom_ref_rows(self, rows):
        """Bulk path for pre-serialized GVCF band rows (block_combiner's
        vectorized middle segments): one fh.write per span."""
        if rows:
            self._fh.write("".join(rows))
            self.records_written += len(rows)

    def write_hom_ref_block(self, contig, start, stop, ref_base, dp, gq,
                            min_dp, pls):
        """Fast path for GVCF hom-ref band rows (the vast majority of
        GVCF output): formats the fixed GT:DP:GQ:MIN_DP:PL shape directly,
        byte-identical to write() on the equivalent Variant."""
        pl = ",".join(str(int(x)) for x in pls)
        self._fh.write(
            f"{contig}\t{start + 1}\t.\t{ref_base}\t<NON_REF>\t.\t.\t"
            f"END={stop + 1}\tGT:DP:GQ:MIN_DP:PL\t"
            f"0/0:{dp}:{gq}:{min_dp}:{pl}\n")
        self.records_written += 1

    def close(self):
        self._fh.close()
        # gz outputs get a .tbi alongside, like the reference
        # (writer.cpp:97-98; non-gz outputs are not indexed)
        if self.path.endswith(".gz"):
            try:
                from . import tabix
                tabix.build_index(self.path)
            except (ValueError, OSError):
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class VcfReader:
    """Minimal VCF reader for dbSNP ID lookups (VcfLoader counterpart).

    A bgzipped VCF with a .tbi next to it is queried through the index
    (htslib tabix role); otherwise the whole file is loaded eagerly."""

    def __init__(self, path):
        import os
        self.path = path
        self._tbi = None
        self.by_contig = {}
        if path.endswith(".gz") and os.path.exists(path + ".tbi"):
            from . import tabix
            self._tbi = tabix.TabixIndex.load(path + ".tbi")
            return
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as fh:
            for line in fh:
                if line.startswith("#"):
                    continue
                f = line.rstrip("\n").split("\t")
                if len(f) < 5:
                    continue
                contig, pos, rsid, ref, alts = (f[0], int(f[1]) - 1, f[2],
                                                f[3], f[4])
                flt = f[6] if len(f) > 6 else "."
                self.by_contig.setdefault(contig, []).append(
                    (pos, ref, alts.split(","), rsid, flt))
        for contig in self.by_contig:
            self.by_contig[contig].sort()

    @staticmethod
    def _events(start, ref, alts):
        """Biallelic (start, ref, alt) events: a biallelic record is taken
        AS-IS; multi-allelic alts are suffix- then prefix-trimmed with
        the start advanced (split_variant_context_to_biallelics +
        trim_alleles, rovaca_variant_context_utils.cpp:650-695)."""
        if len(alts) == 1:
            return [(start, ref, alts[0])]
        out = []
        for alt in alts:
            r, a, s = ref, alt, start
            if not a.startswith("<") and a != "*":
                while len(r) > 1 and len(a) > 1 and r[-1] == a[-1]:
                    r, a = r[:-1], a[:-1]
                while len(r) > 1 and len(a) > 1 and r[0] == a[0]:
                    r, a, s = r[1:], a[1:], s + 1
            out.append((s, r, a))
        return out

    def lookup_id(self, contig, start, ref_bases, alt_bases_list):
        """';'-joined rsIDs of unfiltered dbSNP records at the call start
        that share a biallelic event with the call, else None
        (variant_annotator_engine.cpp:99-170: same start, FILTER empty,
        and at least one (start, ref, alt) event in common)."""
        ref_s = ref_bases.decode() if isinstance(ref_bases, bytes) \
            else ref_bases
        alt_s = [a.decode() if isinstance(a, bytes) else a
                 for a in alt_bases_list]
        call_events = set(self._events(start, ref_s, alt_s))

        if self._tbi is not None:
            from . import tabix
            rows = []
            for line in tabix.fetch_lines(self.path, self._tbi, contig,
                                          start, start + 1):
                f = line.split("\t")
                if len(f) >= 5 and int(f[1]) - 1 == start:
                    rows.append((start, f[3], f[4].split(","), f[2],
                                 f[6] if len(f) > 6 else "."))
        else:
            import bisect
            all_rows = self.by_contig.get(contig, [])
            i = bisect.bisect_left(all_rows, (start, "", [], "", ""))
            rows = []
            while i < len(all_rows) and all_rows[i][0] == start:
                rows.append(all_rows[i])
                i += 1

        ids = []
        for pos, ref, alts, rsid, flt in rows:
            if flt not in (".", ""):
                continue   # the reference skips any filtered record
            if any(ev in call_events
                   for ev in self._events(pos, ref, alts)):
                ids.append(rsid)
        return ";".join(ids) if ids else None
