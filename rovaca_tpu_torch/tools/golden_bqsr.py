"""BQSR golden equivalence: this package and the reference binary on the
same BAM with the same GATKReport recalibration table.

Counterpart of scripts/golden_bqsr.py. Because BQSR recalibrates base
quals before any calling, an exact VCF match (QUAL/PL/annotations) under a
table that shifts quals non-trivially is end-to-end evidence that the
recalibration math agrees (hierarchical Bayesian empirical-qual deltas over
RG/QS/Context/Cycle covariates — reference:
src/haplotypecaller/bqsr/bqsr_read_transformer.cpp:170-243, table parse
:245-372).

The generated table exercises every lookup level:
  - RecalTable0: one row a read group, the two groups shifted apart
  - RecalTable1: rows for every qual in the BAM, shifted empirical quals
  - RecalTable2: Context rows (all 16 2-mers) and Cycle rows (+-1..100),
    mixed signs

``generate`` writes the corpus of ``golden_e2e.generate`` and the table,
as the script does for the same seed; ``run_ours`` runs this package's
HaplotypeCaller with ``--bqsr-recal-table`` into ``ours.vcf`` (on the card
by default); ``run_ref`` runs the reference binary into ``ref.vcf`` and
stops with one line without it; ``diff`` holds the two with
``golden_e2e.diff``. ``golden`` holds ``ours.vcf`` of the default corpus
to rovaca_tpu's xla VCF of it, committed as
tests/golden_torch/bqsr_full.vcf.xz.

    python -m rovaca_tpu_torch.tools.golden_bqsr gen  <dir> [len] [cov] [seed]
    python -m rovaca_tpu_torch.tools.golden_bqsr ours <dir>
        [--engine auto|cuda|torch|native]
    python -m rovaca_tpu_torch.tools.golden_bqsr ref  <dir>
    python -m rovaca_tpu_torch.tools.golden_bqsr diff <dir>
    python -m rovaca_tpu_torch.tools.golden_bqsr golden <dir> [--engine ...]
"""

import argparse
import itertools
import os
import sys

from . import golden_e2e, golden_flows

CORPUS = dict(genome_len=60_000, coverage=25, seed=20260820)
QUALS = range(2, 51)     # simdata's quals span ~2..40: cover generously
REFERENCE = "bqsr_full.vcf.xz"
CORPUS_KEY = "corpus_bqsr"


def write_recal_table(path, quals, rgs=("rg1", "rg2")):
    """A GATKReport exercising RG/QS/Context/Cycle lookups
    (format: bqsr_read_transformer.cpp:254-293 sscanf protocol)."""
    args_rows = [
        ("binary_tag_name", "null"),
        ("covariate",
         "ReadGroupCovariate,QualityScoreCovariate,"
         "ContextCovariate,CycleCovariate"),
        ("default_platform", "null"),
        ("deletions_default_quality", "45"),
        ("force_platform", "null"),
        ("indels_context_size", "3"),
        ("insertions_default_quality", "45"),
        ("low_quality_tail", "2"),
        ("maximum_cycle_value", "500"),
        ("mismatches_context_size", "2"),
        ("mismatches_default_quality", "-1"),
        ("no_standard_covs", "false"),
        ("quantizing_levels", "16"),
        ("solid_nocall_strategy", "THROW_EXCEPTION"),
        ("solid_recal_mode", "SET_Q_ZERO"),
    ]
    quant_rows = [(q, 1000, q) for q in range(94)]  # identity (ignored)

    # RG rows: estimated reported 37.0, slight excess errors; the
    # second group skews the other way to make RG lookups observable
    rg_rows = [(rg, "M", f"{36.5 + 0.8 * k:.4f}", "37.0000",
                1_000_000, 800.00) for k, rg in enumerate(rgs)]

    # QS rows: empirical = q - 1 for even q, q + 1 for odd (bounded)
    def phred_err(n, q):
        return round(n * 10 ** (-q / 10.0), 2)

    qs_rows = []
    for k, rg in enumerate(rgs):
        for q in sorted(quals):
            emp = max(2, min(93, (q - 1 if q % 2 == 0 else q + 1) + k))
            n = 500_000
            qs_rows.append((rg, q, "M", f"{emp:.4f}", n, phred_err(n, emp)))

    # Context rows: all 16 2-mers at each qual, empirical +/- 2 by parity
    ctx_rows = []
    mers = ["".join(p) for p in itertools.product("ACGT", repeat=2)]
    for rg in rgs:
        for q in sorted(quals):
            for i, mer in enumerate(mers):
                emp = max(2, min(93, q + (2 if i % 2 else -2)))
                n = 40_000
                ctx_rows.append((rg, q, mer, "Context", "M",
                                 f"{emp:.4f}", n, phred_err(n, emp)))
        # Cycle rows: cycles 1..N and -1..-N, empirical +/- 3
        for q in sorted(quals):
            for cyc in list(range(1, 101)) + list(range(-1, -101, -1)):
                emp = max(2, min(93, q + (3 if cyc > 0 else -3)))
                n = 60_000
                ctx_rows.append((rg, q, cyc, "Cycle", "M",
                                 f"{emp:.4f}", n, phred_err(n, emp)))

    def table(out, name, desc, header, rows, fmts):
        out.write(f"#:GATKTable:{len(header)}:{len(rows)}:"
                  + ":".join(fmts) + ":;\n")
        out.write(f"#:GATKTable:{name}:{desc}\n")
        out.write("  ".join(header) + "\n")
        for r in rows:
            out.write("  ".join(str(v) for v in r) + "\n")
        out.write("\n")

    with open(path, "w") as out:
        out.write("#:GATKReport.v1.1:5\n")
        table(out, "Arguments", "Recalibration argument collection values",
              ["Argument", "Value"], args_rows, ["%s", "%s"])
        table(out, "Quantized", "Quality quantization map",
              ["QualityScore", "Count", "QuantizedScore"], quant_rows,
              ["%d", "%d", "%d"])
        table(out, "RecalTable0", "recal table 0",
              ["ReadGroup", "EventType", "EmpiricalQuality",
               "EstimatedQReported", "Observations", "Errors"],
              rg_rows, ["%s"] * 6)
        table(out, "RecalTable1", "recal table 1",
              ["ReadGroup", "QualityScore", "EventType",
               "EmpiricalQuality", "Observations", "Errors"],
              qs_rows, ["%s"] * 6)
        table(out, "RecalTable2", "recal table 2",
              ["ReadGroup", "QualityScore", "CovariateValue",
               "CovariateName", "EventType", "EmpiricalQuality",
               "Observations", "Errors"],
              ctx_rows, ["%s"] * 8)


def generate(outdir, genome_len=CORPUS["genome_len"],
             coverage=CORPUS["coverage"], seed=CORPUS["seed"]):
    golden_e2e.generate(outdir, genome_len, coverage, seed)
    write_recal_table(os.path.join(outdir, "recal.table"), QUALS)
    print("recal table ->", os.path.join(outdir, "recal.table"))


def table_flags(outdir):
    return ["--bqsr-recal-table", os.path.join(outdir, "recal.table")]


def run_ours(outdir, engine="auto", stats=None):
    """This package's HaplotypeCaller with the table on ``outdir``'s corpus
    into ours.vcf, in process; ``stats`` receives the run's counters.
    Returns the output's path."""
    from .. import cli
    path = os.path.join(outdir, "ours.vcf")
    rc = cli.main(["HaplotypeCaller",
                   "-i", os.path.join(outdir, "sample.bam"),
                   "-r", os.path.join(outdir, "ref.fa"), "-o", path,
                   "--pairhmm-engine", engine, "--log-level", "WARNING"]
                  + table_flags(outdir), stats=stats)
    if rc not in (0, None):
        raise SystemExit(f"our CLI failed: {rc}")
    print("ours ->", path)
    return path


def run_ref(outdir):
    """The reference binary with the table into ref.vcf; stops with one
    line without it."""
    golden_e2e.run_ref(outdir, extra=table_flags(outdir))


def diff_committed(outdir):
    """ours.vcf against rovaca_tpu's committed VCF, in ``outdir``/golden;
    0 when they match."""
    return golden_flows.diff_against(os.path.join(outdir, "ours.vcf"),
                                     REFERENCE,
                                     os.path.join(outdir, "golden"), False)


def golden(outdir, engine="auto"):
    """gen (unless ``outdir`` holds the corpus), the corpus's hashes
    against the manifest's, ours, and ours held to the committed
    reference. Returns the problems, [] when all hold."""
    if not os.path.exists(os.path.join(outdir, "recal.table")):
        generate(outdir)
    stale = golden_flows.corpus_problems(outdir, CORPUS_KEY)
    if stale:
        return [f"stale corpus: {stale}"]
    run_ours(outdir, engine)
    return [] if diff_committed(outdir) == 0 else [
        f"diverges from {REFERENCE}"]


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m rovaca_tpu_torch.tools.golden_bqsr",
        description="a corpus and a recalibration table: run this package "
                    "or the reference binary with it, diff; golden: hold "
                    "this package to rovaca_tpu's committed VCF")
    p.add_argument("command", choices=["gen", "ours", "ref", "diff",
                                       "golden"])
    p.add_argument("dir")
    p.add_argument("numbers", nargs="*", type=int,
                   help="gen: genome_len coverage seed")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "cuda", "torch", "native"])
    a = p.parse_args(argv)
    if a.command == "gen":
        generate(a.dir, *a.numbers)
    elif a.command == "ours":
        run_ours(a.dir, a.engine)
    elif a.command == "ref":
        run_ref(a.dir)
    elif a.command == "diff":
        return golden_e2e.diff(a.dir)
    else:
        problems = golden(a.dir, a.engine)
        for line in problems:
            print(" ", line)
        print("BQSR:", "MATCH" if not problems else "DIVERGENT")
        return 1 if problems else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
