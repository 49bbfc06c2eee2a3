"""The port held to rovaca_tpu's outputs committed in tests/golden_torch/.

tests/golden_torch/ commits a 50 kb / 30x corpus
(``tools.golden_e2e.generate(genome_len=50_000, coverage=30, seed=424242)``),
the inputs of its flows, the output that ``python -m rovaca_tpu.cli
HaplotypeCaller --pairhmm-engine xla`` made for each flow of
``tools.golden_flows.FLOWS`` (VCF, GVCF, banded VCF and GVCF, BQSR, BED,
dbSNP, --resume, two BAMs, -L, --pcr-indel-model NONE, --gq-bands), and
rovaca_tpu's VCF and GVCF of the 1 Mb / 30x corpus (seed 424242) and of
the adversarial corpus (``tools.golden_adversarial``, seed 20260505) that
chip_smoke.py generates. ``MANIFEST.json`` gives each file's command, seed,
engine and SHA-256.

Here, on the CPU:
- every committed file has the manifest's SHA-256;
- the port's CLI (``--pairhmm-engine native``; the banded flows run K3's
  plain versions) gives each flow's reference record for record
  (``golden_e2e.diff``, IDs included, GVCF band rows exactly), and the flow
  did what it is for (``golden_flows.effect_problems``);
- the port's BuildBamIndex and IndexFeatureFile give the committed .bai and
  .tbi byte for byte;
- rovaca_tpu's xla runs still give the references (here for the flows of
  XLA_HERE, in test_torch_golden_xla.py for the others), so they cannot go
  stale;
- marked slow: the 1 Mb corpus regenerated, its hashes held to the
  manifest's, and rovaca_tpu's xla VCF and GVCF of it diffed with the
  committed ones (~5 minutes).

Regenerate every reference, the golden tools' of
test_torch_golden_tools.py included (~16 minutes on 8 cores; the 1 Mb and
adversarial runs need a directory with ~250 MB free):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_golden.py \\
        --work /tmp/golden_work
"""

import argparse
import json
import lzma
import os
import shutil

import pytest

from rovaca_tpu.cli import main as jax_cli
from rovaca_tpu_torch.cli import main as port_cli
from rovaca_tpu_torch.tools import (golden_adversarial, golden_e2e,
                                    golden_flows)
from rovaca_tpu_torch.tools.golden_flows import FLOWS, GOLDEN_DIR

# the flows whose xla regeneration runs in this file; the others run in
# test_torch_golden_xla.py, so that two workers share the xla runs
XLA_HERE = ("vcf", "gvcf", "bed", "interval", "pcr_none", "gq_bands")
XLA_ELSEWHERE = tuple(f for f in FLOWS if f not in XLA_HERE)
LARGE = {"vcf": "1mb.vcf.xz", "gvcf": "1mb.g.vcf.xz"}
ADVERSARIAL = {"vcf": golden_adversarial.REFERENCES[False],
               "gvcf": golden_adversarial.REFERENCES[True]}


def test_manifest_matches_committed_files():
    manifest = golden_flows.load_manifest()
    assert not golden_flows.manifest_problems()
    refs = {golden_flows.reference_name(f) for f in FLOWS} | set(
        LARGE.values()) | set(ADVERSARIAL.values())
    for name in refs:
        entry = manifest["files"][name]
        assert entry["engine"] == "xla" and "rovaca_tpu.cli" in \
            entry["command"], (name, entry)
    total = sum(os.path.getsize(os.path.join(GOLDEN_DIR, n))
                for n in os.listdir(GOLDEN_DIR))
    assert total < 4 << 20, total


def _port_runs():
    """A cli for run_flow that runs the port and keeps each run's stats."""
    runs = []

    def cli(argv):
        stats = {}
        runs.append(stats)
        return port_cli(argv, stats=stats)
    return cli, runs


@pytest.mark.parametrize("flow", list(FLOWS))
def test_port_flow_matches_reference(flow, tmp_path):
    cli, runs = _port_runs()
    result = golden_flows.run_flow(cli, flow, str(tmp_path / "run"),
                                   "native")
    assert golden_flows.diff_flow(flow, result["output"],
                                  str(tmp_path / "diff")) == 0
    # on the CPU only the banded flows realign on the banded path
    assert golden_flows.banded_realign(flow, "native") == flow.startswith(
        "banded")
    assert not golden_flows.effect_problems(
        flow, result, engine="native",
        sw_launches=[s["sw_launches"] for s in runs])
    for stats in runs:
        assert stats["regions"] > 0


def test_index_tools_match_committed(tmp_path):
    for tool, src, committed in (
            ("BuildBamIndex", "sample.bam", "sample.bam.bai"),
            ("IndexFeatureFile", "dbsnp.vcf.gz", "dbsnp.vcf.gz.tbi")):
        out = str(tmp_path / committed)
        assert port_cli([tool, "-i", os.path.join(GOLDEN_DIR, src), "-o",
                         out]) == 0
        with open(out, "rb") as a, \
                open(os.path.join(GOLDEN_DIR, committed), "rb") as b:
            assert a.read() == b.read(), tool


def regenerate_matches(flow, tmp_path):
    """rovaca_tpu's xla run of ``flow`` on the committed inputs matches the
    committed reference."""
    result = golden_flows.run_flow(jax_cli, flow, str(tmp_path / "run"),
                                   "xla")
    assert golden_flows.diff_flow(flow, result["output"],
                                  str(tmp_path / "diff")) == 0


@pytest.mark.parametrize("flow", XLA_HERE)
def test_reference_regenerates(flow, tmp_path):
    regenerate_matches(flow, tmp_path)


@pytest.mark.slow
def test_1mb_references_regenerate(tmp_path):
    corpus = str(tmp_path / "corpus")
    golden_e2e.generate(corpus, **golden_flows.CORPUS_1MB)
    assert not golden_flows.corpus_problems(corpus, "corpus_1mb")
    for mode, ref in LARGE.items():
        gvcf = mode == "gvcf"
        out = str(tmp_path / f"1mb.{mode}")
        assert jax_cli(_large_argv(corpus, out, gvcf)) == 0
        assert golden_flows.diff_against(out, ref, str(tmp_path / mode),
                                         gvcf) == 0


def golden_adversarial_script():
    """scripts/golden_adversarial.py as a module (it imports tests/simdata
    and rovaca_tpu)."""
    import importlib.util
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    spec = importlib.util.spec_from_file_location(
        "golden_adversarial_script", os.path.join(
            os.path.dirname(here), "scripts", "golden_adversarial.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _large_references(work, corpus, tag, names, args, record):
    """rovaca_tpu's xla VCF and GVCF of a corpus that is not committed, as
    ``names``' files of the golden directory."""
    for mode, name in names.items():
        out = os.path.join(work, f"{tag}.{mode}")
        argv = _large_argv(corpus, out, mode == "gvcf")
        assert jax_cli(argv) == 0
        _xz(out, os.path.join(GOLDEN_DIR, name))
        rel = [os.path.relpath(a, corpus) if a.startswith(corpus) else
               os.path.basename(a) if a == out else a for a in argv]
        record(name, _command(rel) + "; xz -9 the output", "xla", args)


def _large_argv(corpus, out, gvcf):
    return (["HaplotypeCaller", "-i", os.path.join(corpus, "sample.bam"),
             "-r", os.path.join(corpus, "ref.fa"), "-o", out]
            + (["-e", "GVCF"] if gvcf else [])
            + ["--pairhmm-engine", "xla", "--log-level", "WARNING"])


# -- the generator of tests/golden_torch/ ---------------------------------

def _truth(golden):
    with open(os.path.join(golden, "truth.txt")) as f:
        return [(int(p), r, a) for _, p, r, a, _ in
                (ln.split() for ln in f)]


def _write_targets(golden, truth):
    """Three 100 bp targets, each on one truth variant (the 3rd, 9th and
    15th); the other variants lie outside targets +- BED_PADDING."""
    with open(os.path.join(golden, "targets.bed"), "w") as f:
        for pos, _, _ in (truth[2], truth[8], truth[14]):
            f.write(f"chr20\t{pos - 50}\t{pos + 50}\n")


def _write_recal_table(golden):
    """A GATK report for both read groups: each reported quality 3 lower
    empirically, a context and a cycle row."""
    rgs = ("rg1", "rg2")
    quals = range(2, 42)
    qs_rows = [f"{rg}  {q}  M  {max(q - 3, 1):.4f}  10000  "
               f"{10000 * 10 ** (-max(q - 3, 1) / 10):.2f}"
               for rg in rgs for q in quals]
    text = (
        "#:GATKReport.v1.1:5\n"
        "#:GATKTable:2:2:%s:%s:;\n"
        "#:GATKTable:Arguments:Recalibration argument collection values "
        "used in this run\n"
        "Argument                    Value\n"
        "binary_tag_name             null\n"
        "covariate                   ReadGroupCovariate,QualityScoreCovariate"
        ",ContextCovariate,CycleCovariate\n"
        "#:GATKTable:3:1:%d:%d:%d:;\n"
        "#:GATKTable:Quantized:Quality quantization map\n"
        "QualityScore  Count  QuantizedScore\n"
        "30  100  30\n"
        f"#:GATKTable:6:{len(rgs)}:%s:%s:%.4f:%.4f:%d:%.2f:;\n"
        "#:GATKTable:RecalTable0:\n"
        "ReadGroup  EventType  EmpiricalQuality  EstimatedQReported  "
        "Observations  Errors\n"
        + "".join(f"{rg}  M  28.0000  31.0000  400000  600.00\n"
                  for rg in rgs)
        + f"#:GATKTable:6:{len(qs_rows)}:%s:%d:%s:%.4f:%d:%.2f:;\n"
        "#:GATKTable:RecalTable1:\n"
        "ReadGroup  QualityScore  EventType  EmpiricalQuality  Observations"
        "  Errors\n"
        + "".join(r + "\n" for r in qs_rows)
        + "#:GATKTable:8:2:%s:%d:%s:%s:%s:%.4f:%d:%.2f:;\n"
        "#:GATKTable:RecalTable2:\n"
        "ReadGroup  QualityScore  CovariateValue  CovariateName  EventType  "
        "EmpiricalQuality  Observations  Errors\n"
        "rg1  30  AC  Context  M  25.0000  20000  63.00\n"
        "rg2  35  1  Cycle  M  31.0000  5000  4.00\n")
    with open(os.path.join(golden, "recal.table"), "w") as f:
        f.write(text)


def _write_dbsnp(golden, truth):
    """Every truth site under rs1000 + k, except the first SNP, which
    carries another allele (DECOY_ID), and the next variant, which is
    filtered (FILTERED_ID); indexed by rovaca_tpu's IndexFeatureFile."""
    from rovaca_tpu_torch.io import bgzf
    decoy = next(k for k, (_, r, a) in enumerate(truth)
                 if len(r) == len(a) == 1)
    rows = []
    for k, (pos, ref, alt) in enumerate(truth):
        rid, flt = f"rs{1000 + k}", "."
        if k == decoy:
            rid = golden_flows.DECOY_ID
            alt = next(b for b in "ACGT" if b not in (ref, alt))
        elif k == decoy + 1:
            rid, flt = golden_flows.FILTERED_ID, "LowQual"
        rows.append(f"chr20\t{pos}\t{rid}\t{ref}\t{alt}\t.\t{flt}\t.\n")
    path = os.path.join(golden, "dbsnp.vcf.gz")
    with bgzf.Writer(path) as w:
        w.write(("##fileformat=VCFv4.2\n##contig=<ID=chr20,length="
                 f"{golden_flows.CORPUS['genome_len']}>\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                 + "".join(rows)).encode())
    assert jax_cli(["IndexFeatureFile", "-i", path]) == 0


def _xz(src, dst):
    with open(src, "rb") as a, lzma.open(dst, "wb", preset=9) as b:
        shutil.copyfileobj(a, b)


def _command(argv, env=()):
    return " ".join([f"{k}={v}" for k, v in env]
                    + ["python", "-m", "rovaca_tpu.cli", *argv])


def generate(work):
    """Write tests/golden_torch/ anew with rovaca_tpu's xla runs; ``work``
    holds the runs, the 1 Mb corpus and the adversarial one."""
    golden = GOLDEN_DIR
    corpus_cmd = ("rovaca_tpu_torch.tools.golden_e2e.generate(genome_len="
                  "50_000, coverage=30, seed=424242)")
    files = {}

    def record(name, command, engine=None, corpus=golden_flows.CORPUS):
        files[name] = {"command": command, "seed": corpus["seed"],
                       "corpus": corpus, "engine": engine}

    shutil.rmtree(golden, ignore_errors=True)
    os.makedirs(golden)
    golden_e2e.generate(golden, **golden_flows.CORPUS)
    for name in ("ref.fa", "ref.fa.fai", "sample.bam", "truth.txt"):
        record(name, corpus_cmd)
    bai = os.path.join(golden, "sample.bam.bai")
    assert jax_cli(["BuildBamIndex", "-i", os.path.join(golden, "sample.bam"),
                    "-o", bai]) == 0
    record("sample.bam.bai", "python -m rovaca_tpu.cli BuildBamIndex -i "
           "sample.bam -o sample.bam.bai")
    truth = _truth(golden)
    _write_targets(golden, truth)
    record("targets.bed", "tests/test_torch_golden.py:_write_targets")
    _write_recal_table(golden)
    record("recal.table", "tests/test_torch_golden.py:_write_recal_table")
    _write_dbsnp(golden, truth)
    record("dbsnp.vcf.gz", "tests/test_torch_golden.py:_write_dbsnp")
    record("dbsnp.vcf.gz.tbi",
           "python -m rovaca_tpu.cli IndexFeatureFile -i dbsnp.vcf.gz")

    for flow in FLOWS:
        result = golden_flows.run_flow(jax_cli, flow,
                                       os.path.join(work, flow), "xla")
        name = golden_flows.reference_name(flow)
        _xz(result["output"], os.path.join(golden, name))
        env = FLOWS[flow].env
        steps = [_command(argv, env) for argv in result["commands"]]
        if FLOWS[flow].two_bams:
            steps.insert(0, "rovaca_tpu_torch.tools.golden_flows.split_bam("
                         "sample.bam) -> part0.bam, part1.bam")
        if FLOWS[flow].resume:
            steps.insert(1, "cp resume_full.vcf.gz resume.vcf.gz; "
                         "resume.vcf.gz.progress = {\"contigs\": {\"chr20\":"
                         " -1048576}}")
        record(name, "; ".join(steps) + "; xz -9 the output", "xla")

    manifest = {
        "generator": "JAX_PLATFORMS=cpu PYTHONPATH=. python "
                     "tests/test_torch_golden.py --work DIR",
        "corpus": golden_flows.CORPUS,
        "flows": {f: golden_flows.reference_name(f) for f in FLOWS},
    }
    corpus = os.path.join(work, "corpus_1mb")
    golden_e2e.generate(corpus, **golden_flows.CORPUS_1MB)
    manifest["corpus_1mb"] = {
        "args": golden_flows.CORPUS_1MB,
        "command": corpus_cmd.replace("50_000", "1_000_000"),
        "ref.fa": golden_flows.sha256_file(
            os.path.join(corpus, "ref.fa")),
        "sample.bam payload": golden_flows.sha256_bam_payload(
            os.path.join(corpus, "sample.bam"))}
    _large_references(work, corpus, "1mb", LARGE, golden_flows.CORPUS_1MB,
                      record)
    # the adversarial corpus, by scripts/golden_adversarial.py's generator
    # (tools.golden_adversarial.generate gives the same files)
    corpus = os.path.join(work, "corpus_adversarial")
    golden_adversarial_script().generate(
        corpus, golden_flows.CORPUS_ADVERSARIAL["seed"])
    manifest["corpus_adversarial"] = {
        "args": golden_flows.CORPUS_ADVERSARIAL,
        "command": "python scripts/golden_adversarial.py gen DIR "
                   f"{golden_flows.CORPUS_ADVERSARIAL['seed']}",
        **golden_flows.corpus_hashes(corpus)}
    _large_references(work, corpus, "adversarial", ADVERSARIAL,
                      golden_flows.CORPUS_ADVERSARIAL, record)
    for name, entry in files.items():
        entry["sha256"] = golden_flows.sha256_file(os.path.join(golden, name))
    manifest["files"] = dict(sorted(files.items()))
    with open(os.path.join(golden, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    # the golden tools' references, which the rmtree above removed
    from test_torch_golden_tools import generate as generate_tools
    generate_tools(os.path.join(work, "tools"))


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="Regenerate tests/golden_torch/ "
                                "with rovaca_tpu's xla engine")
    p.add_argument("--work", required=True,
                   help="scratch directory for the runs and the 1 Mb corpus")
    generate(p.parse_args().work)
