"""rovaca_tpu_torch stands on its own: no import of rovaca_tpu, its own host
layer held to rovaca_tpu's, on the CPU.

- A static scan (ast) of every module of rovaca_tpu_torch/ and of
  chip_smoke.py finds no import of rovaca_tpu (the child processes of a
  port run are checked in test_torch_e2e.py and test_torch_distributed.py).
- ``tools.golden_e2e.generate`` writes the same FASTA, BAM, index and truth
  bytes as scripts/golden_e2e.generate for the same seed.
- Two processes that build the same native library at once both load it.
- The flows that run through the port's own copies of the host layer
  (BQSR, BED with padding, dbSNP IDs, --resume on a truncated .vcf.gz, two
  contigs, two BAMs, and the flags -L, --gq-bands, --max-mnp-distance,
  --pcr-indel-model, --sample-name, --max-reads-depth, --assemble-output)
  give, with ``--pairhmm-engine torch``, the records of ``rovaca_tpu.cli
  --pairhmm-engine xla`` on the same inputs: (CHROM, POS, REF, ALT, GT) and
  IDs identical, the other fields within golden_e2e's QUAL_TOL, FLOAT_TOL
  and PL_TOL, GVCF band rows identical; the --assemble-output dumps are
  equal as text.
"""

import ast
import gzip
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from rovaca_tpu.cli import main as jax_cli
from rovaca_tpu_torch.cli import main as port_cli
from rovaca_tpu_torch.io import bgzf
from rovaca_tpu_torch.tools import golden_e2e, golden_flows

import simdata
from test_bqsr import REPORT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "rovaca_tpu_torch")


def _imports(path):
    """(line, module) of every import in a Python file, absolute names."""
    tree = ast.parse(open(path).read(), path)
    pkg = os.path.relpath(os.path.dirname(path), REPO).replace(os.sep, ".")
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.split(".")[:len(pkg.split(".")) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            out.append((node.lineno, mod))
    return out


def test_port_imports_nothing_of_rovaca_tpu():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 80
    for tool in ("golden_pairhmm.py", "golden_assembly.py",
                 "golden_bqsr.py", "golden_modes.py", "golden_region.py",
                 "finalize_diff.py", "golden_sweep.py"):
        assert os.path.join(PORT, "tools", tool) in files
    bad = [(os.path.relpath(f, REPO), line, mod)
           for f in files for line, mod in _imports(f)
           if mod.split(".")[0] in ("rovaca_tpu", "jax")]
    assert not bad, bad


def test_scan_sees_relative_and_lazy_imports(tmp_path):
    """The scan resolves relative imports and finds imports inside
    functions."""
    mod = tmp_path / "m.py"
    mod.write_text("def f():\n    from rovaca_tpu.io import bam\n"
                   "from ..x import y\n")
    found = [m for _, m in _imports(str(mod))]
    assert "rovaca_tpu.io" in found
    assert any(m.endswith(".x") for m in found)


def test_generate_matches_scripts(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import golden_e2e as scripts_golden
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    scripts_golden.generate(str(tmp_path / "scripts"), genome_len=5000,
                            coverage=8, seed=17)
    golden_e2e.generate(str(tmp_path / "port"), genome_len=5000, coverage=8,
                        seed=17)
    for name in ("ref.fa", "sample.bam", "sample.bam.bai", "truth.txt"):
        a = (tmp_path / "scripts" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        assert a == b, name


_BUILD = """\
import ctypes, os, sys, time
from rovaca_tpu_torch.native import build
build.BUILD_DIR = sys.argv[1]
while not os.path.exists(sys.argv[2]):
    time.sleep(0.005)
path = build.shared_lib("pcr", extra_flags=("-fopenmp",))
ctypes.CDLL(path).rovaca_pcr_apply_batch
print("LOADED", path)
"""


def test_concurrent_native_builds_both_load(tmp_path):
    """Two processes build the same library into an empty build directory
    at the same moment: both load it, and no temporary file is left."""
    out_dir, go = tmp_path / "native", tmp_path / "go"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(out_dir),
                               str(go)], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(2)]
    go.write_text("")
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    paths = set()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
        paths.add(so.split("LOADED", 1)[1].strip())
    assert paths == {str(out_dir / "_pcr.so")}
    assert not list(out_dir.glob("*.tmp"))


# -- flows through the port's host layer, against rovaca_tpu's ------------

@pytest.fixture(scope="module")
def standard_case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_flows")
    fasta, bam, truth, _ = simdata.make_standard_case(tmp)
    return tmp, fasta, bam, truth


def _two_contig_case(tmp):
    """tests/test_e2e.py:TestMultiContig's input: a SNP on each of two
    contigs."""
    from rovaca_tpu.io.bam import BamHeader, BamWriter
    from rovaca_tpu.io.fasta import write_fasta
    from rovaca_tpu.reads.record import ReadRecord
    rng = np.random.default_rng(31)
    refs = {c: simdata.random_ref(rng, 1200) for c in ("chrA", "chrB")}
    reads = []
    for ci, (contig, ref) in enumerate(refs.items()):
        pos = 600
        alt = "ACGT"[("ACGT".index(ref[pos]) + 1) % 4]
        hap = ref[:pos] + alt + ref[pos + 1:]
        for i in range(12):
            s = int(rng.integers(480, 560))
            for src, tag in ((ref, "r"), (hap, "a")):
                frag = src[s:s + 100]
                reads.append(ReadRecord(
                    name=f"{contig}_{tag}{i}", flag=0, ref_id=ci, pos=s,
                    mapping_quality=60, cigar=f"{len(frag)}M", bases=frag,
                    quals=[35] * len(frag), contig=contig))
    fasta, bam = str(tmp / "two.fa"), str(tmp / "two.bam")
    write_fasta(fasta, refs)
    header = BamHeader(
        "@HD\tVN:1.6\tSO:coordinate\n"
        + "".join(f"@SQ\tSN:{c}\tLN:1200\n" for c in refs)
        + "@RG\tID:rg1\tSM:S1\n", list(refs), [1200, 1200])
    reads.sort(key=lambda r: (r.ref_id, r.pos))
    with BamWriter(bam, header) as w:
        for r in reads:
            w.write(r)
    return fasta, bam


def _dbsnp(tmp, truth):
    """A bgzipped dbSNP VCF with the case's het SNP and deletion under rs
    IDs (rs1000, rs1002), a decoy allele at the hom SNP (rs1001) and a
    filtered record at the insertion (rs1003), indexed by the port's
    IndexFeatureFile."""
    rows = []
    for k, (name, (pos, ref, alt)) in enumerate(sorted(
            truth.items(), key=lambda kv: kv[1][0])):
        if name == "hom_snp":
            alt = next(b for b in "ACGT" if b not in (ref, alt))
        flt = "LowQual" if name == "het_ins" else "."
        rows.append(f"chr20\t{pos + 1}\trs{1000 + k}\t{ref}\t{alt}\t.\t{flt}"
                    f"\t.\n")
    path = str(tmp / "dbsnp.vcf.gz")
    with bgzf.Writer(path) as w:
        w.write(("##fileformat=VCFv4.2\n##contig=<ID=chr20,length=3000>\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                 + "".join(rows)).encode())
    assert port_cli(["IndexFeatureFile", "-i", path]) == 0
    return path


def _run_both(fasta, bam, out_dir, extra, name="out.vcf"):
    """The port's CLI (torch) and rovaca_tpu's (xla) on the same inputs
    (``bam`` one path or a list): out_dir/ours_<name>, out_dir/ref_<name>.
    "{side}" in an argument of ``extra`` becomes "ours" or "ref"."""
    ours, ref = str(out_dir / f"ours_{name}"), str(out_dir / f"ref_{name}")
    inputs = [x for b in ([bam] if isinstance(bam, str) else bam)
              for x in ("-i", b)]
    for cli, engine, side, out in ((port_cli, "torch", "ours", ours),
                                   (jax_cli, "xla", "ref", ref)):
        assert cli(["HaplotypeCaller", *inputs, "-r", fasta, "-o", out,
                    "--pairhmm-engine", engine,
                    *(a.format(side=side) for a in extra)]) == 0
    return ours, ref


def _resume(fasta, bam, out_dir, cli, engine, tag):
    """tests/test_e2e.py:TestResumeBgzf's flow: a straight-through .vcf.gz,
    a copy whose checkpoint claims only a window before the contig, then
    --resume on the copy. Returns (straight-through, resumed) records."""
    full = str(out_dir / f"{tag}_full.vcf.gz")
    assert cli(["HaplotypeCaller", "-i", bam, "-r", fasta, "-o", full,
                "--pairhmm-engine", engine]) == 0
    part = str(out_dir / f"{tag}_part.vcf.gz")
    shutil.copy(full, part)
    with open(part + ".progress", "w") as fh:
        json.dump({"contigs": {"chr20": -(1 << 20)}}, fh)
    assert cli(["HaplotypeCaller", "-i", bam, "-r", fasta, "-o", part,
                "--pairhmm-engine", engine, "--resume"]) == 0
    with open(part, "rb") as fh:
        assert fh.read().endswith(bgzf.EOF_BLOCK)

    def body(path):
        with gzip.open(path, "rt") as fh:
            return [ln for ln in fh if not ln.startswith("#")]
    return body(full), body(part)


# flow -> arguments of both runs; "two_bams" and "two_contigs" change the
# inputs, "resume" the procedure
FLAG_FLOWS = {
    "interval": ["-L", "chr20:500-1600"],
    "gq_bands": ["-e", "GVCF", "--gq-bands", "5,20,60"],
    "max_mnp_distance": ["--max-mnp-distance", "2"],
    "pcr_indel_model": ["--pcr-indel-model", "NONE"],
    "sample_name": ["--sample-name", "NA24385"],
    "max_reads_depth": ["--max-reads-depth", "8"],
    "assemble_output": ["--assemble-output", "{side}_assembly.txt"],
}


@pytest.mark.parametrize("flow", ["bqsr", "bed", "dbsnp", "resume",
                                  "two_contigs", "two_bams", *FLAG_FLOWS])
def test_flow_matches_reference(standard_case, tmp_path, flow):
    tmp, fasta, bam, truth = standard_case
    extra = FLAG_FLOWS.get(flow, [])
    gvcf = "GVCF" in extra
    if flow == "bqsr":
        table = tmp_path / "recal.table"
        table.write_text(REPORT)
        extra = ["--bqsr-recal-table", str(table)]
    elif flow == "bed":
        bed = tmp_path / "targets.bed"
        bed.write_text("chr20\t560\t640\nchr20\t1450\t1560\n")
        extra = ["-b", str(bed), "-P", "100"]
    elif flow == "dbsnp":
        extra = ["-d", _dbsnp(tmp_path, truth)]
    elif flow == "two_contigs":
        fasta, bam = _two_contig_case(tmp_path)
    elif flow == "two_bams":
        bam = golden_flows.split_bam(bam, str(tmp_path))
    elif flow == "interval":       # indexed, so -L seeks
        shutil.copy(bam, tmp_path / "indexed.bam")
        bam = str(tmp_path / "indexed.bam")
        assert port_cli(["BuildBamIndex", "-i", bam]) == 0
    elif flow == "assemble_output":
        extra = [extra[0], str(tmp_path / extra[1])]

    if flow == "resume":
        full_p, ours = _resume(fasta, bam, tmp_path, port_cli, "torch",
                               "ours")
        full_r, ref = _resume(fasta, bam, tmp_path, jax_cli, "xla", "ref")
        assert ours == full_p and ref == full_r
        header = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        (tmp_path / "ours.vcf").write_text(header + "".join(ours))
        (tmp_path / "ref.vcf").write_text(header + "".join(ref))
    else:
        suffix = ".g.vcf" if gvcf else ".vcf"
        ours, ref = _run_both(fasta, bam, tmp_path, extra, "out" + suffix)
        shutil.copy(ours, tmp_path / f"ours{suffix}")
        shutil.copy(ref, tmp_path / f"ref{suffix}")
    records, _ = golden_e2e.parse_vcf(
        str(tmp_path / ("ours.g.vcf" if gvcf else "ours.vcf")))
    assert records
    positions = {p for (_, p, _, _) in records}
    if flow == "bed":      # only the targeted variants are called
        assert positions <= set(range(460, 1661))
    elif flow == "interval":
        assert positions <= set(range(500, 1601)) and 601 in positions
    elif flow == "dbsnp":
        # the het SNP's ID; neither the decoy allele's nor the filtered one's
        ids = {r["id"] for r in records.values() if r["id"] != "."}
        assert "rs1000" in ids and not ids & {"rs1001", "rs1003"}, ids
    elif flow == "two_contigs":
        assert {c for (c, _, _, _) in records} == {"chrA", "chrB"}
    elif flow == "sample_name":
        for side in ("ours", "ref"):
            with open(tmp_path / f"{side}.vcf") as fh:
                header = [ln for ln in fh if ln.startswith("#CHROM")]
            assert header[0].rstrip("\n").endswith("\tNA24385"), side
    elif flow == "assemble_output":
        dumps = [(tmp_path / f"{side}_assembly.txt").read_text()
                 for side in ("ours", "ref")]
        assert dumps[0] and dumps[0] == dumps[1]
    assert golden_e2e.diff(str(tmp_path), gvcf=gvcf, check_id=True) == 0
