"""The port's golden tools held to rovaca_tpu, and the generator of their
committed references.

tests/golden_torch/ commits, besides the flows' references
(test_torch_golden.py), what rovaca_tpu made on the corpora of the port's
golden tools, xz-compressed:

- ``bqsr_full.vcf.xz``: ``python -m rovaca_tpu.cli HaplotypeCaller
  --bqsr-recal-table --pairhmm-engine xla`` on ``tools.golden_bqsr``'s
  corpus (60 kb / 25x, seed 20260820, and its table of every lookup level);
- ``modes_<mode>.vcf.xz``: rovaca_tpu's xla VCF of each corpus of
  ``tools.golden_modes`` (seed 20260821): multicontig, multibam (over
  a.bam and b.bam), dbsnp (with ``-d``), bed (``-b targets.bed -P 50``);
- ``region_report.txt``: rovaca_tpu's per-region chain (the "ours" section
  of scripts/golden_region.py:69-95, ``compute_likelihoods(engine="xla")``)
  on three regions of the committed 50 kb corpus, around its truth SNP at
  5021, insertion at 8270 and deletion at 16302.

The corpora are not committed: ``MANIFEST.json`` pins them by hash
(``corpus_bqsr``, ``corpus_modes_<mode>``), taken from the scripts'
generators (scripts/golden_bqsr.py, scripts/golden_modes.py with its
binary leg cut off) except multibam, whose split the port makes stable
(``tools.golden_modes._gen_multibam``); the generator checks that the
port's corpora are the same files. Regenerate these entries alone (~3
minutes on 8 cores):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_golden_tools.py \\
        --work DIR

Here, on the CPU: finalize_diff's tuples are rovaca_tpu's on all 80
regions and its main reads a harness dump; golden_sweep's table on one
seed with its reference leg stubbed; every reference leg stops with one
line without .refbuild/. test_torch_golden_bqsr.py,
test_torch_golden_modes.py and test_torch_golden_region.py hold the other
tools, one file each so that workers share them.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import lzma
import os
import shutil
import sys

import pytest

from rovaca_tpu.cli import main as jax_cli
from rovaca_tpu_torch.tools import (finalize_diff, golden_bqsr, golden_flows,
                                    golden_modes, golden_region, golden_sweep)
from rovaca_tpu_torch.tools.golden_flows import GOLDEN_DIR

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# (kind, 1-based position) of the committed corpus's truth variants that
# the region report's regions are centred on, and their half width
REGION_SITES = (("SNP", 5021), ("insertion", 8270), ("deletion", 16302))
REGION_HALF = 50


def load_script(name):
    """scripts/<name>.py as a module (the scripts import tests/simdata,
    each other and rovaca_tpu)."""
    for d in (HERE, os.path.join(REPO, "scripts")):
        if d not in sys.path:
            sys.path.insert(0, d)
    spec = importlib.util.spec_from_file_location(
        f"{name}_script", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def region_bounds():
    """[(contig, start0, end0)] of the report's regions."""
    return [("chr20", pos - 1 - REGION_HALF, pos - 1 + REGION_HALF)
            for _, pos in REGION_SITES]


# -- finalize_diff ----------------------------------------------------------

def _jax_tuples():
    """rovaca_tpu's (scripts/finalize_diff.py's) tuples of the 80 regions."""
    script = load_script("finalize_diff")
    return [((beg, end), script.ours_tuples(beg, end, reads))
            for beg, end, reads in script.load_cases()]


def _write_dump(path, tuples):
    """A dump in the reference harness's format (name, 1-based start,
    cigar, seq, quals per read; haplotypes omitted)."""
    with open(path, "w") as f:
        for (beg, end), rows in tuples:
            f.write(f"chr1:{beg}-{end}\treads: {len(rows)}\n")
            for pos, name, cigar, seq, quals in rows:
                f.write(f"{name}\t{pos}\t{cigar}\t{seq}\t{quals}\n")
            f.write("haplotypes: 0\n\n")


def test_finalize_tuples_match_rovaca_tpu():
    want = _jax_tuples()
    got = [((beg, end), finalize_diff.ours_tuples(beg, end, reads))
           for beg, end, reads in finalize_diff.load_cases()]
    assert len(got) == 80
    assert got == want


def test_finalize_main_reads_harness_dump(tmp_path, capsys):
    tuples = _jax_tuples()
    dump = str(tmp_path / "dump.txt")
    _write_dump(dump, tuples)
    assert finalize_diff.main([dump]) == 0
    assert capsys.readouterr().out.strip().endswith(
        "80/80 regions read-level identical")
    (beg_end, rows) = tuples[3]
    pos, name, cigar, seq, quals = rows[0]
    rows[0] = (pos, name, cigar, seq, ("#" if quals[0] != "#" else "$")
               + quals[1:])
    _write_dump(dump, tuples)
    assert finalize_diff.main([dump]) == 1
    out = capsys.readouterr().out
    assert out.strip().endswith("79/80 regions read-level identical")
    assert f"REGION chr1:{beg_end[0]}-{beg_end[1]}" in out


# -- golden_sweep -----------------------------------------------------------

def _committed_ref(drop_last=False):
    """A reference leg that writes rovaca_tpu's committed VCF or GVCF of the
    50 kb corpus; ``drop_last`` leaves out its last record."""
    def ref(outdir, gvcf):
        path = os.path.join(outdir, "ref.g.vcf" if gvcf else "ref.vcf")
        golden_flows.unpack_reference(
            golden_flows.reference_name("gvcf" if gvcf else "vcf"), path)
        if drop_last:
            with open(path) as f:
                lines = f.readlines()
            with open(path, "w") as f:
                f.writelines(lines[:-1])
    return ref


@pytest.mark.parametrize("divergent", [False, True])
def test_sweep_table(divergent, tmp_path, capsys):
    c = golden_flows.CORPUS
    rows = golden_sweep.sweep(str(tmp_path), [c["seed"]], c["genome_len"],
                              c["coverage"], "native",
                              ref=_committed_ref(divergent))
    rc = golden_sweep.report(rows)
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == [
        "seed", str(c["seed"]),
        "vcf=" + ("DIVERGENT" if divergent else "MATCH"),
        "gvcf=" + ("DIVERGENT" if divergent else "MATCH")]
    assert out[-1] == ("SWEEP: DIVERGENT" if divergent else
                       "SWEEP: ALL MATCH")
    assert rc == int(divergent)


# -- the reference legs -----------------------------------------------------

def _ref_legs(d):
    bam = os.path.join(GOLDEN_DIR, "sample.bam")
    fasta = os.path.join(GOLDEN_DIR, "ref.fa")
    return {
        "golden_bqsr ref": lambda: golden_bqsr.main(["ref", d]),
        "golden_modes ref": lambda: golden_modes.main(["ref", "bed", d]),
        "golden_modes <mode>": lambda: golden_modes.main(["all", d]),
        "golden_region": lambda: golden_region.main(
            [bam, fasta, "chr20", "4970", "5070", d]),
        "finalize_diff": lambda: finalize_diff.main([
            os.path.join(d, "dump.txt")]),
        "golden_sweep": lambda: golden_sweep.main([d]),
    }


@pytest.mark.parametrize("leg", list(_ref_legs("")))
def test_reference_leg_stops_without_binary(leg, tmp_path):
    d = str(tmp_path / "w")
    with pytest.raises(SystemExit) as exc:
        _ref_legs(d)[leg]()
    msg = exc.value.code
    assert isinstance(msg, str) and "\n" not in msg, msg
    assert msg.startswith("reference binary missing: ") and \
        ".refbuild" in msg, msg
    assert not os.path.exists(d) or not os.listdir(d)


def test_manifest_pins_the_tools_references():
    manifest = golden_flows.load_manifest()
    names = [golden_bqsr.REFERENCE, *golden_modes.REFERENCES.values(),
             "region_report.txt"]
    for name in names:
        entry = manifest["files"][name]
        assert entry["engine"] == "xla" and "rovaca_tpu" in \
            entry["command"], (name, entry)
    for key in [golden_bqsr.CORPUS_KEY] + [golden_modes.corpus_key(m)
                                           for m in golden_modes.MODES]:
        hashed = [k for k in manifest[key] if k not in ("args", "command")]
        assert "ref.fa" in hashed and any(k.endswith(" payload")
                                          for k in hashed), key
    assert [k for k in golden_region.read_report()] == region_bounds()


# -- the generator ----------------------------------------------------------

def _xz(src, dst):
    with open(src, "rb") as a, lzma.open(dst, "wb", preset=9) as b:
        shutil.copyfileobj(a, b)


def _jax_argv(bams, fasta, out, *flags):
    return (["HaplotypeCaller"] + [x for b in bams for x in ("-i", b)]
            + ["-r", fasta, "-o", out, *flags, "--pairhmm-engine", "xla",
               "--log-level", "WARNING"])


def _command(argv, base):
    rel = [os.path.relpath(a, base) if a.startswith(base) else a
           for a in argv]
    return " ".join(["python", "-m", "rovaca_tpu.cli", *rel])


def _same_files(a, b, names):
    """The corpus files ``names`` of directories ``a`` and ``b`` agree."""
    ha, hb = golden_flows.corpus_hashes(a, names), \
        golden_flows.corpus_hashes(b, names)
    bad = [n for n in names if ha[n] != hb[n]]
    assert not bad, f"{a} and {b} differ in {bad}"
    return ha


def jax_region_report(bam, fasta, contig, rs, re_):
    """rovaca_tpu's "ours" section of scripts/golden_region.py (lines
    36-51's read set, 69-95's chain and lines) as text."""
    from rovaca_tpu.io.fasta import FastaFile
    from rovaca_tpu.ops import pairhmm
    from rovaca_tpu.pipeline.caller import HaplotypeCaller, HCArgs
    from rovaca_tpu.pipeline.hc_engine import CallerConfig, RegionCaller
    hc = HaplotypeCaller(HCArgs(bam_paths=[bam], reference_path=fasta,
                                output_path=os.devnull))
    pad_s, pad_e = rs - 100, re_ + 1 + 100
    region_reads = None
    for c, reads in hc._reads_by_contig(hc._open_reader(None), None):
        if c == contig:
            region_reads = [x for x in reads
                            if x.pos < pad_e and x.end > pad_s]
            break
    assert region_reads, "no reads overlap the region"
    ref = FastaFile(fasta).fetch(contig)

    class R:
        start, end, is_active = rs, re_, True
    caller = RegionCaller(CallerConfig(), {contig: len(ref)})
    p = caller.prepare_region(R, region_reads, ref, contig)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if isinstance(p, list):
            print("trimmed: none")
            return out.getvalue()
        print(f"trimmed: {p.variant_span[0] + 1}-{p.variant_span[1] + 1} "
              f"padded: {p.span[0] + 1}-{p.span[1] + 1}")
        print(f"pairhmm_reads: {len(p.call_reads)}")
        for r in sorted(p.call_reads, key=lambda r: (r.name, r.pos)):
            q = "".join(chr(x + 33) for x in r.quals)
            print(f"  {r.name}\t{r.pos + 1}\t{r.cigar}\t{r.bases.decode()}"
                  f"\t{q}")
        lik, kept = pairhmm.compute_likelihoods(
            p.call_reads, [h.bases for h in p.haps], engine="xla")
        calls = caller.finish_region(p, lik, kept)
        for c in calls:
            g = c.genotypes[0]
            ad = ",".join(str(x) for x in (g.ad or []))
            pl = ",".join(str(x) for x in (g.pl or []))
            alts = ",".join(a.bases.decode() for a in c.alleles)
            print(f"variant: {c.start + 1} {alts} QUAL={c.qual:.2f} "
                  f"AD={ad} DP={g.dp} GQ={g.gq} PL={pl}")
    return out.getvalue()


def generate(work):
    """Write the tools' references into tests/golden_torch/ and their
    entries into MANIFEST.json (the other entries stay); ``work`` holds
    the corpora and the runs."""
    manifest = golden_flows.load_manifest()
    files = manifest["files"]

    def record(name, command, seed, corpus):
        files[name] = {"command": command, "seed": seed, "corpus": corpus,
                       "engine": "xla",
                       "sha256": golden_flows.sha256_file(
                           os.path.join(GOLDEN_DIR, name))}

    # BQSR: the script's corpus and table, the port's the same files
    script_bqsr = load_script("golden_bqsr")
    c = golden_bqsr.CORPUS
    d = os.path.join(work, "bqsr")
    port_d = os.path.join(work, "bqsr_port")
    with contextlib.redirect_stdout(io.StringIO()):
        script_bqsr.generate(d, c["genome_len"], c["coverage"], c["seed"])
        golden_bqsr.generate(port_d)
    names = ["ref.fa", "sample.bam payload", "truth.txt", "recal.table"]
    manifest[golden_bqsr.CORPUS_KEY] = {
        "args": c, "command": "python scripts/golden_bqsr.py gen DIR "
        f"{c['genome_len']} {c['coverage']} {c['seed']}",
        **_same_files(d, port_d, names)}
    out = os.path.join(d, "bqsr_full.vcf")
    argv = _jax_argv([os.path.join(d, "sample.bam")],
                     os.path.join(d, "ref.fa"), out,
                     *golden_bqsr.table_flags(d))
    assert jax_cli(argv) == 0
    _xz(out, os.path.join(GOLDEN_DIR, golden_bqsr.REFERENCE))
    record(golden_bqsr.REFERENCE, _command(argv, d) + "; xz -9 the output",
           c["seed"], c)

    # the modes: the script's corpora (its binary leg cut off), the port's
    # the same files; multibam the port's (its split is stable)
    script_modes = load_script("golden_modes")
    script_modes._run_both_and_diff = lambda *a, **k: True
    for mode in golden_modes.MODES:
        d = os.path.join(work, "modes", mode)
        port_d = os.path.join(work, "modes_port", mode)
        names = ["ref.fa", "sample.bam payload"] + {
            "multibam": ["a.bam payload", "b.bam payload"],
            "dbsnp": ["dbsnp.vcf"], "bed": ["targets.bed"]}.get(mode, [])
        args = {"mode": mode, "seed": golden_modes.SEED}
        if mode == "multibam":
            golden_modes.generate(mode, d)
            hashes = golden_flows.corpus_hashes(d, names)
            command = ("python -m rovaca_tpu_torch.tools.golden_modes gen "
                       f"multibam DIR {golden_modes.SEED}")
        else:
            script_modes.MODES[mode](d, golden_modes.SEED)
            golden_modes.generate(mode, port_d)
            hashes = _same_files(d, port_d, names)
            command = (f"scripts/golden_modes.py mode_{mode}(DIR, "
                       f"{golden_modes.SEED}) without its binary leg")
        manifest[golden_modes.corpus_key(mode)] = {
            "args": args, "command": command, **hashes}
        out = os.path.join(d, f"modes_{mode}.vcf")
        argv = _jax_argv(golden_modes.bams(mode, d),
                         os.path.join(d, "ref.fa"), out,
                         *golden_modes.ours_flags(mode, d))
        assert jax_cli(argv) == 0
        name = golden_modes.REFERENCES[mode]
        _xz(out, os.path.join(GOLDEN_DIR, name))
        record(name, _command(argv, d) + "; xz -9 the output",
               golden_modes.SEED, args)

    # the region report on the committed 50 kb corpus
    bam = os.path.join(GOLDEN_DIR, "sample.bam")
    fasta = os.path.join(GOLDEN_DIR, "ref.fa")
    with open(golden_region.REPORT, "w") as f:
        for contig, s, e in region_bounds():
            f.write(f"{golden_region.HEADER}{contig} {s} {e}\n")
            f.write(jax_region_report(bam, fasta, contig, s, e))
    record("region_report.txt",
           "tests/test_torch_golden_tools.py:jax_region_report (rovaca_tpu, "
           "scripts/golden_region.py:69-95, engine xla) on sample.bam and "
           "ref.fa at chr20 " + ", ".join(f"{s}-{e}" for _, s, e in
                                          region_bounds()),
           golden_flows.CORPUS["seed"], golden_flows.CORPUS)

    manifest["generator_tools"] = ("JAX_PLATFORMS=cpu PYTHONPATH=. python "
                                   "tests/test_torch_golden_tools.py --work "
                                   "DIR")
    manifest["files"] = dict(sorted(files.items()))
    with open(os.path.join(GOLDEN_DIR, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="Regenerate the golden tools' "
                                "references in tests/golden_torch/ with "
                                "rovaca_tpu's xla engine")
    p.add_argument("--work", required=True,
                   help="scratch directory for the corpora and the runs")
    generate(p.parse_args().work)
