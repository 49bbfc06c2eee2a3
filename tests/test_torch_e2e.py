"""rovaca_tpu_torch CLI end to end against rovaca_tpu's, on the CPU.

The standard case (tests/simdata.make_standard_case) goes through
``rovaca_tpu_torch.cli --pairhmm-engine torch`` (with the default native SW
realignment, and with ROVACA_BANDED_REALIGN=1, the banded SW's plain version
on the CPU) and ``rovaca_tpu.cli --pairhmm-engine xla``. (CHROM, POS, REF,
ALT, GT) must be identical and the other fields within
scripts/golden_e2e.py's QUAL_TOL, FLOAT_TOL and PL_TOL; GVCF band rows must
be identical.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from rovaca_tpu.cli import main as jax_cli
from rovaca_tpu_torch.cli import main as port_cli

import simdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import golden_e2e  # noqa: E402


@pytest.fixture(scope="module")
def standard_case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_e2e")
    fasta, bam, _, _ = simdata.make_standard_case(tmp)
    return tmp, fasta, bam


@pytest.fixture(scope="module")
def error_case(tmp_path_factory):
    """A 6 kb corpus whose reads carry sequencing errors
    (scripts/golden_e2e.generate), so that realignment has reads that are
    not exact substrings of their haplotype and the banded batch runs."""
    tmp = tmp_path_factory.mktemp("torch_e2e_errors")
    golden_e2e.generate(str(tmp), genome_len=6000, coverage=20, seed=7)
    return tmp, str(tmp / "ref.fa"), str(tmp / "sample.bam")


def _port_against_reference(case, monkeypatch, gvcf, name):
    """Run the port's CLI (torch engine) and rovaca_tpu's (xla engine) into
    <tmp>/<name>/; returns (golden_e2e.diff's code, the port's stats)."""
    tmp, fasta, bam = case
    out = tmp / name
    out.mkdir()
    mode = ["-e", "GVCF"] if gvcf else []
    ours = str(out / ("ours.g.vcf" if gvcf else "ours.vcf"))
    ref = str(out / ("ref.g.vcf" if gvcf else "ref.vcf"))
    stats = {}
    assert port_cli(["HaplotypeCaller", "-i", bam, "-r", fasta, "-o", ours,
                     "--pairhmm-engine", "torch", *mode], stats=stats) == 0
    monkeypatch.delenv("ROVACA_BANDED_REALIGN", raising=False)  # default
    assert jax_cli(["HaplotypeCaller", "-i", bam, "-r", fasta, "-o", ref,
                    "--pairhmm-engine", "xla", *mode]) == 0
    assert stats["regions"] > 0 and stats["calls"] > 0
    assert stats["launches"] > 0 and stats["device_ms"] == 0.0
    return golden_e2e.diff(str(out), gvcf=gvcf), stats


@pytest.mark.parametrize("gvcf", [False, True])
def test_port_matches_reference(standard_case, monkeypatch, gvcf):
    monkeypatch.delenv("ROVACA_BANDED_REALIGN", raising=False)
    rc, stats = _port_against_reference(standard_case, monkeypatch, gvcf,
                                        "gvcf" if gvcf else "vcf")
    assert rc == 0
    assert stats["sw_launches"] == stats["sw_fallbacks"] == 0


@pytest.mark.parametrize("gvcf", [False, True])
def test_banded_realign_matches_reference(error_case, monkeypatch, gvcf):
    monkeypatch.setenv("ROVACA_BANDED_REALIGN", "1")
    rc, stats = _port_against_reference(
        error_case, monkeypatch, gvcf,
        "banded_gvcf" if gvcf else "banded_vcf")
    assert rc == 0
    assert stats["sw_launches"] > 0
    assert stats["sw_fallbacks"] >= 0


def _run_without_jax(case, env_extra):
    """The port's CLI (torch engine, GVCF) in a fresh interpreter; asserts
    that jax never entered sys.modules. Returns the run's stats."""
    tmp, fasta, bam = case
    code = (
        "import json, sys\n"
        "from rovaca_tpu_torch import cli\n"
        "stats = {}\n"
        f"rc = cli.main(['HaplotypeCaller', '-i', {bam!r}, '-r', {fasta!r},"
        f" '-o', {str(tmp / 'nojax.vcf')!r}, '--pairhmm-engine', 'torch',"
        " '-e', 'GVCF'], stats=stats)\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('NOJAX_OK', json.dumps(stats))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "ROVACA_BANDED_REALIGN")}
    env["PYTHONPATH"] = REPO
    env.update(env_extra)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NOJAX_OK" in res.stdout
    return json.loads(res.stdout.split("NOJAX_OK", 1)[1])


def test_cli_run_never_imports_jax(standard_case):
    stats = _run_without_jax(standard_case, {})
    assert stats["sw_launches"] == 0


def test_banded_cli_run_never_imports_jax(error_case):
    stats = _run_without_jax(error_case, {"ROVACA_BANDED_REALIGN": "1"})
    assert stats["sw_launches"] > 0


@pytest.mark.parametrize("argv,env", [
    (["--shards", "2"], {}),
    (["-t", "2"], {}),
])
def test_unported_paths_are_refused(standard_case, monkeypatch, capsys,
                                    argv, env):
    tmp, fasta, bam = standard_case
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc = port_cli(["HaplotypeCaller", "-i", bam, "-r", fasta, "-o",
                   str(tmp / "refused.vcf"), "--pairhmm-engine", "torch",
                   *argv])
    assert rc == 2
    assert "not ported yet" in capsys.readouterr().err


def test_default_engine_needs_gpu(standard_case, monkeypatch):
    tmp, fasta, bam = standard_case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["HaplotypeCaller", "-i", bam, "-r", fasta, "-o",
                  str(tmp / "auto.vcf")])


def test_index_tools(standard_case):
    tmp, fasta, bam = standard_case
    bai = str(tmp / "port.bai")
    assert port_cli(["BuildBamIndex", "-i", bam, "-o", bai]) == 0
    assert jax_cli(["BuildBamIndex", "-i", bam, "-o",
                    str(tmp / "ref.bai")]) == 0
    with open(bai, "rb") as a, open(tmp / "ref.bai", "rb") as b:
        assert a.read() == b.read()
    vcf_gz = str(tmp / "calls.vcf.gz")
    assert port_cli(["HaplotypeCaller", "-i", bam, "-r", fasta, "-o",
                     vcf_gz, "--pairhmm-engine", "native"]) == 0
    assert port_cli(["IndexFeatureFile", "-i", vcf_gz]) == 0
    assert os.path.getsize(vcf_gz + ".tbi") > 0
