"""rovaca_tpu_torch CLI end to end against rovaca_tpu's, on the CPU.

The standard case (tests/simdata.make_standard_case) goes through
``rovaca_tpu_torch.cli --pairhmm-engine torch`` (with the default native SW
realignment, and with ROVACA_BANDED_REALIGN=1, the banded SW's plain version
on the CPU) and ``rovaca_tpu.cli --pairhmm-engine xla``. (CHROM, POS, REF,
ALT, GT) must be identical and the other fields within
scripts/golden_e2e.py's QUAL_TOL, FLOAT_TOL and PL_TOL; GVCF band rows must
be identical. Runs of the port's CLI in fresh interpreters (plain, banded,
``--shards 2``, ``-t 2``; ranks in test_torch_distributed.py) show that
neither they nor any process they start imports jax or any module of
rovaca_tpu; an incomplete multi-process environment is refused.
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


# Installed on PYTHONPATH by _run_without_jax: every interpreter started
# with it (the CLI, its shard processes, -t workers, ranks) appends
# "<pid> jax=<bool> rovaca_tpu=<bool> <argv, or pool-worker>" to
# $ROVACA_TEST_MARKS as it exits; rovaca_tpu is True when rovaca_tpu or any
# rovaca_tpu.* module is in sys.modules.
_MARK_SITECUSTOMIZE = """\
import atexit, os, sys

def _mark():
    mp = sys.modules.get("multiprocessing")
    child = mp is not None and mp.parent_process() is not None
    role = "pool-worker" if child else " ".join(sys.argv)[:300]
    ref = any(m == "rovaca_tpu" or m.startswith("rovaca_tpu.")
              for m in sys.modules)
    with open(os.environ["ROVACA_TEST_MARKS"], "a") as f:
        f.write(f"{os.getpid()} jax={'jax' in sys.modules} "
                f"rovaca_tpu={ref} {role}\\n")

atexit.register(_mark)
"""


def _run_without_jax(case, env_extra, argv=("-e", "GVCF"), out="nojax.vcf",
                     ranks=({},), timeout=300):
    """The port's CLI (torch engine, GVCF by default) in fresh interpreters,
    one per entry of ``ranks`` (its environment on top of ``env_extra``),
    all started together. Each asserts that neither jax nor a module of
    rovaca_tpu entered its sys.modules; so does every process they start
    (shards, -t workers), through the marks a sitecustomize writes as each
    interpreter exits. Returns (the first process's stats, the marks'
    lines)."""
    tmp, fasta, bam = case
    output = str(tmp / out)
    code = (
        "import json, sys\n"
        "from rovaca_tpu_torch import cli\n"
        "stats = {}\n"
        f"rc = cli.main(['HaplotypeCaller', '-i', {bam!r}, '-r', {fasta!r},"
        f" '-o', {output!r}, '--pairhmm-engine', 'torch',"
        f" *{list(argv)!r}], stats=stats)\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not [m for m in sys.modules if m == 'rovaca_tpu'"
        " or m.startswith('rovaca_tpu.')], 'rovaca_tpu was imported'\n"
        "print('NOJAX_OK', json.dumps(stats))\n")
    site = tmp / f"{out}.site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_MARK_SITECUSTOMIZE)
    marks = tmp / f"{out}.marks"
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "ROVACA_BANDED_REALIGN")}
    env.update(PYTHONPATH=f"{site}{os.pathsep}{REPO}",
               ROVACA_TEST_MARKS=str(marks), **env_extra)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=str(tmp),
                              env={**env, **rank_env}, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for rank_env in ranks]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
        assert "NOJAX_OK" in so
    lines = marks.read_text().splitlines()
    assert lines and all(" jax=False rovaca_tpu=False " in ln
                         for ln in lines), lines
    return json.loads(outs[0][0].split("NOJAX_OK", 1)[1]), lines


def test_cli_run_never_imports_jax(standard_case):
    stats, marks = _run_without_jax(standard_case, {})
    assert stats["sw_launches"] == 0
    assert len(marks) == 1


def test_banded_cli_run_never_imports_jax(error_case):
    stats, _ = _run_without_jax(error_case, {"ROVACA_BANDED_REALIGN": "1"})
    assert stats["sw_launches"] > 0


@pytest.mark.parametrize("argv,role,n_role", [
    (["--shards", "2"], "rovaca_tpu_torch/cli.py HaplotypeCaller", 2),
    (["-t", "2"], " pool-worker", 2),
], ids=["shards", "host_workers"])
def test_parallel_cli_run_never_imports_jax(standard_case, argv, role,
                                            n_role):
    """--shards 2 and -t 2: neither the CLI nor the shard processes or
    worker processes it starts import jax."""
    _, marks = _run_without_jax(standard_case, {}, argv=argv,
                                out=f"nojax_{argv[0].strip('-')}.vcf")
    assert sum(role in ln for ln in marks) >= n_role, marks


_REFUSED = {"ROVACA_AUTO_DISTRIBUTED": "torchrun's environment",
            "JAX_COORDINATOR_ADDRESS": "needs JAX_NUM_PROCESSES"}


@pytest.mark.parametrize("argv,env", [
    (["--shards", "1"], {"ROVACA_AUTO_DISTRIBUTED": "1"}),
    (["-t", "1"], {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1"}),
])
def test_unported_paths_are_refused(standard_case, monkeypatch, capsys,
                                    argv, env):
    """An incomplete multi-process environment is refused with exit code 2
    before any rendezvous (ROVACA_AUTO_DISTRIBUTED reads torchrun's names;
    rovaca_tpu's cloud-TPU auto-detection has no counterpart)."""
    tmp, fasta, bam = standard_case
    msg = _REFUSED[next(iter(env))]
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
              "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc = port_cli(["HaplotypeCaller", "-i", bam, "-r", fasta, "-o",
                   str(tmp / "refused.vcf"), "--pairhmm-engine", "torch",
                   *argv])
    assert rc == 2
    err = capsys.readouterr().err
    assert "error: " in err and msg in err, err
    assert not os.path.exists(tmp / "refused.vcf")


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
    assert jax_cli(["IndexFeatureFile", "-i", vcf_gz, "-o",
                    str(tmp / "ref.tbi")]) == 0
    with open(vcf_gz + ".tbi", "rb") as a, open(tmp / "ref.tbi", "rb") as b:
        assert a.read() == b.read()
