"""The port's reference-golden tools against the C++ reference's committed
outputs and against rovaca_tpu's scripts, on the CPU.

tests/golden/ holds what the reference binary gave: pairhmm_result_ref.txt
(its AVX-512 rovaca::call_pairhmm on the 64 cases of pairhmm_cases.txt) and
assembly_result_ref.txt (its FakeAssembler on the 80 regions of
assembly_cases.txt / assembly_ref.txt). Tolerances:

- PairHMM: the bar of tests/test_golden_pairhmm.py, the same kept read set
  and every post-normalization log10 cell within 4e-3 of the reference's
  (``golden_pairhmm.GOLDEN_ATOL``), and here, where the plain versions and
  the native engine run, also within diff's tighter rtol 5e-5 / atol 1e-4
  (no case outside them). The port against rovaca_tpu's xla engine: the
  same kept set and 4e-3.
- Assembly: the read count and the sorted haplotype set identical in every
  region (tests/test_golden_assembly.py's bar).
- gen and the SAM round trip: byte for byte.

By default the torch engine scores the stratified subset range(0, 64, 3) of
tests/test_golden_pairhmm.py; ROVACA_GOLDEN_FULL=1 runs all 64 cases.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from rovaca_tpu_torch.tools import golden_assembly, golden_pairhmm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
FULL = os.environ.get("ROVACA_GOLDEN_FULL") == "1"
SUBSET = range(64) if FULL else range(0, 64, 3)
TIGHT = "no case outside rtol 5e-5 / atol 1e-4"


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _held(res, n_cases):
    assert res["cases"] == n_cases
    assert not res["mismatches"], "\n".join(res["mismatches"])
    assert res["worst_abs"] <= golden_pairhmm.GOLDEN_ATOL
    assert res["outside_tight"] == 0, TIGHT
    # the plain versions and the native engine launch no kernel
    assert res["launches"] == {"pairhmm_indexed": 0, "pairhmm_dense": 0}


def test_native_engine_matches_reference_on_all_cases():
    _held(golden_pairhmm.golden("native"), 64)


def test_dense_plain_path_matches_reference():
    """compute_likelihoods(engine="torch"): K2's plain version."""
    res = golden_pairhmm.golden("torch", cases=SUBSET)
    _held(res, len(SUBSET))
    assert res["scheduler_launches"] is None


def test_scheduler_plain_path_matches_reference():
    """One PairHMMScheduler flush group, engine torch: K1's plain version
    on compact batches."""
    res = golden_pairhmm.golden("torch", scheduler=True, cases=SUBSET)
    _held(res, len(SUBSET))
    assert res["scheduler_launches"] >= 1


def test_port_matches_rovaca_tpu_xla():
    """The port's compute_likelihoods(engine="torch") against rovaca_tpu's
    (engine="xla") on three cases, each package on its own records: the
    same kept reads, every cell within 4e-3."""
    from rovaca_tpu.ops.pairhmm import api as jax_api
    from rovaca_tpu_torch.ops.pairhmm import api
    script = _script("golden_pairhmm")
    path = os.path.join(GOLDEN, "pairhmm_cases.txt")
    ours = golden_pairhmm.read_pairhmm_case_file(path)
    with open(path) as fh:
        lines = fh.readlines()
    for ci in (0, 31, 63):
        haps, reads = ours[ci]
        hap_bytes = [h.encode() for h in haps]
        theirs = [script.parse_sam_line(sam_line) for sam_line in
                  _case_read_lines(lines, ci)]
        lik, kept = api.compute_likelihoods(reads, hap_bytes,
                                            pcr_model="CONSERVATIVE",
                                            engine="torch")
        jlik, jkept = jax_api.compute_likelihoods(theirs, hap_bytes,
                                                  pcr_model="CONSERVATIVE",
                                                  engine="xla")
        np.testing.assert_array_equal(kept, jkept)
        assert lik.shape == jlik.shape
        assert float(np.abs(lik - jlik).max(initial=0.0)) \
            <= golden_pairhmm.GOLDEN_ATOL, ci


def _case_read_lines(lines, ci):
    """The SAM lines of case ``ci`` of a PairHMM case file's lines."""
    i = 0
    for _ in range(ci + 1):
        h, r = map(int, lines[i].split())
        start = i + 1 + h
        i = start + r
    return lines[start:start + r]


def test_assembly_matches_reference_binary():
    n, mismatches = golden_assembly.golden()
    assert n == 80
    assert not mismatches, "\n".join(mismatches)


def test_gen_matches_the_scripts(tmp_path):
    """Both tools' gen give the scripts' gen files byte for byte (for
    golden_pairhmm, today's script output: the committed case file is
    frozen and differs from it in a few overlapping mates' quals)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for tool, mod, files in (
            ("golden_assembly", golden_assembly, ("cases.txt", "ref.txt")),
            ("golden_pairhmm", golden_pairhmm, ("cases.txt",))):
        ours, theirs = tmp_path / f"{tool}_ours", tmp_path / f"{tool}_theirs"
        assert mod.main(["gen", str(ours)]) == 0
        subprocess.run([sys.executable,
                        os.path.join(REPO, "scripts", f"{tool}.py"), "gen",
                        str(theirs)], check=True, capture_output=True,
                       cwd=REPO, env=env)
        for name in files:
            assert (ours / name).read_bytes() == \
                (theirs / name).read_bytes(), (tool, name)
    committed = os.path.join(GOLDEN, "assembly_cases.txt")
    with open(committed, "rb") as fh:
        assert (tmp_path / "golden_assembly_ours" / "cases.txt"
                ).read_bytes() == fh.read()


def test_sam_round_trip_matches_the_script():
    """parse_sam_line then sam_line gives back every read line of both
    committed case files, as the script's pair does, and the two records
    carry the same fields."""
    script = _script("golden_assembly")
    n = 0
    for lines in _sam_lines():
        for contig, line in lines:
            ours = golden_assembly.parse_sam_line(line, contig)
            theirs = script.parse_sam_line(line, contig)
            assert golden_assembly.sam_line(ours, contig) == line.rstrip("\n")
            assert script.sam_line(theirs, contig) == line.rstrip("\n")
            for f in ("name", "flag", "pos", "mapping_quality", "bases",
                      "mate_pos", "tlen", "mate_ref_id", "contig"):
                assert getattr(ours, f) == getattr(theirs, f), (f, line)
            assert str(ours.cigar) == str(theirs.cigar)
            np.testing.assert_array_equal(ours.quals, theirs.quals)
            n += 1
    assert n == 7515     # 4,242 assembly reads and 3,273 PairHMM reads


def _sam_lines():
    """[(contig, SAM line)] of the assembly and PairHMM case files."""
    out = []
    with open(os.path.join(GOLDEN, "assembly_cases.txt")) as fh:
        while True:
            head = fh.readline()
            if not head.strip():
                break
            c, _, _, k = head.split("\t")
            out += [(c, fh.readline()) for _ in range(int(k))]
            fh.readline()
    yield out
    with open(os.path.join(GOLDEN, "pairhmm_cases.txt")) as fh:
        lines = fh.readlines()
    out, i = [], 0
    while i < len(lines) and lines[i].strip():
        h, r = map(int, lines[i].split())
        out += [("chr1", ln) for ln in lines[i + 1 + h:i + 1 + h + r]]
        i += 1 + h + r
    yield out


@pytest.mark.parametrize("tool", ["golden_pairhmm", "golden_assembly"])
def test_ref_without_binary_stops_with_one_line(tool, tmp_path, monkeypatch):
    mod = {"golden_pairhmm": golden_pairhmm,
           "golden_assembly": golden_assembly}[tool]
    monkeypatch.setattr(mod, "REF_BIN", str(tmp_path / "missing"))
    with pytest.raises(SystemExit) as exc:
        mod.main(["ref", str(tmp_path)])
    assert isinstance(exc.value.code, str)
    assert "reference binary missing" in exc.value.code
    assert "\n" not in exc.value.code
    assert not os.path.exists(tmp_path / "result_ref.txt")


@pytest.mark.parametrize("scheduler", [False, True])
def test_cuda_engine_refused_without_a_card(scheduler, monkeypatch):
    """--engine cuda stops with one line; the library call raises. Neither
    falls back to the plain version or to native."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["golden", "--engine", "cuda"] + (["--scheduler"] if scheduler
                                             else [])
    with pytest.raises(SystemExit) as exc:
        golden_pairhmm.main(argv)
    assert "needs a CUDA device" in exc.value.code
    assert "\n" not in exc.value.code
    with pytest.raises(RuntimeError, match="no CUDA device"):
        golden_pairhmm.golden("cuda", scheduler=scheduler, cases=[0])
