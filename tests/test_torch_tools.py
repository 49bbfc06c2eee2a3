"""The measuring tools of rovaca_tpu_torch (rovaca_tpu_torch/tools/), on the
CPU, against their scripts/ and bench.py counterparts.

Each test works on a copy of the 50 kb corpus committed in
tests/golden_torch/ with the ``native`` engine:

- golden_e2e's command line: ``gen`` writes the FASTA, BAM payload and
  truth list of ``scripts/golden_e2e.py gen`` for the same arguments;
  ``ours --engine native`` then ``diff`` against the committed VCF gives
  ``RESULT: MATCH``; ``ref`` without the reference binary stops with one
  line and no traceback;
- race_e2e with two native contenders (VCF, GVCF) and two rounds writes a
  RACE.json with both runs in round-robin order, medians, own walls, the
  reference binary's contenders under ``skipped`` and every output matching
  the committed references; a cuda contender without a card stops the race
  before any run;
- host_profile's layers cover every row and take at least 90% of the
  profiled time; reference confidence has time in GVCF mode only;
- kernel_bench's batch is bench.py's through rovaca_tpu's
  build_pair_batch and build_pair_batch_compact, with the same effective
  cells; without a card its main exits 1 and prints no
  metric line; its CPU baseline runs one copy a core at once;
- scaling_bench with 1 and 2 shards writes SCALING.json and the split's
  VCF passes depth_masked_diff;
- simdata.simulate_reads is tests/simdata.py's, read for read;
- accuracy_eval.make_truth is scripts/accuracy_eval.py's, make_corpus
  writes the FASTA and BAM payload the script's steps build, and score_calls
  gives the stated recall, precision and concordance on the committed VCF
  and on a copy with a call dropped, one added and a genotype changed.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from rovaca_tpu.ops.pairhmm import compact as jax_compact
from rovaca_tpu.ops.pairhmm import prep as jax_prep
from rovaca_tpu_torch.io.fasta import FastaFile
from rovaca_tpu_torch.tools import (accuracy_eval, golden_e2e, golden_flows,
                                    host_profile, kernel_bench, race_e2e,
                                    scaling_bench)
from rovaca_tpu_torch.tools import simdata as port_simdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = golden_flows.GOLDEN_DIR
CORPUS_FILES = ("sample.bam", "sample.bam.bai", "ref.fa", "ref.fa.fai",
                "truth.txt")
N_READS = 15363          # reads of the committed 50 kb corpus
N_TRUTH = 20             # its truth variants


@pytest.fixture
def corpus(tmp_path):
    d = tmp_path / "corpus"
    d.mkdir()
    for name in CORPUS_FILES:
        shutil.copy(os.path.join(GOLDEN, name), d)
    return str(d)


@pytest.fixture
def no_ref_bin(monkeypatch, tmp_path):
    monkeypatch.setattr(golden_e2e, "REF_BIN",
                        str(tmp_path / "missing" / "rovaca"))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_gen_matches_the_jax_script(tmp_path):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    assert golden_e2e.main(["gen", str(ours), "20000", "30", "7"]) == 0
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "golden_e2e.py"), "gen",
                    str(theirs), "20000", "30", "7"], check=True,
                   capture_output=True,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    for name in ("ref.fa", "truth.txt"):
        assert _read(ours / name) == _read(theirs / name), name
    assert (golden_flows.sha256_bam_payload(str(ours / "sample.bam"))
            == golden_flows.sha256_bam_payload(str(theirs / "sample.bam")))


def test_ours_then_diff_matches_committed_vcf(corpus, capsys):
    assert golden_e2e.main(["ours", corpus, "--engine", "native"]) == 0
    golden_flows.unpack_reference(golden_flows.reference_name("vcf"),
                                  os.path.join(corpus, "ref.vcf"))
    assert golden_e2e.main(["diff", corpus, "--check-id"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "RESULT: MATCH"


def test_ref_without_binary_stops_with_one_line(corpus, monkeypatch,
                                                tmp_path):
    real = golden_e2e.REF_BIN
    monkeypatch.setattr(golden_e2e, "REF_BIN", str(tmp_path / "missing"))
    with pytest.raises(SystemExit) as exc:
        golden_e2e.main(["ref", corpus])
    assert isinstance(exc.value.code, str)
    assert "reference binary missing" in exc.value.code
    assert "\n" not in exc.value.code
    assert not os.path.exists(os.path.join(corpus, "ref.vcf"))
    if not os.path.exists(real):    # the command line, in this checkout
        r = subprocess.run([sys.executable, "-m",
                            "rovaca_tpu_torch.tools.golden_e2e", "ref",
                            corpus], capture_output=True, text=True,
                           cwd=REPO)
        assert r.returncode != 0
        assert len(r.stderr.strip().splitlines()) == 1, r.stderr
        assert "Traceback" not in r.stderr


def test_race_of_native_contenders(corpus, tmp_path, no_ref_bin):
    out = str(tmp_path / "race")
    names = ("native", "native_gvcf", "reference_avx", "reference_avx_gvcf")
    res = race_e2e.run_race(corpus, out, names, n_runs=2,
                            log=lambda line: None)
    with open(os.path.join(out, "RACE.json")) as f:
        js = json.load(f)
    assert js["n_reads"] == N_READS and js["n_runs"] == 2
    assert js["sequence"] == ["native", "native_gvcf"] * 2
    assert sorted(js["skipped"]) == ["reference_avx", "reference_avx_gvcf"]
    assert js["held_to"] == "rovaca_tpu's committed output"
    assert sorted(js["contenders"]) == ["native", "native_gvcf"]
    for name, c in js["contenders"].items():
        assert len(c["runs_s"]) == 2 and len(c["own_s"]) == 2
        assert c["wall_s"] == pytest.approx(sum(c["runs_s"]) / 2)
        assert c["spread_s"] == [min(c["runs_s"]), max(c["runs_s"])]
        assert all(0 < own < wall for own, wall in zip(c["own_s"],
                                                       c["runs_s"]))
        assert c["launches"] == [0, 0] and c["card_s"] == [0.0, 0.0]
        assert len(c["cpu_s"]) == 2 and all(0 < cpu for cpu in c["cpu_s"])
        assert c["reads_per_s"] == pytest.approx(N_READS / c["wall_s"])
        assert c["ok"] and c["diff"] == "RESULT: MATCH", (name, c["diff"])
        assert c["vs_reference"] is None
    assert res["contenders"]["native_gvcf"]["own_median_s"] > 0


@pytest.mark.parametrize("rounds", [2, 4])
def test_race_runs_every_round(corpus, tmp_path, monkeypatch, rounds):
    """The race runs the rounds it is asked for, whatever they take."""
    def fake_run(name, cmd, env):
        golden_flows.unpack_reference(golden_flows.reference_name("vcf"),
                                      cmd[cmd.index("-o") + 1])
        return 1.0, [(N_READS, 21, 20, 0.5, 0, 0.0)], 0.9

    monkeypatch.setattr(race_e2e, "_run", fake_run)
    res = race_e2e.run_race(corpus, str(tmp_path / "race"), ("native",),
                            n_runs=rounds, log=lambda line: None)
    assert res["n_runs"] == rounds
    assert res["sequence"] == ["native"] * rounds
    c = res["contenders"]["native"]
    assert c["runs_s"] == [1.0] * rounds and c["own_s"] == [0.5] * rounds
    assert c["diff"] == "RESULT: MATCH"


def test_race_refuses_cuda_without_a_card(corpus, tmp_path, no_card):
    out = tmp_path / "race"
    with pytest.raises(SystemExit) as exc:
        race_e2e.run_race(corpus, str(out), ("native", "cuda"), n_runs=1)
    assert "needs a CUDA device" in exc.value.code
    assert not out.exists() or not any(out.iterdir())
    with pytest.raises(SystemExit):
        race_e2e.main([corpus, "--contenders", "cuda_gvcf",
                       "--out", str(out)])


@pytest.mark.parametrize("gvcf", [False, True])
def test_host_profile_covers_the_layers(corpus, gvcf):
    out = os.path.join(corpus, "profile.json")
    argv = [corpus, "--engine", "native", "--out", out]
    argv += ["--gvcf"] if gvcf else ["--torch-profiler"]
    assert host_profile.main(argv) == 0
    with open(out) as f:
        res = json.load(f)
    rows = res["rows"]
    assert sorted(rows) == sorted(host_profile.ROWS)
    assert sum(rows.values()) == pytest.approx(res["profiled_s"], rel=1e-6)
    named = sum(v for k, v in rows.items() if k != "other")
    assert named >= 0.9 * res["profiled_s"], rows
    assert res["layers"]["host_prep"] == pytest.approx(
        sum(v for k, v in rows.items() if k.startswith("host_prep/")))
    assert (rows["ref_confidence"] > 0) == gvcf
    assert (rows["block_combiner"] > 0) == gvcf
    assert rows["pairhmm_launch"] > 0 and rows["genotyping_write"] > 0
    assert res["stats"]["calls"] > 0 and len(res["top_cumulative"]) == 25
    if not gvcf:     # no card here: the trace holds no device time
        assert res["torch_profiler"]["card_busy_share"] == "not measured"


def test_kernel_bench_batch_is_bench_py_s():
    """bench.py:143-169's reads and haps, batched by rovaca_tpu's
    build_pair_batch and build_pair_batch_compact, equal kernel_bench's
    batches, with the same effective cells."""
    batches, cells = kernel_bench.bench_batches()
    want_cells = 0
    for seed, (dense, comp) in zip((0, 1), batches):
        r2 = np.random.default_rng(seed)
        reads = []
        for _ in range(16 * 128):
            L = int(r2.integers(120, 152))
            reads.append(kernel_bench._Read(
                "".join(r2.choice(list("ACGT"), size=L)),
                r2.integers(10, 40, size=L)))
        haps = ["".join(r2.choice(list("ACGT"),
                                  size=int(r2.integers(300, 380))))
                for _ in range(8 * 8)]
        want = jax_prep.build_pair_batch(reads, haps)
        for name in ("trans", "rbase", "rlen", "hbase", "hlen"):
            np.testing.assert_array_equal(getattr(dense, name),
                                          getattr(want, name), name)
        want_c = jax_compact.build_pair_batch_compact(reads, haps)
        for name in ("q", "gi", "gc", "rbase", "rlen", "hcode", "hlen"):
            np.testing.assert_array_equal(getattr(comp, name),
                                          getattr(want_c, name), name)
        want_cells += sum(len(r.bases) * len(h) for r in reads for h in haps)
    assert cells == want_cells


def test_kernel_bench_without_a_card_prints_no_metric(capsys, no_card):
    assert kernel_bench.main([]) == 1
    captured = capsys.readouterr()
    assert "pairhmm_cell_updates_per_sec" not in captured.out
    assert "needs a CUDA device" in captured.err


def test_kernel_bench_cpu_baseline_is_measured_on_every_core(monkeypatch):
    """One copy of the AVX-512 bench a core, all at once, their rates
    summed; where the CPU cannot run it, both rates are "not measured"."""
    monkeypatch.setattr(kernel_bench, "BASELINE_ITERS", 50)
    base = kernel_bench.cpu_baseline()
    if base["per_core_cells_per_s"] == "not measured":
        assert base["cells_per_s"] == "not measured" and base["why"]
        return
    assert base["processes"] == len(os.sched_getaffinity(0))
    assert len(base["process_rates"]) == base["processes"]
    assert base["cells_per_s"] == pytest.approx(sum(base["process_rates"]))
    assert base["per_core_cells_per_s"] > 0
    assert all(r > 0 for r in base["process_rates"])


@pytest.mark.parametrize("tool", ["host_profile", "scaling_bench",
                                  "accuracy_eval"])
def test_cuda_measurement_refused_without_a_card(corpus, tool, no_card):
    main = {"host_profile": host_profile.main,
            "scaling_bench": scaling_bench.main,
            "accuracy_eval": accuracy_eval.main}[tool]
    argv = [corpus] if tool != "accuracy_eval" else [
        "--dir", os.path.join(corpus, "acc")]
    with pytest.raises(SystemExit) as exc:
        main(argv + ["--engine", "cuda"])
    assert "needs a CUDA device" in exc.value.code


def test_scaling_one_and_two_shards(corpus):
    res = scaling_bench.run_scaling(corpus, (1, 2), "native",
                                    log=lambda line: None)
    with open(os.path.join(corpus, "SCALING.json")) as f:
        js = json.load(f)
    assert sorted(js["runs"]) == ["1", "2"] and js["n_reads"] == N_READS
    two = js["runs"]["2"]
    assert two["ok"] and two["diff_vs_1shard"].startswith("MATCH"), two
    assert two["records"] == js["runs"]["1"]["records"] > 0
    assert two["efficiency_vs_1"] == pytest.approx(
        js["runs"]["1"]["wall_s"] / (2 * two["wall_s"]))
    assert js["startup_probe_s"] > 0 and res["path"].endswith("SCALING.json")


def _script_reads(simdata_mod, seed, ref, hap1, hap2, contig, n_per_hap):
    rng = np.random.default_rng(seed)
    return (simdata_mod.simulate_reads(rng, ref, hap1, contig, n_per_hap,
                                       name_prefix="h1_")
            + simdata_mod.simulate_reads(rng, ref, hap2, contig, n_per_hap,
                                         name_prefix="h2_"))


def _fields(r):
    return (r.name, r.flag, r.ref_id, r.pos, r.mapping_quality,
            str(r.cigar), r.bases, list(map(int, r.quals)), r.contig)


@pytest.mark.parametrize("seed", [5, 42])
def test_simulate_reads_is_the_jax_package_s(seed):
    """tools.simdata.simulate_reads and tests/simdata.py's give the same
    reads (name, flag, position, cigar, bases, quals) for one seed, on a
    haplotype with a SNP, an insertion and a deletion."""
    import simdata as jax_simdata
    rng = np.random.default_rng(seed)
    ref = jax_simdata.random_ref(rng, 6000)
    variants = [(1000, ref[1000], "ACGT"[("ACGT".index(ref[1000]) + 1) % 4]),
                (2500, ref[2500], ref[2500] + "GATT"),
                (4000, ref[4000:4006], ref[4000])]
    hap = jax_simdata.apply_variants(ref, variants)
    ours = _script_reads(port_simdata, seed, ref, ref, hap, "chr1", 300)
    theirs = _script_reads(jax_simdata, seed, ref, ref, hap, "chr1", 300)
    assert len(ours) == len(theirs) == 600
    assert [_fields(r) for r in ours] == [_fields(r) for r in theirs]
    assert any(set(str(r.cigar)) & set("IDS") for r in ours)


def test_make_corpus_is_the_script_s(tmp_path):
    """accuracy_eval.make_corpus writes the FASTA and the BAM payload that
    scripts/accuracy_eval.py's main builds for its seed (its steps, with
    tests/simdata.py and rovaca_tpu's writers), and the script's truth."""
    import simdata as jax_simdata
    from rovaca_tpu.io.fasta import write_fasta
    length, coverage, n_variants, seed = 12_000, 6, 8, 42
    ours = str(tmp_path / "ours")
    n = accuracy_eval.make_corpus(ours, length, coverage, n_variants, seed)
    rng = np.random.default_rng(seed)
    ref = jax_simdata.random_ref(rng, length)
    truth = accuracy_eval.make_truth(rng, ref, n_variants)
    hom = [(p, r, a) for p, r, a, g in truth if g == "hom"]
    het = [(p, r, a) for p, r, a, g in truth if g == "het"]
    hap1 = jax_simdata.apply_variants(ref, sorted(hom))
    hap2 = jax_simdata.apply_variants(ref, sorted(hom + het))
    n_per_hap = coverage * length // 100 // 2
    reads = (jax_simdata.simulate_reads(rng, ref, hap1, "chr1", n_per_hap,
                                        name_prefix="h1_")
             + jax_simdata.simulate_reads(rng, ref, hap2, "chr1", n_per_hap,
                                          name_prefix="h2_"))
    theirs = tmp_path / "theirs"
    theirs.mkdir()
    write_fasta(str(theirs / "ref.fa"), {"chr1": ref})
    jax_simdata.write_test_bam(str(theirs / "s.bam"), reads, "chr1", length)
    assert n == len(reads) > 0
    assert _read(os.path.join(ours, "ref.fa")) == _read(theirs / "ref.fa")
    assert (golden_flows.sha256_bam_payload(os.path.join(ours, "sample.bam"))
            == golden_flows.sha256_bam_payload(str(theirs / "s.bam")))
    assert accuracy_eval.read_truth(os.path.join(ours, "truth.txt")) == [
        ("chr1", p, r, a, g) for p, r, a, g in truth]


def test_make_truth_is_the_script_s(monkeypatch):
    # the script sets JAX_PLATFORMS, a compile cache and sys.path at import
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        "accuracy_eval_script", os.path.join(REPO, "scripts",
                                             "accuracy_eval.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    ref = "".join(np.random.default_rng(1).choice(list("ACGT"), size=30_000))
    for seed in (3, 42):
        assert (accuracy_eval.make_truth(np.random.default_rng(seed), ref, 40)
                == script.make_truth(np.random.default_rng(seed), ref, 40))


def _committed_vcf(tmp_path):
    path = str(tmp_path / "vcf.vcf")
    return golden_flows.unpack_reference(golden_flows.reference_name("vcf"),
                                         path)


def test_score_calls_on_the_committed_vcf(tmp_path):
    truth = os.path.join(GOLDEN, "truth.txt")
    ref = os.path.join(GOLDEN, "ref.fa")
    sc = accuracy_eval.score_calls(_committed_vcf(tmp_path), truth, ref)
    assert (sc["truth"], sc["tp"], sc["fn"], sc["fp"]) == (N_TRUTH, N_TRUTH,
                                                           0, 0)
    assert sc["recall"] == sc["precision"] == 1.0
    assert sc["genotype_concordance"] == 1.0
    # one call dropped, one spurious call added, one genotype flipped
    with open(_committed_vcf(tmp_path)) as f:
        lines = f.readlines()
    body = [i for i, ln in enumerate(lines) if not ln.startswith("#")]
    fields = lines[body[1]].split("\t")
    gt = fields[9].split(":")
    gt[0] = "1/1" if gt[0] in ("0/1", "0|1") else "0/1"
    fields[9] = ":".join(gt)
    lines[body[1]] = "\t".join(fields)
    extra = lines[body[2]].split("\t")
    extra[1] = str(int(extra[1]) + 7)
    base = bytes(FastaFile(ref).fetch(extra[0], int(extra[1]) - 1,
                                      int(extra[1]))).decode()
    extra[3], extra[4] = base, "ACGT"[("ACGT".index(base) + 1) % 4]
    del lines[body[0]]
    lines.append("\t".join(extra))
    edited = str(tmp_path / "edited.vcf")
    with open(edited, "w") as f:
        f.writelines(lines)
    sc = accuracy_eval.score_calls(edited, truth, ref)
    assert (sc["tp"], sc["fn"], sc["fp"]) == (N_TRUTH - 1, 1, 1)
    assert sc["recall"] == pytest.approx((N_TRUTH - 1) / N_TRUTH)
    assert sc["precision"] == pytest.approx((N_TRUTH - 1) / N_TRUTH)
    assert sc["genotype_concordance"] == pytest.approx(
        (N_TRUTH - 2) / (N_TRUTH - 1))


def test_accuracy_eval_end_to_end_on_native(tmp_path, capsys):
    d = str(tmp_path / "acc")
    assert accuracy_eval.main(["8000", "20", "6", "--engine", "native",
                               "--dir", d]) == 0
    out = capsys.readouterr().out
    assert "[acc] recall=" in out
    assert len(accuracy_eval.read_truth(os.path.join(d, "truth.txt"))) == 6
