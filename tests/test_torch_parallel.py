"""rovaca_tpu_torch's parallel layer against rovaca_tpu's, on the CPU.

- ``shard_intervals`` and ``merge_shard_vcfs``: the same output as
  rovaca_tpu's, exactly (bytes, and tabix queries of a BGZF merge).
- ``sharded_pairhmm_step`` / ``sharded_pipeline_step`` on four CPU devices
  against rovaca_tpu's on a 4-device virtual mesh, fed the same numpy-seeded
  batches: rtol 2e-5 on pairs at or above MIN_ACCEPTED_F32 and the same set
  below it (the bar tests/test_pairhmm.py sets the native engine against
  XLA); the global best within rtol 2e-5.
- ``pipeline_dryrun``: passes, with rovaca_tpu's record count.
- The scheduler over a device list: array-equal to one device.
- ``platform.devices`` (every card, a torchrun rank's own card) and
  ``entry.entry`` against ``__graft_entry__.entry`` (rtol 2e-5).
- The CLI, each run in its own interpreter with a timeout: ``--shards 2``
  against the port's unsharded run (GVCF, per position) and against
  ``rovaca_tpu.cli --shards 2`` (VCF, golden_e2e); a failed shard fails
  the run; ``-t 2`` byte-identical to ``-t 1``; marked slow, the two-shard
  divergence confinement of tests/test_shard_confinement.py.
"""

import gzip
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rovaca_tpu.io import bgzf, tabix
from rovaca_tpu.ops.pairhmm import prep
from rovaca_tpu.parallel import pipeline_shard as jax_pipeline_shard
from rovaca_tpu.parallel import sharded_runner as jax_runner
from rovaca_tpu.parallel import sharding as jax_sharding
from rovaca_tpu_torch import entry
from rovaca_tpu_torch.ops.pairhmm import compact, dense, indexed
from rovaca_tpu_torch.parallel import pipeline_shard, sharded_runner, sharding
from rovaca_tpu_torch.pipeline.scheduler import PairHMMScheduler
from rovaca_tpu_torch.utils import platform

import simdata
from test_parallel import _expand_gvcf
from test_torch_pairhmm import assert_forward_close, region_case
from test_torch_scheduler import flush_group

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import golden_e2e  # noqa: E402

_entry_spec = importlib.util.spec_from_file_location(
    "graft_entry", REPO / "__graft_entry__.py")
graft_entry = importlib.util.module_from_spec(_entry_spec)
_entry_spec.loader.exec_module(graft_entry)

CPU4 = [torch.device("cpu")] * 4
S = 4
RTOL = 2e-5


# --------------------------------------------------------------------------
# interval math and merge
# --------------------------------------------------------------------------

@pytest.mark.parametrize("intervals,n_shards,kw", [
    ([("chr1", 0, 1000)], 4, {"boundary_pad": 50}),
    ([("chr1", 0, 600), ("chr2", 0, 600)], 3, {}),
    ([("c", 0, 3)], 8, {}),
])
def test_shard_intervals_cases(intervals, n_shards, kw):
    got = sharding.shard_intervals(intervals, n_shards, **kw)
    assert got == jax_sharding.shard_intervals(intervals, n_shards, **kw)
    assert len(got) == n_shards


@pytest.mark.parametrize("n_shards", range(1, 10))
def test_shard_intervals_random(n_shards):
    rng = np.random.default_rng(100 + n_shards)
    intervals = []
    for c in range(int(rng.integers(1, 5))):
        start = int(rng.integers(0, 5000))
        intervals.append((f"chr{c}", start,
                          start + int(rng.integers(1, 200_000))))
    pad = int(rng.integers(0, 2000))
    got = sharding.shard_intervals(intervals, n_shards, boundary_pad=pad)
    assert got == jax_sharding.shard_intervals(intervals, n_shards,
                                               boundary_pad=pad)
    total = sum(e - s for _, s, e in intervals)
    assert sum(c[4] - c[3] for s in got for c in s) == total


_HEADER = ("##fileformat=VCFv4.2\n##contig=<ID=chr1,length=1000>\n"
           "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")


def _write_shard(path, body, gz):
    text = (_HEADER + body).encode()
    if gz:
        with bgzf.Writer(path) as w:
            w.write(text)
    else:
        with open(path, "wb") as f:
            f.write(text)


@pytest.mark.parametrize("in_gz", [False, True])
@pytest.mark.parametrize("out_gz", [False, True])
def test_merge_matches_reference(tmp_path, in_gz, out_gz):
    bodies = ["chr1\t10\t.\tA\tC\t50\t.\tDP=9\n",
              "",
              "chr1\t500\t.\tG\tT\t60\t.\tDP=7\nchr1\t700\t.\tC\tA\t8\t.\t"
              "DP=3\n"]
    shards = []
    for k, body in enumerate(bodies):
        path = str(tmp_path / f"s{k}.vcf{'.gz' if in_gz else ''}")
        _write_shard(path, body, in_gz)
        shards.append(path)
    ext = ".vcf.gz" if out_gz else ".vcf"
    ours, ref = str(tmp_path / f"ours{ext}"), str(tmp_path / f"ref{ext}")
    counts = sharded_runner.merge_shard_vcfs(shards, ours)
    assert counts == jax_runner.merge_shard_vcfs(shards, ref) == [1, 0, 2]
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    opener = gzip.open if out_gz else open
    with opener(ours, "rt") as f:
        body = [ln for ln in f if not ln.startswith("#")]
    assert [ln.split("\t")[1] for ln in body] == ["10", "500", "700"]
    if out_gz:
        with open(ours + ".tbi", "rb") as a, open(ref + ".tbi", "rb") as b:
            assert a.read() == b.read()
        idx = tabix.TabixIndex.load(ours + ".tbi")
        got = list(tabix.fetch_lines(ours, idx, "chr1", 400, 600))
        assert len(got) == 1 and got[0].split("\t")[1] == "500"


# --------------------------------------------------------------------------
# sharded device steps against rovaca_tpu's on a 4-device virtual mesh
# --------------------------------------------------------------------------

def _dense_shards(seed):
    """S dense batches of one shape (GR 2, GH 2, Lr 128, Lh 256), stacked."""
    rng = np.random.default_rng(seed)
    batches = [prep.build_pair_batch(*region_case(rng, 150, 11),
                                     len_buckets=(128,),
                                     hap_len_buckets=(256,))
               for _ in range(S)]
    return tuple(np.stack([getattr(b, f) for b in batches])
                 for f in ("trans", "rbase", "rlen", "hbase", "hlen"))


def _compact_shards(seed, G=6):
    """S compact launches of one shape with G (hap tile, read tile) pairs
    each, repeated pairs included, stacked."""
    rng = np.random.default_rng(seed)
    launches = []
    for _ in range(S):
        b = compact.build_pair_batch_compact(*region_case(rng, 150, 11),
                                             len_buckets=(128,),
                                             hap_len_buckets=(256,))
        hidx = rng.integers(0, b.gh, G).astype(np.int32)
        ridx = rng.integers(0, b.gr, G).astype(np.int32)
        launches.append(b.arrays() + (hidx, ridx))
    return tuple(np.stack(parts) for parts in zip(*launches))


def test_sharded_pairhmm_step_matches_reference():
    inputs = _dense_shards(61)
    before = dense.LAUNCHES
    got, best = sharding.sharded_pairhmm_step(
        CPU4, *(torch.from_numpy(x) for x in inputs))
    assert dense.LAUNCHES == before          # the CPU runs the plain version
    mesh = jax_sharding.make_data_mesh(jax.devices()[:S])
    want, want_best = jax_sharding.sharded_pairhmm_step(mesh, *inputs)
    want = np.asarray(want)
    assert got.shape == want.shape == (S, 2, 2, 8, 128)
    assert_forward_close(got.numpy(), want, rtol=RTOL)
    np.testing.assert_allclose(float(best), float(want_best), rtol=RTOL)
    assert float(best) == got.numpy().max()


def test_sharded_pipeline_step_matches_reference():
    inputs = _compact_shards(62)
    before = indexed.LAUNCHES
    got = pipeline_shard.sharded_pipeline_step(
        CPU4, *(torch.from_numpy(x) for x in inputs))
    assert indexed.LAUNCHES == before
    mesh = jax_sharding.make_data_mesh(jax.devices()[:S])
    want = np.asarray(jax_pipeline_shard.sharded_pipeline_step(mesh,
                                                               *inputs))
    assert got.shape == want.shape == (S, 6, 8, 128)
    assert_forward_close(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("n_devices", [1, 2])
def test_sharded_steps_round_robin_over_devices(n_devices):
    """Any device list gives the one-device result: shard s runs on
    devices[s % n] and the gather keeps shard order."""
    inputs = tuple(torch.from_numpy(x) for x in _compact_shards(63, G=3))
    cpu = torch.device("cpu")
    got = pipeline_shard.sharded_pipeline_step([cpu] * n_devices, *inputs)
    for s in range(S):
        want = indexed.pairhmm_indexed_compact(*(x[s].contiguous()
                                                 for x in inputs))
        assert torch.equal(got[s], want)


def test_pipeline_dryrun_matches_reference():
    n = pipeline_shard.pipeline_dryrun(4, genome_len=6000, devices=CPU4)
    assert n >= 2
    assert n == jax_pipeline_shard.pipeline_dryrun(4, genome_len=6000)


def test_ordered_merge_matches_reference():
    per = [[("chr1", 5), ("chr1", 9)], [], [("chr2", 1)]]
    assert sharding.ordered_merge(per) == jax_sharding.ordered_merge(per)
    assert sharding.ordered_merge(per) == [("chr1", 5), ("chr1", 9),
                                           ("chr2", 1)]


def test_entry_matches_reference():
    """entry(): K2 on the example dense batch (its plain version on the
    CPU) against __graft_entry__.entry()'s pairhmm_xla on the same batch."""
    fn, args = entry.entry(device="cpu")
    got = fn(*args).numpy()
    jax_fn, jax_args = graft_entry.entry()
    want = np.asarray(jax_fn(*jax_args))
    assert got.shape == want.shape == (1, 1, 8, 128)
    assert_forward_close(got, want, rtol=RTOL)


def test_platform_devices(monkeypatch):
    """Every visible card, a torchrun rank's own card (LOCAL_RANK % n), or
    a card by index; no torch.device is touched on the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert platform.devices() == cards
    assert platform.device() == cards[0] and platform.device(1) == cards[1]
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert platform.devices() == [cards[1]] and platform.device() == cards[1]
    assert sharding.data_devices() == [cards[1]]


def test_data_devices_default_needs_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.data_devices()
    assert sharding.data_devices(CPU4) == CPU4


# --------------------------------------------------------------------------
# the scheduler over a device list
# --------------------------------------------------------------------------

def test_scheduler_device_list_matches_single_device():
    """Launches round-robin over three devices: results identical to one
    device (tests/test_parallel.py's multi-device scheduler test)."""
    jobs = flush_group(seed=35)
    out = {}
    for n in (3, 1):
        sched = PairHMMScheduler(engine="torch",
                                 devices=[torch.device("cpu")] * n)
        sched.NR_MAX, sched.NH_MAX, sched.G_MAX = 3, 3, 4   # many launches
        for key, reads, haps in jobs:
            sched.submit(key, reads, haps)
        out[n] = sched.run()
        assert sched.launches > 3
    assert out[3].keys() == out[1].keys()
    for key in out[1]:
        np.testing.assert_array_equal(out[3][key][1], out[1][key][1])
        np.testing.assert_array_equal(out[3][key][0], out[1][key][0])


def test_scheduler_default_devices():
    assert PairHMMScheduler(engine="torch").devices == [torch.device("cpu")]
    assert PairHMMScheduler(engine="native").devices == []
    with pytest.raises(ValueError, match="empty device list"):
        PairHMMScheduler(engine="torch", devices=[])


# --------------------------------------------------------------------------
# the CLI: --shards and -t
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def snp_case(tmp_path_factory):
    """tests/test_parallel.py's sharded-GVCF case: one het SNP at 3000 of a
    6 kb contig, 40 reads from each haplotype."""
    from rovaca_tpu.io.fasta import write_fasta
    tmp = tmp_path_factory.mktemp("torch_parallel")
    rng = np.random.default_rng(9)
    L = 6000
    ref = simdata.random_ref(rng, L)
    pos = 3000
    hap = ref[:pos] + ("A" if ref[pos] != "A" else "T") + ref[pos + 1:]
    reads = (simdata.simulate_reads(rng, ref, ref, "chr1", 40)
             + simdata.simulate_reads(rng, ref, hap, "chr1", 40))
    reads.sort(key=lambda r: r.pos)
    bam = str(tmp / "s.bam")
    fa = str(tmp / "ref.fa")
    simdata.write_test_bam(bam, reads, "chr1", L)
    write_fasta(fa, {"chr1": ref})
    return tmp, fa, bam


@pytest.fixture(scope="module")
def standard_case(tmp_path_factory):
    """simdata.make_standard_case: four variants on 3 kb at 24x."""
    tmp = tmp_path_factory.mktemp("torch_parallel_std")
    fasta, bam, _, _ = simdata.make_standard_case(tmp)
    return tmp, fasta, bam


def _cli(module, bam, fa, out, engine, *extra, timeout=300):
    """``python -m <module> HaplotypeCaller`` in a fresh interpreter whose
    shard processes take two threads each; returns (exit code, stderr)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", module, "HaplotypeCaller", "-i", bam, "-r", fa,
         "-o", str(out), "--pairhmm-engine", engine, "--log-level", "WARNING",
         *extra],
        env=env, capture_output=True, text=True, timeout=timeout)
    return res.returncode, res.stderr


def _port(bam, fa, out, *extra, engine="torch"):
    rc, err = _cli("rovaca_tpu_torch.cli", bam, fa, out, engine, *extra)
    assert rc == 0, err[-3000:]
    return err


def _summary(err):
    """(records, launches) from the CLI's summary line."""
    m = re.search(r"(\d+) records in [\d.]+s \((\d+) launches", err)
    return int(m.group(1)), int(m.group(2))


def test_sharded_gvcf_semantically_equal(snp_case):
    tmp, fa, bam = snp_case
    one, two = str(tmp / "one.g.vcf"), str(tmp / "two.g.vcf")
    _port(bam, fa, one, "-e", "GVCF")
    assert "sharded x2" in _port(bam, fa, two, "-e", "GVCF", "--shards", "2")
    a, b = _expand_gvcf(one), _expand_gvcf(two)
    assert a.keys() == b.keys()
    mismatch = {p for p in a if a[p] != b[p]}
    assert not mismatch, sorted(mismatch)[:5]
    assert not list(tmp.glob("two.g.vcf.shard*"))   # shard files removed


def _records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("#")]


def test_sharded_vcf_matches_reference_sharded(standard_case):
    tmp, fa, bam = standard_case
    out = tmp / "shards_vs_ref"
    out.mkdir()
    _port(bam, fa, out / "ours.vcf", "--shards", "2")
    rc, err = _cli("rovaca_tpu.cli", bam, fa, out / "ref.vcf", "xla",
                   "--shards", "2")
    assert rc == 0, err[-3000:]
    assert len(_records(out / "ours.vcf")) >= 4
    assert golden_e2e.diff(str(out)) == 0


def test_failed_shard_fails_the_run(standard_case):
    tmp, fa, bam = standard_case
    # the shards run engine 'cuda' and fail without a card
    rc, err = _cli("rovaca_tpu_torch.cli", bam, fa, tmp / "failed.vcf",
                   "cuda", "--shards", "2")
    assert rc == 1
    assert "shard process failed" in err and "no CUDA device" in err
    assert not os.path.exists(tmp / "failed.vcf")


def test_host_workers_output_identical(standard_case):
    tmp, fa, bam = standard_case
    one, two = tmp / "t1.vcf", tmp / "t2.vcf"
    assert _summary(_port(bam, fa, one))[0] >= 4
    records, launches = _summary(_port(bam, fa, two, "-t", "2"))
    assert records >= 4 and launches > 0
    assert one.read_bytes() == two.read_bytes()


# --------------------------------------------------------------------------
# divergence confinement (tests/test_shard_confinement.py's bar)
# --------------------------------------------------------------------------

_race_spec = importlib.util.spec_from_file_location(
    "race_e2e", REPO / "scripts" / "race_e2e.py")
race = importlib.util.module_from_spec(_race_spec)
_race_spec.loader.exec_module(race)


@pytest.mark.slow
def test_two_shard_divergence_confined(tmp_path):
    d = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), ROVACA_NATIVE_THREADS="1")
    gen = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "golden_e2e.py"),
         "gen", d, "60000", "30", "555111"],
        capture_output=True, text=True, timeout=600)
    assert gen.returncode == 0, gen.stderr[-500:]
    for name, extra in (("plain", []), ("shard", ["--shards", "2"])):
        cp = subprocess.run(
            [sys.executable, "-m", "rovaca_tpu_torch.cli", "HaplotypeCaller",
             "-i", f"{d}/sample.bam", "-r", f"{d}/ref.fa",
             "-o", f"{d}/{name}.vcf", "--pairhmm-engine", "torch"] + extra,
            env=env, capture_output=True, text=True, timeout=1200)
        assert cp.returncode == 0, cp.stderr[-800:]
    ok, detail = race.depth_masked_diff(f"{d}/plain.vcf", f"{d}/shard.vcf",
                                        bam_path=f"{d}/sample.bam")
    assert ok, detail
