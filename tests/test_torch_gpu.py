"""CUDA kernel tests of rovaca_tpu_torch; they skip without a GPU.

This file imports neither jax, nor anything of rovaca_tpu, nor the test
conftest, so it also runs on a GPU host that has neither:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: for the PairHMM kernels rtol 2e-5 against the plain torch
version on pairs at or above MIN_ACCEPTED_F32, the same set of pairs below it
(the float64 rescue set), exact zeros on padding lanes and haps; for the
banded SW kernel none: its four outputs must be bit-identical to the plain
version's, its traceback kernel's slots equal to the plain traceback's,
and its cigars equal to the exact host SW's.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from rovaca_tpu_torch import constants as C
from rovaca_tpu_torch.assembly.sw import (READ_TO_HAPLOTYPE_PARAMS,
                                          OverhangStrategy, _sw_align_python)
from rovaca_tpu_torch.ops.pairhmm import compact, dense, indexed, prep
from rovaca_tpu_torch.ops.sw import banded
from rovaca_tpu_torch.parallel.host_executor import HostExecutor
from rovaca_tpu_torch.parallel.pipeline_shard import sharded_pipeline_step
from rovaca_tpu_torch.pipeline.hc_engine import CallerConfig
from rovaca_tpu_torch.pipeline.scheduler import PairHMMScheduler
from rovaca_tpu_torch.tools import golden_flows, kernel_bench, race_e2e
from rovaca_tpu_torch.utils import platform

THR = np.float32(C.MIN_ACCEPTED_F32)


class Read:
    def __init__(self, bases, quals, mapping_quality):
        self.bases = bases.encode()
        self.quals = np.asarray(quals, dtype=np.uint8)
        self.mapping_quality = mapping_quality


def region(rng, n_reads, n_haps):
    """Reads are noisy fragments of a random reference (a few unrelated),
    haps mutated copies of it cut to ragged lengths; N bases in both."""
    L = int(rng.integers(150, 400))
    ref = rng.choice(list("ACGT"), size=L)
    haps = []
    for _ in range(n_haps):
        h = ref.copy()
        snp = rng.random(L) < 0.01
        h[snp] = rng.choice(list("ACGT"), size=int(snp.sum()))
        h[rng.random(L) < 0.002] = "N"
        haps.append("".join(h[:int(rng.integers(L // 2, L + 1))]))
    reads = []
    for k in range(n_reads):
        rl = int(rng.integers(30, 150))
        s = int(rng.integers(0, L - 30))
        frag = (rng.choice(list("ACGTN"), size=rl) if k % 13 == 4
                else ref[s:s + rl].copy())
        frag[rng.random(len(frag)) < 0.01] = "N"
        reads.append(Read("".join(frag), rng.integers(5, 41, len(frag)),
                          int(rng.integers(20, 61))))
    return reads, haps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def assert_forward_close(got, want, rtol=2e-5):
    np.testing.assert_array_equal(got < THR, want < THR)
    kept = want >= THR
    np.testing.assert_allclose(got[kept], want[kept], rtol=rtol)


@pytest.mark.gpu
def test_kernel_matches_plain(cuda):
    rng = np.random.default_rng(41)
    reads, haps = region(rng, 200, 13)
    b = compact.build_pair_batch_compact(reads, haps)
    assert (b.gr, b.gh) == (2, 2)
    hidx = np.array([0, 1, 1, 0, 1, 0], np.int32)
    ridx = np.array([1, 0, 1, 0, 1, 1], np.int32)
    t = compact.to_device(b.arrays() + (hidx, ridx), cuda)
    before = indexed.LAUNCHES
    got = indexed.pairhmm_indexed_compact(*t)
    torch.cuda.synchronize()
    assert indexed.LAUNCHES == before + 1
    want = indexed.pairhmm_indexed_compact_torch(*t).cpu().numpy()
    got = got.cpu().numpy()
    assert (want < THR).any() and (want >= THR).any()
    assert_forward_close(got, want)
    for g, (h, r) in enumerate(zip(hidx, ridx)):
        if r == 1:                                 # padding lanes 200..255
            assert np.all(got[g, :, 200 - 128:] == 0)
        if h == 1:                                 # padding haps 13..15
            assert np.all(got[g, 13 - 8:] == 0)


# read lengths at the sweep's boundaries: one lane, a full and a ragged
# first lane, 4 rows a lane, and one past the strip of a 128-row bucket
BOUNDARY_RL = (1, 31, 32, 33, 4 * 32 - 1, 4 * 32 + 1)


def boundary_batch(rng, Lr, Lh, G):
    """Compact stacks of random reads whose lengths cycle through
    BOUNDARY_RL (cut to Lr) and haps of length 1 or Lh, every pair of the G
    drawn at random."""
    NR, NH = 4, 4
    codes = np.array([1, 2, 4, 8], np.int8)
    rlen = np.array([min(BOUNDARY_RL[k % len(BOUNDARY_RL)], Lr)
                     for k in range(NR * 128)], np.int32).reshape(NR, 1, 128)
    valid = np.arange(Lr)[None, :, None] < rlen
    rbase = np.where(valid, codes[rng.integers(0, 4, (NR, Lr, 128))],
                     0).astype(np.int8)
    q = np.where(valid, rng.integers(6, 41, rbase.shape), 0).astype(np.uint8)
    gi = np.where(valid, rng.integers(20, 46, rbase.shape), 0).astype(
        np.uint8)
    gc = np.where(valid, 10, 0).astype(np.uint8)
    hlen = np.where(np.arange(8)[None, :, None] % 2, Lh, 1).repeat(
        NH, 0).astype(np.int32)
    hcode = codes[rng.integers(0, 4, (NH, Lh, 8))]
    hcode[np.arange(Lh)[None, :, None] >= hlen[:, None, :, 0]] = 0
    hidx = rng.integers(0, NH, G).astype(np.int32)
    ridx = rng.integers(0, NR, G).astype(np.int32)
    return (q, gi, gc, rbase, rlen, hcode, hlen, hidx, ridx)


@pytest.mark.gpu
@pytest.mark.parametrize("Lr,Lh,G", [(128, 256, 1), (128, 256, 1024),
                                     (256, 512, 1), (512, 256, 1)])
def test_kernels_at_sweep_boundaries(cuda, Lr, Lh, G):
    """K1 and K2 against their plain versions at reads of 1, 31, 32, 33,
    127 and 129 rows (cut to the bucket) and haps of 1 base and of Lh: one
    strip of 1-4 rows a lane (Lr 128), of up to 8 (Lr 256), and two strips
    (Lr 512)."""
    rng = np.random.default_rng(49 + Lr + G)
    arrays = boundary_batch(rng, Lr, Lh, G)
    t = compact.to_device(arrays, cuda)
    got = indexed.pairhmm_indexed_compact(*t).cpu().numpy()
    want = indexed.pairhmm_indexed_compact_torch(*t).cpu().numpy()
    assert (want >= THR).any()
    assert_forward_close(got, want)
    assert np.all(got[want == 0] == 0)
    q, gi, gc, rbase, rlen, hcode, hlen = t[:7]
    d = (compact.materialize_channels(q, gi, gc).contiguous(), rbase.int(),
         rlen, compact.broadcast_haps(hcode).contiguous(), hlen)
    got = dense.pairhmm_dense(*d).cpu().numpy()
    want = dense.pairhmm_dense_torch(*d).cpu().numpy()
    assert_forward_close(got, want)
    assert np.all(got[want == 0] == 0)


@pytest.mark.gpu
def test_index_outside_stacks_poisons_pair(cuda):
    rng = np.random.default_rng(42)
    reads, haps = region(rng, 20, 3)
    b = compact.build_pair_batch_compact(reads, haps)
    hidx = np.array([0, 5], np.int32)
    ridx = np.array([0, 0], np.int32)
    t = compact.to_device(b.arrays() + (hidx, ridx), cuda)
    out = indexed.pairhmm_indexed_compact(*t).cpu().numpy()
    assert np.all(np.isfinite(out[0])) and np.all(np.isnan(out[1]))


@pytest.mark.gpu
def test_scheduler_cuda_matches_torch(cuda):
    rng = np.random.default_rng(43)
    jobs = [(k, *region(rng, n, h))
            for k, (n, h) in enumerate([(40, 3), (150, 9), (7, 2), (260, 5),
                                        (12, 17)])]
    results = {}
    for engine in ("cuda", "torch"):
        sched = PairHMMScheduler(engine=engine)
        for key, reads, haps in jobs:
            sched.submit(key, reads, haps)
        results[engine] = sched.run()
        if engine == "cuda":
            assert sched.launches >= 1 and sched.device_ms > 0
    for key, _, _ in jobs:
        lik_c, kept_c = results["cuda"][key]
        lik_t, kept_t = results["torch"][key]
        np.testing.assert_array_equal(kept_c, kept_t)
        np.testing.assert_allclose(lik_c, lik_t, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_dense_kernel_matches_plain(cuda):
    rng = np.random.default_rng(44)
    reads, haps = region(rng, 200, 13)
    b = prep.build_pair_batch(reads, haps)
    assert (b.gr, b.gh) == (2, 2)
    t = compact.to_device((b.trans, b.rbase, b.rlen, b.hbase, b.hlen), cuda)
    before = dense.LAUNCHES
    got = dense.pairhmm_dense(*t)
    torch.cuda.synchronize()
    assert dense.LAUNCHES == before + 1
    want = dense.pairhmm_dense_torch(*t).cpu().numpy()
    got = got.cpu().numpy()
    assert (want < THR).any() and (want >= THR).any()
    assert_forward_close(got, want)
    assert np.all(got[:, 1, :, 200 - 128:] == 0)      # padding lanes
    assert np.all(got[1, :, 13 - 8:] == 0)            # padding haps


def _sw_cases(rng, n):
    """Haps as refs, reads as noisy fragments, diagonals from the read's
    offset; every fifth diagonal moved off the band."""
    pairs, diags = [], []
    for k in range(n):
        hap = rng.choice(list("ACGT"), size=int(rng.integers(180, 600)))
        off = int(rng.integers(0, len(hap) - 150))
        read = hap[off:off + int(rng.integers(60, 150))].copy()
        read[rng.random(len(read)) < 0.03] = "A"
        cut = int(rng.integers(10, len(read) - 10))
        read = np.concatenate([read[:cut], read[cut + int(k % 3):]])
        pairs.append(("".join(hap).encode(), "".join(read).encode()))
        diags.append(off if k % 5 else (off + 300) % len(hap))
    return pairs, diags


@pytest.mark.gpu
@pytest.mark.parametrize("indel_init", [False, True])
def test_banded_kernel_bit_equal_to_plain(cuda, indel_init):
    rng = np.random.default_rng(45)
    pairs, diags = _sw_cases(rng, 70)
    arrays = banded.pack_batch([r for r, _ in pairs], [a for _, a in pairs],
                               diags)
    C_pad = arrays[3]
    t = [torch.from_numpy(a).to(cuda) for a in arrays[:3]]
    params = (READ_TO_HAPLOTYPE_PARAMS.match, READ_TO_HAPLOTYPE_PARAMS.mismatch,
              READ_TO_HAPLOTYPE_PARAMS.gap_open,
              READ_TO_HAPLOTYPE_PARAMS.gap_extend)
    before = banded.LAUNCHES
    got = banded.banded_sw(*t, params=params, C=C_pad, indel_init=indel_init)
    torch.cuda.synchronize()
    assert banded.LAUNCHES == before + 1
    want = banded.banded_sw_torch(*t, params=params, C=C_pad,
                                  indel_init=indel_init)
    for name, g, w in zip(("bt", "colm", "lastrow", "edge"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g.cpu(), w.cpu()), name


@pytest.mark.gpu
def test_banded_batch_on_card_matches_host_sw(cuda):
    rng = np.random.default_rng(46)
    pairs, diags = _sw_cases(rng, 40)
    res, plain = (banded.sw_align_banded_batch(
        pairs, READ_TO_HAPLOTYPE_PARAMS, overhang=OverhangStrategy.SOFTCLIP,
        diagonals=diags, device=dev) for dev in (cuda, "cpu"))
    assert any(r.fell_back for r in res) and not all(r.fell_back
                                                     for r in res)
    for k, ((ref, alt), r, p) in enumerate(zip(pairs, res, plain)):
        assert (str(r.result.cigar), r.result.alignment_offset,
                r.fell_back) == (str(p.result.cigar),
                                 p.result.alignment_offset, p.fell_back)
        if k % 5:                          # diagonal inside the band
            want = _sw_align_python(ref, alt, READ_TO_HAPLOTYPE_PARAMS,
                                    OverhangStrategy.SOFTCLIP)
            assert str(r.result.cigar) == str(want.cigar)
            assert r.result.alignment_offset == want.alignment_offset


def _sw_cases_at(rng, n, Ln):
    """n pairs that pack to Ln: haps of Ln - 127 .. Ln bases, reads noisy
    20-150 base fragments with a deletion in a third of them, every fifth
    diagonal moved off the band."""
    pairs, diags = [], []
    for k in range(n):
        hap = rng.choice(list("ACGT"), size=int(rng.integers(max(Ln - 100, 60),
                                                 Ln + 1)))
        rl = int(rng.integers(20, min(151, len(hap) - 10)))
        off = int(rng.integers(0, len(hap) - rl))
        read = hap[off:off + rl].copy()
        read[rng.random(rl) < 0.02] = "C"
        if k % 3 == 1:
            cut = int(rng.integers(5, rl - 5))
            read = np.concatenate([read[:cut], read[cut + 2:]])
        pairs.append(("".join(hap).encode(), "".join(read).encode()))
        diags.append(off if k % 5 != 4 else -(rl + 200))
    return pairs, diags


def _hold_traceback(got, want):
    """The traceback kernel's slots against the plain version's: header
    and elements equal, slot for slot (entries past the count are free)."""
    assert got.dtype == want.dtype == torch.int32 and got.shape == want.shape
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(got[:, :banded.HEADER],
                                  want[:, :banded.HEADER])
    assert banded.unpack_slots(got) == banded.unpack_slots(want)


# (B, Ln): one alignment, a partial block, one alignment past a full
# block, the full launch; 128 and 1024 rows
SW_BOUNDARY = [(1, 128), (2, 128), (3, 1024), (33, 128), (33, 1024),
               (1024, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Ln", SW_BOUNDARY)
def test_banded_kernels_at_boundary_shapes(cuda, B, Ln):
    """The DP bit-identical to the plain version, and the traceback kernel
    equal to its plain version slot for slot."""
    rng = np.random.default_rng(50 + B + Ln)
    pairs, diags = _sw_cases_at(rng, B, Ln)
    refs = [r for r, _ in pairs]
    alts = [a for _, a in pairs]
    *arrays, C_pad = banded.pack_batch(refs, alts, diags)
    assert arrays[0].shape == (B, Ln)
    t = [torch.from_numpy(a).to(cuda) for a in arrays]
    P = READ_TO_HAPLOTYPE_PARAMS
    params = (P.match, P.mismatch, P.gap_open, P.gap_extend)
    got = banded.banded_sw(*t, params=params, C=C_pad)
    want = banded.banded_sw_torch(*t, params=params, C=C_pad,
                                  indel_init=False)
    for name, g, w in zip(("bt", "colm", "lastrow", "edge"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    S = banded.slot_width(refs, alts)
    before = banded.TB_LAUNCHES
    slots = banded.sw_traceback(*got, t[2], overhang=OverhangStrategy.SOFTCLIP,
                                S=S)
    torch.cuda.synchronize()
    assert banded.TB_LAUNCHES == before + 1
    _hold_traceback(slots, banded.sw_traceback_torch(
        *want, t[2], overhang=OverhangStrategy.SOFTCLIP, S=S))


@pytest.mark.gpu
@pytest.mark.parametrize("overhang", [OverhangStrategy.SOFTCLIP,
                                      OverhangStrategy.IGNORE])
def test_traceback_kernel_matches_plain(cuda, overhang):
    rng = np.random.default_rng(51)
    pairs, diags = _sw_cases(rng, 70)
    hap = pairs[0][0]                 # no base to align, none that matches
    pairs += [(hap, b""), (hap, b"N" * 60)]
    diags += [40, 40]
    refs = [r for r, _ in pairs]
    alts = [a for _, a in pairs]
    *arrays, C_pad = banded.pack_batch(refs, alts, diags)
    t = [torch.from_numpy(a).to(cuda) for a in arrays]
    P = READ_TO_HAPLOTYPE_PARAMS
    outs = banded.banded_sw(*t, params=(P.match, P.mismatch, P.gap_open,
                                        P.gap_extend), C=C_pad)
    S = banded.slot_width(refs, alts)
    got = banded.sw_traceback(*outs, t[2], overhang=overhang, S=S)
    want = banded.sw_traceback_torch(*outs, t[2], overhang=overhang, S=S)
    assert (want[:, 0] == 0).any() and (want[:, 0] == 1).any()
    _hold_traceback(got, want)


@pytest.mark.gpu
def test_banded_kernel_refuses_scores_past_its_keys(cuda):
    *arrays, C_pad = banded.pack_batch([b"ACGT" * 20], [b"ACGT" * 5], [10])
    t = [torch.from_numpy(a).to(cuda) for a in arrays]
    with pytest.raises(ValueError, match="2\\^23"):
        banded.banded_sw(*t, params=(10, -15, -30, -2 ** 16), C=C_pad)


@pytest.mark.gpu
def test_banded_batch_brings_back_only_the_slots(cuda, monkeypatch):
    """On the card, sw_align_banded_batch moves one (B, S) int32 tensor to
    the host: bt, colm, lastrow and edge stay on the card."""
    rng = np.random.default_rng(52)
    pairs, diags = _sw_cases(rng, 40)
    moved = []

    def spy(name, real):
        def call(self, *args, **kwargs):
            out = real(self, *args, **kwargs)
            if name == "copy_":
                src = args[0]
                if self.device.type == "cpu" and src.device.type == "cuda":
                    moved.append((tuple(src.shape), src.dtype))
            elif self.device.type == "cuda" and not (
                    isinstance(out, torch.Tensor) and out.device.type
                    == "cuda"):
                moved.append((tuple(self.shape), self.dtype))
            return out
        return call

    for name in ("copy_", "cpu", "to", "numpy", "tolist", "item", "__int__"):
        monkeypatch.setattr(torch.Tensor, name,
                            spy(name, getattr(torch.Tensor, name)))
    before = banded.LAUNCHES, banded.TB_LAUNCHES
    res = banded.sw_align_banded_batch(
        pairs, READ_TO_HAPLOTYPE_PARAMS, overhang=OverhangStrategy.SOFTCLIP,
        diagonals=diags, device=cuda)
    monkeypatch.undo()
    assert (banded.LAUNCHES, banded.TB_LAUNCHES) == (before[0] + 1,
                                                     before[1] + 1)
    S = banded.slot_width([r for r, _ in pairs], [a for _, a in pairs])
    assert moved == [((40, S), torch.int32)]
    assert len(res) == 40 and any(r.fell_back for r in res)


@pytest.mark.gpu
def test_scheduler_device_list_matches_one_device(cuda):
    """Launches round-robin over every card named twice: lik and kept
    array-equal to a one-device scheduler's."""
    rng = np.random.default_rng(47)
    jobs = [(k, *region(rng, n, h))
            for k, (n, h) in enumerate([(40, 3), (150, 9), (7, 2), (260, 5),
                                        (12, 17), (90, 4)])]
    results = {}
    for name, devices in (("list", platform.devices() * 2),
                          ("one", [cuda])):
        sched = PairHMMScheduler(engine="cuda", devices=devices)
        sched.NR_MAX = sched.NH_MAX = 3                 # several launches
        for key, reads, haps in jobs:
            sched.submit(key, reads, haps)
        before = indexed.LAUNCHES
        results[name] = sched.run()
        assert indexed.LAUNCHES - before == sched.launches > 2
        assert sched.device_ms > 0
    for key, _, _ in jobs:
        lik_l, kept_l = results["list"][key]
        lik_o, kept_o = results["one"][key]
        np.testing.assert_array_equal(kept_l, kept_o)
        np.testing.assert_array_equal(lik_l, lik_o)


@pytest.mark.gpu
def test_sharded_pipeline_step_on_cards_matches_plain(cuda):
    rng = np.random.default_rng(48)
    launches = []
    for _ in range(4):
        b = compact.build_pair_batch_compact(*region(rng, 150, 11),
                                             len_buckets=(256,),
                                             hap_len_buckets=(512,))
        hidx = rng.integers(0, b.gh, 5).astype(np.int32)
        ridx = rng.integers(0, b.gr, 5).astype(np.int32)
        launches.append(b.arrays() + (hidx, ridx))
    stacked = [torch.from_numpy(np.stack(parts)) for parts in zip(*launches)]
    before = indexed.LAUNCHES
    got = sharded_pipeline_step(platform.devices() * 2, *stacked)
    torch.cuda.synchronize()
    assert indexed.LAUNCHES == before + 4
    assert got.device == platform.devices()[0]
    want = sharded_pipeline_step([torch.device("cpu")], *stacked)
    assert_forward_close(got.cpu().numpy(), want.numpy())


# (torch imported, CUDA initialised) in the process that evaluates it
_CUDA_STATE = ("(lambda t: (t is not None, t is not None and "
               "t.cuda.is_initialized()))"
               "(__import__('sys').modules.get('torch'))")


@pytest.mark.gpu
def test_host_worker_never_touches_the_card(cuda):
    """-t 2's workers prepare regions on the host: with this process's CUDA
    context live, a worker has imported no torch and initialised no CUDA."""
    torch.ones(1, device=cuda)
    assert torch.cuda.is_initialized()
    executor = HostExecutor(2, CallerConfig(pairhmm_engine="cuda"),
                            {"chr1": 1000})
    try:
        states = [executor._pool.submit(eval, _CUDA_STATE).result(timeout=120)
                  for _ in range(4)]
    finally:
        executor.close()
    assert states == [(False, False)] * 4


@pytest.mark.gpu
def test_kernel_bench_names_the_card(cuda, capsys):
    """kernel_bench's JSON line: bench.py's batch on K2 and K1, the card's
    name, a positive rate."""
    assert kernel_bench.main([]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "pairhmm_cell_updates_per_sec"
    assert out["device"] == torch.cuda.get_device_name(0)
    assert out["value"] > 0 and out["unit"] == "cells/s"
    for name in ("pairhmm_dense", "pairhmm_indexed"):
        k = out["kernels"][name]
        assert k["ms"] > 0 and 0 < k["share_of_bound"] <= 1


@pytest.mark.gpu
def test_race_of_one_cuda_round(cuda, tmp_path):
    """One cuda contender, one round after the warm-up, on the committed
    50 kb corpus: K1 launched, the VCF rovaca_tpu's committed one."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for name in ("sample.bam", "sample.bam.bai", "ref.fa", "ref.fa.fai"):
        shutil.copy(os.path.join(golden_flows.GOLDEN_DIR, name), corpus)
    res = race_e2e.run_race(str(corpus), str(tmp_path / "race"), ("cuda",),
                            n_runs=1, log=lambda line: None)
    c = res["contenders"]["cuda"]
    assert len(c["runs_s"]) == 1 and c["launches"][0] > 0
    assert 0 < c["card_share"] < 1
    assert c["ok"] and c["diff"] == "RESULT: MATCH", c["diff"]
    assert res["held_to"] == "rovaca_tpu's committed output"


@pytest.mark.gpu
def test_default_cuda_run_realigns_on_the_banded_kernel(cuda, tmp_path,
                                                        monkeypatch):
    """The CLI's default cuda run realigns on K3 (DP and traceback, as many
    launches as banded batches, more than none) on a golden_e2e corpus with
    sequencing errors; ROVACA_BANDED_REALIGN=0 launches no K3 and gives the
    same records."""
    from rovaca_tpu_torch import cli
    from rovaca_tpu_torch.tools import golden_e2e
    golden_e2e.generate(str(tmp_path), genome_len=20_000, coverage=30,
                        seed=7)
    runs = {}
    for flag in (None, "0"):
        if flag is None:
            monkeypatch.delenv("ROVACA_BANDED_REALIGN", raising=False)
        else:
            monkeypatch.setenv("ROVACA_BANDED_REALIGN", flag)
        out = str(tmp_path / f"out_{flag}.vcf")
        stats = {}
        dp, tb = banded.LAUNCHES, banded.TB_LAUNCHES
        assert cli.main(["HaplotypeCaller", "-i", str(tmp_path / "sample.bam"),
                         "-r", str(tmp_path / "ref.fa"), "-o", out,
                         "--log-level", "WARNING"], stats=stats) == 0
        assert banded.LAUNCHES - dp == banded.TB_LAUNCHES - tb \
            == stats["sw_launches"]
        with open(out) as f:
            runs[flag] = (stats, [ln for ln in f if not ln.startswith("#")])
    assert runs[None][0]["sw_launches"] > 0
    assert runs["0"][0]["sw_launches"] == runs["0"][0]["sw_fallbacks"] == 0
    assert runs[None][1] == runs["0"][1] and len(runs[None][1]) > 0


@pytest.mark.gpu
def test_golden_pairhmm_on_the_card(cuda):
    """tools.golden_pairhmm.golden on the card, 8 of the committed cases:
    one flush group on K1 and one compute_likelihoods a case on K2, each
    held to the C++ reference's committed output (the same kept reads,
    every cell within 4e-3) and launching its kernel."""
    from rovaca_tpu_torch.tools import golden_pairhmm
    cases = range(0, 64, 8)
    k1 = golden_pairhmm.golden("cuda", scheduler=True, cases=cases)
    k2 = golden_pairhmm.golden("cuda", cases=cases)
    for res in (k1, k2):
        assert res["cases"] == 8
        assert not res["mismatches"], res["mismatches"]
        assert res["worst_abs"] <= golden_pairhmm.GOLDEN_ATOL
    assert k1["launches"]["pairhmm_indexed"] == k1["scheduler_launches"] >= 1
    assert k1["launches"]["pairhmm_dense"] == 0
    assert k2["launches"] == {"pairhmm_indexed": 0, "pairhmm_dense": 8}
