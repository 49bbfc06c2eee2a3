"""CUDA kernel tests of rovaca_tpu_torch; they skip without a GPU.

This file imports neither jax nor the test conftest, so it also runs on a
GPU host that has no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: for the PairHMM kernels rtol 2e-5 against the plain torch
version on pairs at or above MIN_ACCEPTED_F32, the same set of pairs below it
(the float64 rescue set), exact zeros on padding lanes and haps; for the
banded SW kernel none: its four outputs must be bit-identical to the plain
version's, and its cigars equal to the exact host SW's.
"""

import numpy as np
import pytest
import torch

from rovaca_tpu import constants as C
from rovaca_tpu.assembly.sw import (READ_TO_HAPLOTYPE_PARAMS,
                                    OverhangStrategy, _sw_align_python)
from rovaca_tpu.ops.pairhmm import prep
from rovaca_tpu_torch.ops.pairhmm import compact, dense, indexed
from rovaca_tpu_torch.ops.sw import banded
from rovaca_tpu_torch.pipeline.scheduler import PairHMMScheduler

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
