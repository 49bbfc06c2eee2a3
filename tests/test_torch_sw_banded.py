"""rovaca_tpu_torch banded Smith-Waterman against the JAX package.

The same numpy-seeded pairs go through rovaca_tpu's Pallas kernel in
interpret mode and through the port. Tolerance: none. The DP outputs (bt,
colm, lastrow, edge) must be bit-identical, and cigars, offsets and the
fallback decision identical, to rovaca_tpu's banded batch and to the exact
host SW (``_sw_align_python``).
"""

import numpy as np
import pytest
import torch

from rovaca_tpu.assembly.sw import (DANGLING_END_PARAMS,
                                    HAPLOTYPE_TO_REFERENCE_PARAMS,
                                    READ_TO_HAPLOTYPE_PARAMS,
                                    OverhangStrategy, _sw_align_python)
from rovaca_tpu.ops.sw import banded as jbanded
from rovaca_tpu_torch.ops.sw import banded

PARAMS = [READ_TO_HAPLOTYPE_PARAMS, HAPLOTYPE_TO_REFERENCE_PARAMS,
          DANGLING_END_PARAMS]
OVERHANGS = [OverhangStrategy.SOFTCLIP, OverhangStrategy.IGNORE]


def _seq(rng, L):
    return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), L))


def _mutate(rng, s, n_snp=2, n_ins=1, n_del=1):
    s = bytearray(s)
    for _ in range(n_snp):
        i = rng.integers(0, len(s))
        s[i] = ord("ACGT"[rng.integers(4)])
    for _ in range(n_ins):
        i = rng.integers(0, len(s))
        s[i:i] = _seq(rng, int(rng.integers(1, 4)))
    for _ in range(n_del):
        i = rng.integers(0, max(1, len(s) - 6))
        del s[i:i + int(rng.integers(1, 4))]
    return bytes(s)


def _cases(rng, n=12, off_band=0):
    """Haps as refs, mutated fragments as alts, diagonals from the fragment's
    offset; the last ``off_band`` diagonals are moved far off to force
    fallbacks."""
    cases, diags = [], []
    for _ in range(n):
        hap = _seq(rng, int(rng.integers(180, 420)))
        off = int(rng.integers(0, max(1, len(hap) - 150)))
        read = _mutate(rng, hap[off:off + int(rng.integers(60, 150))])
        cases.append((hap, read))
        diags.append(off)
    for k in range(n - off_band, n):
        diags[k] = (diags[k] + 200) % 400
    return cases, diags


def _jax_dp(ref_arr, alt_arr, meta, C, params, indel_init):
    """rovaca_tpu's kernel (interpret mode) on the port's flat layout,
    reshaped back to one row per alignment."""
    S = jbanded.S
    B, Ln = ref_arr.shape
    G = -(-B // S)
    pad = G * S - B

    def grouped(a, fill):
        a = np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
        return a.reshape((G, S) + a.shape[1:])

    meta128 = np.zeros((B, 128), np.int32)
    meta128[:, :3] = meta
    bt, colm, lastrow, edge = (np.asarray(o) for o in jbanded._banded_call(
        grouped(ref_arr, 0), grouped(alt_arr, -1), grouped(meta128, 0),
        Ln=Ln, C=C, params=params, indel_init=indel_init, interpret=True))
    bt = bt.transpose(0, 2, 1, 3).reshape(G * S, Ln, -1)[:B]
    colm = colm.transpose(0, 2, 1).reshape(G * S, Ln)[:B]
    return bt, colm, lastrow.reshape(G * S, -1)[:B], edge.reshape(-1)[:B]


def _as_tuple(p):
    return (p.match, p.mismatch, p.gap_open, p.gap_extend)


@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("indel_init", [False, True])
def test_plain_dp_bit_equal_to_pallas(params, indel_init):
    rng = np.random.default_rng(100 + params.match + indel_init)
    cases, diags = _cases(rng, n=11, off_band=2)
    refs = [r for r, _ in cases]
    alts = [a for _, a in cases]
    ref_arr, alt_arr, meta, C = banded.pack_batch(refs, alts, diags)
    got = banded.banded_sw(*(torch.from_numpy(a) for a in
                             (ref_arr, alt_arr, meta)),
                           params=_as_tuple(params), C=C,
                           indel_init=indel_init)
    want = _jax_dp(ref_arr, alt_arr, meta, C, _as_tuple(params), indel_init)
    for name, g, w in zip(("bt", "colm", "lastrow", "edge"), got, want):
        g = g.numpy()
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    assert got[0].dtype == torch.int16
    assert (got[0] != 0).any()


@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("overhang", OVERHANGS)
def test_batch_matches_pallas_and_oracle(params, overhang):
    rng = np.random.default_rng(hash((params.match, int(overhang))) % 2**31)
    cases, diags = _cases(rng, n=12)
    got = banded.sw_align_banded_batch(cases, params, overhang=overhang,
                                       diagonals=diags)
    want = jbanded.sw_align_banded_batch(cases, params, overhang=overhang,
                                         diagonals=diags, interpret=True)
    assert len(got) == len(want) == len(cases)
    for (ref, alt), g, w in zip(cases, got, want):
        oracle = _sw_align_python(ref, alt, params, overhang)
        assert str(g.result.cigar) == str(w.result.cigar) \
            == str(oracle.cigar)
        assert g.result.alignment_offset == w.result.alignment_offset \
            == oracle.alignment_offset
        assert g.fell_back == w.fell_back
    assert not any(g.fell_back for g in got)


def test_wrong_diagonal_falls_back_exactly():
    rng = np.random.default_rng(7)
    hap = _seq(rng, 400)
    read = hap[300:380]          # true diagonal 300
    pairs = [(hap, read), (hap, read)]
    res = banded.sw_align_banded_batch(
        pairs, READ_TO_HAPLOTYPE_PARAMS,
        overhang=OverhangStrategy.SOFTCLIP, diagonals=[10, 300])
    jres = jbanded.sw_align_banded_batch(
        pairs, READ_TO_HAPLOTYPE_PARAMS,
        overhang=OverhangStrategy.SOFTCLIP, diagonals=[10, 300],
        interpret=True)
    want = _sw_align_python(hap, read, READ_TO_HAPLOTYPE_PARAMS,
                            OverhangStrategy.SOFTCLIP)
    assert [r.fell_back for r in res] == [r.fell_back for r in jres] \
        == [True, False]
    for r in res:
        assert str(r.result.cigar) == str(want.cigar)
        assert r.result.alignment_offset == want.alignment_offset


@pytest.mark.parametrize("overhang", [OverhangStrategy.INDEL,
                                      OverhangStrategy.LEADING_INDEL])
def test_indel_family_uses_host_path(overhang):
    rng = np.random.default_rng(3)
    hap = _seq(rng, 300)
    alt = _mutate(rng, hap, n_snp=3, n_ins=2, n_del=2)
    before = banded.LAUNCHES
    res = banded.sw_align_banded_batch([(hap, alt)], READ_TO_HAPLOTYPE_PARAMS,
                                       overhang=overhang)[0]
    want = _sw_align_python(hap, alt, READ_TO_HAPLOTYPE_PARAMS, overhang)
    assert res.fell_back
    assert str(res.result.cigar) == str(want.cigar)
    assert banded.LAUNCHES == before


def test_scan_matches_sequential_on_real_values():
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(rng.integers(-50, 50, (6, banded.W)).astype(
        np.int32))
    v, idx = banded._excl_cummax_arg(vals)
    for b in range(vals.shape[0]):
        best, arg = banded.NEG, -1
        for w in range(banded.W):
            if w > 0:
                assert (int(v[b, w]), int(idx[b, w])) == (best, arg)
            if int(vals[b, w]) > best:
                best, arg = int(vals[b, w]), w
        assert int(v[b, 0]) == banded.NEG


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "padding"])
def test_wrapper_rejects_bad_input(bad):
    ref_arr, alt_arr, meta, C = banded.pack_batch([b"ACGT" * 20],
                                                  [b"ACGT" * 5], [10])
    t = [torch.from_numpy(a) for a in (ref_arr, alt_arr, meta)]
    if bad == "dtype":
        t[0] = t[0].long()
        err = TypeError
    elif bad == "shape":
        t[2] = t[2][:, :2].contiguous()
        err = ValueError
    elif bad == "padding":
        t[1] = t[1][:, :C + 128].contiguous()
        err = ValueError
    else:
        t = [x.to("meta") for x in t]
        err = ValueError
    with pytest.raises(err):
        banded.banded_sw(*t, params=_as_tuple(READ_TO_HAPLOTYPE_PARAMS), C=C)
