"""rovaca_tpu_torch banded Smith-Waterman against the JAX package.

The same numpy-seeded pairs go through rovaca_tpu's Pallas kernel in
interpret mode and through the port. Tolerance: none. The DP outputs (bt,
colm, lastrow, edge) must be bit-identical, and cigars, offsets and the
fallback decision identical, to rovaca_tpu's banded batch and to the exact
host SW (``_sw_align_python``). The packed traceback's plain version,
decoded, must equal both packages' ``_traceback_band`` on the Pallas
kernel's outputs.
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
                                       diagonals=diags, device="cpu")
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
        overhang=OverhangStrategy.SOFTCLIP, diagonals=[10, 300],
        device="cpu")
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
                                       overhang=overhang, device="cpu")[0]
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


def _traceback_cases(rng, kind):
    """(pairs, diagonals) of one traceback case batch; see
    test_packed_traceback_matches_both_packages."""
    if kind == "b1":
        cases, diags = _cases(rng, n=1)
        return cases, diags
    if kind in ("softclip", "ignore"):
        return _cases(rng, n=10)
    if kind == "edge_guard":       # diagonals far off: the guard fires
        cases, diags = _cases(rng, n=4)
        return cases, [(d + 200) % 400 for d in diags]
    if kind == "band_edge":
        # a read whose first 50 bases sit 30 columns off the rest (a
        # deletion, or an insertion), the diagonal chosen to put them on the
        # band's outermost cell: the optimum beats the edge, but the walk
        # reaches it (cell w of diagonal d is off + 64 - d)
        pairs, diags = [], []
        for k in range(4):
            hap = _seq(rng, 300)
            if k % 2:
                read = hap[50:100] + hap[130:230]    # diagonals 50, 80
                diags.append(127 - 64 + 50)
            else:
                read = hap[50:100] + _seq(rng, 30) + hap[100:200]
                diags.append(0 - 64 + 50)            # diagonals 50, 20
            pairs.append((hap, read))
        pairs.append((hap, hap[100:200]))            # and one traced
        diags.append(100)
        return pairs, diags
    if kind == "clips":            # the read runs past both hap ends
        pairs, diags = [], []
        for _ in range(6):
            hap = _seq(rng, int(rng.integers(100, 140)))
            lead = int(rng.integers(10, 20))
            read = (_seq(rng, lead) + hap + _seq(rng, int(rng.integers(10,
                                                                       20))))
            pairs.append((hap, read))
            diags.append(-lead)
        return pairs, diags
    assert kind == "empty"         # no base matches, and no base at all
    hap = _seq(rng, 150)
    return [(hap, b"N" * 60), (hap, b""), (hap, hap[40:100])], [40, 40, 40]


TRACEBACK_KINDS = ["softclip", "ignore", "edge_guard", "band_edge", "clips",
                   "empty", "b1"]


def _walk_left_band(bt, colm, lastrow, edge, n, m, off):
    """True when the end-cell search passes the edge guard (so a None from
    _traceback_band comes from the walk leaving the band)."""
    best = max([int(c) for c in colm[:n] if c > banded.NEG // 2],
               default=None)
    csn = n - off - banded.W // 2
    row = [int(lastrow[j - csn]) for j in range(1, m + 1)
           if 0 <= j - csn < banded.W and lastrow[j - csn] > banded.NEG // 2]
    best = max([b for b in [best] + row if b is not None], default=None)
    return best is not None and int(edge) < best


@pytest.mark.parametrize("kind", TRACEBACK_KINDS)
def test_packed_traceback_matches_both_packages(kind):
    """The plain packed traceback, decoded, equals the port's and
    rovaca_tpu's _traceback_band on the Pallas kernel's outputs (interpret
    mode): the fall-back decision, the cigar and the offset."""
    from rovaca_tpu.ops.sw.banded import _traceback_band as jax_traceback
    rng = np.random.default_rng(300 + TRACEBACK_KINDS.index(kind))
    pairs, diags = _traceback_cases(rng, kind)
    overhang = (OverhangStrategy.IGNORE if kind == "ignore"
                else OverhangStrategy.SOFTCLIP)
    params = _as_tuple(READ_TO_HAPLOTYPE_PARAMS)
    refs = [r for r, _ in pairs]
    alts = [a for _, a in pairs]
    ref_arr, alt_arr, meta, C = banded.pack_batch(refs, alts, diags)
    outs = _jax_dp(ref_arr, alt_arr, meta, C, params, False)
    bt, colm, lastrow, edge = (o.astype(np.int16 if k == 0 else np.int32)
                               for k, o in enumerate(outs))
    S = banded.slot_width(refs, alts)
    packed = banded.sw_traceback(
        *(torch.from_numpy(np.ascontiguousarray(x))
          for x in (bt, colm, lastrow, edge, meta)),
        overhang=overhang, S=S)
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (
        len(pairs), S)
    decoded = banded.unpack_slots(packed.numpy())
    walked_off = 0
    for k, (ref, alt) in enumerate(pairs):
        n, m = len(ref), len(alt)
        args = (bt[k], colm[k], lastrow[k], n, m, diags[k], overhang,
                int(edge[k]))
        port, jax = banded._traceback_band(*args), jax_traceback(*args)
        assert (port is None) == (jax is None) == (decoded[k] is None)
        if port is None:
            walked_off += _walk_left_band(bt[k], colm[k], lastrow[k],
                                          edge[k], n, m, diags[k])
            assert not packed[k, :banded.HEADER].any()
            continue
        offset, elems = decoded[k]
        assert str(banded.Cigar(elems[::-1])) == str(port.cigar) \
            == str(jax.cigar)
        assert offset == port.alignment_offset == jax.alignment_offset
        assert int(packed[k, 2]) == len(port.cigar.elements)
    fell_back = sum(d is None for d in decoded)
    if kind == "edge_guard":
        assert fell_back == len(pairs) and walked_off == 0
    elif kind == "band_edge":
        assert walked_off > 0 and fell_back < len(pairs)
    elif kind == "clips":          # soft clips at both ends, walk order
        S_OP = banded.CigarOp.S
        assert all(d[1][0][0] == d[1][-1][0] == S_OP for d in decoded)
    elif kind == "empty":          # no match and no base fall back
        assert [d is None for d in decoded] == [True, True, False]
    else:
        assert fell_back == 0


def test_batch_without_device_raises_without_a_card(monkeypatch):
    """K3's entry point defaults to the card: with none it raises, and never
    runs the plain version in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(8)
    hap = _seq(rng, 200)
    before = banded.LAUNCHES, banded.TB_LAUNCHES
    with pytest.raises(RuntimeError, match="no CUDA device"):
        banded.sw_align_banded_batch([(hap, hap[50:120] + b"A")],
                                     READ_TO_HAPLOTYPE_PARAMS)
    assert (banded.LAUNCHES, banded.TB_LAUNCHES) == before
    # nothing to align, or a global strategy: no device is needed
    assert banded.sw_align_banded_batch([], READ_TO_HAPLOTYPE_PARAMS) == []
    res = banded.sw_align_banded_batch([(hap, hap[50:120] + b"A")],
                                       READ_TO_HAPLOTYPE_PARAMS,
                                       overhang=OverhangStrategy.INDEL)
    assert res[0].fell_back


@pytest.mark.parametrize("bad", ["overhang", "shape", "dtype", "slot"])
def test_traceback_wrapper_rejects_bad_input(bad):
    ref_arr, alt_arr, meta, C = banded.pack_batch([b"ACGT" * 20],
                                                  [b"ACGT" * 5], [10])
    outs = list(banded.banded_sw(*(torch.from_numpy(a) for a in
                                   (ref_arr, alt_arr, meta)),
                                 params=_as_tuple(READ_TO_HAPLOTYPE_PARAMS),
                                 C=C))
    kw = dict(overhang=OverhangStrategy.SOFTCLIP, S=103)
    if bad == "overhang":
        kw["overhang"] = OverhangStrategy.INDEL
    elif bad == "shape":
        outs[2] = outs[2][:, :64].contiguous()
    elif bad == "dtype":
        outs[0] = outs[0].int()
    else:
        kw["S"] = banded.HEADER
    with pytest.raises(ValueError):
        banded.sw_traceback(*outs, torch.from_numpy(meta), **kw)
    before = banded.TB_LAUNCHES
    kw = dict(overhang=OverhangStrategy.SOFTCLIP, S=103)
    if bad == "overhang":          # the good call, on the CPU: no launch
        got = banded.sw_traceback(*banded.banded_sw(
            *(torch.from_numpy(a) for a in (ref_arr, alt_arr, meta)),
            params=_as_tuple(READ_TO_HAPLOTYPE_PARAMS), C=C),
            torch.from_numpy(meta), **kw)
        assert int(got[0, 0]) == 1 and banded.TB_LAUNCHES == before


@pytest.mark.parametrize("params", PARAMS)
def test_score_bound_leaves_room_for_long_haplotypes(params):
    """The DP kernel's scan keys hold |scores| below KEY_LIMIT: each of
    GATK's score sets leaves room for 2 kb against 500 bases, several times
    a realignment batch's haplotypes and reads."""
    ref_arr, alt_arr, _, _ = banded.pack_batch([b"A" * 2000], [b"C" * 500],
                                               [0])
    bound = banded.score_bound(_as_tuple(params), ref_arr.shape[1],
                               alt_arr.shape[1])
    assert 0 < bound < banded.KEY_LIMIT
    assert banded.score_bound((10, -15, -30, -2 ** 16), 128, 640) \
        >= banded.KEY_LIMIT
