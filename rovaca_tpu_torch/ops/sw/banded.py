"""Banded Smith-Waterman: the CUDA kernel, its plain version, host traceback.

Counterpart of rovaca_tpu/ops/sw/banded.py, which imports jax at module top,
so its host traceback is carried over here with the same logic. Affine-gap
SW in a 128-wide diagonal band: row i scores columns [c0(i), c0(i) + 128)
with c0(i) = i - offset - 64, so the diagonal neighbour is the same lane of
the row above, the vertical one the next lane, and the in-row gap chain is an
exclusive max-plus prefix scan with earliest-index argmax.

Layout: the TPU kernel groups eight alignments per (8, 128) tile; that is TPU
layout, not contract. Here one alignment is one row of every input:

- refs (B, Ln) int32 ref bytes, zero past each ref's end;
- alts (B, A) int32 alt bytes, alt k stored from C + diagonal[k], -1 around;
- meta (B, 3) int32 [n, m, diagonal];

and the outputs are bt (B, Ln, 128) int16 (0 diagonal, +k vertical jump, -k
horizontal jump), colm (B, Ln) int32 (score at column m per row), lastrow
(B, 128) int32 (row n's band) and edge (B,) int32 (best score on the band's
outermost lanes, the fallback guard). Rows past n: bt 0, colm NEG.

``banded_sw`` is the wrapper: on CUDA tensors it launches the hand-written
kernel csrc/sw_banded.cu (or raises), on CPU tensors it runs
``banded_sw_torch``. ``sw_align_banded_batch`` packs pairs, runs the band on
a device, traces back on the host and falls back to the exact host SW where
the band cannot be trusted, flagging each such alignment.
"""

import ctypes

import numpy as np
import torch

from rovaca_tpu.assembly.sw import (LOW_INIT_VALUE, MATRIX_MIN_CUTOFF,
                                    OverhangStrategy, SWResult,
                                    _sw_align_python)
from rovaca_tpu.reads.cigar import Cigar, CigarOp

from .. import build

W = 128                 # band width
NEG = int(LOW_INIT_VALUE)
LAUNCHES = 0            # kernel launches made by banded_sw


def _shift_left(x, fill):
    """x[:, w] <- x[:, w + 1]; the last lane <- fill."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def _excl_cummax_arg(vals):
    """Exclusive running max along lanes with earliest-index argmax, in the
    TPU kernel's log steps (banded.py:_excl_cummax_arg). vals: (B, W) int32.
    Returns (maxv, argw): maxv[w] = max_{k<w} vals[k] (NEG at w = 0)."""
    lane = torch.arange(W, dtype=torch.int32, device=vals.device)
    v = torch.roll(vals, 1, dims=1)
    v[:, 0] = NEG
    idx = (lane - 1).expand_as(vals)
    s = 1
    while s < W:
        vs = torch.where(lane >= s, torch.roll(v, s, dims=1), NEG)
        take = vs >= v                  # earlier index wins ties
        idx = torch.where(take, torch.roll(idx, s, dims=1), idx)
        v = torch.where(take, vs, v)
        s *= 2
    return v, idx


def banded_sw_torch(refs, alts, meta, *, params, C, indel_init):
    """Plain torch version of the banded DP (any device), row by row,
    vectorised over (alignments, band lanes), int32 throughout. ``params`` is
    (match, mismatch, gap_open, gap_extend); C is the alts' left padding
    before each diagonal. Rows past the longest ref are all frozen and are
    filled, not computed."""
    wm, wmm, wo, we = (int(p) for p in params)
    B, Ln = refs.shape
    dev = refs.device
    i32 = torch.int32
    lane = torch.arange(W, dtype=i32, device=dev)
    n, m, off = (meta[:, k:k + 1] for k in range(3))         # (B, 1)

    def row0_val(j):
        v = (torch.where(j == 0, 0, wo + (j - 1) * we) if indel_init
             else torch.zeros_like(j))
        return torch.where((j >= 0) & (j <= m), v, NEG)

    def col0_val(i):
        return (0 if i == 0 else wo + (i - 1) * we) if indel_init else 0

    H = row0_val(-off - W // 2 + lane)                        # (B, W)
    v_prev = torch.full((B, W), NEG, dtype=i32, device=dev)
    ks_prev = torch.zeros((B, W), dtype=i32, device=dev)
    lastrow = torch.full((B, W), NEG, dtype=i32, device=dev)
    edge = torch.full((B, 1), NEG, dtype=i32, device=dev)
    bt = torch.zeros((B, Ln, W), dtype=torch.int16, device=dev)
    colm = torch.full((B, Ln), NEG, dtype=i32, device=dev)
    outer = (lane == 0) | (lane == W - 1)

    n_rows = int(n.max()) if B else 0
    for i in range(1, n_rows + 1):
        j = i - off - W // 2 + lane                           # (B, W)
        valid = (j >= 1) & (j <= m)
        c0 = col0_val(i)

        # vertical gap state, band-shifted: the row above at column j
        open_v = _shift_left(H, NEG) + wo
        ext_v = _shift_left(v_prev, NEG) + we
        v_new = torch.maximum(open_v, ext_v)
        ks_new = torch.where(open_v > ext_v, 1,
                             _shift_left(ks_prev, 0) + 1).to(i32)

        # diagonal: ref[i-1] against alt[j-1], stored at C + off + j - 1
        start = i - W // 2 - 1 + C
        achars = alts[:, start:start + W]
        rchar = refs[:, i - 1:i]
        d = H + torch.where(achars == rchar, wm, wmm).to(i32)

        # horizontal chain as an exclusive max-plus scan
        hv = torch.maximum(d, v_new).clamp(min=MATRIX_MIN_CUTOFF)
        hv = torch.where(valid, hv, torch.where(j == 0, c0, NEG).to(i32))
        Bk = torch.where(j >= 0, hv + wo - we * lane, NEG).to(i32)
        gmax, gargw = _excl_cummax_arg(Bk)
        G = gmax + we * (lane - 1)
        ki = lane - gargw

        use_gap = (d < v_new) | (d < G)
        right_ge = G >= v_new
        Hval = torch.where(use_gap, torch.where(right_ge, G, v_new), d)
        Hval = torch.clamp(Hval, min=MATRIX_MIN_CUTOFF)
        b = torch.where(use_gap, torch.where(right_ge, -ki, ks_new), 0)
        Hcur = torch.where(valid, Hval,
                           torch.where(j == 0, c0, NEG).to(i32))
        b = torch.where(valid, b, 0)

        # rows past the alignment end freeze every carry
        live = i <= n                                         # (B, 1)
        Hcur = torch.where(live, Hcur, H)
        v_new = torch.where(live, v_new, v_prev)
        ks_new = torch.where(live, ks_new, ks_prev)
        bt[:, i - 1] = torch.where(live, b, 0).to(torch.int16)
        colm[:, i - 1] = torch.where(live & (j == m), Hcur, NEG).amax(dim=1)
        lastrow = torch.where(i == n, Hcur, lastrow)
        edge_here = torch.where(live & valid & outer, Hcur, NEG).amax(
            dim=1, keepdim=True)
        edge = torch.maximum(edge, edge_here)
        H, v_prev, ks_prev = Hcur, v_new, ks_new
    return bt, colm, lastrow, edge[:, 0]


_ARGS = ("refs", "alts", "meta")


def _check(refs, alts, meta, C):
    for name, t in zip(_ARGS, (refs, alts, meta)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t)}")
        if t.device != refs.device:
            raise ValueError(f"{name} on {t.device}, refs on {refs.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int32")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 2-d tensor")
    B = refs.shape[0]
    if alts.shape[0] != B or tuple(meta.shape) != (B, 3):
        raise ValueError(f"alts {tuple(alts.shape)} and meta "
                         f"{tuple(meta.shape)} do not match refs "
                         f"{tuple(refs.shape)}")
    if C < W // 2 + 1 or C + refs.shape[1] + W // 2 > alts.shape[1]:
        raise ValueError(f"alt padding C={C} does not cover the band "
                         f"(Ln={refs.shape[1]}, A={alts.shape[1]})")


def _kernel_lib():
    fn = build.load("sw_banded").rovaca_sw_banded
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p] * 5)
    return fn


def banded_sw(refs, alts, meta, *, params, C, indel_init=False):
    """Run the banded DP of B alignments (layout in the module docstring).

    CUDA tensors: one launch of the CUDA kernel on the current stream, no
    synchronisation; a failed build or launch raises. CPU tensors: the plain
    version. Returns (bt, colm, lastrow, edge) on the inputs' device.
    """
    global LAUNCHES
    _check(refs, alts, meta, C)
    if refs.device.type == "cpu":
        return banded_sw_torch(refs, alts, meta, params=params, C=C,
                               indel_init=indel_init)
    if refs.device.type != "cuda":
        raise ValueError(f"unsupported device {refs.device}")
    B, Ln = refs.shape
    A = alts.shape[1]
    dev = refs.device
    bt = torch.empty((B, Ln, W), dtype=torch.int16, device=dev)
    colm = torch.empty((B, Ln), dtype=torch.int32, device=dev)
    lastrow = torch.empty((B, W), dtype=torch.int32, device=dev)
    edge = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return bt, colm, lastrow, edge
    fn = _kernel_lib()
    wm, wmm, wo, we = (int(p) for p in params)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(refs.data_ptr(), alts.data_ptr(), meta.data_ptr(),
                 B, Ln, A, C, wm, wmm, wo, we, int(bool(indel_init)),
                 bt.data_ptr(), colm.data_ptr(), lastrow.data_ptr(),
                 edge.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sw_banded launch failed: CUDA error {err}")
    LAUNCHES += 1
    return bt, colm, lastrow, edge


class BandedSWResult:
    __slots__ = ("result", "fell_back")

    def __init__(self, result, fell_back):
        self.result = result
        self.fell_back = fell_back


def _traceback_band(bt, colm, lastrow, n, m, offset, overhang, maxscore_edge):
    """Exact GATK end-cell search + traceback over the band, or None when
    the band-edge guard says the optimum may live outside it (carried over
    from rovaca_tpu/ops/sw/banded.py:_traceback_band). bt: (Ln, W); colm:
    (Ln,); lastrow: (W,)."""
    segment_length = 0
    if overhang == OverhangStrategy.INDEL:
        p1, p2 = n, m
    else:
        p1, p2 = 0, m
        maxscore = -np.inf
        for i in range(1, n + 1):
            if colm[i - 1] >= maxscore and colm[i - 1] > LOW_INIT_VALUE // 2:
                p1 = i
                maxscore = colm[i - 1]
        if overhang != OverhangStrategy.LEADING_INDEL:
            csn = n - offset - W // 2
            for j in range(1, m + 1):
                w = j - csn
                if not 0 <= w < W:
                    continue
                cur = lastrow[w]
                if cur <= LOW_INIT_VALUE // 2:
                    continue
                if cur > maxscore or (cur == maxscore
                                      and abs(n - j) < abs(p1 - p2)):
                    p1, p2 = n, j
                    maxscore = cur
                    segment_length = m - j
        if maxscore == -np.inf or maxscore_edge >= maxscore:
            return None            # optimum may live outside the band
    elements = []
    if segment_length > 0 and overhang == OverhangStrategy.SOFTCLIP:
        elements.append((CigarOp.S, segment_length))
        segment_length = 0

    state = CigarOp.M
    while True:
        w = p2 - (p1 - offset - W // 2)
        if not 1 <= w <= W - 2:    # touching the edge: the band is not
            return None            # to be trusted
        btr = int(bt[p1 - 1, w])
        if btr > 0:
            new_state, step = CigarOp.D, btr
        elif btr < 0:
            new_state, step = CigarOp.I, -btr
        else:
            new_state, step = CigarOp.M, 1
        if new_state == CigarOp.M:
            p1 -= 1
            p2 -= 1
        elif new_state == CigarOp.I:
            p2 -= step
        else:
            p1 -= step
        if new_state == state:
            segment_length += step
        else:
            if segment_length > 0:
                elements.append((state, segment_length))
            segment_length = step
            state = new_state
        if not (p1 > 0 and p2 > 0):
            break

    if overhang == OverhangStrategy.SOFTCLIP:
        elements.append((state, segment_length))
        if p2 > 0:
            elements.append((CigarOp.S, p2))
        alignment_offset = p1
    elif overhang == OverhangStrategy.IGNORE:
        elements.append((state, segment_length + p2))
        alignment_offset = p1 - p2
    else:
        elements.append((state, segment_length))
        if p1 > 0:
            elements.append((CigarOp.D, p1))
        elif p2 > 0:
            elements.append((CigarOp.I, p2))
        alignment_offset = 0
    return SWResult(Cigar(reversed(elements)), alignment_offset)


def _round_up(x, mult):
    return -(-x // mult) * mult


def _as_bytes(s):
    return s.encode() if isinstance(s, str) else bytes(s)


def pack_batch(refs, alts, diagonals):
    """Host packing of byte strings (banded.py:407-434, one row per
    alignment): returns (ref_arr (B, Ln), alt_arr (B, A), meta (B, 3)) int32
    and C, the alts' left padding before each diagonal."""
    Ln = _round_up(max(len(r) for r in refs), W)
    Lm = max(len(a) for a in alts)
    offmin = min(0, min(diagonals))
    offmax = max(0, max(diagonals))
    # C keeps every band start inside the array; A covers the largest
    # padded alt and the band's reach past the last row
    C = _round_up(2 * W - offmin, W)
    A = _round_up(max(C + offmax + Lm, C + Ln) + 2 * W, W)
    B = len(refs)
    ref_arr = np.zeros((B, Ln), dtype=np.int32)
    alt_arr = np.full((B, A), -1, dtype=np.int32)
    meta = np.zeros((B, 3), dtype=np.int32)
    for k, (r, a) in enumerate(zip(refs, alts)):
        ref_arr[k, :len(r)] = np.frombuffer(r, dtype=np.uint8)
        p = C + diagonals[k]
        alt_arr[k, p:p + len(a)] = np.frombuffer(a, dtype=np.uint8)
        meta[k] = (len(r), len(a), diagonals[k])
    return ref_arr, alt_arr, meta, C


def _to_host(t):
    """Device tensor -> numpy, through pinned memory on CUDA."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def sw_align_banded_batch(pairs, params, overhang=OverhangStrategy.SOFTCLIP,
                          diagonals=None, device="cpu"):
    """Align [(ref, alt), ...] in a 128-wide diagonal band on ``device``.

    diagonals[k] is alt k's expected start within ref (default
    (len(ref) - len(alt)) // 2). Returns one BandedSWResult per pair whose
    .result is the exact GATK SW output; .fell_back is True where the pair
    went to the host SW instead: every INDEL / LEADING_INDEL pair (a global
    alignment no fixed band soundly holds) and every band miss.
    """
    if not pairs:
        return []
    refs = [_as_bytes(r) for r, _ in pairs]
    alts = [_as_bytes(a) for _, a in pairs]
    if overhang in (OverhangStrategy.INDEL, OverhangStrategy.LEADING_INDEL):
        return [BandedSWResult(_sw_align_python(r, a, params, overhang), True)
                for r, a in zip(refs, alts)]
    if diagonals is None:
        diagonals = [(len(r) - len(a)) // 2 for r, a in zip(refs, alts)]
    diagonals = [int(d) for d in diagonals]
    ref_arr, alt_arr, meta, C = pack_batch(refs, alts, diagonals)
    dev = torch.device(device)
    pin = dev.type == "cuda"
    t = [torch.from_numpy(a) for a in (ref_arr, alt_arr, meta)]
    if pin:
        t = [x.pin_memory().to(dev, non_blocking=True) for x in t]
    outs = banded_sw(*t, params=(params.match, params.mismatch,
                                 params.gap_open, params.gap_extend),
                     C=C, indel_init=False)
    outs = [_to_host(o) for o in outs]
    if pin:
        torch.cuda.current_stream(dev).synchronize()
    bt, colm, lastrow, edge = (np.asarray(o) for o in outs)

    out = []
    for k in range(len(pairs)):
        n, m = len(refs[k]), len(alts[k])
        res = _traceback_band(bt[k], colm[k], lastrow[k], n, m, diagonals[k],
                              overhang, int(edge[k]))
        if res is None:
            out.append(BandedSWResult(
                _sw_align_python(refs[k], alts[k], params, overhang), True))
        else:
            out.append(BandedSWResult(res, False))
    return out
