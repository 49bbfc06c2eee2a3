"""Banded Smith-Waterman: the DP and traceback kernels, their plain versions.

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

The traceback turns those into one packed int32 slot an alignment, of S >=
max(n + m) + 3 entries: [status (1 traced, 0 fall back), alignment offset,
element count, elements...], the elements in the walk's order (the cigar
reversed), each (length << 4) | op. Entries past the count are unspecified.

``banded_sw`` and ``sw_traceback`` are the wrappers: on CUDA tensors they
launch the hand-written kernels of csrc/sw_banded.cu (or raise), on CPU
tensors they run ``banded_sw_torch`` and ``sw_traceback_torch``.
``sw_align_banded_batch`` packs pairs, runs both on a device, brings back
only the slots, decodes them, and falls back to the exact host SW where the
band cannot be trusted, flagging each such alignment.
"""

import ctypes

import numpy as np
import torch

from ...assembly.sw import (LOW_INIT_VALUE, MATRIX_MIN_CUTOFF,
                            OverhangStrategy, SWResult, _sw_align_python)
from ...reads.cigar import Cigar, CigarOp
from ...utils import platform
from .. import build

W = 128                 # band width
NEG = int(LOW_INIT_VALUE)
HEADER = 3              # status, alignment offset, element count
KEY_LIMIT = 2 ** 23     # |scores| the DP kernel's (value, index) keys hold
LAUNCHES = 0            # DP kernel launches made by banded_sw
TB_LAUNCHES = 0         # traceback kernel launches made by sw_traceback


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


def _kernel_fn(name, n_ptr_in, n_int, n_ptr_out):
    fn = getattr(build.load("sw_banded"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr_in + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p] * n_ptr_out)
    return fn


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def score_bound(params, Ln, A):
    """A bound on |score| (and on the gap scan's B[k]) anywhere in a band of
    Ln rows over A alt columns: every path from row or column 0 has at most
    2 (Ln + A) steps, each worth at most the sum of |params|."""
    return sum(abs(int(p)) for p in params) * (2 * (Ln + A) + 2 * W)


def banded_sw(refs, alts, meta, *, params, C, indel_init=False):
    """Run the banded DP of B alignments (layout in the module docstring).

    CUDA tensors: one launch of the CUDA kernel on the current stream, no
    synchronisation; a failed build or launch raises, and so do scores
    that could pass KEY_LIMIT (``score_bound``), which the kernel's scan
    keys need. CPU tensors: the plain version. Returns (bt, colm, lastrow, edge) on the
    inputs' device.
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
    wm, wmm, wo, we = (int(p) for p in params)
    if score_bound(params, Ln, A) >= KEY_LIMIT:
        raise ValueError(f"scores {params} over Ln={Ln}, A={A} may reach "
                         f"2^23, past the kernel's scan keys")
    dev = refs.device
    bt = torch.empty((B, Ln, W), dtype=torch.int16, device=dev)
    colm = torch.empty((B, Ln), dtype=torch.int32, device=dev)
    lastrow = torch.empty((B, W), dtype=torch.int32, device=dev)
    edge = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return bt, colm, lastrow, edge
    fn = _kernel_fn("rovaca_sw_banded", 3, 9, 5)
    with torch.cuda.device(dev):
        err = fn(refs.data_ptr(), alts.data_ptr(), meta.data_ptr(),
                 B, Ln, A, C, wm, wmm, wo, we, int(bool(indel_init)),
                 bt.data_ptr(), colm.data_ptr(), lastrow.data_ptr(),
                 edge.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"sw_banded launch failed: CUDA error {err}")
    LAUNCHES += 1
    return bt, colm, lastrow, edge


def _check_traceback(bt, colm, lastrow, edge, meta, overhang, S):
    if overhang not in (OverhangStrategy.SOFTCLIP, OverhangStrategy.IGNORE):
        raise ValueError(f"the band traceback takes SOFTCLIP or IGNORE, "
                         f"not {overhang!r}")
    B, Ln = colm.shape
    shapes = {"bt": (bt, (B, Ln, W), torch.int16),
              "lastrow": (lastrow, (B, W), torch.int32),
              "edge": (edge, (B,), torch.int32),
              "meta": (meta, (B, 3), torch.int32),
              "colm": (colm, (B, Ln), torch.int32)}
    for name, (t, shape, dtype) in shapes.items():
        if t.device != colm.device:
            raise ValueError(f"{name} on {t.device}, colm on {colm.device}")
        if tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} of "
                             f"shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if S <= HEADER:
        raise ValueError(f"slot width {S}: no room past the header")


def sw_traceback_torch(bt, colm, lastrow, edge, meta, *, overhang, S):
    """Plain version of the traceback kernel: ``_traceback_band`` on each
    alignment, packed into (B, S) int32 slots (module docstring) on the
    inputs' device; entries past each count are 0. An alignment whose
    cigar would not fit its slot falls back (none does at S >= max(n + m) +
    3)."""
    dev = colm.device
    bt, colm, lastrow, edge, meta = (t.cpu().numpy() for t in
                                     (bt, colm, lastrow, edge, meta))
    B, Ln = colm.shape
    out = np.zeros((B, S), dtype=np.int32)
    for k in range(B):
        n, m, off = (int(x) for x in meta[k])
        res = _traceback_band(bt[k], colm[k], lastrow[k], min(n, Ln), m, off,
                              overhang, int(edge[k]))
        if res is None or len(res.cigar.elements) > S - HEADER:
            continue
        elems = res.cigar.elements[::-1]          # the walk's order
        out[k, :HEADER] = (1, res.alignment_offset, len(elems))
        out[k, HEADER:HEADER + len(elems)] = [(length << 4) | int(op)
                                              for op, length in elems]
    return torch.from_numpy(out).to(dev)


def sw_traceback(bt, colm, lastrow, edge, meta, *, overhang, S):
    """Trace back B alignments from banded_sw's outputs into (B, S) int32
    slots (module docstring). CUDA tensors: one launch of the traceback
    kernel on the current stream, no synchronisation; a failed build or
    launch raises. CPU tensors: the plain version."""
    global TB_LAUNCHES
    _check_traceback(bt, colm, lastrow, edge, meta, overhang, S)
    dev = colm.device
    if dev.type == "cpu":
        return sw_traceback_torch(bt, colm, lastrow, edge, meta,
                                  overhang=overhang, S=S)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, Ln = colm.shape
    out = torch.empty((B, S), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    fn = _kernel_fn("rovaca_sw_traceback", 5, 4, 2)
    with torch.cuda.device(dev):
        err = fn(bt.data_ptr(), colm.data_ptr(), lastrow.data_ptr(),
                 edge.data_ptr(), meta.data_ptr(), B, Ln, S, int(overhang),
                 out.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"sw_traceback launch failed: CUDA error {err}")
    TB_LAUNCHES += 1
    return out


def unpack_slots(packed):
    """(B, S) packed slots (numpy) -> per alignment None (fall back) or
    (alignment offset, [(CigarOp, length), ...] in the walk's order)."""
    out = []
    for row in packed:
        if row[0] != 1:
            out.append(None)
            continue
        cnt = int(row[2])
        out.append((int(row[1]), [(CigarOp(int(e) & 15), int(e) >> 4)
                                  for e in row[HEADER:HEADER + cnt]]))
    return out


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


def slot_width(refs, alts):
    """Packed slot width of a batch: max(n + m) + HEADER entries, room for
    every cigar a walk can give (it has at most n + m elements)."""
    return max(len(r) + len(a) for r, a in zip(refs, alts)) + HEADER


def sw_align_banded_batch(pairs, params, overhang=OverhangStrategy.SOFTCLIP,
                          diagonals=None, device=None):
    """Align [(ref, alt), ...] in a 128-wide diagonal band on ``device``
    (default: the card, ``utils.platform.device()``, which raises without
    one; pass "cpu" for the plain versions).

    On a card the DP and the traceback kernels run back to back on the
    current stream, and only the packed slots come back, through pinned
    memory, after one synchronisation. diagonals[k] is alt k's expected
    start within ref (default (len(ref) - len(alt)) // 2). Returns one
    BandedSWResult per pair whose .result is the exact GATK SW output;
    .fell_back is True where the pair went to the host SW instead: every
    INDEL / LEADING_INDEL pair (a global alignment no fixed band soundly
    holds) and every band miss.
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
    dev = platform.device() if device is None else torch.device(device)
    ref_arr, alt_arr, meta, C = pack_batch(refs, alts, diagonals)
    S = slot_width(refs, alts)
    scores = (params.match, params.mismatch, params.gap_open,
              params.gap_extend)
    t = [torch.from_numpy(a) for a in (ref_arr, alt_arr, meta)]
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            t = [x.pin_memory().to(dev, non_blocking=True) for x in t]
            slots = sw_traceback(*banded_sw(*t, params=scores, C=C), t[2],
                                 overhang=overhang, S=S)
            packed = torch.empty(slots.shape, dtype=slots.dtype,
                                 pin_memory=True)
            packed.copy_(slots, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
    else:
        packed = sw_traceback(*banded_sw(*t, params=scores, C=C), t[2],
                              overhang=overhang, S=S)

    out = []
    for k, traced in enumerate(unpack_slots(packed.numpy())):
        if traced is None:
            out.append(BandedSWResult(
                _sw_align_python(refs[k], alts[k], params, overhang), True))
        else:
            offset, elems = traced
            out.append(BandedSWResult(SWResult(Cigar(elems[::-1]), offset),
                                      False))
    return out
