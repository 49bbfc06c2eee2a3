"""Indexed PairHMM forward over compact tile stacks: kernel and plain version.

Counterpart of rovaca_tpu/ops/pairhmm/indexed.py:pairhmm_pallas_indexed as
fused by compact.py:pairhmm_indexed_compact. Inputs are the compact integer
tile stacks plus a (G,) list of (hap-tile, read-tile) pairs; the output is
(G, 8, 128) raw forward sums scaled by 2^120 (2^1020 in float64).

``pairhmm_indexed_compact`` is the wrapper: on CUDA tensors it launches the
hand-written kernel csrc/pairhmm_indexed.cu (or raises), on CPU tensors it
runs ``pairhmm_indexed_compact_torch``, the plain torch port of
xla.py:_forward_one / pairhmm_xla_indexed.
"""

import ctypes
import functools

import torch

from ... import constants as C
from .. import build
from . import prep
from .compact import broadcast_haps, materialize_channels, tables

LAUNCHES = 0    # kernel launches made by pairhmm_indexed_compact

# plain version: pairs per chunk are capped so no (pairs, Lh, 8, 128) state
# tensor exceeds this many elements
_CHUNK_ELEMS = 1 << 26


def _affine_compose(left, right):
    """Compose affine maps f(x) = a*x + b: right after left."""
    a1, b1 = left
    a2, b2 = right
    return a2 * a1, a2 * b1 + b2


def _interleave(even, odd, dim):
    shape = list(even.shape)
    shape[dim] = even.shape[dim] + odd.shape[dim]
    out = even.new_empty(shape)
    lead = (slice(None),) * dim
    out[lead + (slice(0, None, 2),)] = even
    out[lead + (slice(1, None, 2),)] = odd
    return out


def _associative_scan(elems, dim):
    """Inclusive scan of (a, b) affine pairs along ``dim``, in the same
    odd/even association order as jax.lax.associative_scan, so float32
    rounding follows the XLA path."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(x, start, stop=None, step=1):
        return x[(slice(None),) * dim + (slice(start, stop, step),)]

    reduced = _affine_compose(tuple(sl(e, 0, -1, 2) for e in elems),
                              tuple(sl(e, 1, None, 2) for e in elems))
    odd = _associative_scan(reduced, dim)
    if n % 2 == 0:
        even = _affine_compose(tuple(sl(e, 0, -1) for e in odd),
                               tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = _affine_compose(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _forward(trans, rbase, rlen, hbase, hlen):
    """P independent (hap-tile x read-tile) pairs, vectorised.

    trans: (P, Lr, 8, 128) float; rbase: (P, Lr, 128) i32; rlen: (P, 1, 128)
    i32; hbase: (P, Lh, 8, 128) i32; hlen: (P, 8, 1) i32. Returns (P, 8, 128)
    raw sums in trans' dtype. A loop over read rows, each row vectorised over
    (P, Lh, 8, 128), the in-row D recurrence solved by the associative scan.
    Rows past every read's end would only copy the row above, so the loop
    stops at the longest read.
    """
    P, Lh = hbase.shape[0], hbase.shape[1]
    dt = trans.dtype
    init = (C.INITIAL_CONSTANT_F64 if dt == torch.float64
            else C.INITIAL_CONSTANT_F32)
    init_d = (torch.tensor(init, dtype=dt, device=trans.device)
              / hlen.clamp(min=1).to(dt))                     # (P, 8, 1)
    init_d = init_d.expand(P, 8, prep.READ_TILE)

    col = torch.arange(Lh, device=trans.device).view(1, Lh, 1, 1)
    hvalid = col < hlen[:, None]                              # (P, Lh, 8, 1)

    # carries are padded along columns: index 0 = virtual column -1
    Mp = torch.zeros((P, Lh + 1, 8, prep.READ_TILE), dtype=dt,
                     device=trans.device)
    Ip = torch.zeros_like(Mp)
    Dp = init_d[:, None].expand(P, Lh + 1, 8, prep.READ_TILE)
    zcol = torch.zeros((P, 1, 8, prep.READ_TILE), dtype=dt,
                       device=trans.device)

    n_rows = int(rlen.max()) if rlen.numel() else 0
    for i in range(n_rows):
        t = trans[:, i]                                       # (P, 8, 128)
        p_mm, p_gapm, p_mi, p_ii, p_md, p_dd, p_distm, p_1distm = (
            t[:, k, None, None, :] for k in range(8))         # (P,1,1,128)
        match = (rbase[:, i, None, None, :] & hbase) != 0     # (P,Lh,8,128)
        prior = torch.where(hvalid,
                            torch.where(match, p_1distm, p_distm),
                            torch.zeros((), dtype=dt, device=trans.device))

        Mnew = prior * (Mp[:, :-1] * p_mm + (Ip[:, :-1] + Dp[:, :-1])
                        * p_gapm)
        Inew = Mp[:, 1:] * p_mi + Ip[:, 1:] * p_ii

        # D[j] = md*M[j-1] + dd*D[j-1], D[-1] = 0 for every real row
        m_left = torch.cat([zcol, Mnew[:, :-1]], dim=1)
        a = p_dd.expand(P, Lh, 8, prep.READ_TILE)
        b = p_md * m_left
        _, Dnew = _associative_scan((a, b), dim=1)

        # copy-through for lanes whose read ended
        valid = (i < rlen)[:, None]                           # (P,1,1,128)
        Mnew = torch.where(valid, Mnew, Mp[:, 1:])
        Inew = torch.where(valid, Inew, Ip[:, 1:])
        Dnew = torch.where(valid, Dnew, Dp[:, 1:])

        Mp = torch.cat([zcol, Mnew], dim=1)
        Ip = torch.cat([zcol, Inew], dim=1)
        Dp = torch.cat([zcol, Dnew], dim=1)
    return Mp[:, 1:].sum(dim=1) + Ip[:, 1:].sum(dim=1)


def pairhmm_indexed_compact_torch(q, gi, gc, rbase, rlen, hcode, hlen, hidx,
                                  ridx, dtype=torch.float32):
    """Plain torch version of the indexed forward (any device).

    q/gi/gc: (NR, Lr, 128) u8; rbase: (NR, Lr, 128) i8; rlen: (NR, 1, 128)
    i32; hcode: (NH, Lh, 8) i8; hlen: (NH, 8, 1) i32; hidx/ridx: (G,) i32.
    Returns (G, 8, 128) raw sums in ``dtype`` (float32, or float64 for the
    rescue). A pair listed more than once is computed once (a padded launch
    repeats its filler pair); pairs are taken in chunks to bound memory.
    """
    if hidx.shape[0] > 1:
        pairs, inverse = torch.unique(torch.stack([hidx, ridx], dim=1),
                                      dim=0, return_inverse=True)
        if pairs.shape[0] < hidx.shape[0]:
            return pairhmm_indexed_compact_torch(
                q, gi, gc, rbase, rlen, hcode, hlen,
                pairs[:, 0].contiguous(), pairs[:, 1].contiguous(),
                dtype)[inverse]
    G = hidx.shape[0]
    Lh = hcode.shape[1]
    out = torch.empty((G, 8, prep.READ_TILE), dtype=dtype, device=q.device)
    chunk = max(1, _CHUNK_ELEMS // (Lh * 8 * prep.READ_TILE))
    for s in range(0, G, chunk):
        rsel = ridx[s:s + chunk].long()
        hsel = hidx[s:s + chunk].long()
        out[s:s + chunk] = _forward(
            materialize_channels(q[rsel], gi[rsel], gc[rsel], dtype),
            rbase[rsel].int(), rlen[rsel], broadcast_haps(hcode[hsel]),
            hlen[hsel])
    return out


_ARGS = ("q", "gi", "gc", "rbase", "rlen", "hcode", "hlen", "hidx", "ridx")
_DTYPES = (torch.uint8, torch.uint8, torch.uint8, torch.int8, torch.int32,
           torch.int8, torch.int32, torch.int32, torch.int32)


def _check(tensors):
    q, _, _, _, rlen, hcode, hlen, hidx, ridx = tensors
    dev = q.device
    for name, t, dt in zip(_ARGS, tensors, _DTYPES):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t)}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    NR, Lr = q.shape[0], q.shape[1]
    NH, Lh = hcode.shape[0], hcode.shape[1]
    want = {"q": (NR, Lr, prep.READ_TILE), "gi": (NR, Lr, prep.READ_TILE),
            "gc": (NR, Lr, prep.READ_TILE),
            "rbase": (NR, Lr, prep.READ_TILE),
            "rlen": (NR, 1, prep.READ_TILE), "hcode": (NH, Lh, prep.HAP_TILE),
            "hlen": (NH, prep.HAP_TILE, 1), "hidx": (hidx.shape[0],),
            "ridx": (hidx.shape[0],)}
    for name, t in zip(_ARGS, tensors):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{want[name]}")


@functools.lru_cache(maxsize=None)
def _kernel_tables(device):
    """(2, 128) f32 [ph2pr; match-to-match diagonal] the kernel stages in
    shared memory."""
    return torch.stack(tables(device)).contiguous()


def _kernel_lib():
    lib = build.load("pairhmm_indexed")
    fn = lib.rovaca_pairhmm_indexed
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    return fn


def pairhmm_indexed_compact(q, gi, gc, rbase, rlen, hcode, hlen, hidx, ridx):
    """Score G tile pairs: out[g] is hap tile hidx[g] x read tile ridx[g].

    CUDA tensors: one launch of the CUDA kernel on the current stream, no
    synchronisation; a failed build or launch raises. CPU tensors: the plain
    version. Returns (G, 8, 128) float32 raw sums.
    """
    global LAUNCHES
    tensors = (q, gi, gc, rbase, rlen, hcode, hlen, hidx, ridx)
    _check(tensors)
    if q.device.type == "cpu":
        return pairhmm_indexed_compact_torch(*tensors)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    fn = _kernel_lib()
    NR, Lr = q.shape[0], q.shape[1]
    NH, Lh = hcode.shape[0], hcode.shape[1]
    G = hidx.shape[0]
    tab = _kernel_tables(q.device)
    out = torch.empty((G, prep.HAP_TILE, prep.READ_TILE), dtype=torch.float32,
                      device=q.device)
    if G == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), tab.data_ptr(),
                 G, NR, NH, Lr, Lh, C.INITIAL_CONSTANT_F32, out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"pairhmm_indexed launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
