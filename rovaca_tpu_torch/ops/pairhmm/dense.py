"""Dense PairHMM forward over every (hap tile, read tile): kernel and plain.

Counterpart of rovaca_tpu/ops/pairhmm/kernel.py:pairhmm_pallas, the launcher
behind the library entry (api.pairhmm_raw / compute_likelihoods). Inputs are
a dense ``prep.PairBatch``'s tensors: trans (GR, Lr, 8, 128) f32 channels,
rbase (GR, Lr, 128) i32, rlen (GR, 1, 128) i32, hbase (GH, Lh, 8, 128) i32
lane-broadcast, hlen (GH, 8, 1) i32. The output is (GH, GR, 8, 128) raw
forward sums scaled by 2^120.

``pairhmm_dense`` is the wrapper: on CUDA tensors it launches the
hand-written kernel csrc/pairhmm_dense.cu (or raises), on CPU tensors it runs
``pairhmm_dense_torch``, the plain forward of indexed.py over all pairs.
"""

import ctypes

import torch

from ... import constants as C
from .. import build
from . import prep
from .indexed import _CHUNK_ELEMS, _forward

LAUNCHES = 0    # kernel launches made by pairhmm_dense

_ARGS = ("trans", "rbase", "rlen", "hbase", "hlen")


def pairhmm_dense_torch(trans, rbase, rlen, hbase, hlen):
    """Plain torch version (any device): the indexed forward over all
    GH x GR tile pairs, in chunks of pairs to bound memory. Like the kernel
    it reads lane 0 of the lane-broadcast hbase."""
    GR, GH, Lh = trans.shape[0], hbase.shape[0], hbase.shape[1]
    out = torch.empty((GH, GR, prep.HAP_TILE, prep.READ_TILE),
                      dtype=trans.dtype, device=trans.device)
    flat = out.view(GH * GR, prep.HAP_TILE, prep.READ_TILE)
    pairs = torch.arange(GH * GR, device=trans.device)
    hcode = hbase[..., :1]
    chunk = max(1, _CHUNK_ELEMS // (Lh * prep.HAP_TILE * prep.READ_TILE))
    for s in range(0, GH * GR, chunk):
        hsel, rsel = pairs[s:s + chunk] // GR, pairs[s:s + chunk] % GR
        flat[s:s + chunk] = _forward(
            trans[rsel], rbase[rsel], rlen[rsel],
            hcode[hsel].expand(-1, -1, -1, prep.READ_TILE), hlen[hsel])
    return out


def _check(tensors):
    trans, _, _, hbase, _ = tensors
    GR, Lr = trans.shape[0], trans.shape[1]
    GH, Lh = hbase.shape[0], hbase.shape[1]
    want = {"trans": ((GR, Lr, 8, prep.READ_TILE), torch.float32),
            "rbase": ((GR, Lr, prep.READ_TILE), torch.int32),
            "rlen": ((GR, 1, prep.READ_TILE), torch.int32),
            "hbase": ((GH, Lh, prep.HAP_TILE, prep.READ_TILE), torch.int32),
            "hlen": ((GH, prep.HAP_TILE, 1), torch.int32)}
    for name, t in zip(_ARGS, tensors):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t)}")
        if t.device != trans.device:
            raise ValueError(f"{name} on {t.device}, trans on {trans.device}")
        shape, dt = want[name]
        if t.dtype != dt:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dt}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _kernel_lib():
    fn = build.load("pairhmm_dense").rovaca_pairhmm_dense
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    return fn


def pairhmm_dense(trans, rbase, rlen, hbase, hlen):
    """Score every (hap tile, read tile) of a dense batch.

    CUDA tensors: one launch of the CUDA kernel on the current stream, no
    synchronisation; a failed build or launch raises. CPU tensors: the plain
    version. Returns (GH, GR, 8, 128) float32 raw sums.
    """
    global LAUNCHES
    tensors = (trans, rbase, rlen, hbase, hlen)
    _check(tensors)
    if trans.device.type == "cpu":
        return pairhmm_dense_torch(*tensors)
    if trans.device.type != "cuda":
        raise ValueError(f"unsupported device {trans.device}")
    GR, Lr = trans.shape[0], trans.shape[1]
    GH, Lh = hbase.shape[0], hbase.shape[1]
    out = torch.empty((GH, GR, prep.HAP_TILE, prep.READ_TILE),
                      dtype=torch.float32, device=trans.device)
    if GR == 0 or GH == 0:
        return out
    fn = _kernel_lib()
    with torch.cuda.device(trans.device):
        stream = torch.cuda.current_stream(trans.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), GR, GH, Lr, Lh,
                 C.INITIAL_CONSTANT_F32, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pairhmm_dense launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
