// Banded Smith-Waterman for Hopper (sm_90a), one alignment per warp.
//
// Replaces the Pallas TPU kernel rovaca_tpu/ops/sw/banded.py:_banded_call
// (body _banded_kernel). Same contract, in a flat layout of one alignment per
// row (see rovaca_tpu_torch/ops/sw/banded.py): affine-gap SW with SOFTCLIP /
// IGNORE initialisation (or the INDEL family's, indel_init) in a 128-wide
// diagonal band, emitting the int16 backtrack band, the column-m score of
// every row, row n's band and the band-edge maximum. All arithmetic is int32
// and every output is bit-identical to the plain torch version.
//
// What bounds it on the H100: each row depends on the row above, so one
// alignment is a serial chain of Ln rows of ~30 integer ops per cell plus the
// in-row gap scan; the inputs (a few KB an alignment) are read once and the
// backtrack band (256 bytes a row) is the only sizeable output. The limit is
// the latency of that chain, hidden by running many alignments at once.
//
// Design:
// - one warp owns one alignment; lane l holds band cells w = 4l .. 4l+3, so
//   the row above's shift by one lane (the vertical neighbour of cell w is
//   cell w+1) is an in-register move plus one __shfl_down_sync of each
//   lane's first cell;
// - the in-row gap chain G[w] = max_{k<w}(B[k] + e(w-k)) is an exclusive
//   max-scan with earliest-index argmax: an in-lane pass over the 4 cells,
//   a 5-step __shfl_up_sync scan of the lane totals whose combine keeps the
//   earlier index on ties, then one shuffle to make it exclusive;
// - the ref and the padded alt are staged in shared memory (int16) once an
//   alignment; the row's alt characters are 4 consecutive shared reads;
// - each row's 128 backtrack values leave as one coalesced 8-byte store a
//   lane; rows past the alignment's end are filled (bt 0, colm NEG) without
//   being computed, as the TPU kernel's frozen carries would give.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kW = 128;
constexpr int kCells = 4;          // band cells per lane
constexpr int kWarps = 4;          // alignments per block
constexpr int kNeg = -(1 << 30);   // LOW_INIT_VALUE
constexpr int kCutoff = -100000000;  // MATRIX_MIN_CUTOFF
constexpr unsigned kFull = 0xffffffffu;

struct Scores {
  int wm, wmm, wo, we, indel_init;
};

__host__ __device__ inline size_t smem_bytes(int Ln, int A) {
  return sizeof(int16_t) * (size_t)kWarps * (Ln + A);
}

__device__ __forceinline__ int row0_val(int j, int m, const Scores& p) {
  if (j < 0 || j > m) return kNeg;
  if (!p.indel_init || j == 0) return 0;
  return p.wo + (j - 1) * p.we;
}

__global__ void __launch_bounds__(kWarps * 32)
sw_banded_kernel(const int32_t* __restrict__ refs,
                 const int32_t* __restrict__ alts,
                 const int32_t* __restrict__ meta, int B, int Ln, int A,
                 int C, Scores p, int16_t* __restrict__ bt,
                 int32_t* __restrict__ colm, int32_t* __restrict__ lastrow,
                 int32_t* __restrict__ edge) {
  extern __shared__ int16_t smem16[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // a whole warp: no block barrier follows

  int16_t* s_ref = smem16 + (size_t)warp * (Ln + A);
  int16_t* s_alt = s_ref + Ln;
  const int32_t* ref_b = refs + (size_t)b * Ln;
  const int32_t* alt_b = alts + (size_t)b * A;
  for (int k = lane; k < Ln; k += 32) s_ref[k] = (int16_t)ref_b[k];
  for (int k = lane; k < A; k += 32) s_alt[k] = (int16_t)alt_b[k];
  __syncwarp();

  const int n = min(meta[b * 3], Ln);
  const int m = meta[b * 3 + 1];
  const int off = meta[b * 3 + 2];
  const int w0 = lane * kCells;

  int H[kCells], V[kCells], KS[kCells], last[kCells];
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    H[c] = row0_val(-off - kW / 2 + w0 + c, m, p);
    V[c] = kNeg;
    KS[c] = 0;
    last[c] = kNeg;
  }
  int edge_acc = kNeg;
  int16_t* bt_b = bt + (size_t)b * Ln * kW;
  int32_t* colm_b = colm + (size_t)b * Ln;

  for (int i = 1; i <= n; ++i) {
    const int cs = i - off - kW / 2;      // column of band lane 0
    const int c0 = p.indel_init ? p.wo + (i - 1) * p.we : 0;

    // row above at column j: the next cell, across lanes for the last one
    int h_nx = __shfl_down_sync(kFull, H[0], 1);
    int v_nx = __shfl_down_sync(kFull, V[0], 1);
    int k_nx = __shfl_down_sync(kFull, KS[0], 1);
    if (lane == 31) {
      h_nx = kNeg;
      v_nx = kNeg;
      k_nx = 0;
    }
    const int rchar = s_ref[i - 1];
    const int16_t* arow = s_alt + (i - kW / 2 - 1 + C + w0);

    int d[kCells], vnew[kCells], ksnew[kCells];
    int pv[kCells], pk[kCells];   // in-lane inclusive prefix max, argmax
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      const int j = cs + w0 + c;
      const bool valid = j >= 1 && j <= m;
      const int hup = c + 1 < kCells ? H[(c + 1) % kCells] : h_nx;
      const int vsh = c + 1 < kCells ? V[(c + 1) % kCells] : v_nx;
      const int ksh = c + 1 < kCells ? KS[(c + 1) % kCells] : k_nx;
      const int open_v = hup + p.wo;
      const int ext_v = vsh + p.we;
      vnew[c] = max(open_v, ext_v);
      ksnew[c] = open_v > ext_v ? 1 : ksh + 1;
      d[c] = H[c] + ((int)arow[c] == rchar ? p.wm : p.wmm);
      int hv = max(max(d[c], vnew[c]), kCutoff);
      hv = valid ? hv : (j == 0 ? c0 : kNeg);
      const int bk = j >= 0 ? hv + p.wo - p.we * (w0 + c) : kNeg;
      pv[c] = bk;
      pk[c] = w0 + c;
      const int cp = c > 0 ? c - 1 : 0;   // the cell before
      if (c > 0 && bk <= pv[cp]) {        // the earlier cell wins ties
        pv[c] = pv[cp];
        pk[c] = pk[cp];
      }
    }

    // inclusive scan of the lane totals; the earlier lane wins ties
    int tv = pv[kCells - 1], tk = pk[kCells - 1];
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int ov = __shfl_up_sync(kFull, tv, s);
      const int ok = __shfl_up_sync(kFull, tk, s);
      if (lane >= s && ov >= tv) {
        tv = ov;
        tk = ok;
      }
    }
    int ev = __shfl_up_sync(kFull, tv, 1);
    int ek = __shfl_up_sync(kFull, tk, 1);
    if (lane == 0) {
      ev = kNeg;
      ek = -1;
    }

    short bts[kCells];
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      const int w = w0 + c;
      const int j = cs + w;
      const bool valid = j >= 1 && j <= m;
      int gmax = ev, garg = ek;   // exclusive prefix at cell c
      const int cp = c > 0 ? c - 1 : 0;
      if (c > 0 && pv[cp] > ev) {       // the earlier lanes win ties
        gmax = pv[cp];
        garg = pk[cp];
      }
      const int G = gmax + p.we * (w - 1);
      const int ki = w - garg;
      const bool use_gap = d[c] < vnew[c] || d[c] < G;
      const bool right_ge = G >= vnew[c];
      int hval = use_gap ? (right_ge ? G : vnew[c]) : d[c];
      hval = max(hval, kCutoff);
      const int btv = use_gap ? (right_ge ? -ki : ksnew[c]) : 0;
      const int hcur = valid ? hval : (j == 0 ? c0 : kNeg);
      bts[c] = (short)(valid ? btv : 0);
      H[c] = hcur;
      V[c] = vnew[c];
      KS[c] = ksnew[c];
      if (i == n) last[c] = hcur;
      if (valid && (w == 0 || w == kW - 1)) edge_acc = max(edge_acc, hcur);
    }
    *reinterpret_cast<short4*>(bt_b + (size_t)(i - 1) * kW + w0) =
        make_short4(bts[0], bts[1], bts[2], bts[3]);

    // column m sits in at most one cell of the band
    const int wm_ = m - cs;
    if (wm_ >= 0 && wm_ < kW) {
      if (lane == (wm_ >> 2)) {
        const int q = wm_ & 3;
        colm_b[i - 1] = q == 0 ? H[0] : q == 1 ? H[1] : q == 2 ? H[2] : H[3];
      }
    } else if (lane == 0) {
      colm_b[i - 1] = kNeg;
    }
  }
  // rows past the alignment's end: frozen carries, bt 0, colm NEG
  for (int i = n; i < Ln; ++i) {
    *reinterpret_cast<short4*>(bt_b + (size_t)i * kW + w0) =
        make_short4(0, 0, 0, 0);
    if (lane == 0) colm_b[i] = kNeg;
  }
#pragma unroll
  for (int c = 0; c < kCells; ++c) lastrow[(size_t)b * kW + w0 + c] = last[c];
  const int e31 = __shfl_sync(kFull, edge_acc, 31);
  if (lane == 0) edge[b] = max(edge_acc, e31);
}

}  // namespace

extern "C" int rovaca_sw_banded(const void* refs, const void* alts,
                                const void* meta, int B, int Ln, int A, int C,
                                int wm, int wmm, int wo, int we,
                                int indel_init, void* bt, void* colm,
                                void* lastrow, void* edge, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = smem_bytes(Ln, A);
  cudaError_t err = cudaFuncSetAttribute(
      sw_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Scores p = {wm, wmm, wo, we, indel_init};
  const int blocks = (B + kWarps - 1) / kWarps;
  sw_banded_kernel<<<blocks, kWarps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(refs), static_cast<const int32_t*>(alts),
      static_cast<const int32_t*>(meta), B, Ln, A, C, p,
      static_cast<int16_t*>(bt), static_cast<int32_t*>(colm),
      static_cast<int32_t*>(lastrow), static_cast<int32_t*>(edge));
  return (int)cudaGetLastError();
}
