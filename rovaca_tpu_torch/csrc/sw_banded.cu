// Banded Smith-Waterman for Hopper (sm_90a): the band DP and its traceback.
//
// sw_banded_kernel replaces the Pallas TPU kernel
// rovaca_tpu/ops/sw/banded.py:_banded_call (body _banded_kernel). Same
// contract, in a flat layout of one alignment per row (see
// rovaca_tpu_torch/ops/sw/banded.py): affine-gap SW with SOFTCLIP / IGNORE
// initialisation (or the INDEL family's, indel_init) in a 128-wide diagonal
// band, emitting the int16 backtrack band, the column-m score of every row,
// row n's band and the band-edge maximum. All arithmetic is int32 and every
// output is bit-identical to the plain torch version, for scores the wrapper
// has checked fit the scan's keys (below).
//
// sw_traceback_kernel replaces the host half of the TPU path
// (rovaca_tpu/ops/sw/banded.py:_traceback_band, run on the host after the
// whole band came back): the end-cell search over colm and row n, the
// band-edge guard and the walk over bt, for SOFTCLIP and IGNORE. It writes one
// packed slot an alignment, so only the slots cross PCIe, never the band:
//   slot[0] status (1 traced, 0 fall back to the host SW), slot[1] the
//   alignment offset, slot[2] the number of cigar elements, then the
//   elements in the walk's order (the cigar reversed), (length << 4) | op.
//
// What bounds them on the H100:
// - the DP: each row depends on the row above, so an alignment is a serial
//   chain of Ln rows, each ~16 integer operations a band cell plus the
//   in-row gap scan's shuffles; the inputs (a few KB an alignment) are read
//   once and bt (256 bytes a row) is the only sizeable output. Counted over
//   the rows that need computing, the operations bound it; in practice the
//   latency of a row's dependent chain (row above's shuffle -> cell update
//   -> lane total -> shuffle scan -> cell update) does, hidden only by the
//   alignments in flight, and the realignment path launches a few at a time.
// - the traceback: a walk of ~n + m dependent steps over bt (still in L2
//   behind the DP), one alignment a warp: the latency of its loads.
//
// Design of the DP:
// - one warp an alignment, kWarps alignments a block; lane l holds band
//   cells w = 4l .. 4l + 3, so the row above's shift by one cell (the
//   vertical neighbour of cell w is cell w+1) is an in-register move plus
//   one shuffle of each lane's first cell. (Half a warp an alignment, 8
//   cells a lane, was slower at every measured shape: a longer serial
//   in-lane prefix and twice the registers outweigh one scan step less.)
// - the in-row gap chain G[w] = max_{k<w}(B[k] + e(w-k)) is an exclusive
//   max-scan with earliest-index argmax. B[k] and its index travel as one
//   int32 key, B[k] * 128 + (127 - k): a plain max keeps the larger value
//   and, on ties, the earlier index, so each step of the 5-step
//   __shfl_up_sync scan is one shuffle and one max (the lane's total is a
//   tree of maxes over its cells). That is exact while |B| < 2^23, which the
//   wrapper checks from the scores and lengths before a launch. Cells that
//   hold LOW_INIT_VALUE-based scores (left of column 0, right of column m)
//   all map to one floor key: a gap from them never wins against the
//   diagonal of a real cell, so their order cannot reach any output;
// - Hopper's DPX instructions: __vimax3_s32 for max(d, vertical, cutoff)
//   and max(d, gap, cutoff); __vibmax_s32 (max, and whether the first
//   operand won) for the vertical open/extend choice (open wins only when
//   strictly greater) and the cell's gap/vertical/diagonal choice;
// - the ref and the padded alt are staged in shared memory (int16: the alt
//   padding is -1), only the span the band reaches; each lane keeps its 4
//   alt characters in registers and reads one new one a row (the band
//   slides one column a row);
// - each row's 128 backtrack values leave as one coalesced 8-byte store a
//   lane. Rows whose band misses columns 0..m (above the alt's first
//   diagonal or below its last) and rows past the alignment's end are
//   stored as fill (bt 0, colm NEG) and not computed, as the TPU kernel's
//   frozen carries would give: a 150-base read against a 500-base haplotype
//   computes ~280 of 500 rows. The traceback never reads the fill, but the
//   contract (bit-equal to the plain version) writes it, and it is most of
//   the DP's bytes at the realignment shapes.
// Design of the traceback: one warp an alignment, all lanes in step. The
// lanes reduce colm (the last row with the highest score wins) and row n's
// band (the highest score, then the column nearest n, then the first, which
// is what the sequential scan with its running end cell keeps). The walk
// reads 32 cells down the current diagonal at once, one a lane, and takes
// the run of diagonal steps up to the first gap cell (a ballot) in one go;
// a gap step is one serial step. Lane 0 writes the slot. It is launched
// right after the DP on the same stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kW = 128;
constexpr int kCells = 4;            // band cells a lane: 32 lanes a band
constexpr int kWarps = 4;            // alignments (warps) a DP block
constexpr int kNeg = -(1 << 30);     // LOW_INIT_VALUE
constexpr int kHalfLow = -(1 << 29);  // LOW_INIT_VALUE // 2
constexpr int kCutoff = -100000000;  // MATRIX_MIN_CUTOFF
constexpr int kFloor = INT32_MIN;    // the key of a LOW_INIT_VALUE-based cell
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOpM = 0, kOpI = 1, kOpD = 2, kOpS = 4;  // CigarOp
constexpr int kSoftclip = 0, kIgnore = 3;              // OverhangStrategy
constexpr int kTbWarps = 4;          // alignments a traceback block

struct Scores {
  int wm, wmm, wo, we, indel_init;
};

__device__ __forceinline__ int row0_val(int j, int m, const Scores& p) {
  if (j < 0 || j > m) return kNeg;
  if (!p.indel_init || j == 0) return 0;
  return p.wo + (j - 1) * p.we;
}

__device__ __forceinline__ void store_row(int16_t* dst, const int16_t* v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(
      (uint32_t)(uint16_t)v[0] | ((uint32_t)(uint16_t)v[1] << 16),
      (uint32_t)(uint16_t)v[2] | ((uint32_t)(uint16_t)v[3] << 16));
}

__global__ void __launch_bounds__(kWarps * 32)
sw_banded_kernel(const int32_t* __restrict__ refs,
                 const int32_t* __restrict__ alts,
                 const int32_t* __restrict__ meta, int B, int Ln, int A,
                 int C, Scores p, int16_t* __restrict__ bt,
                 int32_t* __restrict__ colm, int32_t* __restrict__ lastrow,
                 int32_t* __restrict__ edge) {
  extern __shared__ int16_t smem16[];
  const int slot = threadIdx.x >> 5;   // alignment within the block
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + slot;
  if (b >= B) return;   // a whole warp: no block barrier follows

  int16_t* s_ref = smem16 + (size_t)slot * (Ln + A);
  int16_t* s_alt = s_ref + Ln;
  const int n = min(meta[b * 3], Ln);
  const int m = meta[b * 3 + 1];
  const int off = meta[b * 3 + 2];
  {
    // the ref's rows, and the alt columns rows 0..n of the band reach
    const int32_t* ref_b = refs + (size_t)b * Ln;
    const int32_t* alt_b = alts + (size_t)b * A;
    for (int k = lane; k < n; k += 32) s_ref[k] = (int16_t)ref_b[k];
    const int a_end = min(A, C + n + kW / 2);
    for (int k = C - kW / 2 - 1 + lane; k < a_end; k += 32)
      s_alt[k] = (int16_t)alt_b[k];
  }
  __syncwarp();

  const int w0 = lane * kCells;
  int H[kCells], V[kCells], KS[kCells], last[kCells], a[kCells], kb[kCells];
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    H[c] = row0_val(-off - kW / 2 + w0 + c, m, p);
    V[c] = kNeg;
    KS[c] = 0;
    last[c] = kNeg;
    a[c] = s_alt[C - kW / 2 - 1 + w0 + c];   // row 0's alt window
    // key of cell w: (hv + wo - we*w) * 128 + 127 - w = hv * 128 + kb
    kb[c] = (p.wo - p.we * (w0 + c)) * 128 + (kW - 1 - (w0 + c));
  }
  int edge_acc = kNeg;
  int16_t* bt_b = bt + (size_t)b * Ln * kW;
  int32_t* colm_b = colm + (size_t)b * Ln;

  for (int i = 1; i <= n; ++i) {
    const int cs = i - off - kW / 2;      // column of band cell 0
    const int c0 = p.indel_init ? p.wo + (i - 1) * p.we : 0;
    // a row whose band misses columns 0..m (left of column 0, or right of
    // column m) is all fill: H NEG, bt 0, colm NEG. Its V and KS reach no
    // later cell that could hold a score, so it is not computed.
    if (cs + kW - 1 < 0 || cs > m) {
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        H[c] = kNeg;
        if (i == n) last[c] = kNeg;
        a[c] = s_alt[i - kW / 2 - 1 + C + w0 + c];
      }
      const int16_t zeros[kCells] = {};
      store_row(bt_b + (size_t)(i - 1) * kW + w0, zeros);
      if (lane == 0) colm_b[i - 1] = kNeg;
      continue;
    }

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
#pragma unroll
    for (int c = 0; c + 1 < kCells; ++c) a[c] = a[c + 1];
    a[kCells - 1] = s_alt[i - kW / 2 - 1 + C + w0 + kCells - 1];

    int d[kCells], vnew[kCells], ksnew[kCells], key[kCells], fill[kCells];
    bool valid[kCells];
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      const int j = cs + w0 + c;
      valid[c] = (unsigned)(j - 1) < (unsigned)m;   // 1 <= j <= m
      fill[c] = j == 0 ? c0 : kNeg;
      const int hup = c + 1 < kCells ? H[(c + 1) % kCells] : h_nx;
      const int vsh = c + 1 < kCells ? V[(c + 1) % kCells] : v_nx;
      const int ksh = c + 1 < kCells ? KS[(c + 1) % kCells] : k_nx;
      bool ext_ge;   // extend wins ties: open only when strictly greater
      vnew[c] = __vibmax_s32(vsh + p.we, hup + p.wo, &ext_ge);
      ksnew[c] = ext_ge ? ksh + 1 : 1;
      d[c] = H[c] + (a[c] == rchar ? p.wm : p.wmm);
      const int hv = valid[c] ? __vimax3_s32(d[c], vnew[c], kCutoff)
                              : fill[c];
      key[c] = valid[c] || j == 0 ? hv * 128 + kb[c] : kFloor;
    }

    // the lane's total as a tree of maxes, then an inclusive scan of the
    // totals (lanes below s get their own value back)
    int sv = max(max(key[0], key[1]), max(key[2], key[3]));
#pragma unroll
    for (int s = 1; s < 32; s <<= 1)
      sv = max(sv, __shfl_up_sync(kFull, sv, s));
    int ek = __shfl_up_sync(kFull, sv, 1);
    if (lane == 0) ek = kFloor;

    int16_t bts[kCells];
    int pk = kFloor;          // in-lane prefix over the cells before c
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      const int w = w0 + c;
      const int gkey = max(ek, pk);      // exclusive prefix at cell c
      pk = max(pk, key[c]);
      const int G = (gkey >> 7) + p.we * (w - 1);
      const int garg = kW - 1 - (gkey & (kW - 1));
      bool right_ge, d_ge;
      const int gv = __vibmax_s32(G, vnew[c], &right_ge);
      const int hval = __vimax3_s32(d[c], gv, kCutoff);
      __vibmax_s32(d[c], gv, &d_ge);
      const int btv = d_ge ? 0 : (right_ge ? garg - w : ksnew[c]);
      const int hcur = valid[c] ? hval : fill[c];
      bts[c] = (int16_t)(valid[c] ? btv : 0);
      H[c] = hcur;
      V[c] = vnew[c];
      KS[c] = ksnew[c];
      if (i == n) last[c] = hcur;
      if (valid[c] && ((c == 0 && lane == 0) ||
                       (c == kCells - 1 && lane == 31)))
        edge_acc = max(edge_acc, hcur);
    }
    store_row(bt_b + (size_t)(i - 1) * kW + w0, bts);

    // column m sits in at most one cell of the band
    const int wm_ = m - cs;
    if (wm_ >= 0 && wm_ < kW) {
      if (lane == wm_ / kCells) {
        const int q = wm_ % kCells;
        int v = H[0];
#pragma unroll
        for (int c = 1; c < kCells; ++c) v = q == c ? H[c] : v;
        colm_b[i - 1] = v;
      }
    } else if (lane == 0) {
      colm_b[i - 1] = kNeg;
    }
  }
  const int e_hi = __shfl_sync(kFull, edge_acc, 31);
  // rows past the alignment's end: frozen carries, bt 0, colm NEG
  const int16_t zeros[kCells] = {};
  for (int i = n; i < Ln; ++i) {
    store_row(bt_b + (size_t)i * kW + w0, zeros);
    if (lane == 0) colm_b[i] = kNeg;
  }
#pragma unroll
  for (int c = 0; c < kCells; ++c) lastrow[(size_t)b * kW + w0 + c] = last[c];
  if (lane == 0) edge[b] = max(edge_acc, e_hi);
}

// (value, distance, column) b better than a: higher value, then nearer, then
// the earlier column
__device__ __forceinline__ bool row_n_better(int bv, int bd, int bj, int av,
                                             int ad, int aj) {
  return bv > av || (bv == av && (bd < ad || (bd == ad && bj < aj)));
}

__global__ void __launch_bounds__(kTbWarps * 32)
sw_traceback_kernel(const int16_t* __restrict__ bt,
                    const int32_t* __restrict__ colm,
                    const int32_t* __restrict__ lastrow,
                    const int32_t* __restrict__ edge,
                    const int32_t* __restrict__ meta, int B, int Ln, int S,
                    int overhang, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kTbWarps + (threadIdx.x >> 5);
  if (b >= B) return;   // a whole warp
  const int n = min(meta[b * 3], Ln);
  const int m = meta[b * 3 + 1];
  const int off = meta[b * 3 + 2];
  const int32_t* colm_b = colm + (size_t)b * Ln;

  // rows: the last row of the highest score above LOW_INIT_VALUE // 2
  int best = INT32_MIN, bi = 0;
  for (int i = 1 + lane; i <= n; i += 32) {
    const int v = colm_b[i - 1];
    if (v > kHalfLow && v >= best) {
      best = v;
      bi = i;
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int ov = __shfl_xor_sync(kFull, best, s);
    const int oi = __shfl_xor_sync(kFull, bi, s);
    if (ov > best || (ov == best && oi > bi)) {
      best = ov;
      bi = oi;
    }
  }
  int p1 = bi, p2 = m, maxscore = best, seg = 0;

  // row n, columns 1..m in the band. Scanned in order, a cell takes the end
  // when it beats the running score, or ties it nearer column n than the
  // running end: so the end moves to the highest cell nearest n (the first
  // of two as near), and for a tie with the rows' score only if nearer n
  // than their end.
  const int csn = n - off - kW / 2;
  const int32_t* last_b = lastrow + (size_t)b * kW;
  int rv = INT32_MIN, rd = INT32_MAX, rj = INT32_MAX;
#pragma unroll
  for (int q = 0; q < kW / 32; ++q) {
    const int j = lane + 32 * q + csn;
    const int cur = last_b[lane + 32 * q];
    if (j >= 1 && j <= m && cur > kHalfLow &&
        row_n_better(cur, abs(n - j), j, rv, rd, rj)) {
      rv = cur;
      rd = abs(n - j);
      rj = j;
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int ov = __shfl_xor_sync(kFull, rv, s);
    const int od = __shfl_xor_sync(kFull, rd, s);
    const int oj = __shfl_xor_sync(kFull, rj, s);
    if (row_n_better(ov, od, oj, rv, rd, rj)) {
      rv = ov;
      rd = od;
      rj = oj;
    }
  }
  if (rv > maxscore ||
      (rv == maxscore && rv != INT32_MIN && rd < abs(p1 - p2))) {
    p1 = n;
    p2 = rj;
    maxscore = rv;
    seg = m - rj;
  }

  int32_t* slot = out + (size_t)b * S;
  int32_t* el = slot + 3;
  const int cap = S - 3;
  int cnt = 0;
  bool ok = maxscore != INT32_MIN && edge[b] < maxscore;
  auto push = [&](int op, int len) {
    if (cnt >= cap) {
      ok = false;
      return;
    }
    if (lane == 0) el[cnt] = (len << 4) | op;
    ++cnt;
  };
  if (ok && seg > 0 && overhang == kSoftclip) {
    push(kOpS, seg);
    seg = 0;
  }
  int state = kOpM;
  const int16_t* bt_b = bt + (size_t)b * Ln * kW;
  while (ok) {
    const int w = p2 - (p1 - off - kW / 2);
    if (w < 1 || w > kW - 2) {   // touching the edge: the band is not
      ok = false;                // to be trusted
      break;
    }
    // diagonal steps keep w: lane k reads the cell k steps down the
    // diagonal, and the run goes to the first gap cell or to row/column 0
    const int reach = min(32, min(p1, p2));
    const int v = lane < reach ? bt_b[(size_t)(p1 - 1 - lane) * kW + w] : 0;
    const unsigned gaps = __ballot_sync(kFull, v != 0);
    const int run = gaps ? __ffs(gaps) - 1 : reach;
    if (run > 0) {
      if (state == kOpM) {
        seg += run;
      } else {
        if (seg > 0) push(state, seg);
        seg = run;
        state = kOpM;
      }
      p1 -= run;
      p2 -= run;
      if (!(p1 > 0 && p2 > 0)) break;
      if (!gaps) continue;
    }
    const int btr = __shfl_sync(kFull, v, run);   // the gap cell
    int ns, step;
    if (btr > 0) {
      ns = kOpD;
      step = btr;
      p1 -= step;
    } else {
      ns = kOpI;
      step = -btr;
      p2 -= step;
    }
    if (ns == state) {
      seg += step;
    } else {
      if (seg > 0) push(state, seg);
      seg = step;
      state = ns;
    }
    if (!(p1 > 0 && p2 > 0)) break;
  }
  int aoff = 0;
  if (ok) {
    if (overhang == kSoftclip) {
      push(state, seg);
      if (p2 > 0) push(kOpS, p2);
      aoff = p1;
    } else {
      push(state, seg + p2);
      aoff = p1 - p2;
    }
  }
  if (lane == 0) {
    slot[0] = ok ? 1 : 0;
    slot[1] = ok ? aoff : 0;
    slot[2] = ok ? cnt : 0;
  }
}

}  // namespace

// The caller has checked |scores| < 2^23.
extern "C" int rovaca_sw_banded(const void* refs, const void* alts,
                                const void* meta, int B, int Ln, int A, int C,
                                int wm, int wmm, int wo, int we,
                                int indel_init, void* bt, void* colm,
                                void* lastrow, void* edge, void* stream) {
  if (B <= 0) return 0;
  const Scores p = {wm, wmm, wo, we, indel_init};
  const size_t smem = sizeof(int16_t) * (size_t)kWarps * (Ln + A);
  cudaError_t err = cudaFuncSetAttribute(
      sw_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kWarps - 1) / kWarps;
  sw_banded_kernel<<<blocks, kWarps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(refs), static_cast<const int32_t*>(alts),
      static_cast<const int32_t*>(meta), B, Ln, A, C, p,
      static_cast<int16_t*>(bt), static_cast<int32_t*>(colm),
      static_cast<int32_t*>(lastrow), static_cast<int32_t*>(edge));
  return (int)cudaGetLastError();
}

// out: (B, S) int32 packed slots, S >= max(n + m) + 3; overhang SOFTCLIP (0)
// or IGNORE (3).
extern "C" int rovaca_sw_traceback(const void* bt, const void* colm,
                                   const void* lastrow, const void* edge,
                                   const void* meta, int B, int Ln, int S,
                                   int overhang, void* out, void* stream) {
  if (B <= 0) return 0;
  if (S < 4 || (overhang != kSoftclip && overhang != kIgnore))
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + kTbWarps - 1) / kTbWarps;
  sw_traceback_kernel<<<blocks, kTbWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(bt), static_cast<const int32_t*>(colm),
      static_cast<const int32_t*>(lastrow), static_cast<const int32_t*>(edge),
      static_cast<const int32_t*>(meta), B, Ln, S, overhang,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
