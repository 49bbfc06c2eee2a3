// PairHMM forward of one (read, hap) pair by one warp, for Hopper (sm_90a).
//
// Shared by the indexed kernel (pairhmm_indexed.cu, K1) and the dense one
// (pairhmm_dense.cu, K2), which replace the Pallas TPU kernel body
// rovaca_tpu/ops/pairhmm/kernel.py:_pairhmm_kernel; they differ only in where
// a read row's eight channels come from, which the template parameter
// supplies.
//
// What bounds it on the H100: operations. A cell costs 11 float operations
// (M: 2 mul, 1 add, 1 FMA; I and D: 1 mul, 1 FMA each; an FMA counts 2),
// ~6.1 Tcells/s at 67 TFLOP/s of FP32 outside the tensor cores, against a few
// hundred input bytes per read row and hap column. Each cell also needs a
// predicate and a select for its prior, and cells chain (M needs the
// diagonal, I the cell above, D the cell to the left), so the SMs' issue
// rate, not bytes, sets the pace: every instruction that is not a cell's own
// arithmetic is time lost.
//
// Scheme: register blocking, as the TPU kernel blocks ROWS_PER_ITER rows of
// a tile per sweep. Each lane holds R consecutive read rows in registers
// (R = ceil(rl / 32), at most RMAX), so one warp covers a read of up to
// 32 * R rows in one strip. The lanes sweep hap columns along anti-diagonals:
// at step t lane l computes column t - l for its R rows, top to bottom, and
// each row hands M, I and I + D to the row below it in registers. Only a
// lane's top row takes the row above from the lane below, by three
// __shfl_up_sync a step, so one shuffle triple serves R cells instead of
// one; the diagonal is the previous step's row above. The hap code of a step
// is one shared-memory byte for R cells.
//
// No per-cell bounds test. The hap codes sit in shared memory between
// kHapPad zero codes on either side: a lane before its first column (t < l)
// computes exact zeros from zero inputs, and a lane past the hap's end
// computes values that flow only to columns past the end, which nothing
// reads. A ragged strip puts its spare slots above its first row, never
// below its last, so the row rl-1 is the bottom row of the strip's last
// lane, whose last column is the strip's last step: the sum over that row
// is taken at every step without a test. The spare slots of a first strip
// carry row -1 (M = I = 0, D = 2^120/hlen) down unchanged: mm = gapm = mi =
// ii = md = distm = one_distm = 0 and dd = 1 give exactly that row back.
//
// A read longer than 32 * RMAX rows sweeps several strips: the first takes
// the remainder, and a strip's last row (M, I and I + D per column) waits in
// shared memory for lane 0 of the next.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rovaca {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kHapPad = 32;  // zero hap codes before and after a hap's own

// One read row's channels in prep.py order, and its base code.
struct RowChannels {
  float mm, gapm, mi, ii, md, dd, distm, one_distm;
  int base;
};

// Bytes of a padded hap-code buffer for haps of up to Lh bases.
__host__ __device__ constexpr int hap_buffer_bytes(int Lh) {
  return Lh + 2 * kHapPad;
}

// Stage hap codes code(j), j < hl, into s_hap with kHapPad zeros on either
// side; the block's threads share the work.
template <class HapCode>
__device__ __forceinline__ void stage_hap(int8_t* s_hap, int hl,
                                          const HapCode& code) {
  for (int k = threadIdx.x; k < hl + 2 * kHapPad; k += blockDim.x) {
    const int j = k - kHapPad;
    s_hap[k] = (j >= 0 && j < hl) ? code(j) : (int8_t)0;
  }
}

// One strip of n read rows starting at row a, R rows a lane. kFirst: the row
// above the strip is row -1; else it is in `top` (M at [0, Lh), I at
// [Lh, 2Lh), I + D at [2Lh, 3Lh)). kLast: the strip ends the read, else its
// last row goes to `bottom` in the same layout. Returns, in every lane, the
// sum over columns of M + I on the strip's last row.
template <int R, bool kFirst, bool kLast, class RowSource>
__device__ __forceinline__ float sweep_strip(const RowSource& row, int a,
                                             int n, const int8_t* s_hap,
                                             int hl, float init_d,
                                             const float* top, float* bottom,
                                             int Lh) {
  const int lane = threadIdx.x & 31;
  const int nl = (n + R - 1) / R;  // lanes that hold rows
  const int pad = nl * R - n;      // spare slots above row a (lane 0)
  RowChannels ch[R];
  float M[R], D[R], S[R];  // own cell at the last column: M, D and I + D
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = lane * R + r - pad;
    if (k < 0) {  // carries row -1 down (only a first strip has spare slots)
      ch[r] = {0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0};
      D[r] = init_d;
    } else {
      ch[r] = k < n ? row(a + k)
                    : RowChannels{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
      D[r] = 0.f;
    }
    M[r] = 0.f;
    S[r] = D[r];
  }
  // the row above the top row at column -1: row -1 (I + D = init_d) for
  // lane 0 of a first strip, else a real row (0)
  float m_dg = 0.f;
  float s_dg = (kFirst && lane == 0) ? init_d : 0.f;
  float i_bot = 0.f;  // own bottom row's I at the last column
  float acc = 0.f;
  const int8_t* hap = s_hap + kHapPad - lane;  // hap[t]: column t - lane
  const int steps = hl + nl - 1;
  for (int t = 0; t < steps; ++t) {
    // the row above at column t - lane: the lower lane's bottom row from the
    // last step, or for lane 0 row -1 / the previous strip's last row
    float up_m = __shfl_up_sync(kFullMask, M[R - 1], 1);
    float up_i = __shfl_up_sync(kFullMask, i_bot, 1);
    float up_s = __shfl_up_sync(kFullMask, S[R - 1], 1);
    if (lane == 0) {
      if (kFirst) {
        up_m = 0.f;
        up_i = 0.f;
        up_s = init_d;
      } else if (t < hl) {
        up_m = top[t];
        up_i = top[Lh + t];
        up_s = top[2 * Lh + t];
      }
    }
    const float next_m_dg = up_m, next_s_dg = up_s;
    const int h = hap[t];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float prior =
          (ch[r].base & h) != 0 ? ch[r].one_distm : ch[r].distm;
      const float m = prior * (m_dg * ch[r].mm + s_dg * ch[r].gapm);
      const float ins = up_m * ch[r].mi + up_i * ch[r].ii;
      const float del = M[r] * ch[r].md + D[r] * ch[r].dd;
      m_dg = M[r];  // row r at the last column: row r + 1's diagonal
      s_dg = S[r];
      up_m = m;  // row r at this column: above row r + 1
      up_i = ins;
      M[r] = m;
      D[r] = del;
      S[r] = ins + del;
    }
    i_bot = up_i;
    m_dg = next_m_dg;
    s_dg = next_s_dg;
    acc += M[R - 1] + i_bot;
    if (!kLast && lane == nl - 1 && t >= lane) {
      const int j = t - lane;
      bottom[j] = M[R - 1];
      bottom[Lh + j] = i_bot;
      bottom[2 * Lh + j] = S[R - 1];
    }
  }
  // the strip's last row is the bottom row of lane nl - 1
  return __shfl_sync(kFullMask, acc, nl - 1);
}

// One strip for a read of rl <= 32 * RMAX rows, at the fewest rows a lane
// (R = ceil(rl / 32)), which keeps the most lanes busy.
template <int R, int RMAX, class RowSource>
__device__ __forceinline__ float one_strip(const RowSource& row, int rl,
                                           const int8_t* s_hap, int hl,
                                           float init_d) {
  if constexpr (R < RMAX) {
    if (rl > 32 * R)
      return one_strip<R + 1, RMAX>(row, rl, s_hap, hl, init_d);
  }
  return sweep_strip<R, true, true>(row, 0, rl, s_hap, hl, init_d, nullptr,
                                    nullptr, 0);
}

// Forward sum over one pair: the sum over columns of M + I on row rl-1,
// returned in every lane. ``row(i)`` returns read row i's RowChannels;
// s_hap holds the hap's codes padded by stage_hap; ``rows`` is the warp's
// 3 * Lh floats of shared memory, needed (and non-null) only when
// rl > 32 * RMAX.
template <int RMAX, class RowSource>
__device__ __forceinline__ float pair_forward(const RowSource& row, int rl,
                                              const int8_t* s_hap, int hl,
                                              float init_d, float* rows,
                                              int Lh) {
  constexpr int kStrip = 32 * RMAX;
  if (rl <= kStrip) return one_strip<1, RMAX>(row, rl, s_hap, hl, init_d);
  const int rest = (rl - 1) % kStrip + 1;  // rows of the first strip
  sweep_strip<RMAX, true, false>(row, 0, rest, s_hap, hl, init_d, nullptr,
                                 rows, Lh);
  int a = rest;
  for (; a + kStrip < rl; a += kStrip) {
    __syncwarp();
    sweep_strip<RMAX, false, false>(row, a, kStrip, s_hap, hl, init_d, rows,
                                    rows, Lh);
  }
  __syncwarp();
  return sweep_strip<RMAX, false, true>(row, a, kStrip, s_hap, hl, init_d,
                                        rows, nullptr, Lh);
}

}  // namespace rovaca
