// PairHMM forward of one (read, hap) pair by one warp, for Hopper (sm_90a).
//
// Shared by the indexed kernel (pairhmm_indexed.cu) and the dense one
// (pairhmm_dense.cu); they differ only in where a read row's eight channels
// come from, which the template parameter supplies.
//
// What bounds it on the H100: the forward recurrence is a chain of dependent
// float ops per cell (M needs the diagonal, I the cell above, D the cell to
// the left), about a dozen flops per cell against a handful of input bytes
// per read row and hap column. So the limit is the latency of the
// anti-diagonal chain and the issue rate of the SMs, not bytes.
//
// Scheme (gpuPairHMM's, not the TPU's 4x8 register blocking): the 32 lanes
// hold 32 consecutive read rows (a strip) and sweep hap columns along
// anti-diagonals, so 32 cells advance per step with no barrier. The row above
// a lane arrives from the lane below by __shfl_up_sync; the diagonal is the
// previous step's row-above value, kept in a register. The strip's last row
// (M, I, D over the hap's columns) waits in shared memory for lane 0 of the
// next strip. Only the pair's own rlen x hlen cells are swept; the result is
// summed on the fly by the lane that holds row rlen-1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rovaca {

constexpr unsigned kFullMask = 0xffffffffu;

// One read row's channels in prep.py order, and its base code.
struct RowChannels {
  float mm, gapm, mi, ii, md, dd, distm, one_distm;
  int base;
};

// Forward sum over one pair. ``row(i)`` returns read row i's RowChannels
// (called once a row by the lane that holds it); s_hap holds the hap's codes;
// row_m/i/d are the warp's Lh-long shared rows. Returns, in the lane holding
// row rl-1 (lane (rl-1) % 32), the sum over columns of M + I on that row.
template <class RowSource>
__device__ __forceinline__ float pair_forward(const RowSource& row, int rl,
                                              const int8_t* s_hap, int hl,
                                              float init_d, float* row_m,
                                              float* row_i, float* row_d) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int i0 = 0; i0 < rl; i0 += 32) {
    const int i = i0 + lane;
    const bool row_ok = i < rl;
    const int nrows = min(32, rl - i0);
    RowChannels ch = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
    if (row_ok) ch = row(i);
    // own cell at column j-1 (starts as column -1: all zero), and the
    // row-above cell one column back (the diagonal of the next step)
    float mc = 0.f, ic = 0.f, dc = 0.f;
    float m_dg = 0.f, i_dg = 0.f;
    float d_dg = (i0 == 0 && lane == 0) ? init_d : 0.f;
    const int nsteps = hl + nrows - 1;
    for (int t = 0; t < nsteps; ++t) {
      const int j = t - lane;
      // row above at column j: the lower lane's cell from the last step
      float m_up = __shfl_up_sync(kFullMask, mc, 1);
      float i_up = __shfl_up_sync(kFullMask, ic, 1);
      float d_up = __shfl_up_sync(kFullMask, dc, 1);
      if (lane == 0) {
        if (i0 == 0) {  // row -1: M = I = 0, D = 2^120 / hapLen
          m_up = 0.f;
          i_up = 0.f;
          d_up = init_d;
        } else if (t < hl) {
          m_up = row_m[t];
          i_up = row_i[t];
          d_up = row_d[t];
        }
      }
      if (row_ok && j >= 0 && j < hl) {
        const float prior =
            (ch.base & s_hap[j]) != 0 ? ch.one_distm : ch.distm;
        const float m = prior * (m_dg * ch.mm + (i_dg + d_dg) * ch.gapm);
        const float ins = m_up * ch.mi + i_up * ch.ii;
        const float del = mc * ch.md + dc * ch.dd;
        mc = m;
        ic = ins;
        dc = del;
        if (lane == 31) {  // strip's last row feeds the next strip
          row_m[j] = m;
          row_i[j] = ins;
          row_d[j] = del;
        }
        if (i == rl - 1) acc += m + ins;
      }
      m_dg = m_up;
      i_dg = i_up;
      d_dg = d_up;
    }
    __syncwarp();
  }
  return acc;
}

}  // namespace rovaca
