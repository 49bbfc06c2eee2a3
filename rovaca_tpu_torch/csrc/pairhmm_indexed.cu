// Indexed PairHMM forward for Hopper (sm_90a), compact integer inputs.
//
// Replaces the Pallas TPU kernel rovaca_tpu/ops/pairhmm/indexed.py:
// pairhmm_pallas_indexed (body kernel.py:_pairhmm_kernel), as fused with
// channel materialisation by compact.py:pairhmm_indexed_compact. Same
// contract: G explicit (hap-tile, read-tile) pairs, each tile 8 haps x 128
// reads, output (G, 8, 128) float32 raw forward sums scaled by 2^120.
//
// The per-pair sweep (one warp per (read, hap) pair, anti-diagonals over
// hap columns) is pair_forward in pairhmm_forward.cuh, shared with the dense
// kernel; see there for what bounds it and why it is laid out so. Here a
// block owns one (tile pair, hap) and its warps take the 128 reads of the
// read tile in turn, so the hap's codes and the (128,) ph2pr and
// match-to-match tables are staged in shared memory once a block. The eight
// f32 channels are looked up per read row from the uint8 quals and never go
// through HBM; neither does a lane-broadcast hap tensor.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pairhmm_forward.cuh"

namespace {

constexpr int kReadTile = 128;
constexpr int kHapTile = 8;
constexpr int kWarps = 4;
constexpr int kTable = 128;

__host__ __device__ inline size_t smem_bytes(int Lh) {
  // tables, then per warp one row of M, I, D, then the hap codes
  return sizeof(float) * (2 * kTable + 3 * (size_t)kWarps * Lh) + Lh;
}

// Channels of one read row, looked up from its uint8 quals and the tables.
struct QualRows {
  const uint8_t* q;
  const uint8_t* gi;
  const uint8_t* gc;
  const int8_t* rbase;
  const float* s_ph2pr;
  const float* s_m2m;
  size_t base;  // offset of row 0 of this read in the (NR, Lr, 128) stacks

  __device__ __forceinline__ rovaca::RowChannels operator()(int i) const {
    const size_t off = base + (size_t)i * kReadTile;
    const float p_gi = s_ph2pr[gi[off] & 127];
    const float p_gc = s_ph2pr[gc[off] & 127];
    const float p_q = s_ph2pr[q[off] & 127];
    return {s_m2m[gi[off] & 127], 1.f - p_gc, p_gi, p_gc, p_gi, p_gc,
            p_q / 3.f, 1.f - p_q, rbase[off]};
  }
};

__global__ void __launch_bounds__(kWarps * 32)
pairhmm_indexed_kernel(const uint8_t* __restrict__ q,
                       const uint8_t* __restrict__ gi,
                       const uint8_t* __restrict__ gc,
                       const int8_t* __restrict__ rbase,
                       const int32_t* __restrict__ rlen,
                       const int8_t* __restrict__ hcode,
                       const int32_t* __restrict__ hlen,
                       const int32_t* __restrict__ hidx,
                       const int32_t* __restrict__ ridx,
                       const float* __restrict__ tables,
                       int NR, int NH, int Lr, int Lh,
                       float initial_constant,
                       float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_ph2pr = smem;
  float* s_m2m = smem + kTable;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row_m = smem + 2 * kTable + 3 * warp * Lh;
  float* row_i = row_m + Lh;
  float* row_d = row_i + Lh;
  int8_t* s_hap = reinterpret_cast<int8_t*>(smem + 2 * kTable +
                                            3 * kWarps * Lh);

  const int g = blockIdx.x / kHapTile;
  const int h = blockIdx.x % kHapTile;
  float* out_gh = out + ((size_t)g * kHapTile + h) * kReadTile;
  const int ht = hidx[g];
  const int rt = ridx[g];
  if (ht < 0 || ht >= NH || rt < 0 || rt >= NR) {
    // an index outside the tile stacks poisons its pair's outputs
    for (int r = threadIdx.x; r < kReadTile; r += blockDim.x)
      out_gh[r] = __int_as_float(0x7fc00000);
    return;
  }
  const int hl = min(hlen[ht * kHapTile + h], Lh);
  if (hl <= 0) {  // padding hap: exactly 0
    for (int r = threadIdx.x; r < kReadTile; r += blockDim.x) out_gh[r] = 0.f;
    return;
  }
  for (int k = threadIdx.x; k < 2 * kTable; k += blockDim.x)
    smem[k] = tables[k];
  for (int j = threadIdx.x; j < hl; j += blockDim.x)
    s_hap[j] = hcode[((size_t)ht * Lh + j) * kHapTile + h];
  __syncthreads();

  // row -1: M = I = 0, D = 2^120 / hapLen in every column and the corner
  const float init_d = initial_constant / (float)hl;
  const int32_t* rlen_t = rlen + (size_t)rt * kReadTile;

  for (int read = warp; read < kReadTile; read += kWarps) {
    const int rl = min(rlen_t[read], Lr);
    if (rl <= 0) {  // padding lane: exactly 0
      if (lane == 0) out_gh[read] = 0.f;
      continue;
    }
    const QualRows rows{q, gi, gc, rbase, s_ph2pr, s_m2m,
                        ((size_t)rt * Lr) * kReadTile + read};
    const float acc = rovaca::pair_forward(rows, rl, s_hap, hl, init_d, row_m,
                                           row_i, row_d);
    if (lane == (rl - 1) % 32) out_gh[read] = acc;
  }
}

}  // namespace

extern "C" int rovaca_pairhmm_indexed(const void* q, const void* gi,
                                      const void* gc, const void* rbase,
                                      const void* rlen, const void* hcode,
                                      const void* hlen, const void* hidx,
                                      const void* ridx, const void* tables,
                                      int G, int NR, int NH, int Lr, int Lh,
                                      float initial_constant, void* out,
                                      void* stream) {
  if (G <= 0) return 0;
  const size_t smem = smem_bytes(Lh);
  cudaError_t err = cudaFuncSetAttribute(
      pairhmm_indexed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pairhmm_indexed_kernel<<<G * kHapTile, kWarps * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(gi),
      static_cast<const uint8_t*>(gc), static_cast<const int8_t*>(rbase),
      static_cast<const int32_t*>(rlen), static_cast<const int8_t*>(hcode),
      static_cast<const int32_t*>(hlen), static_cast<const int32_t*>(hidx),
      static_cast<const int32_t*>(ridx), static_cast<const float*>(tables),
      NR, NH, Lr, Lh, initial_constant, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
