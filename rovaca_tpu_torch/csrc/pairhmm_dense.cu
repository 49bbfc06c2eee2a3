// Dense PairHMM forward for Hopper (sm_90a), host-made float32 channels.
//
// Replaces the Pallas TPU kernel rovaca_tpu/ops/pairhmm/kernel.py:
// pairhmm_pallas (body kernel.py:_pairhmm_kernel), the launcher over the
// dense grid of every (hap tile, read tile). Same contract:
// trans (GR, Lr, 8, 128) f32 channels in prep.py order, rbase (GR, Lr, 128)
// i32, rlen (GR, 1, 128) i32, hbase (GH, Lh, 8, 128) i32 lane-broadcast,
// hlen (GH, 8, 1) i32; output (GH, GR, 8, 128) float32 raw forward sums
// scaled by 2^120, exactly 0 on padding lanes and haps.
//
// The per-pair sweep is pair_forward in pairhmm_forward.cuh, shared with the
// indexed kernel; see there for what bounds it. A block owns one (hap tile,
// read tile, hap) and its warps take the 128 reads of the read tile in turn.
// The hap's codes are staged in shared memory once a block, reading one lane
// of the lane-broadcast hbase, not 128. A read row's eight channels are read
// from trans by the lane that holds the row, once per pair.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pairhmm_forward.cuh"

namespace {

constexpr int kReadTile = 128;
constexpr int kHapTile = 8;
constexpr int kWarps = 4;

__host__ __device__ inline size_t smem_bytes(int Lh) {
  // per warp one row of M, I, D, then the hap codes
  return sizeof(float) * 3 * (size_t)kWarps * Lh + Lh;
}

// Channels of one read row, read from the dense f32 channel stack.
struct DenseRows {
  const float* trans;
  const int32_t* rbase;
  size_t base;  // offset of row 0 of this read in the (GR, Lr, 128) stacks

  __device__ __forceinline__ rovaca::RowChannels operator()(int i) const {
    const size_t off = base + (size_t)i * kReadTile;
    const size_t lane = off % kReadTile;
    const float* t = trans + (off - lane) * 8 + lane;   // (row, k, lane)
    return {t[0], t[kReadTile], t[2 * kReadTile], t[3 * kReadTile],
            t[4 * kReadTile], t[5 * kReadTile], t[6 * kReadTile],
            t[7 * kReadTile], rbase[off]};
  }
};

__global__ void __launch_bounds__(kWarps * 32)
pairhmm_dense_kernel(const float* __restrict__ trans,
                     const int32_t* __restrict__ rbase,
                     const int32_t* __restrict__ rlen,
                     const int32_t* __restrict__ hbase,
                     const int32_t* __restrict__ hlen, int GR, int Lr, int Lh,
                     float initial_constant, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row_m = smem + 3 * warp * Lh;
  float* row_i = row_m + Lh;
  float* row_d = row_i + Lh;
  int8_t* s_hap = reinterpret_cast<int8_t*>(smem + 3 * kWarps * Lh);

  const int h = blockIdx.x % kHapTile;
  const int rt = (blockIdx.x / kHapTile) % GR;
  const int ht = blockIdx.x / (kHapTile * GR);
  float* out_gh = out + (((size_t)ht * GR + rt) * kHapTile + h) * kReadTile;
  const int hl = min(hlen[ht * kHapTile + h], Lh);
  if (hl <= 0) {  // padding hap: exactly 0
    for (int r = threadIdx.x; r < kReadTile; r += blockDim.x) out_gh[r] = 0.f;
    return;
  }
  for (int j = threadIdx.x; j < hl; j += blockDim.x)
    s_hap[j] = (int8_t)hbase[(((size_t)ht * Lh + j) * kHapTile + h) *
                             kReadTile];
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
    const DenseRows rows{trans, rbase,
                         ((size_t)rt * Lr) * kReadTile + read};
    const float acc = rovaca::pair_forward(rows, rl, s_hap, hl, init_d, row_m,
                                           row_i, row_d);
    if (lane == (rl - 1) % 32) out_gh[read] = acc;
  }
}

}  // namespace

extern "C" int rovaca_pairhmm_dense(const void* trans, const void* rbase,
                                    const void* rlen, const void* hbase,
                                    const void* hlen, int GR, int GH, int Lr,
                                    int Lh, float initial_constant, void* out,
                                    void* stream) {
  if (GR <= 0 || GH <= 0) return 0;
  const size_t smem = smem_bytes(Lh);
  cudaError_t err = cudaFuncSetAttribute(
      pairhmm_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pairhmm_dense_kernel<<<GH * GR * kHapTile, kWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(trans), static_cast<const int32_t*>(rbase),
      static_cast<const int32_t*>(rlen), static_cast<const int32_t*>(hbase),
      static_cast<const int32_t*>(hlen), GR, Lr, Lh, initial_constant,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
