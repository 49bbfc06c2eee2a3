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
// read tile, hap) and its 8 warps take the 128 reads of the read tile in
// turn. The hap's codes are staged in shared memory once a block, reading
// one lane of the lane-broadcast hbase, not 128. A read row's eight channels
// are read from trans by the lane that holds the row, once per pair.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pairhmm_forward.cuh"

namespace {

constexpr int kReadTile = 128;
constexpr int kHapTile = 8;
constexpr int kWarps = 8;

// Shared memory: (reads longer than one strip only) one row of M, I, I + D
// per warp, then the padded hap codes.
__host__ __device__ inline size_t smem_bytes(int Lh, bool strips) {
  return sizeof(float) * (strips ? 3 * (size_t)kWarps * Lh : 0) +
         rovaca::hap_buffer_bytes(Lh);
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

// RMAX: the most read rows a lane holds; reads longer than 32 * RMAX rows
// sweep several strips (``strips``), handing rows over in shared memory.
template <int RMAX>
__global__ void __launch_bounds__(kWarps * 32, 2)
pairhmm_dense_kernel(const float* __restrict__ trans,
                     const int32_t* __restrict__ rbase,
                     const int32_t* __restrict__ rlen,
                     const int32_t* __restrict__ hbase,
                     const int32_t* __restrict__ hlen, int GR, int Lr, int Lh,
                     bool strips, float initial_constant,
                     float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* rows = strips ? smem + 3 * warp * Lh : nullptr;
  int8_t* s_hap =
      reinterpret_cast<int8_t*>(smem + (strips ? 3 * kWarps * Lh : 0));

  const int h = blockIdx.x % kHapTile;
  const int rt = (blockIdx.x / kHapTile) % GR;
  const int ht = blockIdx.x / (kHapTile * GR);
  float* out_gh = out + (((size_t)ht * GR + rt) * kHapTile + h) * kReadTile;
  const int hl = min(hlen[ht * kHapTile + h], Lh);
  if (hl <= 0) {  // padding hap: exactly 0
    for (int r = threadIdx.x; r < kReadTile; r += blockDim.x) out_gh[r] = 0.f;
    return;
  }
  // lane 0 of the lane-broadcast hbase, not 128 lanes
  const int32_t* hcol = hbase + ((size_t)ht * Lh * kHapTile + h) * kReadTile;
  rovaca::stage_hap(s_hap, hl, [&](int j) {
    return (int8_t)hcol[(size_t)j * kHapTile * kReadTile];
  });
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
    const DenseRows drows{trans, rbase, ((size_t)rt * Lr) * kReadTile + read};
    const float acc = rovaca::pair_forward<RMAX>(drows, rl, s_hap, hl, init_d,
                                                 rows, Lh);
    if (lane == 0) out_gh[read] = acc;
  }
}

template <int RMAX>
int launch(const void* trans, const void* rbase, const void* rlen,
           const void* hbase, const void* hlen, int GR, int GH, int Lr,
           int Lh, float initial_constant, void* out, cudaStream_t stream) {
  const bool strips = Lr > 32 * RMAX;
  const size_t smem = smem_bytes(Lh, strips);
  cudaError_t err = cudaFuncSetAttribute(
      pairhmm_dense_kernel<RMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pairhmm_dense_kernel<RMAX><<<GH * GR * kHapTile, kWarps * 32, smem,
                               stream>>>(
      static_cast<const float*>(trans), static_cast<const int32_t*>(rbase),
      static_cast<const int32_t*>(rlen), static_cast<const int32_t*>(hbase),
      static_cast<const int32_t*>(hlen), GR, Lr, Lh, strips,
      initial_constant, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rovaca_pairhmm_dense(const void* trans, const void* rbase,
                                    const void* rlen, const void* hbase,
                                    const void* hlen, int GR, int GH, int Lr,
                                    int Lh, float initial_constant, void* out,
                                    void* stream) {
  if (GR <= 0 || GH <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // reads of the 64 and 128 buckets: at most 4 rows a lane; longer: 8
  if (Lr <= 128)
    return launch<4>(trans, rbase, rlen, hbase, hlen, GR, GH, Lr, Lh,
                     initial_constant, out, s);
  return launch<8>(trans, rbase, rlen, hbase, hlen, GR, GH, Lr, Lh,
                   initial_constant, out, s);
}
