// Per-tile, per-group partial sums of limb columns: the group-by hot op.
//
// Replaces presto_tpu/ops/pallas_kernels.py::limb_partial_sums (kernel
// body _limb_sum_kernel). For every 1024-row tile t, group g < G and limb
// column c:
//
//     out[t][g][c] = sum of limbs[r][c] over rows r of tile t with ids[r] == g
//
// Rows whose id is outside [0, G) contribute nothing. The TPU kernel
// computes this as one_hot(ids)^T @ limbs on the MXU; here it is a
// segmented integer sum. Two input forms, as on the TPU:
//   * narrow: int16 lanes holding 8-bit limbs (|v| <= 255);
//   * wide:   float32 lanes holding 13-bit limbs (|v| <= 8191).
// Sums accumulate in int32 and become float32 only on the store. They are
// exact: at most 1024 rows of |v| <= 8191 per tile gives |sum| < 2^23, which
// float32 holds exactly. Nothing goes through TF32 or FP8.
//
// Bound: memory. Each row's L limbs are read once and the arithmetic is one
// integer add per limb. At TPC-H q1 SF1 (n = 6.0M, G = 16, L = 70 int16) the
// kernel must move 840 MB of limbs + 24 MB of ids + 26 MB of partials, about
// 0.27 ms at the H100 SXM's 3.35 TB/s.
//
// Design (simple and exact first; mma/wgmma with a bf16 one-hot, and fusing
// the limb split into this kernel, are later work):
//   * one block per (tile, column chunk), 8 warps, each warp owns a
//     128-row stripe of the tile;
//   * lanes walk a row's contiguous limbs (coalesced reads) and each warp
//     adds into its own private G x C int32 table in shared memory, so
//     no two threads ever update one address: no atomics. A shared table
//     with atomics would serialize on q1's few live groups (4 of 16);
//   * four rows are loaded before any of them is added, for memory-level
//     parallelism;
//   * at the end the 8 private tables are summed and stored as float32.
// The wrapper chooses the column chunk C so that 8 * G * C * 4 bytes of
// shared memory fit its budget; more than 48 KB is opted in with
// cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;
constexpr int kWarps = 8;
constexpr int kStripe = kTile / kWarps;
constexpr int kRowsPerStep = 4;

__device__ __forceinline__ int limb_value(int16_t v) { return static_cast<int>(v); }
__device__ __forceinline__ int limb_value(float v) { return __float2int_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
limb_sum_kernel(const int32_t* __restrict__ ids, const T* __restrict__ limbs,
                float* __restrict__ out, long long n, int groups, int L,
                int chunk) {
  extern __shared__ int acc[];  // [kWarps][groups][chunk]
  const int table = groups * chunk;
  const long long tile = blockIdx.x;
  const int c0 = blockIdx.y * chunk;
  const int cols = min(chunk, L - c0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kWarps * table; i += blockDim.x) acc[i] = 0;
  __syncthreads();

  int* mine = acc + warp * table;
  const long long begin = tile * kTile + static_cast<long long>(warp) * kStripe;
  const long long end = min(begin + kStripe, n);
  for (long long r = begin; r < end; r += kRowsPerStep) {
    int g[kRowsPerStep];
#pragma unroll
    for (int k = 0; k < kRowsPerStep; ++k) {
      const int id = (r + k < end) ? __ldg(ids + r + k) : -1;
      g[k] = (id >= 0 && id < groups) ? id : -1;
    }
    for (int c = lane; c < cols; c += 32) {
      int v[kRowsPerStep];
#pragma unroll
      for (int k = 0; k < kRowsPerStep; ++k)
        v[k] = g[k] >= 0 ? limb_value(limbs[(r + k) * L + c0 + c]) : 0;
#pragma unroll
      for (int k = 0; k < kRowsPerStep; ++k)
        if (g[k] >= 0) mine[g[k] * chunk + c] += v[k];
    }
  }
  __syncthreads();

  float* dst = out + tile * groups * L;
  for (int i = threadIdx.x; i < groups * cols; i += blockDim.x) {
    const int gi = i / cols;
    const int c = i - gi * cols;
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += acc[w * table + gi * chunk + c];
    dst[gi * L + c0 + c] = static_cast<float>(s);
  }
}

template <typename T>
int launch(const void* ids, const void* limbs, void* out, long long n,
           int groups, int L, int chunk, void* stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  const size_t smem = static_cast<size_t>(kWarps) * groups * chunk * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        limb_sum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>((L + chunk - 1) / chunk));
  limb_sum_kernel<T><<<grid, kWarps * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const T*>(limbs),
      static_cast<float*>(out), n, groups, L, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int limb_partial_sums_i16(const void* ids, const void* limbs,
                                     void* out, long long n, int groups,
                                     int L, int chunk, void* stream) {
  return launch<int16_t>(ids, limbs, out, n, groups, L, chunk, stream);
}

extern "C" int limb_partial_sums_f32(const void* ids, const void* limbs,
                                     void* out, long long n, int groups,
                                     int L, int chunk, void* stream) {
  return launch<float>(ids, limbs, out, n, groups, L, chunk, stream);
}
