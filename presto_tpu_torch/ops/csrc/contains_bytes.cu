// Substring search over a padded string column: LIKE '%needle%'.
//
// Replaces presto_tpu/ops/pallas_kernels.py::contains_bytes (kernel body
// _contains_kernel). For every row i of an (N, W) uint8 chars matrix:
//
//     out[i] = exists j in [0, W - L] with j + L <= lengths[i] and
//              chars[i][j + k] == needle[k] for every k < L
//
// An empty needle (L = 0) matches at j = 0 in every row whose length is
// not negative, as the TPU kernel does. The wrapper handles the cases
// that need no launch (a needle longer than W gives all False).
//
// Bound: memory. Every byte of the matrix, each row's length and each
// output flag move once: (N * W + 5 N) bytes. At the SF1 lineitem.comment
// shape as staged (N = 6.0M, W = 38: the longest generated comment; the
// declared width is 44) that is 0.26 GB, about 0.077 ms at the H100 SXM's
// 3.35 TB/s. The compares are a few byte operations per window and stay
// under the memory time.
//
// Design (simple and right first):
//   * one block of 256 threads takes a tile of R consecutive rows, the
//     VMEM tile of the TPU kernel; R = min(256, 48 KB / W) so the tile
//     fits the default shared memory of a block;
//   * the block copies its tile, R * W contiguous bytes, into shared
//     memory: 16-byte loads when the tile's start is 16-byte aligned,
//     neighbouring threads on neighbouring addresses, bytes otherwise
//     and for the tail;
//   * the needle is a by-value kernel argument (no device buffer, no
//     per-pattern build); the block copies its L bytes to shared memory;
//   * thread r scans row r: every window start j up to min(len, W) - L,
//     compares bytes until the first mismatch, and stops at the first
//     match;
//   * out[i] is written as one byte (torch.bool).
// Rows in a warp have different lengths and match at different windows,
// so the scan diverges; a warp-per-row or word-wide compare is later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNeedle = 1024;
constexpr long long kSmemBytes = 48 * 1024;  // a block's default shared memory
constexpr int kBadArgs = -1;
constexpr int kNeedleTooLong = -2;
constexpr int kRowTooWide = -3;

struct Needle {
  unsigned char b[kMaxNeedle];
};

__global__ void __launch_bounds__(kThreads)
contains_kernel(const unsigned char* __restrict__ chars,
                const int32_t* __restrict__ lengths,
                const __grid_constant__ Needle needle, int L,
                bool* __restrict__ out, long long n, int w, int rows) {
  extern __shared__ uint4 smem[];
  unsigned char* tile = reinterpret_cast<unsigned char*>(smem);
  unsigned char* pat = tile + static_cast<size_t>(rows) * w;

  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int live = static_cast<int>(min(static_cast<long long>(rows), n - row0));
  const size_t nbytes = static_cast<size_t>(live) * w;
  const unsigned char* src = chars + row0 * w;

  size_t done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    const size_t n4 = nbytes / 16;
    for (size_t i = threadIdx.x; i < n4; i += kThreads) smem[i] = __ldg(src4 + i);
    done = n4 * 16;
  }
  for (size_t i = done + threadIdx.x; i < nbytes; i += kThreads) tile[i] = __ldg(src + i);
  for (int k = threadIdx.x; k < L; k += kThreads) pat[k] = needle.b[k];
  __syncthreads();

  const int r = threadIdx.x;
  if (r >= live) return;
  const long long row = row0 + r;
  const unsigned char* s = tile + static_cast<size_t>(r) * w;
  const int last = min(__ldg(lengths + row), w) - L;
  bool found = false;
  for (int j = 0; j <= last && !found; ++j) {
    int k = 0;
    while (k < L && s[j + k] == pat[k]) ++k;
    found = k == L;
  }
  out[row] = found;
}

}  // namespace

// Returns 0 on success, a CUDA error code if the launch fails, or a
// negative code when the arguments do not fit the kernel:
// kNeedleTooLong for L > kMaxNeedle, kRowTooWide when one row and the
// needle exceed a block's shared memory, kBadArgs otherwise.
extern "C" int contains_bytes_u8(const void* chars, const void* lengths,
                                 const void* needle, int L, void* out,
                                 long long n, int w, void* stream) {
  if (L < 0 || w < 1 || n < 0) return kBadArgs;
  if (L > kMaxNeedle) return kNeedleTooLong;
  const int rows = static_cast<int>(
      min(static_cast<long long>(kThreads), (kSmemBytes - L) / w));
  if (rows < 1) return kRowTooWide;
  if (n == 0) return 0;
  Needle nd;
  memset(nd.b, 0, sizeof(nd.b));
  if (L > 0) memcpy(nd.b, needle, static_cast<size_t>(L));
  const long long blocks = (n + rows - 1) / rows;
  const size_t smem = static_cast<size_t>(rows) * w + L;
  contains_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(chars),
      static_cast<const int32_t*>(lengths), nd, L, static_cast<bool*>(out), n,
      w, rows);
  return static_cast<int>(cudaGetLastError());
}
