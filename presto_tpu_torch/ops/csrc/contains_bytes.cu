// Substring search over a padded string column: LIKE '%needle%'.
//
// Replaces presto_tpu/ops/pallas_kernels.py::contains_bytes (kernel body
// _contains_kernel). For every row i of an (N, W) uint8 chars matrix:
//
//     out[i] = exists j >= 0 with j + L <= min(lengths[i], W) and
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
// 3.35 TB/s; at SF10 part.type (N = 2.0M, W = 25) 0.060 GB, 0.018 ms.
// That rate leaves one SM about 3 cycles a row, so the scan has to cost a
// few instructions a word of input on the common path, whatever the rows'
// lengths, and the copies must stay in flight while it runs.
//
// Design (each choice measured on the card; scripts/contains_bytes_phases.py):
//   * persistent blocks: as many as the card holds at once (the SM count
//     times the blocks an SM takes, read at run time), block b walking
//     row tiles b, b + grid, b + 2 grid, ...;
//   * a tile is R rows, R * W contiguous bytes (R = 16 KB / W rounded
//     down to a multiple of 16, at most 1024 and at least 1) and their R
//     lengths. One thread stages both with TMA bulk copies
//     (cp.async.bulk, completing on the stage's mbarrier) from the tile's
//     start rounded down to 16 bytes: the bytes before it (the head) are
//     copied and skipped, so a base pointer that is not 16-byte aligned
//     takes the same path. An array's last piece, when its end is not
//     16-byte aligned, comes by one zero-filled cp.async that the same
//     barrier waits for, so no copy reads past either array. Three
//     stages: tiles t + 1 and t + 2 are in flight while tile t is
//     scanned. (With every thread issuing 16-byte cp.async copies, every
//     warp spent about a seventh of each tile issuing them.)
//   * the scan treats the tile as one stream of bytes, four window starts
//     a word: each step a warp takes 32 neighbouring aligned words of the
//     stage (eight steps' loads first), xors each with the needle's first
//     byte broadcast to four lanes, and the word L - 1 bytes on (a
//     __funnelshift_r of two aligned words) with its last byte, and ORs
//     the two. A word with no zero byte (an exact test of the whole word)
//     holds no candidate; the rare others go, with a ballot and a popc, to
//     the warp's queue in shared memory. Every 32 or more queued words the
//     warp confirms them, one a lane: __vcmpeq4 against zero gives the
//     candidate starts exactly, a start's row is a multiply by a
//     reciprocal of W, a start past min(lengths[row], W) - L is dropped,
//     and the rest are held against the whole needle four bytes a compare
//     (its words in shared memory, its tail masked). A row that matches
//     gets its flag set. Neighbouring lanes read neighbouring words, no
//     lane waits on a row's length, and a match costs its warp no
//     divergence. (A group of lanes a row, four starts a lane, spent most
//     of its time on each row's set-up and votes.)
//   * the flags of a tile collect in shared memory and go out as 16-byte
//     stores one tile later (two flag buffers, cleared by the threads that
//     store them), so each tile takes one block barrier;
//   * the needle is a by-value __grid_constant__ argument (no device
//     buffer, no build per pattern); each block copies its words once.
// Limits: a needle of up to 1024 bytes; a row as wide as three one-row
// stages, the needle, the queues and the flags leave in a block's 227 KB
// of shared memory (contains_bytes_max_width(): about 75,000 bytes).
//
// What holds it back: the scan, about three quarters of each tile's
// cycles (scripts/contains_bytes_phases.py), bound by the latency of its
// shared-memory loads, votes and queue appends rather than by issue or
// bytes.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#ifdef CONTAINS_BYTES_PHASES
// Phase clocks, only in a build with -DCONTAINS_BYTES_PHASES
// (scripts/contains_bytes_phases.py): thread 0 of block 0 adds the clock
// cycles of each phase of its tile loop here, and its tiles in [4].
// Phases: 0 waiting for this tile's copies and the block barrier, 1
// issuing the copies of the tile two ahead (thread 0 issues them all), 2
// storing the flags of the tile before, 3 the scan.
__device__ unsigned long long contains_phase_cycles[5];
#define PHASE_MARK(i)                  \
  if (clocked) {                       \
    const long long now = clock64();   \
    phase[i] += now - mark;            \
    mark = now;                        \
  }
extern "C" int contains_bytes_phases(unsigned long long* host, int reset) {
  if (reset) {
    const unsigned long long zero[5] = {0, 0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(contains_phase_cycles, zero, sizeof(zero)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, contains_phase_cycles, 5 * sizeof(unsigned long long)));
}
#else
#define PHASE_MARK(i)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kTileBytes = 16 * 1024;
constexpr int kMaxTileRows = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kQueue = 64;  // candidate words a warp holds before it confirms them
constexpr int kUnroll = 8;  // steps of 32 words a warp loads before it votes
constexpr int kMaxNeedle = 1024;
constexpr int kNeedleSmem = kMaxNeedle + 16;
constexpr int kBarSmem = 32;  // the stages' mbarriers
constexpr int kMaxSmem = 232448;  // what one block may use on sm_90
constexpr int kBadArgs = -1;
constexpr int kNeedleTooLong = -2;
constexpr int kRowTooWide = -3;

struct alignas(16) Needle {
  unsigned char b[kMaxNeedle];
};

// The shape of a block's work and shared memory for rows of W bytes.
struct Layout {
  int rows;            // R, rows a tile
  int chars_bytes;     // a stage's chars buffer: head, R * W bytes, slack
  int stage_bytes;     // chars buffer and lengths buffer
  int flags_bytes;     // one of the two flag buffers
  int smem;            // the block's dynamic shared memory
  int tiles;           // ceil(N / R)
  unsigned long long recip;  // 2^40 / W + 1: s / W = (s * recip) >> 40 for s < 2^17
};

constexpr int round16(long long x) { return static_cast<int>((x + 15) & ~15LL); }

Layout layout_of(int w) {
  Layout t;
  int r = kTileBytes / w;
  if (r >= 16) r -= r % 16;
  t.rows = r < 1 ? 1 : (r > kMaxTileRows ? kMaxTileRows : r);
  // the head (< 16 bytes), the tile, and slack for the last copy and for
  // the last start's words (at most 10 bytes past the tile)
  t.chars_bytes = round16(static_cast<long long>(t.rows) * w + 32);
  t.stage_bytes = t.chars_bytes + round16(15LL + 4LL * t.rows);
  t.flags_bytes = round16(t.rows);
  t.smem = kBarSmem + kNeedleSmem + kWarps * kQueue * 8 + kStages * t.stage_bytes +
           2 * t.flags_bytes;
  t.recip = (1ULL << 40) / static_cast<unsigned long long>(w) + 1;
  return t;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
// The barrier's phase also waits for this thread's cp.async copies so far.
__device__ __forceinline__ void mbar_track_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred ready;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 ready, [%0], %1;\n"
      "@!ready bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ const unsigned char* down16(const void* p) {
  return reinterpret_cast<const unsigned char*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15));
}

// Stage tile t (one thread): its bytes and its lengths, each from its
// start rounded down to 16 bytes (lo lands at dst + (lo & 15)), as TMA
// bulk copies that complete on the stage's barrier. An array's last
// piece when its end is not 16-byte aligned goes by one zero-filled
// cp.async, which the barrier also waits for; no copy reads past either
// array's end.
__device__ __forceinline__ void issue_tile(unsigned char* st, int chars_bytes,
                                           const unsigned char* chars, const int32_t* lengths,
                                           long long n, int w, int R, int t, uint64_t* bar) {
  const long long r0 = static_cast<long long>(t) * R;
  const long long r1 = min(r0 + R, n);
  const unsigned char* lo[2] = {chars + r0 * w, reinterpret_cast<const unsigned char*>(lengths + r0)};
  const unsigned char* hi[2] = {chars + r1 * w, reinterpret_cast<const unsigned char*>(lengths + r1)};
  const unsigned char* end[2] = {chars + n * w, reinterpret_cast<const unsigned char*>(lengths + n)};
  unsigned char* dst[2] = {st, st + chars_bytes};
  uint32_t bulk[2], tx = 0;
  bool tail = false;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const unsigned char* a = down16(lo[i]);
    const unsigned char* b = down16(hi[i] + 15);
    if (b > end[i]) {  // the array's last, partial 16 bytes
      b = down16(end[i]);
      cp_async16(dst[i] + (b - a), b, static_cast<int>(end[i] - b));
      tail = true;
    }
    bulk[i] = static_cast<uint32_t>(b - a);
    tx += bulk[i];
  }
  if (tail) mbar_track_cp_async(bar);  // before the arrival below, so the phase waits for it
  mbar_arrive_expect(bar, tx);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (bulk[i] > 0) bulk_copy(dst[i], down16(lo[i]), bulk[i], bar);
}

__device__ __forceinline__ int head_of(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// The four bytes at byte offset a of a 4-byte aligned shared buffer, the
// byte at a lowest.
__device__ __forceinline__ uint32_t load4(const unsigned char* buf, int a) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(buf + (a & ~3));
  return __funnelshift_r(p[0], p[1], 8 * (a & 3));
}

// The whole needle at byte offset s, four bytes a compare.
__device__ __forceinline__ bool confirm(const unsigned char* buf, int s, const uint32_t* pat,
                                        int L) {
  for (int k = 0; k < L; k += 4) {
    uint32_t diff = load4(buf, s + k) ^ pat[k >> 2];
    if (L - k < 4) diff &= 0xFFFFFFFFu >> (8 * (4 - (L - k)));
    if (diff) return false;
  }
  return true;
}

// Write a tile's flags from shared memory and clear them for the tile
// after next: 16-byte stores where the tile starts on a multiple of 16
// rows (out itself is 16-byte aligned), bytes for the ragged end. Each
// thread clears what it stored.
__device__ __forceinline__ void store_flags(bool* __restrict__ out, unsigned char* flags,
                                            int tile, int R, long long n) {
  const long long r0 = static_cast<long long>(tile) * R;
  const int rows = static_cast<int>(min(static_cast<long long>(R), n - r0));
  unsigned char* o = reinterpret_cast<unsigned char*>(out) + r0;
  int done = 0;
  if ((R & 15) == 0) {
    const int full = rows >> 4;
    for (int i = threadIdx.x; i < full; i += kThreads) {
      reinterpret_cast<uint4*>(o)[i] = reinterpret_cast<const uint4*>(flags)[i];
      reinterpret_cast<uint4*>(flags)[i] = make_uint4(0, 0, 0, 0);
    }
    done = full << 4;
  }
  for (int i = done + threadIdx.x; i < rows; i += kThreads) {
    o[i] = flags[i];
    flags[i] = 0;
  }
}

// Confirm a warp's queued candidate words, one a lane: each word's set
// bytes are window starts (buffer offsets 4k + u); a start that lies in
// the tile, fits its row's length and holds the whole needle sets its
// row's flag.
__device__ __forceinline__ void confirm_queue(const uint2* queue, int queued,
                                              const unsigned char* st, int head,
                                              const int32_t* lens, int rows, int w, int L,
                                              unsigned long long recip, const uint32_t* pat,
                                              unsigned char* f) {
  for (int e = threadIdx.x & 31; e < queued; e += 32) {
    const uint2 q = queue[e];
    uint32_t cand = __vcmpeq4(q.y, 0u);  // 0xFF where both end bytes match
    while (cand) {
      const int u = (__ffs(cand) - 1) >> 3;
      cand &= ~(0xFFu << (8 * u));
      const int s = static_cast<int>(q.x) + u - head;  // the start's tile offset
      if (s < 0) continue;                              // a head byte, before the tile
      const int r = static_cast<int>((static_cast<unsigned long long>(s) * recip) >> 40);
      if (r >= rows) break;  // past the tile, as are the later starts
      if (s - r * w > min(lens[r], w) - L || f[r]) continue;
      if (confirm(st, head + s, pat, L)) f[r] = 1;
    }
  }
}

// Scan a staged tile: row r's bytes at st + head + r * w, its length at
// lens[r]; a row that holds the needle gets f[r] = 1 (f starts cleared).
// The tile is scanned as one stream: each step a warp takes 32
// neighbouring aligned words of the stage, each the first bytes of the
// four windows that start in it, and the word L - 1 bytes on (a funnel
// shift of two aligned words) their last bytes. A word where both ends
// match somewhere goes to the warp's queue; the warp confirms the queue
// 32 words at a time, so a match costs its lanes no divergence.
__device__ __forceinline__ void scan_tile(const unsigned char* st, int head,
                                          const int32_t* lens, int rows, int w, int L,
                                          unsigned long long recip, const uint32_t* pat,
                                          uint32_t first4, uint32_t last4, uint2* queue,
                                          unsigned char* f) {
  if (L == 0) {
    for (int r = threadIdx.x; r < rows; r += kThreads) f[r] = lens[r] >= 0;
    return;
  }
  const uint32_t* P = reinterpret_cast<const uint32_t*>(st);
  const int lane = threadIdx.x & 31;
  const int lo = (L - 1) >> 2, ls = 8 * ((L - 1) & 3);
  const int top = head + rows * w - L;  // the last start whose window ends in the tile
  int queued = 0;
  for (int kb = (head >> 2) + kUnroll * (threadIdx.x & ~31); 4 * kb <= top;
       kb += kUnroll * kThreads) {
    uint32_t x[kUnroll];
    bool maybe[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {  // the loads of all steps first
      const int k = kb + 32 * i + lane;
      x[i] = 0;
      maybe[i] = false;
      if (4 * k <= top) {
        x[i] = (P[k] ^ first4) | (__funnelshift_r(P[k + lo], P[k + lo + 1], ls) ^ last4);
        maybe[i] = ((x[i] - 0x01010101u) & ~x[i] & 0x80808080u) != 0;  // some byte is 0
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const unsigned ask = __ballot_sync(0xFFFFFFFFu, maybe[i]);
      if (ask) {
        if (maybe[i])
          queue[queued + __popc(ask & ((1u << lane) - 1u))] =
              make_uint2(4 * (kb + 32 * i + lane), x[i]);
        queued += __popc(ask);
        if (queued > kQueue - 32) {
          __syncwarp();
          confirm_queue(queue, queued, st, head, lens, rows, w, L, recip, pat, f);
          queued = 0;
          __syncwarp();
        }
      }
    }
  }
  __syncwarp();
  confirm_queue(queue, queued, st, head, lens, rows, w, L, recip, pat, f);
}

__global__ void __launch_bounds__(kThreads)
contains_bytes_kernel(const unsigned char* __restrict__ chars,
                      const int32_t* __restrict__ lengths,
                      const __grid_constant__ Needle needle, int L,
                      bool* __restrict__ out, long long n, int w, Layout lay) {
  extern __shared__ uint4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint32_t* pat = reinterpret_cast<uint32_t*>(smem + kBarSmem);
  uint2* queue =
      reinterpret_cast<uint2*>(smem + kBarSmem + kNeedleSmem) + (threadIdx.x >> 5) * kQueue;
  unsigned char* stages = smem + kBarSmem + kNeedleSmem + kWarps * kQueue * 8;
  unsigned char* flags = stages + kStages * lay.stage_bytes;

  for (int k = threadIdx.x; k < (L + 3) / 4; k += kThreads)
    pat[k] = reinterpret_cast<const uint32_t*>(needle.b)[k];  // zero past L
  const uint32_t first4 = L > 0 ? needle.b[0] * 0x01010101u : 0u;
  const uint32_t last4 = L > 0 ? needle.b[L - 1] * 0x01010101u : 0u;
  // both flag buffers start cleared; store_flags clears them after use
  for (int i = threadIdx.x; i < 2 * lay.flags_bytes; i += kThreads) flags[i] = 0;

  const int R = lay.rows;
  const int ntiles = lay.tiles;
  const int step = gridDim.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages - 1; ++s)
      if (blockIdx.x + s * step < ntiles)
        issue_tile(stages + s * lay.stage_bytes, lay.chars_bytes, chars, lengths, n, w, R,
                   blockIdx.x + s * step, bars + s);
#ifdef CONTAINS_BYTES_PHASES
  const bool clocked = blockIdx.x == 0 && threadIdx.x == 0;
  long long mark = clock64(), phase[4] = {0, 0, 0, 0};
#endif
  int it = 0;
  int scan_stage = 0;   // it % kStages
  uint32_t parity = 0;  // bit s: the phase of stage s's barrier to wait for
  for (int t = blockIdx.x; t < ntiles; t += step, ++it) {
    mbar_wait(bars + scan_stage, (parity >> scan_stage) & 1);
    parity ^= 1u << scan_stage;
    __syncthreads();  // every thread is done with the tile before: its stage is free
    PHASE_MARK(0);
    const int ahead = scan_stage == 0 ? kStages - 1 : scan_stage - 1;
    if (threadIdx.x == 0 && t + (kStages - 1) * step < ntiles)
      issue_tile(stages + ahead * lay.stage_bytes, lay.chars_bytes, chars, lengths, n, w, R,
                 t + (kStages - 1) * step, bars + ahead);
    PHASE_MARK(1);
    if (it > 0) store_flags(out, flags + ((it - 1) & 1) * lay.flags_bytes, t - step, R, n);
    PHASE_MARK(2);
    const unsigned char* st = stages + scan_stage * lay.stage_bytes;
    const long long r0 = static_cast<long long>(t) * R;
    scan_tile(st, head_of(chars + r0 * w),
              reinterpret_cast<const int32_t*>(st + lay.chars_bytes + head_of(lengths + r0)),
              static_cast<int>(min(static_cast<long long>(R), n - r0)), w, L, lay.recip, pat,
              first4, last4, queue, flags + (it & 1) * lay.flags_bytes);
    scan_stage = scan_stage == kStages - 1 ? 0 : scan_stage + 1;
    PHASE_MARK(3);
  }
#ifdef CONTAINS_BYTES_PHASES
  if (clocked) {
    for (int i = 0; i < 4; ++i) contains_phase_cycles[i] += phase[i];
    contains_phase_cycles[4] += it;
  }
#endif
  __syncthreads();
  if (it > 0)
    store_flags(out, flags + ((it - 1) & 1) * lay.flags_bytes,
                blockIdx.x + (it - 1) * step, R, n);
}

}  // namespace

// The widest row the kernel takes: three one-row stages, the needle, the
// queues and the flags in a block's shared memory.
extern "C" int contains_bytes_max_width() {
  int lo = kTileBytes, hi = 1 << 20;  // layout_of(lo) fits, layout_of(hi) does not
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    (layout_of(mid).smem <= kMaxSmem ? lo : hi) = mid;
  }
  return lo;
}

// chars: (n, w) uint8, lengths: (n,) int32, both contiguous (any
// alignment); needle: L bytes; out: (n,) bool, 16-byte aligned.
// Returns 0 on success, a CUDA error code if the launch fails, or a
// negative code when the arguments do not fit the kernel:
// kNeedleTooLong for L > kMaxNeedle, kRowTooWide when the stages of one
// row, the needle, the queues and the flags exceed a block's shared
// memory (W > contains_bytes_max_width()), kBadArgs otherwise.
extern "C" int contains_bytes_u8(const void* chars, const void* lengths,
                                 const void* needle, int L, void* out,
                                 long long n, int w, void* stream) {
  if (L < 0 || w < 1 || n < 0) return kBadArgs;
  if (reinterpret_cast<uintptr_t>(out) & 15) return kBadArgs;
  if (L > kMaxNeedle) return kNeedleTooLong;
  Layout lay = layout_of(w);
  if (lay.smem > kMaxSmem) return kRowTooWide;
  if (n == 0) return 0;
  if ((n + lay.rows - 1) / lay.rows > (1LL << 30)) return kBadArgs;  // tile indices stay ints
  lay.tiles = static_cast<int>((n + lay.rows - 1) / lay.rows);
  Needle nd;
  memset(nd.b, 0, sizeof(nd.b));
  if (L > 0) memcpy(nd.b, needle, static_cast<size_t>(L));

  // The attribute and the blocks the card holds depend only on the
  // shared memory and the device: query them again only when those
  // change (the queries cost more host time than a small call takes).
  static int seen_dev = -1, seen_smem = -1, seen_grid = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev != seen_dev || lay.smem != seen_smem) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(contains_bytes_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, lay.smem)) !=
            cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, contains_bytes_kernel,
                                                           kThreads, lay.smem)) != cudaSuccess)
      return static_cast<int>(e);
    seen_dev = dev;
    seen_smem = lay.smem;
    seen_grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = min(seen_grid, lay.tiles);
  contains_bytes_kernel<<<static_cast<unsigned>(grid), kThreads, lay.smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(chars), static_cast<const int32_t*>(lengths), nd, L,
      static_cast<bool*>(out), n, w, lay);
  return static_cast<int>(cudaGetLastError());
}
