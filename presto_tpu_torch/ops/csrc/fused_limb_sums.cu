// Fused limb split and per-group limb sums: the small-table group-by.
//
// Replaces presto_tpu/ops/pallas_kernels.py::limb_partial_sums (kernel
// body _limb_sum_kernel) together with the limb split that feeds it
// (presto_tpu/ops/aggregation.py::_fused_limb_sums stacks an (n, L) limb
// matrix before the call). Here the kernel reads the source lanes the
// aggregates name, splits them into limbs in registers and sums the limbs
// per group, so the limb matrix never exists in device memory.
//
// Contract. Every request r names a source lane (bool, int8/16/32/64, or
// the (hi, lo) int64 pair of a 128-bit value), an optional bool mask lane,
// a bit offset `shift` and `bits`. Its contribution for row i is
//     x = V_i >> shift                             (remainder: signed)
//     x = (V_i >> shift) & (2^bits - 1)            (otherwise: unsigned)
// zeroed where the mask is false. x is split into nl = ceil(bits / 7)
// limbs of 7 bits, low first, the low limbs unsigned and the last the
// signed (remainder) or unsigned top field, so that every limb lies in
// [-128, 127] and is held as s8. For every group g < G the kernel adds
// each limb over the rows with ids[i] == g; rows whose id lies outside
// [0, G) contribute nothing. out[g][r][j] (int64, zeroed by the caller)
// receives limb j's total; the wrapper recombines sum_j out[g][r][j] << 7j.
//
// Exactness. Limb sums accumulate in int32 per block, which is exact
// while a block sums at most 2^24 rows (|limb| <= 128): the entry point
// refuses a grid whose blocks would take more. Each block then adds its
// (G, L) table into the int64 output with atomicAdd; integer addition
// makes the order irrelevant, so the result is deterministic.
//
// Bound: memory. The kernel reads the ids (int32) and each distinct source
// lane once and writes G x R x J int64 totals. At TPC-H q1 SF1 (n = 6.0M,
// G = 16, 39 requests, L = 70 limbs) the lanes are ids, six bool masks,
// quantity int16, extendedprice int32, discount int8 and two 128-bit
// lanes: 49 bytes a row, 0.29 GB, about 0.088 ms at the H100 SXM's
// 3.35 TB/s. (The unfused path moves the 840 MB int16 limb matrix twice:
// PyTorch writes it and the per-tile kernel reads it.)
//
// Design:
//   * persistent blocks: at most one block per SM at q1's shared memory,
//     each walking a contiguous range of 1024-row chunks;
//   * each chunk of every lane comes into shared memory with 16-byte
//     cp.async copies (a warp per lane), double buffered: chunk k + 1
//     loads while chunk k is split and summed;
//   * split in registers: thread t takes rows 4t..4t+3 of the chunk, reads
//     each source's four values once as 32-bit words (the top words being
//     sign words), and for each of the source's requests takes a 32-bit
//     window with one funnel shift, cuts 7-bit limbs, masks them and packs
//     the four rows' limbs into one 32-bit store. The entry point groups
//     each source's requests into segments by the word their window starts
//     in, so that a segment's word pair is fixed registers (a runtime word
//     index costs a branch tree per row), and puts the requests of one or
//     two limbs first: those take no branch at all. The limb tile in
//     shared memory is column-major ([limb][row], rows contiguous, each
//     column padded by 16 bytes so that fragment loads hit distinct banks);
//   * sums on the int8 tensor cores: per 32-row k-step each warp builds the
//     one-hot(ids) A fragment (16 groups x 32 rows, s8 0/1) in registers
//     with byte compares and runs mma.sync m16n8k32 s8 x s8 -> s32 against
//     the B fragments of the limb columns it owns (column tile w, w + 8,
//     ...), G/16 m-tiles for G up to 64. This is the TPU kernel's one-hot
//     product, made exact by the integer pipe. The s32 accumulators stay
//     in registers for the block's whole range;
//   * one int64 atomicAdd per (group, limb) per block at the end: no
//     per-tile partials.
// The descriptor table travels as a by-value __grid_constant__ struct: no
// device buffer, no host copy. Each block copies the part the split reads
// into shared memory once.
//
// What holds it back (scripts/fused_limb_sums_phases.py): the split. Each
// warp walks every request of its 128 rows as a short chain of dependent
// shared-memory loads, shifts and stores, and with 8 warps a SM (the
// shared memory of double-buffered stages and the limb tile allows one
// block) the chains' latency is not hidden. Taking requests across warps
// instead of rows, so that a warp's row blocks give independent chains,
// is the next step.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#ifdef FUSED_LIMB_SUMS_PHASES
// Phase clocks, only in a build with -DFUSED_LIMB_SUMS_PHASES
// (scripts/fused_limb_sums_phases.py): thread 0 of block 0 adds the clock
// cycles of each phase of its chunk loop here. Phases: 0 issuing the next
// chunk's copies, 1 waiting for this chunk's copies and the barrier,
// 2 the split and its barrier, 3 the sums and their barrier.
__device__ unsigned long long fused_phase_cycles[4];
#define PHASE_MARK(i)                  \
  if (clocked) {                       \
    const long long now = clock64();   \
    phase[i] += now - mark;            \
    mark = now;                        \
  }
extern "C" int fused_limb_sums_phases(unsigned long long* host, int reset) {
  if (reset) {
    const unsigned long long zero[4] = {0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(fused_phase_cycles, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(host, fused_phase_cycles, 4 * sizeof(unsigned long long)));
}
#else
#define PHASE_MARK(i)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kChunk = kThreads * kRowsPerThread;  // rows per chunk
constexpr int kTileStride = kChunk + 16;           // bytes per limb column
constexpr int kMaxSources = 16;
constexpr int kMaxRequests = 128;
constexpr int kMaxLimbs = 256;
constexpr int kMaxTilesPerWarp = kMaxLimbs / 8 / kWarps;
constexpr long long kMaxRowsPerBlock = 1LL << 24;
constexpr int kMaxSmem = 232448;  // what one block may use on sm_90

// refusals, as negative return codes
constexpr int kBadArgs = -1;
constexpr int kTooMany = -2;
constexpr int kMisaligned = -3;
constexpr int kTooMuchSmem = -4;
constexpr int kTooManyRows = -5;

enum Kind { kBool = 0, kI8 = 1, kI16 = 2, kI32 = 3, kI64 = 4, kI128 = 5 };

__host__ __device__ constexpr int lane_bytes(int kind) {
  return kind <= kI8 ? 1 : kind == kI16 ? 2 : kind == kI32 ? 4 : 8;
}
__host__ __device__ constexpr int lanes_of(int kind) { return kind == kI128 ? 2 : 1; }

// A lane to stage: ids first, then every lane of every source.
struct Lane {
  const unsigned char* ptr;
  int smem;   // byte offset in a stage
  int esize;  // bytes a row
};

struct Source {
  int kind;
  int smem[2];  // stage byte offsets of its lanes: the values, or (lo, hi)
};

// The requests of one source whose first window starts in word q:
// [begin, narrow_end) take at most two limbs, [narrow_end, end) more.
struct alignas(8) Segment {
  uint8_t src, q;
  int16_t begin, narrow_end, end;
};

struct alignas(16) Request {
  int mask_off;   // stage byte offset of its bool mask lane, or -1
  int off0;       // tile byte offset of its first limb column
  int off1;       // of its second (two-limb requests), else the spare column
  uint8_t sh;     // its first window: bits [32q + sh, +32) of the value
  uint8_t nl;     // limbs
  uint8_t m0;     // byte mask of its first limb (one-limb requests: the top)
  uint8_t top;    // byte mask of its last limb
};

struct Table {
  int nlanes, nseg, L, tiles, row_stride;  // row_stride = R * J output columns
  int stage_bytes, tile_smem, ids8_smem;
  Lane lane[1 + 2 * kMaxSources];
  Source src[kMaxSources];
  Segment seg[5 * kMaxSources];
  Request req[kMaxRequests];
  uint16_t out_col[kMaxLimbs];  // tile column -> r * J + j
};
static_assert(sizeof(Table) <= 4096, "the table must fit the kernel's parameter space");

// What the split reads for every request, copied from the parameters into
// shared memory once per block: there one 16-byte load fetches a request
// (from the parameters each field is its own indexed constant load, and
// those dominated the split).
struct Desc {
  Request req[kMaxRequests];
  Segment seg[5 * kMaxSources];
  Source src[kMaxSources];
};
static_assert(sizeof(Desc) % 16 == 0, "stages after the descriptors stay aligned");

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage one chunk of every lane: warp w copies lanes w, w + 8, ... in
// 16-byte pieces. Lanes are 16-byte aligned and chunks start at multiples
// of 1024 rows, so every piece starts aligned; the ragged end is
// zero-filled.
__device__ __forceinline__ void stage_chunk(unsigned char* st, const Table& T, long long chunk,
                                            long long n) {
  const long long row0 = chunk * kChunk;
  const int rows = static_cast<int>(min(static_cast<long long>(kChunk), n - row0));
  const int lane = threadIdx.x & 31;
  for (int l = threadIdx.x >> 5; l < T.nlanes; l += kWarps) {
    const Lane& ln = T.lane[l];
    const unsigned char* from = ln.ptr + row0 * ln.esize;
    const int nbytes = rows * ln.esize;
    for (int i = lane * 16; i < nbytes; i += 32 * 16)
      cp_async16(st + ln.smem + i, from + i, min(16, nbytes - i));
  }
  cp_async_commit();
}

// NB bytes of shared memory (NB in 2, 4, 8, 16, 32) as 32-bit words.
template <int NB>
__device__ __forceinline__ void load_raw(const unsigned char* p, uint32_t* out) {
  if constexpr (NB == 2) {
    out[0] = *reinterpret_cast<const uint16_t*>(p);
  } else if constexpr (NB == 4) {
    out[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (NB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + 16 * i);
      out[4 * i] = v.x; out[4 * i + 1] = v.y; out[4 * i + 2] = v.z; out[4 * i + 3] = v.w;
    }
  }
}

// This thread's rows' values of one source as 32-bit words, low first;
// words past the value's width are its sign word (zero for bool).
__device__ __forceinline__ void load_words(const unsigned char* st, const Source& s, int t,
                                           uint32_t (&w)[kRowsPerThread][6]) {
  constexpr int R = kRowsPerThread;
  const unsigned char* p = st + s.smem[0];
  switch (s.kind) {
    case kBool:
    case kI8: {
      uint32_t raw[1];
      load_raw<R>(p + R * t, raw);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t b = (raw[0] >> (8 * r)) & 0xFFu;
        w[r][0] = s.kind == kBool ? b : static_cast<uint32_t>(static_cast<int8_t>(b));
      }
      break;
    }
    case kI16: {
      uint32_t raw[R / 2];
      load_raw<2 * R>(p + 2 * R * t, raw);
#pragma unroll
      for (int r = 0; r < R; ++r)
        w[r][0] = static_cast<uint32_t>(
            static_cast<int32_t>(static_cast<int16_t>(raw[r >> 1] >> (16 * (r & 1)))));
      break;
    }
    case kI32: {
      uint32_t raw[R];
      load_raw<4 * R>(p + 4 * R * t, raw);
#pragma unroll
      for (int r = 0; r < R; ++r) w[r][0] = raw[r];
      break;
    }
    default: {  // kI64, and the low word pair of kI128
      uint32_t raw[2 * R];
      load_raw<8 * R>(p + 8 * R * t, raw);
#pragma unroll
      for (int r = 0; r < R; ++r) { w[r][0] = raw[2 * r]; w[r][1] = raw[2 * r + 1]; }
      if (s.kind == kI128) {
        load_raw<8 * R>(st + s.smem[1] + 8 * R * t, raw);
#pragma unroll
        for (int r = 0; r < R; ++r) { w[r][2] = raw[2 * r]; w[r][3] = raw[2 * r + 1]; }
      }
      break;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int top = s.kind <= kI32 ? 0 : s.kind == kI64 ? 1 : 3;
    uint32_t topw = w[r][0];
    if (top == 1) topw = w[r][1];
    if (top == 3) topw = w[r][3];
    const uint32_t sign =
        s.kind == kBool ? 0u : static_cast<uint32_t>(static_cast<int32_t>(topw) >> 31);
    if (top < 1) w[r][1] = sign;
    if (top < 3) { w[r][2] = sign; w[r][3] = sign; }
    w[r][4] = sign;
    w[r][5] = sign;
  }
}

// Bits [32q + sh, 32q + sh + 32) of a row's value; q is the same in every
// thread, so the switch does not diverge.
__device__ __forceinline__ uint32_t window(const uint32_t (&w)[6], int q, int sh) {
  uint32_t lo, hi;
  switch (q) {
    case 0: lo = w[0]; hi = w[1]; break;
    case 1: lo = w[1]; hi = w[2]; break;
    case 2: lo = w[2]; hi = w[3]; break;
    case 3: lo = w[3]; hi = w[4]; break;
    default: lo = w[4]; hi = w[5]; break;
  }
  return __funnelshift_r(lo, hi, sh);
}

// The low bytes of four words after a right shift by s, in order, as one
// word.
__device__ __forceinline__ uint32_t pack_rows(const uint32_t (&f)[kRowsPerThread], int s) {
  return __byte_perm(__byte_perm(f[0] >> s, f[1] >> s, 0x0040),
                     __byte_perm(f[2] >> s, f[3] >> s, 0x0040), 0x5410);
}

__device__ __forceinline__ void store_rows(unsigned char* dst, uint32_t v) {
  *reinterpret_cast<uint32_t*>(dst) = v;
}

// This thread's rows' mask bytes as 0x00 / 0xFF (bool bytes are 0 or 1:
// times 0xFF makes byte masks); all 0xFF without a mask.
__device__ __forceinline__ uint32_t keep_of(const unsigned char* st, int mask_off, int t) {
  uint32_t m = 0x01010101u;
  if (mask_off >= 0) m = *reinterpret_cast<const uint32_t*>(st + mask_off + 4 * t);
  return m * 0xFFu;
}

// The requests of one segment, word Q known here: each window is one
// funnel shift of fixed registers. Requests of one or two limbs (the
// 13-bit limb sums and the counts) take no branch: a one-limb request
// writes its unused second limb to the spare column.
template <int Q>
__device__ __forceinline__ void split_segment(const unsigned char* st, const Desc& D,
                                              const Segment& seg,
                                              const uint32_t (&w)[kRowsPerThread][6],
                                              unsigned char* tile_t, int t) {
#pragma unroll 2
  for (int r = seg.begin; r < seg.narrow_end; ++r) {
    const Request rq = D.req[r];
    const uint32_t keep = keep_of(st, rq.mask_off, t);
    uint32_t f[kRowsPerThread];
#pragma unroll
    for (int rr = 0; rr < kRowsPerThread; ++rr)
      f[rr] = __funnelshift_r(w[rr][Q], w[rr][Q + 1], rq.sh);
    store_rows(tile_t + rq.off0, pack_rows(f, 0) & (rq.m0 * 0x01010101u) & keep);
    store_rows(tile_t + rq.off1, pack_rows(f, 7) & (rq.top * 0x01010101u) & keep);
  }
  for (int r = seg.narrow_end; r < seg.end; ++r) {  // more than two limbs
    const Request rq = D.req[r];
    const uint32_t keep = keep_of(st, rq.mask_off, t);
    const uint32_t top = rq.top * 0x01010101u;
    for (int k = 0; 4 * k < rq.nl; ++k) {
      const int p = 32 * Q + rq.sh + 28 * k;
      uint32_t f[kRowsPerThread];
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr) f[rr] = window(w[rr], min(p >> 5, 4), p & 31);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = 4 * k + j;
        if (l < rq.nl) {
          const uint32_t byte_mask = l == rq.nl - 1 ? top : 0x7F7F7F7Fu;
          store_rows(tile_t + rq.off0 + l * kTileStride, pack_rows(f, 7 * j) & byte_mask & keep);
        }
      }
    }
  }
}

// Split a staged chunk: limbs into the tile, ids into one byte each
// (0xFF for rows past n and ids outside [0, G)).
__device__ __forceinline__ void split_chunk(const unsigned char* st, const Table& T,
                                            const Desc& D,
                                            unsigned char* tile, unsigned char* ids8,
                                            int rows, int groups) {
  constexpr int R = kRowsPerThread;
  const int t = threadIdx.x;
  {
    uint32_t id[R];
    load_raw<4 * R>(st + 4 * R * t, id);  // the ids lane sits first in a stage
    uint32_t packed = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int v = static_cast<int32_t>(id[r]);
      const bool ok = R * t + r < rows && v >= 0 && v < groups;
      packed |= (ok ? static_cast<uint32_t>(v) : 0xFFu) << (8 * r);
    }
    store_rows(ids8 + R * t, packed);
  }
  unsigned char* tile_t = tile + R * t;
  uint32_t w[R][6];
  int loaded = -1;
  for (int sg = 0; sg < T.nseg; ++sg) {
    const Segment seg = D.seg[sg];
    if (seg.src != loaded) {
      loaded = seg.src;
      load_words(st, D.src[loaded], t, w);
    }
    switch (seg.q) {
      case 0: split_segment<0>(st, D, seg, w, tile_t, t); break;
      case 1: split_segment<1>(st, D, seg, w, tile_t, t); break;
      case 2: split_segment<2>(st, D, seg, w, tile_t, t); break;
      case 3: split_segment<3>(st, D, seg, w, tile_t, t); break;
      default: split_segment<4>(st, D, seg, w, tile_t, t); break;
    }
  }
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One-hot bytes: 1 where the id byte equals g.
__device__ __forceinline__ uint32_t one_hot4(uint32_t ids4, int g) {
  return __vcmpeq4(ids4, static_cast<uint32_t>(g) * 0x01010101u) & 0x01010101u;
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
fused_limb_sums_kernel(long long n, int groups, long long per_block,
                       const __grid_constant__ Table T,
                       unsigned long long* __restrict__ out) {
  extern __shared__ uint4 smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_raw);
  unsigned char* tile = smem + T.tile_smem;
  unsigned char* ids8 = smem + T.ids8_smem;
  const long long nchunks = (n + kChunk - 1) / kChunk;
  const long long c_begin = static_cast<long long>(blockIdx.x) * per_block;
  const long long c_end = min(nchunks, c_begin + per_block);
  if (c_begin >= c_end) return;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int tq = lane & 3;   // thread in group

  // acc[m][i]: this warp's m-tile m of column tile warp + 8i
  int32_t acc[MT][kMaxTilesPerWarp][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < kMaxTilesPerWarp; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][i][e] = 0;

  Desc& desc = *reinterpret_cast<Desc*>(smem);
  {
    const uint32_t* from[3] = {reinterpret_cast<const uint32_t*>(T.req),
                               reinterpret_cast<const uint32_t*>(T.seg),
                               reinterpret_cast<const uint32_t*>(T.src)};
    uint32_t* to[3] = {reinterpret_cast<uint32_t*>(desc.req),
                       reinterpret_cast<uint32_t*>(desc.seg),
                       reinterpret_cast<uint32_t*>(desc.src)};
    const int words[3] = {static_cast<int>(sizeof(T.req) / 4), static_cast<int>(sizeof(T.seg) / 4),
                          static_cast<int>(sizeof(T.src) / 4)};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      for (int i = threadIdx.x; i < words[a]; i += kThreads) to[a][i] = from[a][i];
  }  // read after the first barrier below
  stage_chunk(smem + sizeof(Desc), T, c_begin, n);
#ifdef FUSED_LIMB_SUMS_PHASES
  const bool clocked = blockIdx.x == 0 && threadIdx.x == 0;
  long long mark = clock64(), phase[4] = {0, 0, 0, 0};
#endif
  for (long long c = c_begin; c < c_end; ++c) {
    const int cur = static_cast<int>((c - c_begin) & 1);
    if (c + 1 < c_end) {
      stage_chunk(smem + sizeof(Desc) + (cur ^ 1) * T.stage_bytes, T, c + 1, n);
      PHASE_MARK(0);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    PHASE_MARK(1);
    const int rows = static_cast<int>(min(static_cast<long long>(kChunk), n - c * kChunk));
    split_chunk(smem + sizeof(Desc) + cur * T.stage_bytes, T, desc, tile, ids8, rows, groups);
    __syncthreads();
    PHASE_MARK(2);
#pragma unroll 4
    for (int ks = 0; ks < kChunk / 32; ++ks) {
      const uint32_t i0 = *reinterpret_cast<const uint32_t*>(ids8 + ks * 32 + 4 * tq);
      const uint32_t i1 = *reinterpret_cast<const uint32_t*>(ids8 + ks * 32 + 16 + 4 * tq);
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        a[m][0] = one_hot4(i0, 16 * m + g);
        a[m][1] = one_hot4(i0, 16 * m + g + 8);
        a[m][2] = one_hot4(i1, 16 * m + g);
        a[m][3] = one_hot4(i1, 16 * m + g + 8);
      }
#pragma unroll
      for (int i = 0; i < kMaxTilesPerWarp; ++i) {
        const int nt = warp + kWarps * i;
        if (nt < T.tiles) {
          const unsigned char* col = tile + (nt * 8 + g) * kTileStride + ks * 32 + 4 * tq;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(col);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(col + 16);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_s8(acc[m][i], a[m], b0, b1);
        }
      }
    }
    __syncthreads();
    PHASE_MARK(3);
  }
#ifdef FUSED_LIMB_SUMS_PHASES
  if (clocked)
    for (int i = 0; i < 4; ++i) fused_phase_cycles[i] += phase[i];
#endif

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < kMaxTilesPerWarp; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * m + g + (e >= 2 ? 8 : 0);
        const int col = (warp + kWarps * i) * 8 + 2 * tq + (e & 1);
        const int32_t v = acc[m][i][e];
        if (row < groups && col < T.L && v != 0)
          atomicAdd(out + static_cast<long long>(row) * T.row_stride + T.out_col[col],
                    static_cast<unsigned long long>(static_cast<long long>(v)));
      }
}

template <int MT>
int launch(long long n, int groups, const Table& T, size_t smem,
           int blocks, unsigned long long* out, cudaStream_t stream) {
  auto kernel = fused_limb_sums_kernel<MT>;
  // The attribute and the blocks the card holds depend only on the kernel,
  // its shared memory and the device: query them again only when those
  // change (the queries cost more host time than the kernel takes).
  static int seen_dev = -1, seen_smem = -1, seen_grid = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev != seen_dev || static_cast<int>(smem) != seen_smem) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
            cudaSuccess)
      return static_cast<int>(e);
    seen_dev = dev;
    seen_smem = static_cast<int>(smem);
    seen_grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long nchunks = (n + kChunk - 1) / kChunk;
  long long grid = blocks > 0 ? blocks : seen_grid;
  grid = min(grid, nchunks);
  const long long per_block = (nchunks + grid - 1) / grid;
  if (min(per_block * kChunk, n) > kMaxRowsPerBlock) return kTooManyRows;
  grid = (nchunks + per_block - 1) / per_block;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(n, groups, per_block, T, out);
  return static_cast<int>(cudaGetLastError());
}

int launch_mt(int mt, long long n, int groups, const Table& T, size_t smem,
              int blocks, unsigned long long* out, cudaStream_t stream) {
  switch (mt) {
    case 1: return launch<1>(n, groups, T, smem, blocks, out, stream);
    case 2: return launch<2>(n, groups, T, smem, blocks, out, stream);
    case 3: return launch<3>(n, groups, T, smem, blocks, out, stream);
    default: return launch<4>(n, groups, T, smem, blocks, out, stream);
  }
}

}  // namespace

// ids: (n,) int32. Source s has kinds[s] (0 bool, 1 int8, 2 int16, 3 int32,
// 4 int64, 5 int128) and lanes[2s] (values, or lo), lanes[2s + 1] (hi of
// an int128, else unused). Request r is reqs[5r..5r+4] = (source, mask
// source or -1, shift, bits, remainder). out: (G, R, J) int64, zeroed;
// J >= every request's ceil(bits / 7). blocks: the grid size, or 0 for as
// many blocks as the card holds at once.
// Returns 0, a CUDA error code, or a negative code: kBadArgs, kTooMany
// (sources, requests or limbs), kMisaligned (a lane not 16-byte aligned),
// kTooMuchSmem, kTooManyRows (a block would sum more than 2^24 rows).
extern "C" int fused_limb_sums(const void* ids, long long n, int groups, int nsrc,
                               const void* const* lanes, const int* kinds, int nreq,
                               const int* reqs, int J, void* out, int blocks, void* stream) {
  if (n < 0 || groups < 1 || groups > 64 || nsrc < 1 || nreq < 1 || J < 1 || blocks < 0)
    return kBadArgs;
  if (nsrc > kMaxSources || nreq > kMaxRequests) return kTooMany;
  Table T;
  memset(&T, 0, sizeof(T));
  T.row_stride = nreq * J;
  if (reinterpret_cast<uintptr_t>(ids) & 15) return kMisaligned;
  T.lane[0] = {static_cast<const unsigned char*>(ids), 0, 4};  // the ids first
  T.nlanes = 1;
  int off = 4 * kChunk;
  for (int s = 0; s < nsrc; ++s) {
    if (kinds[s] < kBool || kinds[s] > kI128) return kBadArgs;
    T.src[s].kind = kinds[s];
    for (int l = 0; l < lanes_of(kinds[s]); ++l) {
      const void* p = lanes[2 * s + l];
      if (p == nullptr) return kBadArgs;
      if (reinterpret_cast<uintptr_t>(p) & 15) return kMisaligned;
      T.src[s].smem[l] = off;
      T.lane[T.nlanes++] = {static_cast<const unsigned char*>(p), off, lane_bytes(kinds[s])};
      off += lane_bytes(kinds[s]) * kChunk;
    }
  }
  T.stage_bytes = off;
  int L = 0;
  for (int r = 0; r < nreq; ++r) {
    const int* q = reqs + 5 * r;
    const int mask = q[1], shift = q[2], bits = q[3];
    if (q[0] < 0 || q[0] >= nsrc) return kBadArgs;
    if (mask < -1 || mask >= nsrc || (mask >= 0 && kinds[mask] != kBool)) return kBadArgs;
    if (shift < 0 || shift > 127 || bits < 1 || bits > 64) return kBadArgs;
    if ((bits + 6) / 7 > J) return kBadArgs;
    L += (bits + 6) / 7;
  }
  if (L > kMaxLimbs) return kTooMany;
  T.L = L;
  T.tiles = (L + 7) / 8;
  const int spare = T.tiles * 8 * kTileStride;  // a tile column no one reads
  // requests in tile order: by source, then by the word their first window
  // starts in (one segment each), then those of at most two limbs first
  int col = 0, r_out = 0;
  for (int s = 0; s < nsrc; ++s) {
    for (int word = 0; word < 5; ++word) {
      Segment& seg = T.seg[T.nseg];
      seg.src = static_cast<uint8_t>(s);
      seg.q = static_cast<uint8_t>(word);
      seg.begin = static_cast<int16_t>(r_out);
      for (int wide = 0; wide < 2; ++wide) {
        if (wide) seg.narrow_end = static_cast<int16_t>(r_out);
        for (int r = 0; r < nreq; ++r) {
          const int* q = reqs + 5 * r;
          const int mask = q[1], shift = q[2], bits = q[3], remainder = q[4];
          const int nl = (bits + 6) / 7;
          if (q[0] != s || min(shift >> 5, 4) != word || (nl > 2) != (wide == 1)) continue;
          const uint8_t top =
              remainder ? 0xFF : static_cast<uint8_t>((1u << (bits - 7 * (nl - 1))) - 1u);
          Request& rq = T.req[r_out++];
          rq.mask_off = mask < 0 ? -1 : T.src[mask].smem[0];
          rq.off0 = col * kTileStride;
          rq.off1 = nl == 2 ? (col + 1) * kTileStride : spare;
          rq.sh = static_cast<uint8_t>(shift & 31);
          rq.nl = static_cast<uint8_t>(nl);
          rq.m0 = nl == 1 ? top : 0x7F;
          rq.top = nl == 1 ? 0 : top;
          for (int j = 0; j < nl; ++j) T.out_col[col + j] = static_cast<uint16_t>(r * J + j);
          col += nl;
        }
      }
      seg.end = static_cast<int16_t>(r_out);
      if (seg.end > seg.begin) ++T.nseg;
    }
  }
  T.tile_smem = static_cast<int>(sizeof(Desc)) + 2 * T.stage_bytes;
  T.ids8_smem = T.tile_smem + (T.tiles * 8 + 1) * kTileStride;  // the spare column too
  const size_t smem = static_cast<size_t>(T.ids8_smem) + kChunk;
  if (smem > static_cast<size_t>(kMaxSmem)) return kTooMuchSmem;
  if (n == 0) return 0;
  const int mt = (groups + 15) / 16;
  auto* o = static_cast<unsigned long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return launch_mt(mt, n, groups, T, smem, blocks, o, st);
}
