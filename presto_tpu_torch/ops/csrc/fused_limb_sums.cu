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
// Exactness. Limb sums accumulate in int32 per block and member, which is
// exact while a block sums at most 2^24 rows of a member (|limb| <= 128):
// the entry point refuses a grid whose blocks would take more. Each block
// then adds its (member, G, L) table into the int64 output with
// atomicAdd; integer addition makes the order irrelevant, so the result
// is deterministic.
//
// Bound: memory. The kernel reads the ids (int32) and each distinct source
// lane once and writes G x R x J int64 totals. At TPC-H q1 SF1 (n = 6.0M,
// G = 16, 39 requests, L = 70 limbs) the lanes are ids, six bool masks,
// quantity int16, extendedprice int32, discount int8 and two 128-bit
// lanes: 49 bytes a row, 0.29 GB, about 0.088 ms at the H100 SXM's
// 3.35 TB/s. (The unfused path moves the 840 MB int16 limb matrix twice:
// PyTorch writes it and the per-tile kernel reads it.)
//
// One entry, members m in [0, B): the kernel of a vmapped pallas_call,
// whose batching rule gives the grid a leading member axis. Each lane is
// shared by every member (member stride 0: the scan's own columns) or
// per member (a filter mask, or ids that a parameter touched). A lone
// call is B = 1 with every lane shared.
//
// Design:
//   * member tiles: block (x, t) walks chunk range x (contiguous
//     1024-row chunks) for members [tM, tM + M). The entry picks M from
//     the shared memory budget (the shared lanes once, M x the member
//     lanes, double buffered, and the limb tile) and the work items the
//     warps can hold, M = 1 for a lone call, then evens M out over the
//     tiles; the chunk ranges times the tiles come to the blocks the
//     card holds at once (one wave);
//   * staging: each chunk of a shared lane comes into shared memory once
//     for the tile's members, each member lane once for every member: a
//     TMA bulk copy (cp.async.bulk) a lane and member, issued from a
//     lane table in shared memory by a few lanes of every warp,
//     completing on the stage's mbarrier (the ragged last chunk by
//     zero-filled 16-byte cp.async), double buffered: chunk k + 1 loads
//     while chunk k is split and summed;
//   * split in registers: thread t takes rows 4t..4t+3 of the chunk,
//     reads each source's four values once as 32-bit words (the top words
//     being sign words), and for each of the source's requests takes a
//     32-bit window with one funnel shift, cuts 7-bit limbs, masks them
//     and packs the four rows' limbs into one 32-bit store. The entry
//     point groups each source's requests into segments by the word their
//     window starts in, so that a segment's word pair is fixed registers,
//     and puts the requests of one or two limbs first: those take no
//     branch. A request over a shared source is split ONCE a chunk into
//     the shared columns of the limb tile; where its mask is a member
//     lane it is split unmasked (the mask comes in at the operand,
//     below). A request over a member source is split for each member
//     into that member's columns, its mask applied in the split; a count
//     of a member bool lane becomes a count of ones under that lane as
//     its mask. The limb tile is column-major ([limb][row], rows
//     contiguous, each column padded by 16 bytes so that fragment loads
//     hit distinct banks);
//   * sums on the int8 tensor cores, mma.sync m16n8k32 s8 x s8 -> s32:
//     the A operand is one-hot rows, B eight limb columns. A row of A is
//     a (member, group) pair: the shared columns take rows packed over
//     the tile's members (pow2(G) rows a member, so 16 members a row
//     block at G = 1), member columns the G rows of their member. Each
//     shared request with a member mask sits in the columns of its mask
//     (one class a mask lane), and its mask bytes are ANDed into the
//     one-hot bytes of A: the mask is applied at the operand, once for
//     all the class's columns. The work items (a row block, a column
//     tile) are spread over the 8 warps in contiguous runs. Where all of
//     a warp's items share their rows (a lone call's one row block), it
//     builds A's one-hot bytes once a k-step for all of them; a warp with
//     a masked item loads every item's mask bytes (an unmasked item's
//     ORed away), a warp with none loads none: no branch in the k-step
//     loop, whose loads then pipeline. The s32 accumulators stay in
//     registers for the block's whole range;
//   * two barriers a chunk (the copies have landed and the last chunk's
//     sums are done; the split is done), and one int64 atomicAdd per
//     (member, group, limb) per block at the end.
// The descriptor table travels as a by-value __grid_constant__ struct: no
// device buffer, no host copy. Each block copies the part the split reads
// into shared memory once.
//
// What holds it back (scripts/fused_limb_sums_phases.py, PERF.md): a
// member lane still costs its bytes for every member (the dashboard's
// per-member ids are 4 of its 6 member bytes a row); the batches' sums,
// where each item of a row block loads its members' mask bytes again
// and the one-hot bytes are byte compares that sm_90 emulates, rebuilt
// every k-step; and a wide table's split (q1) is a chain of dependent
// shared-memory loads, shifts and stores per request, with 8 warps a SM
// to hide it.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#ifdef FUSED_LIMB_SUMS_PHASES
// Phase clocks, only in a build with -DFUSED_LIMB_SUMS_PHASES
// (scripts/fused_limb_sums_phases.py): thread 0 of block (0, 0) adds the
// clock cycles of each phase of its chunk loop here. Phases: 0 issuing the
// next chunk's copies, 1 waiting for this chunk's copies and the barrier,
// 2 the split and its barrier, 3 the sums.
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
constexpr int kMaxClasses = 1 + kMaxSources;       // unmasked, then a member mask each
constexpr int kMaxItemsPerWarp = 16;
constexpr int kMaxMembers = 64;                    // members a block sums at once
constexpr long long kMaxRowsPerBlock = 1LL << 24;
constexpr int kMaxSmem = 232448;  // what one block may use on sm_90
constexpr int kMemberMask = 1 << 30;  // a mask offset in each member's part of a stage
constexpr int kBarBytes = 16;         // the two stages' mbarriers, before the stages

// refusals, as negative return codes
constexpr int kBadArgs = -1;
constexpr int kTooMany = -2;
constexpr int kMisaligned = -3;
constexpr int kTooMuchSmem = -4;
constexpr int kTooManyRows = -5;

enum Kind { kBool = 0, kI8 = 1, kI16 = 2, kI32 = 3, kI64 = 4, kI128 = 5,
            kOne = 6 };  // kOne: no lane, the value 1 in every row (the entry's own)

__host__ __device__ constexpr int lane_bytes(int kind) {
  return kind <= kI8 ? 1 : kind == kI16 ? 2 : kind == kI32 ? 4 : 8;
}
__host__ __device__ constexpr int lanes_of(int kind) { return kind == kI128 ? 2 : 1; }

// A lane to stage: the ids and every lane of every source.
struct Lane {
  const unsigned char* ptr;
  uint32_t bstride;     // bytes from one member's rows to the next (0: shared)
  uint32_t smem : 24;   // byte offset in a stage (a member lane: member 0's)
  uint32_t esize : 8;   // bytes a row
};

struct Source {
  int16_t kind;
  int16_t member;  // its lanes sit in each member's part of a stage
  int smem[2];     // stage byte offsets of its lanes: the values, or (lo, hi)
};

// The requests of one source whose first window starts in word q:
// [begin, narrow_end) take at most two limbs, [narrow_end, end) more.
struct alignas(8) Segment {
  uint8_t src, q;
  int16_t begin, narrow_end, end;
};

struct alignas(16) Request {
  int mask_off;   // stage byte offset of the bool mask the split applies
                  // (| kMemberMask: in each member's part), or -1
  int off0;       // tile byte offset of its first limb column (a member
                  // request: from its member's first column)
  int off1;       // of its second (two-limb requests), else off0 again:
                  // the zero second limb is stored first and overwritten
  uint8_t sh;     // its first window: bits [32q + sh, +32) of the value
  uint8_t nl;     // limbs
  uint8_t m0;     // byte mask of its first limb (one-limb requests: the top)
  uint8_t top;    // byte mask of its last limb
};

struct Table {
  int nlanes, nshared_lanes, nseg, nseg_shared, nreq, J;
  int stage_bytes, stage_shared, member_step;  // a stage; its shared part; each member's part
  int ids_smem, ids_member;      // the ids lane's stage offset; per member?
  int tile_smem, ids8_smem;
  int member_col;                // member 0's first column
  int members, lg;               // M; log2 of the rows a member takes in a shared row block
  int ls, lp, tp, mtm;           // shared columns; member columns, their tiles; m-tiles of G
  int nclasses;                  // classes of shared columns: 0 unmasked, c > 0 a member mask
  int16_t cstart[kMaxClasses], clen[kMaxClasses];
  int cmask[kMaxClasses];        // class c > 0: stage offset of its mask lane (member 0's)
  Lane lane[1 + 2 * kMaxSources];
  Source src[kMaxSources];
  Segment seg[5 * kMaxSources];
  Request req[kMaxRequests];
  uint8_t orig[kMaxRequests];    // each request's index among the caller's
};
static_assert(sizeof(Table) <= 4096, "the table must fit the kernel's parameter space");

// What the split reads for every request, and the copies for every lane,
// copied from the parameters into shared memory once per block: there one
// 16-byte load fetches a request (from the parameters each field is its
// own indexed constant load, and those dominated the split), and the
// lanes of a warp read different lanes' entries at once.
struct Desc {
  Request req[kMaxRequests];
  Segment seg[5 * kMaxSources];
  Source src[kMaxSources];
  uint8_t orig[kMaxRequests];
  Lane lane[1 + 2 * kMaxSources];
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// Work unit u of a stage: a shared lane (the first nshared_lanes), then
// each member lane for each member, member-major.
__device__ __forceinline__ void unit_of(const Table& T, int u, int& l, int& m) {
  if (u < T.nshared_lanes) {
    l = u;
    m = 0;
  } else {
    const int j = u - T.nshared_lanes, per = T.nlanes - T.nshared_lanes;
    m = j / per;
    l = T.nshared_lanes + (j - m * per);
  }
}

// Stage one chunk: a shared lane once, a member lane once for each of the
// tile's `mthis` members (first member `m_first`); `lanes` is the lane
// table in shared memory. A whole chunk goes by TMA bulk copies, one a
// unit, unit u issued by lane u / 8 of warp u % 8 (so that every warp
// issues a few at once) and completing on `bar`, whose expected bytes
// thread 0 sets (a copy may land first: the count of bytes may go below
// zero until then). Lanes are 16-byte aligned and chunks start at
// multiples of 1024 rows, so every copy is aligned. The ragged last chunk
// goes by zero-filled 16-byte cp.async copies (warp w takes units w,
// w + 8, ...), and `bar`'s phase completes at once.
__device__ __forceinline__ void stage_chunk(unsigned char* st, uint64_t* bar, const Table& T,
                                            const Lane* lanes, long long chunk, long long n,
                                            int m_first, int mthis) {
  const long long row0 = chunk * kChunk;
  const int rows = static_cast<int>(min(static_cast<long long>(kChunk), n - row0));
  const int units = T.nshared_lanes + (T.nlanes - T.nshared_lanes) * mthis;
  if (rows == kChunk) {
    if (threadIdx.x == 0)
      mbar_arrive_expect(bar, static_cast<uint32_t>(T.stage_shared + mthis * T.member_step));
    for (int u = (threadIdx.x & 31) * kWarps + (threadIdx.x >> 5); u < units; u += kThreads) {
      int l, m;
      unit_of(T, u, l, m);
      const Lane ln = lanes[l];
      const int esize = ln.esize;
      bulk_copy(st + ln.smem + m * T.member_step,
                ln.ptr + static_cast<long long>(m_first + m) * ln.bstride + row0 * esize,
                static_cast<uint32_t>(kChunk * esize), bar);
    }
    return;
  }
  if (threadIdx.x == 0) mbar_arrive_expect(bar, 0);
  const int lane = threadIdx.x & 31;
  for (int u = threadIdx.x >> 5; u < units; u += kWarps) {
    int l, m;
    unit_of(T, u, l, m);
    const Lane ln = lanes[l];
    const int esize = ln.esize;
    const int nbytes = rows * esize;
    const unsigned char* from =
        ln.ptr + static_cast<long long>(m_first + m) * ln.bstride + row0 * esize;
    unsigned char* to = st + ln.smem + m * T.member_step;
    for (int i = lane * 16; i < nbytes; i += 32 * 16)
      cp_async16(to + i, from + i, min(16, nbytes - i));
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
// words past the value's width are its sign word (zero for bool). `st` is
// the stage, or for a member source its member's part of it.
__device__ __forceinline__ void load_words(const unsigned char* st, const Source& s, int t,
                                           uint32_t (&w)[kRowsPerThread][6]) {
  constexpr int R = kRowsPerThread;
  const unsigned char* p = st + s.smem[0];
  switch (s.kind) {
    case kOne:
#pragma unroll
      for (int r = 0; r < R; ++r) w[r][0] = 1;
      break;
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
    const int top = s.kind <= kI32 || s.kind == kOne ? 0 : s.kind == kI64 ? 1 : 3;
    uint32_t topw = w[r][0];
    if (top == 1) topw = w[r][1];
    if (top == 3) topw = w[r][3];
    const uint32_t sign =
        s.kind == kBool || s.kind == kOne ? 0u
                                          : static_cast<uint32_t>(static_cast<int32_t>(topw) >> 31);
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
// times 0xFF makes byte masks); all 0xFF without a mask. In a member split
// (kMember) a member mask is read in the member's part of the stage,
// `stm`; the shared split has no member mask.
template <bool kMember>
__device__ __forceinline__ uint32_t keep_of(const unsigned char* st, const unsigned char* stm,
                                            int mask_off, int t) {
  uint32_t m = 0x01010101u;
  if (mask_off >= 0) {
    const unsigned char* base = st;
    if (kMember && (mask_off & kMemberMask)) {
      base = stm;
      mask_off &= ~kMemberMask;
    }
    m = *reinterpret_cast<const uint32_t*>(base + mask_off + 4 * t);
  }
  return m * 0xFFu;
}

// The requests of one segment, word Q known here: each window is one
// funnel shift of fixed registers. Requests of one or two limbs (the
// 13-bit limb sums and the counts) take no branch: a one-limb request
// stores its zero second limb into its own column first, then its limb.
template <int Q, bool kMember>
__device__ __forceinline__ void split_segment(const unsigned char* st, const unsigned char* stm,
                                              const Desc& D, const Segment& seg,
                                              const uint32_t (&w)[kRowsPerThread][6],
                                              unsigned char* tile_t, int t) {
#pragma unroll 2
  for (int r = seg.begin; r < seg.narrow_end; ++r) {
    const Request rq = D.req[r];
    const uint32_t keep = keep_of<kMember>(st, stm, rq.mask_off, t);
    uint32_t f[kRowsPerThread];
#pragma unroll
    for (int rr = 0; rr < kRowsPerThread; ++rr)
      f[rr] = __funnelshift_r(w[rr][Q], w[rr][Q + 1], rq.sh);
    store_rows(tile_t + rq.off1, pack_rows(f, 7) & (rq.top * 0x01010101u) & keep);
    store_rows(tile_t + rq.off0, pack_rows(f, 0) & (rq.m0 * 0x01010101u) & keep);
  }
  for (int r = seg.narrow_end; r < seg.end; ++r) {  // more than two limbs
    const Request rq = D.req[r];
    const uint32_t keep = keep_of<kMember>(st, stm, rq.mask_off, t);
    const uint32_t top = rq.top * 0x01010101u;
    unsigned char* first = tile_t + rq.off0;
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
          store_rows(first + l * kTileStride, pack_rows(f, 7 * j) & byte_mask & keep);
        }
      }
    }
  }
}

// Split the requests of segments [s0, s1) into the columns at tile_t (this
// thread's rows). `stm` is the member's part of the stage for a member
// split (kMember), else the stage itself.
template <bool kMember>
__device__ __forceinline__ void split_requests(const unsigned char* st, const unsigned char* stm,
                                               const Desc& D, int s0, int s1,
                                               unsigned char* tile_t, int t) {
  uint32_t w[kRowsPerThread][6];
  int loaded = -1;
  for (int sg = s0; sg < s1; ++sg) {
    const Segment seg = D.seg[sg];
    if (seg.src != loaded) {
      loaded = seg.src;
      const Source& s = D.src[loaded];
      load_words(s.member ? stm : st, s, t, w);
    }
    switch (seg.q) {
      case 0: split_segment<0, kMember>(st, stm, D, seg, w, tile_t, t); break;
      case 1: split_segment<1, kMember>(st, stm, D, seg, w, tile_t, t); break;
      case 2: split_segment<2, kMember>(st, stm, D, seg, w, tile_t, t); break;
      case 3: split_segment<3, kMember>(st, stm, D, seg, w, tile_t, t); break;
      default: split_segment<4, kMember>(st, stm, D, seg, w, tile_t, t); break;
    }
  }
}

// The ids of this thread's rows as one byte each (0xFF for rows past the
// chunk's end and ids outside [0, G)).
__device__ __forceinline__ void split_ids(const unsigned char* lane, unsigned char* ids8,
                                          int rows, int groups, int t) {
  constexpr int R = kRowsPerThread;
  uint32_t id[R];
  load_raw<4 * R>(lane + 4 * R * t, id);
  uint32_t packed = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int v = static_cast<int32_t>(id[r]);
    const bool ok = R * t + r < rows && v >= 0 && v < groups;
    packed |= (ok ? static_cast<uint32_t>(v) : 0xFFu) << (8 * r);
  }
  store_rows(ids8 + R * t, packed);
}

// Split a staged chunk: the shared requests once, the member requests
// (and member ids) once for each of the tile's members.
__device__ __forceinline__ void split_chunk(const unsigned char* st, const Table& T,
                                            const Desc& D, unsigned char* tile,
                                            unsigned char* ids8, int rows, int groups,
                                            int mthis) {
  constexpr int R = kRowsPerThread;
  const int t = threadIdx.x;
  if (!T.ids_member) split_ids(st + T.ids_smem, ids8, rows, groups, t);
  split_requests<false>(st, st, D, 0, T.nseg_shared, tile + R * t, t);
  if (T.ids_member || T.nseg > T.nseg_shared) {
    for (int m = 0; m < mthis; ++m) {
      const unsigned char* stm = st + m * T.member_step;
      if (T.ids_member) split_ids(stm + T.ids_smem, ids8 + m * kChunk, rows, groups, t);
      split_requests<true>(st, stm, D, T.nseg_shared, T.nseg,
                           tile + (T.member_col + m * T.lp) * kTileStride + R * t, t);
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

// A work item: a row block of A against a column tile of B. `key` says
// the rows (r0 | first member << 13 | member item << 19), `col` this
// lane's B column, `mko` the stage offset of the tile's member mask lane
// (member 0's) or -1, `lc0`/`nc` the tile's first column in the column
// map and its live columns.
struct Item {
  int col, key, mko, lc0, nc;
};

// Item i of a block whose shared items are the first `ns` (row block
// i / tsh against shared tile i % tsh, the tiles in class order), then
// each member's member items (m-tile, member tile).
__device__ __forceinline__ Item decode_item(const Table& T, int i, int ns, int tsh, int g) {
  Item it;
  if (i < ns) {
    const int rb = i / tsh;
    int t = i - rb * tsh, c = 0;
    while (t >= (T.clen[c] + 7) >> 3) {
      t -= (T.clen[c] + 7) >> 3;
      ++c;
    }
    it.lc0 = T.cstart[c] + 8 * t;
    it.nc = min(8, T.clen[c] - 8 * t);
    it.col = g < it.nc ? it.lc0 + g : 0;  // past the live columns: any column
    it.key = 16 * rb;
    it.mko = c > 0 ? T.cmask[c] : -1;
  } else {
    const int j = i - ns, per = T.mtm * T.tp;
    const int m = j / per, rest = j - m * per;
    const int mt = rest / T.tp, t = rest - mt * T.tp;
    it.nc = min(8, T.lp - 8 * t);
    it.col = g < it.nc ? T.member_col + m * T.lp + 8 * t + g : 0;
    it.lc0 = T.ls + 8 * t;
    it.key = (16 * mt) | (m << 13) | (1 << 19);
    it.mko = -1;
  }
  return it;
}

// The (member, group) of A row r0 + h of an item's row block: a member
// item's rows are its member's groups, a shared row block packs
// 2^lg rows a member. A member past the tile's members matches nothing.
__device__ __forceinline__ void row_of(int key, int h, int lg_shared, int mthis, int& member,
                                       uint32_t& group) {
  const int lg = (key >> 19) & 1 ? 6 : lg_shared;
  const int r = (key & 0x1FFF) + h;
  member = ((key >> 13) & 63) + (r >> lg);
  group = static_cast<uint32_t>(r & ((1 << lg) - 1));
  if (member >= mthis) {
    member = 0;
    group = 0xFEu;
  }
}

// A's one-hot bytes for rows `rw` (bytes: the ids8 member of rows g and
// g + 8, 0 where the ids are shared, then their groups, 0xFE for a row
// past the tile's members) at k-step offset `off`: 1 where a row's id
// byte is its group. s0, s1: the k-step's shared ids words.
template <bool kMemberIds>
__device__ __forceinline__ void one_hot_rows(uint32_t rw, const unsigned char* ids8, int off,
                                             uint32_t s0, uint32_t s1, uint32_t (&a)[4]) {
  uint32_t lo0 = s0, lo1 = s1, hi0 = s0, hi1 = s1;
  if (kMemberIds) {
    const unsigned char* pl = ids8 + ((rw & 0xFFu) << 10) + off;
    const unsigned char* ph = ids8 + (((rw >> 8) & 0xFFu) << 10) + off;
    lo0 = *reinterpret_cast<const uint32_t*>(pl);
    lo1 = *reinterpret_cast<const uint32_t*>(pl + 16);
    hi0 = *reinterpret_cast<const uint32_t*>(ph);
    hi1 = *reinterpret_cast<const uint32_t*>(ph + 16);
  }
  const uint32_t glo = __byte_perm(rw, 0, 0x2222), ghi = __byte_perm(rw, 0, 0x3333);
  a[0] = __vcmpeq4(lo0, glo) & 0x01010101u;
  a[1] = __vcmpeq4(hi0, ghi) & 0x01010101u;
  a[2] = __vcmpeq4(lo1, glo) & 0x01010101u;
  a[3] = __vcmpeq4(hi1, ghi) & 0x01010101u;
}

// The sums of one split chunk over this warp's items. Item k's rows are
// row[k] (see one_hot_rows); mlo[k] / mhi[k] are the stage offsets of
// their member mask lane and mkeep[k] is 0, or for an item without a
// mask the offsets are 0 and mkeep[k] all ones (the loaded bytes are
// then ORed away). kMemberIds: the ids are per member (else the k-step's
// ids words are loaded once for every item). kSameRows: every item of
// the warp has item 0's rows (a lone call's one row block against its
// column tiles), so A's one-hot bytes are built once a k-step for all of
// them. kMasks: some item of the warp has a mask (else no mask bytes are
// loaded). The flags are the same in every lane of the warp, and no
// branch in the k-step loop depends on data, so its loads pipeline.
template <int KI, bool kMemberIds, bool kSameRows, bool kMasks>
__device__ __forceinline__ void sum_chunk(int32_t (&acc)[KI][4], const int (&colb)[KI],
                                          const uint32_t (&row)[KI], const int (&mlo)[KI],
                                          const int (&mhi)[KI], const uint32_t (&mkeep)[KI],
                                          int kn, const unsigned char* tile,
                                          const unsigned char* ids8,
                                          const unsigned char* st, int tq) {
#pragma unroll 4
  for (int ks = 0; ks < kChunk / 32; ++ks) {
    const int off = ks * 32 + 4 * tq;
    uint32_t s0 = 0, s1 = 0;
    if (!kMemberIds) {
      s0 = *reinterpret_cast<const uint32_t*>(ids8 + off);
      s1 = *reinterpret_cast<const uint32_t*>(ids8 + off + 16);
    }
    uint32_t oh[4];
    if (kSameRows) one_hot_rows<kMemberIds>(row[0], ids8, off, s0, s1, oh);
#pragma unroll
    for (int k = 0; k < KI; ++k) {
      if (k < kn) {
        uint32_t a[4];
        if (kSameRows) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = oh[e];
        } else {
          one_hot_rows<kMemberIds>(row[k], ids8, off, s0, s1, a);
        }
        if (kMasks) {
          const unsigned char* ql = st + mlo[k] + off;
          const unsigned char* qh = st + mhi[k] + off;
          a[0] &= *reinterpret_cast<const uint32_t*>(ql) | mkeep[k];
          a[1] &= *reinterpret_cast<const uint32_t*>(qh) | mkeep[k];
          a[2] &= *reinterpret_cast<const uint32_t*>(ql + 16) | mkeep[k];
          a[3] &= *reinterpret_cast<const uint32_t*>(qh + 16) | mkeep[k];
        }
        const unsigned char* col = tile + colb[k] + ks * 32;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(col);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(col + 16);
        mma_s8(acc[k], a, b0, b1);
      }
    }
  }
}

// sum_chunk with the warp's flags as template arguments.
template <int KI, bool kMemberIds>
__device__ __forceinline__ void sum_chunk_of(bool same_rows, bool masks, int32_t (&acc)[KI][4],
                                             const int (&colb)[KI], const uint32_t (&row)[KI],
                                             const int (&mlo)[KI], const int (&mhi)[KI],
                                             const uint32_t (&mkeep)[KI], int kn,
                                             const unsigned char* tile,
                                             const unsigned char* ids8,
                                             const unsigned char* st, int tq) {
  if (same_rows) {
    if (masks)
      sum_chunk<KI, kMemberIds, true, true>(acc, colb, row, mlo, mhi, mkeep, kn, tile, ids8, st, tq);
    else
      sum_chunk<KI, kMemberIds, true, false>(acc, colb, row, mlo, mhi, mkeep, kn, tile, ids8, st, tq);
  } else {
    if (masks)
      sum_chunk<KI, kMemberIds, false, true>(acc, colb, row, mlo, mhi, mkeep, kn, tile, ids8, st, tq);
    else
      sum_chunk<KI, kMemberIds, false, false>(acc, colb, row, mlo, mhi, mkeep, kn, tile, ids8, st,
                                              tq);
  }
}

// KI: the most work items a warp holds (a power of two >= the entry's
// items / 8).
template <int KI>
__global__ void __launch_bounds__(kThreads, 1)
fused_limb_sums_kernel(long long n, int groups, int batch, long long per_block,
                       const __grid_constant__ Table T,
                       unsigned long long* __restrict__ out, long long out_member) {
  extern __shared__ uint4 smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + sizeof(Desc));  // a stage's each
  unsigned char* stages = smem + sizeof(Desc) + kBarBytes;
  unsigned char* tile = smem + T.tile_smem;
  unsigned char* ids8 = smem + T.ids8_smem;
  const long long nchunks = (n + kChunk - 1) / kChunk;
  const long long c_begin = static_cast<long long>(blockIdx.x) * per_block;
  const long long c_end = min(nchunks, c_begin + per_block);
  if (c_begin >= c_end) return;
  const int m_first = static_cast<int>(blockIdx.y) * T.members;
  const int mthis = min(T.members, batch - m_first);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int tq = lane & 3;   // thread in group

  // this block's items: the shared row blocks against the shared tiles,
  // then each member's m-tiles against its member tiles; warp w takes the
  // run [w K, w K + kn)
  int tsh = 0;
  for (int c = 0; c < T.nclasses; ++c) tsh += (T.clen[c] + 7) >> 3;
  const int ns = ((mthis << T.lg) + 15) / 16 * tsh;
  const int nitems = ns + mthis * T.mtm * T.tp;
  const int K = (nitems + kWarps - 1) / kWarps;
  const int kn = max(0, min(K, nitems - warp * K));
  int colb[KI], mlo[KI], mhi[KI];
  uint32_t mkeep[KI];
  uint32_t row[KI];
  int32_t acc[KI][4];
  bool same_rows = true;  // every item of this warp has its first item's rows
  bool masks = false;     // some item of this warp has a member mask
  int first_key = -1;
#pragma unroll
  for (int k = 0; k < KI; ++k) {
    colb[k] = 4 * tq; row[k] = 0xFEFE0000u; mlo[k] = 0; mhi[k] = 0; mkeep[k] = ~0u;
    if (k < kn) {
      const Item it = decode_item(T, warp * K + k, ns, tsh, g);
      if (k == 0) first_key = it.key;
      same_rows = same_rows && it.key == first_key;
      int m_lo, m_hi;
      uint32_t g_lo, g_hi;
      row_of(it.key, g, T.lg, mthis, m_lo, g_lo);
      row_of(it.key, g + 8, T.lg, mthis, m_hi, g_hi);
      colb[k] = it.col * kTileStride + 4 * tq;
      row[k] = (T.ids_member ? static_cast<uint32_t>(m_lo | (m_hi << 8)) : 0u) | (g_lo << 16) |
               (g_hi << 24);
      if (it.mko >= 0) {
        mlo[k] = it.mko + m_lo * T.member_step;
        mhi[k] = it.mko + m_hi * T.member_step;
        mkeep[k] = 0;
        masks = true;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][e] = 0;
  }

  Desc& desc = *reinterpret_cast<Desc*>(smem);
  {
    const uint32_t* from[5] = {reinterpret_cast<const uint32_t*>(T.req),
                               reinterpret_cast<const uint32_t*>(T.seg),
                               reinterpret_cast<const uint32_t*>(T.src),
                               reinterpret_cast<const uint32_t*>(T.orig),
                               reinterpret_cast<const uint32_t*>(T.lane)};
    uint32_t* to[5] = {reinterpret_cast<uint32_t*>(desc.req),
                       reinterpret_cast<uint32_t*>(desc.seg),
                       reinterpret_cast<uint32_t*>(desc.src),
                       reinterpret_cast<uint32_t*>(desc.orig),
                       reinterpret_cast<uint32_t*>(desc.lane)};
    const int words[5] = {static_cast<int>(sizeof(T.req) / 4), static_cast<int>(sizeof(T.seg) / 4),
                          static_cast<int>(sizeof(T.src) / 4), static_cast<int>(sizeof(T.orig) / 4),
                          static_cast<int>(sizeof(T.lane) / 4)};
#pragma unroll
    for (int a = 0; a < 5; ++a)
      for (int i = threadIdx.x; i < words[a]; i += kThreads) to[a][i] = from[a][i];
  }  // read after the first barrier in the loop
  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    mbar_fence_init();
  }
  __syncthreads();
  stage_chunk(stages, bars, T, desc.lane, c_begin, n, m_first, mthis);
#ifdef FUSED_LIMB_SUMS_PHASES
  const bool clocked = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;
  long long mark = clock64(), phase[4] = {0, 0, 0, 0};
#endif
  uint32_t parity = 0;  // bit s: the phase of stage s's barrier to wait for
  for (long long c = c_begin; c < c_end; ++c) {
    const int cur = static_cast<int>((c - c_begin) & 1);
    const unsigned char* st = stages + cur * T.stage_bytes;
    // this chunk's copies have landed, and every warp is done with the
    // last chunk's split and sums (its tile, and its stage's masks)
    cp_async_wait_all();
    mbar_wait(bars + cur, (parity >> cur) & 1u);
    parity ^= 1u << cur;
    __syncthreads();
    PHASE_MARK(1);
    if (c + 1 < c_end)
      stage_chunk(stages + (cur ^ 1) * T.stage_bytes, bars + (cur ^ 1), T, desc.lane, c + 1, n,
                  m_first, mthis);
    PHASE_MARK(0);
    const int rows = static_cast<int>(min(static_cast<long long>(kChunk), n - c * kChunk));
    split_chunk(st, T, desc, tile, ids8, rows, groups, mthis);
    __syncthreads();
    PHASE_MARK(2);
    if (T.ids_member)
      sum_chunk_of<KI, true>(same_rows, masks, acc, colb, row, mlo, mhi, mkeep, kn, tile, ids8,
                             st, tq);
    else
      sum_chunk_of<KI, false>(same_rows, masks, acc, colb, row, mlo, mhi, mkeep, kn, tile, ids8,
                              st, tq);
    PHASE_MARK(3);
  }
#ifdef FUSED_LIMB_SUMS_PHASES
  if (clocked)
    for (int i = 0; i < 4; ++i) atomicAdd(&fused_phase_cycles[i], static_cast<unsigned long long>(phase[i]));
#endif

  // the column map (tile column -> r * J + j) in the stages, free now
  __syncthreads();
  int* colmap = reinterpret_cast<int*>(stages);
  for (int sg = 0; sg < T.nseg; ++sg) {
    const Segment seg = desc.seg[sg];
    const int base = sg < T.nseg_shared ? 0 : T.ls;  // a member request's columns
    for (int r = seg.begin + threadIdx.x; r < seg.end; r += kThreads) {
      const Request rq = desc.req[r];
      const int col = base + rq.off0 / kTileStride;
      for (int l = 0; l < rq.nl; ++l) colmap[col + l] = desc.orig[r] * T.J + l;
    }
  }
  __syncthreads();
  const int row_stride = T.nreq * T.J;
#pragma unroll
  for (int k = 0; k < KI; ++k) {
    if (k < kn) {
      const Item it = decode_item(T, warp * K + k, ns, tsh, g);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = 2 * tq + (e & 1);
        int member;
        uint32_t group;
        row_of(it.key, g + (e >= 2 ? 8 : 0), T.lg, mthis, member, group);
        const int32_t v = acc[k][e];
        if (cc < it.nc && group < static_cast<uint32_t>(groups) && v != 0)
          atomicAdd(out + static_cast<long long>(m_first + member) * out_member +
                        static_cast<long long>(group) * row_stride + colmap[it.lc0 + cc],
                    static_cast<unsigned long long>(static_cast<long long>(v)));
      }
    }
  }
}

// what the last launch chose: members a tile, tiles, items a warp (KI),
// work items, shared memory, blocks an SM, chunk ranges, classes
int last_plan[8];

template <int KI>
int launch(long long n, int groups, int batch, int tiles, int items, const Table& T,
           size_t smem, int blocks, unsigned long long* out, cudaStream_t stream) {
  auto kernel = fused_limb_sums_kernel<KI>;
  // The attribute and the blocks the card holds depend only on the kernel,
  // its shared memory and the device: query them again only when those
  // change (the queries cost more host time than the kernel takes).
  static int seen_dev = -1, seen_smem = -1, seen_grid = 0, seen_per_sm = 0;
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
    seen_per_sm = per_sm;
    seen_grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  // the blocks the card holds at once, shared among the member tiles:
  // each tile takes the whole number of them that keeps the grid to one
  // wave, or as many more as keep a block within its row limit
  const long long nchunks = (n + kChunk - 1) / kChunk;
  const long long chunks_cap = kMaxRowsPerBlock / kChunk;
  long long grid = blocks > 0 ? blocks
                              : max(static_cast<long long>(max(1, seen_grid / tiles)),
                                    (nchunks + chunks_cap - 1) / chunks_cap);
  grid = min(grid, nchunks);
  const long long per_block = (nchunks + grid - 1) / grid;
  if (min(per_block * kChunk, n) > kMaxRowsPerBlock) return kTooManyRows;
  grid = (nchunks + per_block - 1) / per_block;
  const long long out_member = static_cast<long long>(groups) * T.nreq * T.J;
  const int plan[8] = {T.members, tiles, KI, items, static_cast<int>(smem), seen_per_sm,
                       static_cast<int>(grid), T.nclasses};
  memcpy(last_plan, plan, sizeof(plan));
  const dim3 dims(static_cast<unsigned>(grid), static_cast<unsigned>(tiles));
  kernel<<<dims, kThreads, smem, stream>>>(n, groups, batch, per_block, T, out, out_member);
  return static_cast<int>(cudaGetLastError());
}

int launch_ki(int ki, long long n, int groups, int batch, int tiles, int items, const Table& T,
              size_t smem, int blocks, unsigned long long* out, cudaStream_t stream) {
  switch (ki) {
    case 1: return launch<1>(n, groups, batch, tiles, items, T, smem, blocks, out, stream);
    case 2: return launch<2>(n, groups, batch, tiles, items, T, smem, blocks, out, stream);
    case 4: return launch<4>(n, groups, batch, tiles, items, T, smem, blocks, out, stream);
    case 8: return launch<8>(n, groups, batch, tiles, items, T, smem, blocks, out, stream);
    default: return launch<16>(n, groups, batch, tiles, items, T, smem, blocks, out, stream);
  }
}

constexpr int kMaxBatch = 65535;  // the grid's y extent

// The member stride of a lane, given in rows, as bytes: 0 (shared) or a
// positive multiple of 16 bytes below 2^32; -1 if it is out of range, -2 if
// it would misalign a member's rows.
long long member_bytes(long long stride, int esize) {
  if (stride < 0 || stride >= (1LL << 32) || stride * esize >= (1LL << 32)) return -1;
  if ((stride * esize) & 15) return -2;
  return stride * esize;
}

void set_lane(Lane& ln, const void* ptr, long long bstride, int smem, int esize) {
  ln.ptr = static_cast<const unsigned char*>(ptr);
  ln.bstride = static_cast<uint32_t>(bstride);
  ln.smem = static_cast<uint32_t>(smem);
  ln.esize = static_cast<uint32_t>(esize);
}

// How a request is split and summed: over a shared source, unmasked or
// under a shared mask (kShared) or under a member mask (kMasked: split
// once, the mask applied at the operand), or over a member source
// (kMember: split for each member).
enum Way { kShared = 0, kMasked = 1, kMember = 2 };

}  // namespace

// The one entry, members m in [0, batch); a lone call is batch 1 with every
// stride 0. ids: (n,) int32. Source s has kinds[s] (0 bool, 1 int8, 2
// int16, 3 int32, 4 int64, 5 int128) and lanes[2s] (values, or lo),
// lanes[2s + 1] (hi of an int128, else unused). Member m's ids are ids +
// m * ids_stride rows and its lane l lanes[l] + m * strides[l] rows
// (strides[2s], strides[2s + 1]: a source's lanes, as `lanes`); a stride of
// 0 is a lane every member shares. Request r is reqs[5r..5r+4] = (source,
// mask source or -1, shift, bits, remainder). out: (batch, G, R, J) int64,
// zeroed; J >= every request's ceil(bits / 7). blocks: the chunk ranges of
// each member tile, or 0 for as many as keep the grid to the blocks the
// card holds at once.
// Returns 0, a CUDA error code, or a negative code: kBadArgs (a batch
// outside [1, 65535], a negative stride), kTooMany (sources, requests or
// limbs), kMisaligned (a lane or a stride that does not keep every member's
// rows 16-byte aligned), kTooMuchSmem, kTooManyRows (a block would sum more
// than 2^24 rows of a member).
extern "C" int fused_limb_sums_batched(const void* ids, long long ids_stride, long long n,
                                       int groups, int nsrc, const void* const* lanes,
                                       const long long* strides, const int* kinds, int nreq,
                                       const int* reqs, int J, int batch, void* out,
                                       int blocks, void* stream) {
  if (n < 0 || groups < 1 || groups > 64 || nsrc < 1 || nreq < 1 || J < 1 || blocks < 0 ||
      batch < 1 || batch > kMaxBatch)
    return kBadArgs;
  if (nsrc > kMaxSources || nreq > kMaxRequests) return kTooMany;
  Table T;
  memset(&T, 0, sizeof(T));
  T.nreq = nreq;
  T.J = J;
  if (reinterpret_cast<uintptr_t>(ids) & 15) return kMisaligned;
  const long long ids_b = member_bytes(ids_stride, 4);
  if (ids_b < 0) return ids_b == -1 ? kBadArgs : kMisaligned;
  long long lane_b[2 * kMaxSources];
  bool src_member[kMaxSources];
  for (int s = 0; s < nsrc; ++s) {
    if (kinds[s] < kBool || kinds[s] > kI128) return kBadArgs;
    src_member[s] = false;
    for (int l = 0; l < lanes_of(kinds[s]); ++l) {
      const void* p = lanes[2 * s + l];
      if (p == nullptr) return kBadArgs;
      if (reinterpret_cast<uintptr_t>(p) & 15) return kMisaligned;
      lane_b[2 * s + l] = member_bytes(strides[2 * s + l], lane_bytes(kinds[s]));
      if (lane_b[2 * s + l] < 0) return lane_b[2 * s + l] == -1 ? kBadArgs : kMisaligned;
      if (lane_b[2 * s + l] > 0) src_member[s] = true;
    }
  }
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

  // A count over a member bool lane (the lane itself, no mask, no shift)
  // is the same as a shared one under that lane as its mask: it joins the
  // columns of that mask's class instead of taking member columns. The
  // ones are source `nsrc`, kind kOne, with no lane.
  int esrc[kMaxRequests], emask[kMaxRequests];
  int nsrc_all = nsrc;
  for (int r = 0; r < nreq; ++r) {
    const int* q = reqs + 5 * r;
    esrc[r] = q[0];
    emask[r] = q[1];
    if (nsrc < kMaxSources && src_member[q[0]] && kinds[q[0]] == kBool && q[1] == -1 &&
        q[2] == 0) {
      esrc[r] = nsrc;
      emask[r] = q[0];
      nsrc_all = nsrc + 1;
    }
  }
  if (nsrc_all > nsrc) {
    src_member[nsrc] = false;
    T.src[nsrc].kind = kOne;
    T.src[nsrc].member = 0;
  }

  // the stage: the shared lanes (ids first), then member 0's lanes
  const bool ids_member = ids_b > 0;
  int off = 0, shared_bytes = 0;
  for (int pass = 0; pass < 2; ++pass) {
    const bool member = pass == 1;
    if (ids_member == member) {
      T.ids_smem = off;
      set_lane(T.lane[T.nlanes++], ids, ids_b, off, 4);
      off += 4 * kChunk;
    }
    for (int s = 0; s < nsrc; ++s) {
      if (src_member[s] != member) continue;
      T.src[s].kind = static_cast<int16_t>(kinds[s]);
      T.src[s].member = member;
      for (int l = 0; l < lanes_of(kinds[s]); ++l) {
        T.src[s].smem[l] = off;
        set_lane(T.lane[T.nlanes++], lanes[2 * s + l], lane_b[2 * s + l], off,
                 lane_bytes(kinds[s]));
        off += lane_bytes(kinds[s]) * kChunk;
      }
    }
    if (!member) {
      shared_bytes = off;
      T.nshared_lanes = T.nlanes;
    }
  }
  const int member_bytes_a_stage = off - shared_bytes;
  T.ids_member = ids_member;
  T.stage_shared = shared_bytes;
  T.member_step = member_bytes_a_stage;

  // each request's way; with `demote`, member masks are applied in a
  // member split instead of at the operand (fewer columns and items)
  int way[kMaxRequests], cls[kMaxRequests];
  int cls_src[kMaxClasses];
  int gp_lg = 0;
  while ((1 << gp_lg) < groups) ++gp_lg;
  T.lg = gp_lg;
  T.mtm = (groups + 15) / 16;
  int M = 0, items = 0;
  size_t smem = 0;
  for (int demote = 0; demote < 2 && M == 0; ++demote) {
    T.nclasses = 1;
    cls_src[0] = -1;
    for (int r = 0; r < nreq; ++r) {
      cls[r] = 0;
      if (src_member[esrc[r]]) {
        way[r] = kMember;
      } else if (emask[r] >= 0 && src_member[emask[r]]) {
        way[r] = demote ? kMember : kMasked;
        if (!demote) {
          int c = 1;
          while (c < T.nclasses && cls_src[c] != emask[r]) ++c;
          if (c == T.nclasses) cls_src[T.nclasses++] = emask[r];
          cls[r] = c;
        }
      } else {
        way[r] = kShared;
      }
    }
    int ls = 0, lp = 0, tsh = 0;
    for (int c = 0; c < T.nclasses; ++c) {
      int len = 0;
      for (int r = 0; r < nreq; ++r)
        if (way[r] != kMember && cls[r] == c) len += (reqs[5 * r + 3] + 6) / 7;
      ls += len;
      tsh += (len + 7) / 8;
    }
    for (int r = 0; r < nreq; ++r)
      if (way[r] == kMember) lp += (reqs[5 * r + 3] + 6) / 7;
    const int tp = (lp + 7) / 8;
    for (int m = min(batch, kMaxMembers); m >= 1; --m) {
      const int its = ((m << gp_lg) + 15) / 16 * tsh + m * T.mtm * tp;
      const size_t need = sizeof(Desc) + kBarBytes +
                          2 * static_cast<size_t>(shared_bytes + m * member_bytes_a_stage) +
                          static_cast<size_t>(ls + m * lp) * kTileStride +
                          static_cast<size_t>(ids_member ? m : 1) * kChunk;
      if (its <= kWarps * kMaxItemsPerWarp && need <= static_cast<size_t>(kMaxSmem)) {
        M = m;
        break;
      }
    }
    T.ls = ls;
    T.lp = lp;
    T.tp = tp;
    if (M == 0 && demote == 1) {
      const int its = ((1 << gp_lg) + 15) / 16 * tsh + T.mtm * tp;
      return its > kWarps * kMaxItemsPerWarp ? kTooMany : kTooMuchSmem;
    }
  }
  // even the members out over the tiles
  const int tiles = (batch + M - 1) / M;
  M = (batch + tiles - 1) / tiles;
  T.members = M;
  T.stage_bytes = shared_bytes + M * member_bytes_a_stage;

  // columns: the shared ones by class, then each member's
  int col = 0;
  uint16_t col_of[kMaxRequests];
  for (int c = 0; c < T.nclasses; ++c) {
    T.cstart[c] = static_cast<int16_t>(col);
    for (int r = 0; r < nreq; ++r)
      if (way[r] != kMember && cls[r] == c) {
        col_of[r] = static_cast<uint16_t>(col);
        col += (reqs[5 * r + 3] + 6) / 7;
      }
    T.clen[c] = static_cast<int16_t>(col - T.cstart[c]);
    T.cmask[c] = c > 0 ? T.src[cls_src[c]].smem[0] : -1;
  }
  T.member_col = col;
  int pcol = 0;
  for (int r = 0; r < nreq; ++r)
    if (way[r] == kMember) {
      col_of[r] = static_cast<uint16_t>(pcol);
      pcol += (reqs[5 * r + 3] + 6) / 7;
    }

  // requests in split order: the shared split's, then the member split's;
  // within each by source, then by the word their first window starts in
  // (one segment each), then those of at most two limbs first
  int r_out = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int s = 0; s < nsrc_all; ++s) {
      for (int word = 0; word < 5; ++word) {
        Segment seg;
        seg.src = static_cast<uint8_t>(s);
        seg.q = static_cast<uint8_t>(word);
        seg.begin = static_cast<int16_t>(r_out);
        for (int wide = 0; wide < 2; ++wide) {
          if (wide) seg.narrow_end = static_cast<int16_t>(r_out);
          for (int r = 0; r < nreq; ++r) {
            const int* q = reqs + 5 * r;
            const int mask = emask[r], shift = q[2], bits = q[3], remainder = q[4];
            const int nl = (bits + 6) / 7;
            if ((way[r] == kMember) != (pass == 1)) continue;
            if (esrc[r] != s || min(shift >> 5, 4) != word || (nl > 2) != (wide == 1)) continue;
            const uint8_t top =
                remainder ? 0xFF : static_cast<uint8_t>((1u << (bits - 7 * (nl - 1))) - 1u);
            Request& rq = T.req[r_out++];
            if (mask < 0 || way[r] == kMasked)
              rq.mask_off = -1;
            else if (src_member[mask])
              rq.mask_off = T.src[mask].smem[0] | kMemberMask;
            else
              rq.mask_off = T.src[mask].smem[0];
            rq.off0 = col_of[r] * kTileStride;
            rq.off1 = nl == 2 ? rq.off0 + kTileStride : rq.off0;
            rq.sh = static_cast<uint8_t>(shift & 31);
            rq.nl = static_cast<uint8_t>(nl);
            rq.m0 = nl == 1 ? top : 0x7F;
            rq.top = nl == 1 ? 0 : top;
            T.orig[r_out - 1] = static_cast<uint8_t>(r);
          }
        }
        seg.end = static_cast<int16_t>(r_out);
        if (seg.end > seg.begin) {
          if (T.nseg == 5 * kMaxSources) return kTooMany;
          T.seg[T.nseg++] = seg;
        }
      }
    }
    if (pass == 0) T.nseg_shared = T.nseg;
  }
  T.tile_smem = static_cast<int>(sizeof(Desc)) + kBarBytes + 2 * T.stage_bytes;
  T.ids8_smem = T.tile_smem + (T.ls + M * T.lp) * kTileStride;
  smem = static_cast<size_t>(T.ids8_smem) + static_cast<size_t>(ids_member ? M : 1) * kChunk;
  int tsh = 0;
  for (int c = 0; c < T.nclasses; ++c) tsh += (T.clen[c] + 7) / 8;
  items = ((M << gp_lg) + 15) / 16 * tsh + M * T.mtm * T.tp;
  if (n == 0) return 0;
  const int per_warp = (items + kWarps - 1) / kWarps;
  int ki = 1;
  while (ki < per_warp) ki *= 2;
  auto* o = static_cast<unsigned long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return launch_ki(ki, n, groups, batch, tiles, items, T, smem, blocks, o, st);
}

// What the last launch of this library chose (see last_plan), into
// out[0..7]: members a tile, tiles, items a warp, work items, shared
// memory bytes, blocks an SM, chunk ranges, classes of shared columns.
extern "C" int fused_limb_sums_last_plan(int* out) {
  memcpy(out, last_plan, sizeof(last_plan));
  return 0;
}
