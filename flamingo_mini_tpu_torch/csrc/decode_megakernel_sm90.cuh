// The whole-step decode megakernel on Hopper, both modes: weight-only and
// w8a8 (act_quant, the template parameter kQ); greedy, lazy beam and
// pre-norm OPT, the ragged xattn schedule, any row count
// (decode_megakernel.cu's note says what each phase computes and how it
// rounds; this kernel computes the same).
//
// Replaces flamingo_mini_tpu/ops/pallas_megadecode.py::decode_step_megakernel
// (_mega_call -> _build_kernel) with act_quant off and on;
// fmt_decode_megakernel routes every call here.
//
// Bound: device memory, 0.31 ms a step at flamingo-mini width and b=32
// (decode_megakernel.cu's note), in both modes: they read the same int8
// stacks. What held the first designs back was not the bytes: a cold
// weight read after every grid barrier, a unit of 8 columns that re-read
// (and, w8a8, re-quantized) its activations from L2 for every 8 columns,
// and every weight re-read once per 32 batch rows. The design:
//
// * A block is four consumer warpgroups and a producer warpgroup, one block
//   per SM, the grid cooperative: sixteen consumer warps, because every
//   step of a phase is a chain of dependent trips to memory that more warps
//   overlap. One producer thread (its warpgroup's registers lowered by
//   setmaxnreg to 24, the consumers' raised to 112) walks the
//   step's whole weight schedule, every layer and phase in the consumers'
//   order, and keeps a ring of kRing (8) 4 KB stages full by TMA: one 2-D box
//   of 64 output columns x 64 k of a (d_out, d_in) int8 stack per stage,
//   completion on an mbarrier. It never waits at a grid barrier, so the
//   next phase's weights (the next layer's too) arrive while the consumers
//   finish a phase, wait at the barrier or walk the attention. Both modes
//   stream the same stacks in the same schedule.
// * A linear is Y^T = W A^T on wgmma: 64 output columns are the M side,
//   their int8 weights the A operand from registers, the batch rows the N
//   side (N one of 8..64: what the registers hold beside everything else),
//   the activations the B operand: staged once per block per K-slice into
//   shared memory, K-major, by one cooperative copy that applies the
//   LayerNorm where the phase has one. Weight-only: m64nNk16, the weights
//   converted to bf16 exactly (i8x4_to_bf16x4), B bf16 in the 128-byte
//   swizzle, float32 sums. w8a8: m64nNk32 s32.s8.s8, the weights as they
//   are, B quantized to int8 by the copy (each row's 1 / s, round half to
//   even) in the 64-byte swizzle, int32 sums (exact). Within each 64-k
//   chunk the k order is permuted alike for A and B (sm90_common's
//   b_offset, b_offset_s8), which a dot product does not see. A warpgroup
//   issues its chunks' products two at a time. Up to 64 rows every
//   warpgroup takes all rows (N the row count rounded up) and a quarter of
//   the item's chunks, and their sums are added in shared memory in
//   warpgroup order. Past 64 rows (the wide mode: beams) a pass takes up to
//   256 rows and each warpgroup a quarter of them (N rows, from wg N) over
//   all the item's chunks (weight-only: two chunks to a chain of wgmma
//   accumulations, the chains added by float32 adds in chunk order; w8a8:
//   one int32 chain); past 256 rows the block makes more passes on the
//   weights it holds in the ring. So every int8 weight is read from device
//   memory once per step at any row count, and a pass stages (and
//   quantizes) its rows' activations once.
// * Work items are (64-column tile, K-slice). ops/megadecode.py's plan
//   picks each linear's K-slices from the shapes (its cost model weighs a
//   block's items, chunks and a split's combine) within the shared memory a
//   slice's staged activations may take; in the w8a8 mode no K-slice
//   straddles a D-wide quantization slice of a row-form input. A split
//   tile's partials (float32; w8a8: int32) go to `parts`, and the last
//   block to finish the tile (a per-tile arrival counter, acq_rel) adds
//   them and runs the epilogue: in slice order (weight-only), or in int32
//   per quantization slice, each slice's sum cast to float32 once and
//   scaled, the slices added in order from 0 (w8a8, as _lin_w8a8; the
//   rows' scales of every slice put in shared memory first, so that every
//   partial's load issues at once). No partial is rounded to bf16 and no
//   float atomic is used: two launches on the same inputs give the same
//   bits. The epilogue is a thread per output column, eight rows at a time,
//   every load of a batch issued before its first use.
// * w8a8 row scales: a LayerNorm phase takes each row's max |output| from
//   its statistics pass (one more pass over the row held in registers,
//   rounded once at the end); the LayerNorm's scale and bias it reads are
//   copied into shared memory by cp.async from the start of the phase
//   before, so that they land behind that phase and its grid barrier. The
//   phases that read the attention's output or h take the scale from their
//   producer, whose epilogue notes max |stored bf16| per (row, D-wide
//   slice) by atomicMax of the bit pattern (exact in any order) into words
//   zeroed earlier in the same layer.
// * The time a step takes is the kernel's alone only if its host steps are
//   short: ops/megadecode.py computes the tile plan once per shape. Searched
//   on every call, it took 5-6 ms of Python at OPT-1.3B width in the w8a8
//   mode, more than the step, and a step's timings took the host's pace, a
//   level per process.
// * LayerNorm statistics: once per block per phase (per pass past 256
//   rows), one warp per row, the row's 16-byte units held in registers
//   (all loads in flight at once) and summed in a fixed unit order that
//   megadecode._warp_sum_units repeats: D <= 4096.
// * The grid barrier is the kernel's own (the producer warpgroup takes no
//   part): one 64-bit count of arrivals that only grows, in `sync`; a
//   block's arrival returns the count before it, and it waits for the next
//   multiple of the grid. The per-tile counters sit after it; the last
//   arrival resets its tile's. Nothing needs zeroing but once.
// * Attention: a block takes a row and a group of four heads at a time (at
//   64-wide heads; two at 128, three at 80), its sixteen warps a span of
//   positions each (see `attend`); the cache's 480-512 bytes of a slot for
//   those heads are one 16-byte load per lane. The w8a8 mode sums in
//   float64.
// * A section timer (`mark`) splits each block's time by section for
//   profile_decode.py's sweep.
//
// Build: the step's four kernels at 64-wide heads (weight-only and w8a8,
// each with and without the phase timer), its two at 80 and two at 128
// (weight-only and w8a8) and the w8a8 linear alone are each compiled in a
// translation unit of their own (decode_megakernel_part_*.cu, which set
// FMT_MK_PART and name their kernel), so that their nvcc processes run at
// once beside the other sources'; in one unit they took most of the
// build's three minutes. A part exports one C entry that sizes the grid of
// its kernel and launches it; decode_megakernel.cu (no FMT_MK_PART) holds
// the host side and calls the part a launch needs.
#pragma once

#include <type_traits>

#include "sm90_common.cuh"

#if !defined(FMT_MK_PART)
// the parts' entries: a's grid (*blocks: one block per SM, or 0 if a block
// cannot be resident), then, unless maps is null, the launch on `stream`
extern "C" int fmt_mk_step_w(const MegaArgs* a, const void* maps, void* stream, int* blocks);
extern "C" int fmt_mk_step_q(const MegaArgs* a, const void* maps, void* stream, int* blocks);
extern "C" int fmt_mk_step_w_phases(const MegaArgs* a, const void* maps, void* stream,
                                    int* blocks);
extern "C" int fmt_mk_step_q_phases(const MegaArgs* a, const void* maps, void* stream,
                                    int* blocks);
// the same steps at the self-attention head widths 80 and 128 (no phase
// timer: that is for the 64-wide kernels' profile)
extern "C" int fmt_mk_step_w80(const MegaArgs* a, const void* maps, void* stream, int* blocks);
extern "C" int fmt_mk_step_q80(const MegaArgs* a, const void* maps, void* stream, int* blocks);
extern "C" int fmt_mk_step_w128(const MegaArgs* a, const void* maps, void* stream, int* blocks);
extern "C" int fmt_mk_step_q128(const MegaArgs* a, const void* maps, void* stream, int* blocks);
// the w8a8 linear alone: maps and lin point at a Maps and a Lin
extern "C" int fmt_mk_linear(const MegaArgs* a, const void* maps, const void* lin,
                             void* stream, int* blocks);
#endif

namespace {
namespace mk90 {

using namespace sm90;

// ---------------------------------------------------------------------------
// the w8a8 mode's int8 operands: the 64-byte swizzle's descriptor, the
// int8 products (WgmmaS8: m64nNk32, int8 x int8 -> int32, exact; A four
// words of four int8: row g: k 4 t .. 4 t + 3; row g + 8: the same; row
// g: k 16 + 4 t ..; row g + 8: the same; d as sm90_common's WgmmaBf16),
// and the staged int8 B tile's k order

// wgmma shared-memory descriptor of a tile of 64-byte rows in the 64-byte
// swizzle (the 16-byte unit u of row r at u ^ ((r >> 1) & 3)), its base
// 512-aligned: stride 512 bytes between groups of 8 rows, layout 2 (64-byte
// swizzle). A K-major int8 operand advances 32 bytes (+2) per 32 columns.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) |
         (2ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}
using sm90::fence_regs;  // and sm90_common's overloads beside this one

template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<8> {
  static __device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaS8<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaS8<24> {
  static __device__ __forceinline__ void mma(int (&d)[12], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaS8<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaS8<48> {
  static __device__ __forceinline__ void mma(int (&d)[24], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// b_offset_s8: int8 B, the word k .. k + 3 (k a multiple of 4) of row r at
// byte 32 j + 16 h + 4 t of its row, step j = (k >> 3) & 1, h = (k >> 2) &
// 1, t = k >> 4 (slots 4 t.. of the step for h = 0, 16 + 4 t.. for h =
// 1); a row is 64 bytes, its 16-byte units in the 64-byte swizzle.
__device__ __forceinline__ int b_offset_s8(int r, int k) {
  const int p = 32 * ((k >> 3) & 1) + 16 * ((k >> 2) & 1) + 4 * (k >> 4);
  return r * 64 + ((((p >> 4) ^ ((r >> 1) & 3)) << 4) | (p & 15));
}


constexpr int kGroups = 4;                    // consumer warpgroups
constexpr int kConsumers = 128 * kGroups;     // their threads
constexpr int kCWarps = kConsumers / 32;      // their warps
constexpr int kThreads = kConsumers + 128;    // and the producer warpgroup
constexpr int kTile = 64;                     // output columns per item, k per chunk
constexpr int kChunkBytes = kTile * kTile;    // one ring stage: 64 x 64 int8
constexpr int kRing = 8;                      // weight ring stages
constexpr int kRowGroup = 64;                 // the widest wgmma N the registers hold
constexpr int kPassRows = kGroups * kRowGroup;  // rows of a pass past kRowGroup rows
enum { kXQ, kXO, kXF1, kXF2, kQKV, kO, kFC, kPR, kLinears };
// the section timer's counters (`mark`), and the static shared memory they
// and its last reading take
enum { kSecBarrier, kSecStats, kSecStage, kSecProducts, kSecFinish, kSecAttention, kSecOther,
       kSections };
constexpr int kTimerBytes = (kSections + 1) * 8;

struct Maps {
  CUtensorMap m[kLinears];
};

// (columns, K) of linear `lin`
__host__ __device__ inline void lin_dims(const MegaArgs& a, int lin, int* n, int* k) {
  switch (lin) {
    case kXQ: *n = a.XI; *k = a.D; break;
    case kXO: *n = a.D; *k = a.XI; break;
    case kXF1: *n = a.Dffx; *k = a.D; break;
    case kXF2: *n = a.D; *k = a.Dffx; break;
    case kQKV: *n = 3 * a.D; *k = a.D; break;
    case kO: *n = a.D; *k = a.D; break;
    case kFC: *n = a.Dff; *k = a.D; break;
    default: *n = a.D; *k = a.Dff;  // kPR
  }
}

// the wgmma N of a pass over `rows` rows, at most kRowGroup
// (ops/megadecode.py's WGMMA_N: 8, 16, 24, 32, 48, 64)
__host__ __device__ inline int wgmma_n(int rows) {
  return rows <= 32 ? (rows + 7) / 8 * 8 : (rows <= 48 ? 48 : kRowGroup);
}

// Up to kRowGroup rows a pass takes every row and the warpgroups split an
// item's chunks; past it (the wide mode) a pass takes up to kPassRows rows
// and each warpgroup a quarter of them over all the item's chunks.
__host__ __device__ inline bool wide(const MegaArgs& a) { return a.b > kRowGroup; }

// the rows of the first (the widest) pass
__host__ __device__ inline int pass_rows(const MegaArgs& a) {
  return a.b < kPassRows ? a.b : kPassRows;
}

// a pass over `rows` rows: the wgmma N of each warpgroup's products, and
// the rows of a staged B tile (per chunk)
__host__ __device__ inline int pass_n(const MegaArgs& a, int rows) {
  return wgmma_n(wide(a) ? (rows + kGroups - 1) / kGroups : rows);
}

__host__ __device__ inline int tile_rows(const MegaArgs& a, int rows) {
  return wide(a) ? (rows + 7) / 8 * 8 : wgmma_n(rows);
}

// the most chunks of one item over the linears the schedule runs
__host__ __device__ inline int max_chunks(const MegaArgs& a) {
  int most = 1;
  for (int lin = a.n_xattn > 0 ? 0 : kQKV; lin < kLinears; ++lin) {
    int n, k;
    lin_dims(a, lin, &n, &k);
    const int c = (k / kTile + a.split[lin] - 1) / a.split[lin];
    most = c > most ? c : most;
  }
  return most;
}

// bytes of a staged B tile's row: one 64-k chunk of bf16 (the 128-byte
// swizzle) or, in the w8a8 mode, of int8 (the 64-byte swizzle)
__host__ __device__ inline int b_row_bytes(const MegaArgs& a) { return a.act_quant ? 64 : 128; }

// bytes of a pass row's LayerNorm statistics: (mean, rstd), and in the w8a8
// mode the row's quantization scale and its reciprocal
__host__ __device__ inline int stats_bytes(const MegaArgs& a) { return a.act_quant ? 16 : 8; }

// Byte offsets from the 1024-aligned base of dynamic shared memory: the
// weight ring; a union of the staged B tiles (one tile of tile_rows rows
// per chunk of an item; in the wide mode the last warpgroup's N rows may
// reach up to N rows past the last tile), the item's float32 (w8a8: int32)
// tile (with the warpgroups' reduction before it) and the attention
// scratch; the pass's LayerNorm statistics; in the w8a8 mode the phase's
// LayerNorm scale and bias (2 D floats); the ring's full and empty
// barriers; the combine flag.
struct Layout {
  int ring, uni, stats, lnp, bars, flag, bytes;
};

__host__ __device__ inline int att_bytes(const MegaArgs& a);

__host__ __device__ inline Layout layout(const MegaArgs& a) {
  const int rows = pass_rows(a), n = pass_n(a, rows), tr = tile_rows(a, rows);
  const bool wd = wide(a);
  int uni = (tr * max_chunks(a) + (wd ? n : 0)) * b_row_bytes(a);
  const int red = wd ? (tr + n) * 256 : (kGroups - 1) * n * 256;
  const int att = att_bytes(a);
  uni = red > uni ? red : uni;
  uni = att > uni ? att : uni;
  Layout l;
  l.ring = 0;
  l.uni = kRing * kChunkBytes;
  l.stats = l.uni + ((uni + 1023) & ~1023);
  l.lnp = l.stats + (wd ? kPassRows : kRowGroup) * stats_bytes(a);
  l.bars = l.lnp + (a.act_quant ? 8 * a.D : 0);
  l.flag = l.bars + 2 * kRing * 8;
  l.bytes = 1024 + l.flag + 16;  // + the base's alignment
  return l;
}

// an item's chunks [c0, c0 + nc) of a linear with nk chunks in s slices
__host__ __device__ inline void slice_chunks(int slice, int s, int nk, int* c0, int* nc) {
  *c0 = slice * nk / s;
  *nc = (slice + 1) * nk / s - *c0;
}

// ---------------------------------------------------------------------------
// synchronisation



__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void wg0_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The grid barrier of the consumer threads: one 64-bit count of arrivals
// (sync[0..1]) that only grows; a block's arrival returns the count before
// it, whose next multiple of gridDim.x is the count that releases this
// barrier. Thread 0 of each block arrives (release: the block's writes,
// cumulative over the block barrier before) and waits (acquire). No word
// is ever reset, so a launch needs nothing zeroed but the first's.
__device__ __forceinline__ void grid_sync(unsigned* sync) {
  consumers_sync();
  if (threadIdx.x == 0) {
    unsigned long long* count = reinterpret_cast<unsigned long long*>(sync);
    unsigned long long old, now;
    asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;\n"
                 : "=l"(old) : "l"(count) : "memory");
    const unsigned long long target = (old / gridDim.x + 1) * gridDim.x;
    do {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(now) : "l"(count) : "memory");
    } while (now < target);
  }
  consumers_sync();
}

// the producer's wait for a free stage: it sleeps between polls, so that
// its spin takes no issue slots from the consumer warps of its quadrant
__device__ __forceinline__ void producer_wait(uint32_t bar, uint32_t parity) {
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    __nanosleep(64);
  }
}

// generic-proxy writes to shared memory -> visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// the linear

// rows [r0, r0 + rows) of src (., D): each row's (mean, rstd), one warp per
// row, in megadecode._warp_sum_units' order: lane l takes the 8-element
// units l, l + 32, ... of the row (16-byte loads, all in flight at once,
// held in registers for both passes) and adds them unit by unit, element
// by element from 0, then the lanes meet in the xor butterfly; each op one
// float32 op. kUnits: units a lane holds, ceil(D / 256) <= kMaxUnits. kQ
// (w8a8): a third pass over the held row takes the max |LayerNorm output|
// as stage_b rounds it to bf16 (a max is exact in any order, and rounding
// to nearest is monotone and odd, so the max of the rounded values is the
// rounded max: one rounding, at the end), the scale and bias (ln_s, ln_b)
// read from shared memory, and the row's statistics are (mean, rstd, its
// quantization scale s, 1 / s).
constexpr int kMaxUnits = 16;
template <int kUnits, bool kQ>
__device__ __forceinline__ void ln_stats_units(const bf16* src, int r0, int rows, int D,
                                               void* stats, const float* ln_s,
                                               const float* ln_b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, units = D / 8;
  for (int r = warp; r < rows; r += kCWarps) {
    const uint4* row = reinterpret_cast<const uint4*>(src + static_cast<long long>(r0 + r) * D);
    uint4 u[kUnits];
#pragma unroll
    for (int v = 0; v < kUnits; ++v)
      if (lane + 32 * v < units) u[v] = __ldcg(row + lane + 32 * v);
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < kUnits; ++v) {
      if (lane + 32 * v >= units) break;
      const uint32_t w[4] = {u[v].x, u[v].y, u[v].z, u[v].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        sum = __fadd_rn(__fadd_rn(sum, f.x), f.y);
      }
    }
    const float mean = __fdiv_rn(warp_sum(sum), static_cast<float>(D));
    float sq = 0.f;
#pragma unroll
    for (int v = 0; v < kUnits; ++v) {
      if (lane + 32 * v >= units) break;
      const uint32_t w[4] = {u[v].x, u[v].y, u[v].z, u[v].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        const float d0 = __fsub_rn(f.x, mean), d1 = __fsub_rn(f.y, mean);
        sq = __fadd_rn(__fadd_rn(sq, __fmul_rn(d0, d0)), __fmul_rn(d1, d1));
      }
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), static_cast<float>(D)),
                                        static_cast<float>(1e-5)));
    if constexpr (kQ) {
      float m = 0.f;
#pragma unroll
      for (int v = 0; v < kUnits; ++v) {
        if (lane + 32 * v >= units) break;
        const int k0 = (lane + 32 * v) * 8;
        const float4 s0 = *reinterpret_cast<const float4*>(ln_s + k0);
        const float4 s1 = *reinterpret_cast<const float4*>(ln_s + k0 + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(ln_b + k0);
        const float4 b1 = *reinterpret_cast<const float4*>(ln_b + k0 + 4);
        const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const uint32_t w[4] = {u[v].x, u[v].y, u[v].z, u[v].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
          const float y0 = __fmul_rn(__fmul_rn(__fsub_rn(f.x, mean), rstd), sc[2 * e]);
          const float y1 = __fmul_rn(__fmul_rn(__fsub_rn(f.y, mean), rstd), sc[2 * e + 1]);
          m = fmaxf(m, fmaxf(fabsf(__fadd_rn(y0, bi[2 * e])), fabsf(__fadd_rn(y1, bi[2 * e + 1]))));
        }
      }
      m = rbf(warp_max(m));
      if (lane == 0) {
        const float s = quant_scale(__float_as_uint(m));
        reinterpret_cast<float4*>(stats)[r] = make_float4(mean, rstd, s, quant_inv(s));
      }
    } else if (lane == 0) {
      reinterpret_cast<float2*>(stats)[r] = make_float2(mean, rstd);
    }
  }
}

#define MK90_UNITS(n) \
  case n:             \
    ln_stats_units<n, kQ>(src, r0, rows, D, stats, ln_s, ln_b); \
    break;

template <bool kQ>
__device__ __forceinline__ void ln_stats(const bf16* src, int r0, int rows, int D, void* stats,
                                         const float* ln_s, const float* ln_b) {
  switch ((D + 255) / 256) {
    MK90_UNITS(1) MK90_UNITS(2) MK90_UNITS(3) MK90_UNITS(4) MK90_UNITS(5) MK90_UNITS(6)
    MK90_UNITS(7) MK90_UNITS(8) MK90_UNITS(9) MK90_UNITS(10) MK90_UNITS(11) MK90_UNITS(12)
    MK90_UNITS(13) MK90_UNITS(14) MK90_UNITS(15) MK90_UNITS(16)
  }
}

#undef MK90_UNITS

// One linear phase: which linear, its input, its LayerNorm, its epilogue.
// w8a8: without a LayerNorm, where each input row's quantization scales
// come from: qa[row * qld + j], the bit pattern of max |input| over its
// D-wide slice j (noted by the producing phase's epilogue).
struct Lin {
  int lin;
  const bf16* in;  // (b, K) input, or the LayerNorm's source (b, D)
  const float* ln_s;
  const float* ln_b;  // null: no LayerNorm
  Epi e;
  const unsigned* qa;
  int qld;
};

struct Ctx {
  const MegaArgs& a;
  uint8_t* base;   // the aligned base of dynamic shared memory
  uint32_t sbase;  // its shared-space address
  Layout L;
  int g;           // ring stages consumed so far
  bool lnp_async;  // w8a8: the phase's LayerNorm scale and bias are on their way (prefetch_lnp)
};

__device__ __forceinline__ uint32_t full_bar(const Ctx& c, int stage) {
  return c.sbase + c.L.bars + 8 * stage;
}

__device__ __forceinline__ uint32_t empty_bar(const Ctx& c, int stage) {
  return c.sbase + c.L.bars + 8 * (kRing + stage);
}

// The section timer: thread 0 of the block adds the SM's clock cycles since
// its last reading to counter k at the end of each section of the
// consumers' work (the grid barrier's wait, LayerNorm statistics, staging,
// products, finish, attention, the rest), in static shared memory
// (kTimerBytes, which the shared-memory formula counts); a launch with
// `prof` set writes every block's counters out (profile_decode.py's sweep
// splits the step with them). The readings stay in every launch: the
// kernel measured no slower with them than without (PERF.md, PR 9).
__device__ __forceinline__ unsigned long long* timer_words() {
  __shared__ unsigned long long t[kSections + 1];
  return t;
}

__device__ __forceinline__ void mark(const Ctx& c, int k) {
  if (threadIdx.x == 0) {
    unsigned long long* t = timer_words();
    const unsigned long long now = clock64();
    t[k] += now - t[kSections];
    t[kSections] = now;
  }
}

// The phase timer: where a launch sets `phases`, thread 0 of each block
// copies its section counters (cumulative cycles) at the end of phase i,
// before the grid barrier, to phases[(i * blocks + block) * kSections ..]:
// the difference of two copies is the block's barrier wait before a phase
// and its work in it, so that profile_decode.py can split each phase's
// busiest block.
__device__ __forceinline__ void note_phase(const MegaArgs& a, int i) {
  if (threadIdx.x == 0 && a.phases != nullptr) {
    const unsigned long long* t = timer_words();
    unsigned long long* out = a.phases + (static_cast<long long>(i) * gridDim.x + blockIdx.x) *
                                             kSections;
    for (int k = 0; k < kSections; ++k) out[k] = t[k];
  }
}

// The k-th item of a linear phase for this block (items blockIdx.x,
// + gridDim.x, ...; item = tile s + slice): false past the last.
__device__ __forceinline__ bool item_at(int n_tiles, int s, int k, int* tile, int* slice) {
  const int item = blockIdx.x + k * gridDim.x;
  *tile = item / s;
  *slice = item % s;
  return item < n_tiles * s;
}

// rows [rg0, rg0 + rows) x chunks [c0, c0 + nc) of the input into the
// item's B tiles (tr rows each; rows past `rows` are left as they are: they
// only reach accumulator columns that are never stored). kLN: the LayerNorm
// of each value, rounded to bf16 as megadecode._layer_norm rounds it. kQ (w8a8):
// each value then quantized with its row's 1 / s to int8 (quant4: the
// product, round half to even), in b_offset_s8's order; after a LayerNorm
// 1 / s is the statistics' w and the scale and bias come from shared
// memory; else each unit loads its row's amax word of quantization slice
// j beside its values, and the row's first unit writes (0, 0, s, 1 / s)
// as the row's statistics for the epilogue.
template <bool kLN, bool kQ>
__device__ __forceinline__ void stage_b(const Ctx& c, const Lin& p, int ld, int rg0, int rows, int c0, int nc,
                        int tr, int j = 0) {
  const float2* stats = reinterpret_cast<const float2*>(c.base + c.L.stats);
  float4* qstats = reinterpret_cast<float4*>(c.base + c.L.stats);
  const float* lnp = reinterpret_cast<const float*>(c.base + c.L.lnp);
  uint8_t* tiles = c.base + c.L.uni;
  const int per_row = nc * 8, units = rows * per_row;
  // w8a8 without a LayerNorm: the last amax word seen and its (s, 1 / s),
  // taken again only where a unit's row has another (a thread's units are
  // mostly of one row)
  unsigned seen = 0xffffffffu;
  float s_seen = 0.f, inv_seen = 0.f;
  for (int u0 = threadIdx.x; u0 < units; u0 += 8 * kConsumers) {
    uint4 v[8];
    unsigned amax[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int u = u0 + i * kConsumers, r = u / per_row, q = u - r * per_row;
      if (u < units) {
        v[i] = __ldcg(reinterpret_cast<const uint4*>(
            p.in + static_cast<long long>(rg0 + r) * ld + (c0 + (q >> 3)) * kTile + (q & 7) * 8));
        if constexpr (kQ && !kLN)
          amax[i] = __ldcg(p.qa + static_cast<long long>(rg0 + r) * p.qld + j);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int u = u0 + i * kConsumers, r = u / per_row, q = u - r * per_row;
      if (u >= units) break;
      const int ch = q >> 3, k = (q & 7) * 8, gk = (c0 + ch) * kTile + k;
      if constexpr (kLN) {
        float2 st;
        if constexpr (kQ) {
          const float4 s4 = qstats[r];
          st = make_float2(s4.x, s4.y);
        } else {
          st = stats[r];
        }
        float4 s0, s1, b0, b1;
        if constexpr (kQ) {
          s0 = *reinterpret_cast<const float4*>(lnp + gk);
          s1 = *reinterpret_cast<const float4*>(lnp + gk + 4);
          b0 = *reinterpret_cast<const float4*>(lnp + c.a.D + gk);
          b1 = *reinterpret_cast<const float4*>(lnp + c.a.D + gk + 4);
        } else {
          s0 = __ldg(reinterpret_cast<const float4*>(p.ln_s + gk));
          s1 = __ldg(reinterpret_cast<const float4*>(p.ln_s + gk + 4));
          b0 = __ldg(reinterpret_cast<const float4*>(p.ln_b + gk));
          b1 = __ldg(reinterpret_cast<const float4*>(p.ln_b + gk + 4));
        }
        const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
          const float y0 = __fmul_rn(__fmul_rn(__fsub_rn(f.x, st.x), st.y), sc[2 * e]);
          const float y1 = __fmul_rn(__fmul_rn(__fsub_rn(f.y, st.x), st.y), sc[2 * e + 1]);
          const __nv_bfloat162 h =
              __floats2bfloat162_rn(__fadd_rn(y0, bi[2 * e]), __fadd_rn(y1, bi[2 * e + 1]));
          w[e] = *reinterpret_cast<const uint32_t*>(&h);
        }
        v[i] = make_uint4(w[0], w[1], w[2], w[3]);
      }
      if constexpr (kQ) {
        float inv;
        if constexpr (kLN) {
          inv = qstats[r].w;
        } else {
          if (amax[i] != seen) {
            seen = amax[i];
            s_seen = quant_scale(seen);
            inv_seen = quant_inv(s_seen);
          }
          inv = inv_seen;
          if (q == 0) qstats[r] = make_float4(0.f, 0.f, s_seen, inv);
        }
        uint8_t* tile = tiles + ch * tr * 64;
        *reinterpret_cast<uint32_t*>(tile + b_offset_s8(r, k)) = quant4(v[i].x, v[i].y, inv);
        *reinterpret_cast<uint32_t*>(tile + b_offset_s8(r, k + 4)) = quant4(v[i].z, v[i].w, inv);
      } else {
        uint8_t* tile = tiles + ch * tr * 128;
        *reinterpret_cast<uint32_t*>(tile + b_offset(r, k)) = v[i].x;
        *reinterpret_cast<uint32_t*>(tile + b_offset(r, k + 2)) = v[i].y;
        *reinterpret_cast<uint32_t*>(tile + b_offset(r, k + 4)) = v[i].z;
        *reinterpret_cast<uint32_t*>(tile + b_offset(r, k + 6)) = v[i].w;
      }
    }
  }
}

// where output column m of row n of an item's float32 (int32) tile sits in
// shared memory: 64 words a row, its groups of 4 swizzled by the row
__device__ __forceinline__ int tile_at(int n, int m) {
  return n * kTile + ((((m >> 2) ^ (n & 15)) << 2) | (m & 3));
}

// w8a8: the D-wide quantization slice of an item whose chunks start at c0
__host__ __device__ inline int quant_slice(const MegaArgs& a, int c0) { return c0 * kTile / a.D; }

// Before a pass's products: the LayerNorm statistics where the phase has
// a LayerNorm (stats: not yet taken for these rows; w8a8: the scale and
// bias staged first), then B staged.
template <bool kQ>
__device__ __forceinline__ void prepare_pass(const Ctx& c, const Lin& p, int rg0, int rows,
                                          int c0, int nc, int tr, bool stats) {
  const MegaArgs& a = c.a;
  // w8a8: the phase's LayerNorm scale and bias copied in the phase before
  // (prefetch_lnp) have landed, seen by every thread past the barrier
  if (kQ && p.ln_s != nullptr && c.lnp_async) asm volatile("cp.async.wait_all;\n" ::: "memory");
  consumers_sync();  // the union's last readers are done
  if (p.ln_s != nullptr) {
    if (stats) {
      const float* ln_s = p.ln_s;
      const float* ln_b = p.ln_b;
      if constexpr (kQ) {
        // the LayerNorm scale and bias in shared memory, for the
        // statistics' third pass and the staging: here in the step's first
        // phase, else prefetched
        float4* lnp = reinterpret_cast<float4*>(c.base + c.L.lnp);
        if (!c.lnp_async) {
          for (int i = threadIdx.x; i < a.D / 4; i += kConsumers) {
            lnp[i] = __ldg(reinterpret_cast<const float4*>(p.ln_s) + i);
            lnp[a.D / 4 + i] = __ldg(reinterpret_cast<const float4*>(p.ln_b) + i);
          }
          consumers_sync();
        }
        ln_s = reinterpret_cast<const float*>(lnp);
        ln_b = ln_s + a.D;
      }
      ln_stats<kQ>(p.in, rg0, rows, a.D, c.base + c.L.stats, ln_s, ln_b);
      consumers_sync();
      mark(c, kSecStats);
    }
    stage_b<true, kQ>(c, p, a.D, rg0, rows, c0, nc, tr);
  } else {
    int n_out, K;
    lin_dims(a, p.lin, &n_out, &K);
    stage_b<false, kQ>(c, p, K, rg0, rows, c0, nc, tr, kQ ? quant_slice(a, c0) : 0);
  }
  fence_proxy_async();
  consumers_sync();
  mark(c, kSecStage);
}

// w8a8: the next phase's LayerNorm scale and bias (D floats each) into the
// LayerNorm room of shared memory by asynchronous copies, issued at the
// start of the phase before it (no phase between two LayerNorm phases reads
// the room), so that they land while this phase and the grid barrier run;
// the LayerNorm phase waits for them in prepare_pass.
__device__ __forceinline__ void prefetch_lnp(const Ctx& c, const float* ln_s, const float* ln_b) {
  const int n = c.a.D / 4;
  const uint32_t dst = c.sbase + c.L.lnp;
  for (int i = threadIdx.x; i < 2 * n; i += kConsumers) {
    const float* src = i < n ? ln_s + 4 * i : ln_b + 4 * (i - n);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst + 16 * i), "l"(src) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A warpgroup's products over chunks i0, i0 + step, ... (< nc) of the
// item into acc, the B tile of chunk i at b0 + i * b_stride. wait: the
// chunks' stages are awaited (the first pass); release: each stage is
// released once its weights are in registers (the last pass). The weights
// feed A as sm90_common's fragment note says: converted to bf16 (four k16
// steps a chunk) or, kQ, as they are (two int8 k32 steps).
template <int N, bool kQ, typename Acc>
__device__ __forceinline__ void chunk_products(const Ctx& c, int i0, int step, int nc, uint32_t b0,
                                               int b_stride, bool wait, bool release,
                                               Acc (&acc)[N / 2]) {
  constexpr int kSteps = kQ ? 2 : 4;
  const int tid = threadIdx.x & 127;
  const int wq = tid >> 5, g8 = (tid & 31) >> 2, t4 = tid & 3;
  // chunk i's weights into A fragments (af), its products issued and
  // committed
  auto issue = [&](int i, uint32_t (&af)[kSteps][4]) {
    const int gg = c.g + i, stage = gg % kRing;
    if (wait) mbar_wait(full_bar(c, stage), (gg / kRing) & 1);
    const uint8_t* w = c.base + c.L.ring + stage * kChunkBytes + 16 * t4;
    const uint4 lo = *reinterpret_cast<const uint4*>(w + (16 * wq + g8) * kTile);
    const uint4 hi = *reinterpret_cast<const uint4*>(w + (16 * wq + g8 + 8) * kTile);
    const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w}, wh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if constexpr (kQ) {
        af[j][0] = wl[2 * j];
        af[j][1] = wh[2 * j];
        af[j][2] = wl[2 * j + 1];
        af[j][3] = wh[2 * j + 1];
      } else {
        i8x4_to_bf16x4(wl[j], af[j][0], af[j][2]);
        i8x4_to_bf16x4(wh[j], af[j][1], af[j][3]);
      }
    }
    if (release) mbar_arrive(empty_bar(c, stage));
    const uint64_t db = kQ ? desc_sw64(b0 + i * b_stride) : desc_sw128(b0 + i * b_stride);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if constexpr (kQ) WgmmaS8<N>::mma(acc, af[kk], db + 2 * kk);
      else WgmmaBf16<N>::mma(acc, af[kk], db + 2 * kk);
    }
    wgmma_commit();
  };
  // two chunks issued in turn: a chunk's fragments are rewritten only once
  // its products are done (wait_group 1 after the next chunk is issued)
  uint32_t af0[kSteps][4], af1[kSteps][4];
  for (int i = i0; i < nc; i += 2 * step) {
    issue(i, af0);
    wgmma_wait<1>();
    fence_regs(af1);
    if (i + step < nc) {
      issue(i + step, af1);
      wgmma_wait<1>();
      fence_regs(af0);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(af0);
  fence_regs(af1);
}

// d[4 j + 2 h + e] of a warpgroup's accumulator: output column
// 16 wq + g8 + 8 h, row 8 j + 2 t4 + e, into the item's tile (tile_at)
// from row n0 on
template <int N, typename Acc>
__device__ __forceinline__ void acc_to_tile(Acc* tile, int n0, const Acc (&acc)[N / 2]) {
  const int tid = threadIdx.x & 127;
  const int wq = tid >> 5, g8 = (tid & 31) >> 2, t4 = tid & 3;
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    tile[tile_at(n0 + 8 * (i >> 2) + 2 * t4 + (i & 1), 16 * wq + g8 + 8 * ((i >> 1) & 1))] = acc[i];
}

// A pass's products over the item's nc chunks into the item's tile in the
// union (B tiles of tr rows). Up to kRowGroup rows, warpgroup wg takes
// chunks wg, wg + 4, ... of every row and the warpgroups' sums are added in
// warpgroup order. In the wide mode warpgroup wg takes rows [wg N, wg N +
// N) over every chunk: weight-only, two chunks at a time; w8a8, one chain
// of int32 accumulations over them all (exact in any order). A warpgroup
// past the last row only releases the stages, each once it is full (an
// item may hold more chunks than the ring has stages: an arrival must not
// reach a stage's next round).
template <int N, bool kQ>
__device__ __forceinline__ void products(const Ctx& c, int nc, int rows, int tr, bool wait,
                                         bool release) {
  using Acc = typename std::conditional<kQ, int, float>::type;
  using Acc4 = typename std::conditional<kQ, int4, float4>::type;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const bool wd = wide(c.a), active = !wd || wg * N < rows;
  const int rb = kQ ? 64 : 128;
  Acc acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  if (active && wd) {
    if constexpr (kQ) {
      chunk_products<N, kQ>(c, 0, 1, nc, c.sbase + c.L.uni + wg * N * rb, tr * rb, wait, release,
                            acc);
    } else {
      // the tensor cores' sums over two chunks at a time, added into acc in
      // chunk order by float32 adds: a chain of wgmma accumulations over all
      // the item's chunks parts further from the exact sum (PERF.md §6)
      for (int p0 = 0; p0 < nc; p0 += 2) {
        float part[N / 2];
#pragma unroll
        for (int i = 0; i < N / 2; ++i) part[i] = 0.f;
        chunk_products<N, kQ>(c, p0, 1, min(nc, p0 + 2), c.sbase + c.L.uni + wg * N * 128,
                              tr * 128, wait, release, part);
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
      }
    }
  } else if (active)
    chunk_products<N, kQ>(c, wg, kGroups, nc, c.sbase + c.L.uni, tr * rb, wait, release, acc);
  else if (release)
    for (int i = 0; i < nc; ++i) {
      const int gg = c.g + i;
      if (wait) mbar_wait(full_bar(c, gg % kRing), (gg / kRing) & 1);
      mbar_arrive(empty_bar(c, gg % kRing));
    }
  Acc* tile = reinterpret_cast<Acc*>(c.base + c.L.uni);
  consumers_sync();  // every warpgroup is done with B
  if (wd) {
    if (active) acc_to_tile<N>(tile, wg * N, acc);
  } else {
    // the other warpgroups' sums into warpgroup 0's through the union,
    // then into the tile
    Acc4* red = reinterpret_cast<Acc4*>(tile);
    if (wg > 0) {
#pragma unroll
      for (int q = 0; q < N / 8; ++q)
        red[((wg - 1) * (N / 8) + q) * 128 + tid] =
            Acc4{acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]};
    }
    consumers_sync();
    if (wg == 0) {
      for (int w = 1; w < kGroups; ++w)
#pragma unroll
        for (int q = 0; q < N / 8; ++q) {
          const Acc4 v = red[((w - 1) * (N / 8) + q) * 128 + tid];
          acc[4 * q] += v.x;
          acc[4 * q + 1] += v.y;
          acc[4 * q + 2] += v.z;
          acc[4 * q + 3] += v.w;
        }
      wg0_sync();
      acc_to_tile<N>(tile, 0, acc);
    }
  }
  consumers_sync();
}

// w8a8: the scale of row n (of the pass from rg0) over quantization slice
// j: the LayerNorm statistics' (one slice: the column form), else from the
// row's amax word
__device__ __forceinline__ float row_scale(const Ctx& c, const Lin& p, int rg0, int n, int j) {
  if (p.ln_s != nullptr) return reinterpret_cast<const float4*>(c.base + c.L.stats)[n].z;
  return quant_scale(__ldcg(p.qa + static_cast<long long>(rg0 + n) * p.qld + j));
}

// w8a8: where a split tile's row scales sit in the union (rows x slices
// floats), past the item's tile of int32 sums, within the warpgroups'
// reduction's room (layout)
__host__ __device__ inline int scales_at(const MegaArgs& a) {
  return tile_rows(a, pass_rows(a)) * kTile * 4;
}

// The epilogue of rows [0, rows) of the item's 64 columns, a thread per
// column and every fourth row, eight rows at a time. The sums come from the
// shared-memory tile, or (parts set) are the n_slices partials' sums; every
// load of a batch is issued before its first use. Weight-only: float32
// sums, the partials added in slice order. w8a8 (kQ): int32 sums; a split
// tile's partials are added in int32 (exact) per quantization slice, and
// the slices' f32(sum) * s_j added in slice order from 0, as _lin_w8a8;
// an EPI_STORE output's max |stored value| per row is noted in e.amax for
// the next linear's quantizer (a warp's lanes hold one row's 32 columns).
// Each output rounds as decode_megakernel.cu's epilogue notes.
template <bool kQ>
__device__ __forceinline__ void store_tile(const Ctx& c, const Lin& p, int col0, int rg0,
                                           int rows, const void* tile, const void* parts,
                                           int n_slices, long long part_floats, int c0) {
  const MegaArgs& a = c.a;
  const Epi& e = p.e;
  const int m = threadIdx.x & 63, col = col0 + m;
  const float sc = e.scale[col];
  const float bi = e.bias != nullptr ? ldf(e.bias + col) : 0.f;
  const bool resid = e.kind == EPI_RESID || e.kind == EPI_GATED;
  constexpr int kRowLanes = kConsumers / 64;  // threads a column has
  int n_out = 0, K = 0;
  if constexpr (kQ) lin_dims(a, p.lin, &n_out, &K);
  for (int n0 = threadIdx.x >> 6; n0 < rows; n0 += 8 * kRowLanes) {
    float y[8], xo[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + kRowLanes * j;
      xo[j] = resid && n < rows ? ldf(a.x + (rg0 + n) * a.D + col) : 0.f;
      if constexpr (kQ) {
        y[j] = parts == nullptr && n < rows
                   ? __fmul_rn(__int2float_rn(static_cast<const int*>(tile)[tile_at(n, m)]),
                               reinterpret_cast<const float4*>(c.base + c.L.stats)[n].z)
                   : 0.f;
      } else {
        y[j] = parts == nullptr && n < rows ? static_cast<const float*>(tile)[tile_at(n, m)] : 0.f;
      }
    }
    if (parts != nullptr) {
      if constexpr (kQ) {
        // per quantization slice q (its K-slices are neighbours): the
        // partials added in int32, the sum cast once, scaled by the row's
        // scale of slice q (finish_pass put them in the union), added to y
        // in slice order; every partial's load free to issue at once
        const int* ip = static_cast<const int*>(parts);
        const float* qs = reinterpret_cast<const float*>(c.base + c.L.uni + scales_at(a));
        const int nk = K / kTile, nq = (K + a.D - 1) / a.D;
        int sum[8], q = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) sum[j] = 0;
        auto flush = [&]() {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = n0 + kRowLanes * j;
            if (n < rows) y[j] = __fadd_rn(y[j], __fmul_rn(__int2float_rn(sum[j]), qs[n * nq + q]));
            sum[j] = 0;
          }
        };
        if (nq == 1) {  // the column form: one quantization slice
#pragma unroll 8
          for (int t = 0; t < n_slices; ++t)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (n0 + kRowLanes * j < rows)
                sum[j] += __ldcg(ip + t * part_floats + (n0 + kRowLanes * j) * kTile + m);
        } else {
#pragma unroll 8
          for (int t = 0; t < n_slices; ++t) {
            const int qt = quant_slice(a, t * nk / n_slices);
            if (qt != q) {
              flush();
              q = qt;
            }
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (n0 + kRowLanes * j < rows)
                sum[j] += __ldcg(ip + t * part_floats + (n0 + kRowLanes * j) * kTile + m);
          }
        }
        flush();
      } else {
        const float* fp = static_cast<const float*>(parts);
#pragma unroll 8
        for (int s = 0; s < n_slices; ++s)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (n0 + kRowLanes * j < rows)
              y[j] += __ldcg(fp + s * part_floats + (n0 + kRowLanes * j) * kTile + m);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + kRowLanes * j, row = rg0 + n;
      if (n >= rows) break;
      float v = rbf(y[j] * sc);
      if (e.bias != nullptr) v = rbf(v + bi);
      switch (e.kind) {
        case EPI_STORE: {
          if (e.act >= 0) v = activate(v, e.act);
          const bf16 h = __float2bfloat16_rn(v);
          e.out[row * e.ld + col] = h;
          if constexpr (kQ) {
            if (e.amax != nullptr) {
              const float mx = warp_max(fabsf(__bfloat162float(h)));
              if ((threadIdx.x & 31) == 0)
                atomicMax(e.amax + static_cast<long long>(row) * e.amax_ld + col / a.D,
                          __float_as_uint(mx));
            }
          }
          break;
        }
        case EPI_XQ:
          e.out[row * e.ld + col] = __float2bfloat16_rn(v * e.mul);
          break;
        case EPI_RESID:
          a.x[row * a.D + col] = __float2bfloat16_rn(xo[j] + v);
          break;
        case EPI_GATED:
          a.x[row * a.D + col] = __float2bfloat16_rn(xo[j] + rbf(e.mul * v));
          break;
        default:  // EPI_QKV
          if (col < a.D) e.q[row * a.D + col] = __float2bfloat16_rn(v);
          else if (col < 2 * a.D) e.krow[row * a.D + col - a.D] = __float2bfloat16_rn(v);
          else e.vrow[row * a.D + col - 2 * a.D] = __float2bfloat16_rn(v);
      }
    }
  }
}

// After a pass's products: the epilogue of the item's tile, or, for a tile
// split over K, its partial to `parts` (rows x 64 words, row-major) and,
// for the last block to arrive at the tile, the partials combined and the
// epilogue.
template <bool kQ>
__device__ __forceinline__ void finish_pass(const Ctx& c, const Lin& p, int tile, int slice,
                                         int n_slices, int ps, int rows, int c0) {
  using Acc = typename std::conditional<kQ, int, float>::type;
  const MegaArgs& a = c.a;
  const Acc* t = reinterpret_cast<const Acc*>(c.base + c.L.uni);
  const int rg0 = ps * kPassRows, col0 = tile * kTile, m = threadIdx.x & 63;
  if (n_slices == 1) {
    store_tile<kQ>(c, p, col0, rg0, rows, t, nullptr, 1, 0, c0);
    return;
  }
  int n_out, K;
  lin_dims(a, p.lin, &n_out, &K);
  const int n_tiles = n_out / kTile;
  const long long part_floats = static_cast<long long>(kTile) * tile_rows(a, pass_rows(a));
  Acc* parts = reinterpret_cast<Acc*>(a.parts) +
               (static_cast<long long>(ps) * n_tiles + tile) * n_slices * part_floats;
  if constexpr (kQ) {
    // each row's scale of each quantization slice of the input, into the
    // union past the tile for store_tile's combine: in every block, so that
    // the loads overlap the partial's stores and the arrival
    const int nq = (K + a.D - 1) / a.D;
    float* qs = reinterpret_cast<float*>(c.base + c.L.uni + scales_at(a));
    for (int i = threadIdx.x; i < rows * nq; i += kConsumers)
      qs[i] = row_scale(c, p, rg0, i / nq, i % nq);
  }
  for (int n = threadIdx.x >> 6; n < rows; n += kConsumers / 64)
    __stcg(parts + slice * part_floats + n * kTile + m, t[tile_at(n, m)]);
  consumers_sync();
  int* flag = reinterpret_cast<int*>(c.base + c.L.flag);
  if (threadIdx.x == 0) {
    // release: the block's partial (cumulative over the barrier above);
    // acquire: the other blocks' partials, for the last to arrive
    unsigned* counter = a.sync + 2 + ps * n_tiles + tile;
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(counter) : "memory");
    const int last = old == static_cast<unsigned>(n_slices - 1);
    if (last) *reinterpret_cast<volatile unsigned*>(counter) = 0u;  // read again after a grid barrier
    *flag = last;
  }
  consumers_sync();
  if (!*flag) return;
  store_tile<kQ>(c, p, col0, rg0, rows, nullptr, parts, n_slices, part_floats, c0);
}

#define MK90_PRODUCTS(n)                                              \
  case n:                                                             \
    products<n, kQ>(c, nc, rows, tr, ps == 0, ps == n_pass - 1);      \
    break;

// A linear phase: this block's items, blockIdx.x, + gridDim.x, ...; per
// item and pass: stage, products, finish. Past kPassRows rows the item's
// weights stay in the ring for every pass.
template <bool kQ>
__device__ __forceinline__ void linear_phase(Ctx& c, const Lin& p) {
  const MegaArgs& a = c.a;
  int n_out, K;
  lin_dims(a, p.lin, &n_out, &K);
  const int s = a.split[p.lin], nk = K / kTile;
  const int n_pass = (a.b + kPassRows - 1) / kPassRows;
  bool have_stats = false;
  int tile, slice;
  for (int k = 0; item_at(n_out / kTile, s, k, &tile, &slice); ++k) {
    int c0, nc;
    slice_chunks(slice, s, nk, &c0, &nc);
    for (int ps = 0; ps < n_pass; ++ps) {
      const int rows = min(kPassRows, a.b - ps * kPassRows);
      const int n = pass_n(a, rows), tr = tile_rows(a, rows);
      prepare_pass<kQ>(c, p, ps * kPassRows, rows, c0, nc, tr, n_pass > 1 || !have_stats);
      have_stats = true;
      switch (n) {
        MK90_PRODUCTS(8) MK90_PRODUCTS(16) MK90_PRODUCTS(24) MK90_PRODUCTS(32)
        MK90_PRODUCTS(48) MK90_PRODUCTS(64)
      }
      mark(c, kSecProducts);
      finish_pass<kQ>(c, p, tile, slice, s, ps, rows, c0);
      consumers_sync();
      mark(c, kSecFinish);
    }
    c.g += nc;
  }
}

#undef MK90_PRODUCTS

// ---------------------------------------------------------------------------
// attention

constexpr int kHeadGroup = 4;  // heads per attention item at 64: 256 dims, 512 bytes a slot

// bytes of shared memory `attend` takes: the scores of every position for
// each head of the item (float32), each warp's V sums, each span's maxima
// and sums; the sums float32, or float64 in the w8a8 mode. Laid out for
// 64-wide heads (4 a group, 256 dims) at every width: an item of wider
// heads (`Heads`: 3 of 80, 2 of 128) takes no more of any part, and keeps
// the float64 parts 8-byte aligned.
__host__ __device__ inline int att_bytes(const MegaArgs& a) {
  const int t = a.t_lim > a.NMNV ? a.t_lim : a.NMNV, acc = a.act_quant ? 8 : 4;
  return 4 * kHeadGroup * t + acc * kCWarps * kHeadGroup * kHeadDim +
         (4 + acc) * kCWarps * kHeadGroup;
}

// An attention item of kHD-wide heads: a lane holds 8 dims (one 16-byte
// load of a slot), a head kLanes lanes, an item kHeads heads (a warp's 32
// lanes: 4 x 8 at 64, 2 x 16 at 128; at 80 3 x 10, lanes 30 and 31 idle).
template <int kHD>
struct Heads {
  static_assert(kHD % 8 == 0 && kHD / 8 <= 32, "a head is whole 16-byte loads of a warp");
  static constexpr int kLanes = kHD / 8;
  static constexpr int kHeads = 32 / kLanes;
  static constexpr int kDims = kHeads * kHD;            // dims of an item
  static constexpr bool kRagged = kHeads * kLanes != 32;  // idle lanes
};

// x summed over the kLanes lanes of each head, the same bits on each: xor
// shuffles where kLanes is a power of two; else adjacent pairs, then the
// pairs gathered from the head's first lane in order
template <int kLanes, typename T>
__device__ __forceinline__ T head_sum(T x, int lane0) {
  if constexpr ((kLanes & (kLanes - 1)) == 0) {
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  } else {
    static_assert(kLanes % 2 == 0, "pairs of lanes");
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    T total = __shfl_sync(0xffffffffu, x, lane0);
#pragma unroll
    for (int p = 2; p < kLanes; p += 2) total += __shfl_sync(0xffffffffu, x, lane0 + p);
    return total;
  }
}

// decode_megakernel.cu's note on attention (the same masks, positions and
// roundings: the scores of xattn rounded to bf16, p = exp(s - max) over
// every position < t_lim, bf16(p) V, out = sum / max(l, 1e-30)), laid out
// for the cache's rows: an item is a row and a group of kHeads heads
// (`Heads`; four at 64), whose K or V at a slot is one 16-byte load per
// lane (lane l: head l / kLanes, dims 8 (l % kLanes) ... + 7; its dot over
// 8 dims, then the head's lanes added by `head_sum`). Warp w of the block
// takes the w-th span of the positions and of the V walk; the max is the
// item's, the spans' sums are added in warp order. Weight-only: float32
// sums. kQ (w8a8): the dot products, l and the V sums in float64 (bf16 x
// bf16 products are exact in float32; the sums do not depend on their
// order), each rounded to float32 once, and each row's max |output| over a
// D-wide slice noted in `amax` (row stride amax_ld) for the next linear's
// quantizer. kHD: the heads' width (xattn's are 64; self-attention's the
// trunk's: 64, 80 or 128).
template <bool kQ, int kHD>
__device__ __forceinline__ void attend(const MegaArgs& a, const bf16* q, int ld, const bf16* K,
                                       const bf16* V, int n_head, int t_lim, float scale,
                                       bool xattn, bf16* out, float* smem, unsigned* amax,
                                       int amax_ld) {
  using Acc = typename std::conditional<kQ, double, float>::type;
  using G = Heads<kHD>;
  constexpr int kLanes = G::kLanes, kHeads = G::kHeads, kDims = G::kDims;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool lane_ok = !G::kRagged || lane < kHeads * kLanes;  // not an idle lane
  const int hl = lane_ok ? lane / kLanes : 0;  // the lane's head in the group
  const int lh = lane % kLanes, dim = lh * 8;  // its place in the head, its dims
  const int lane0 = lane - lh;                 // the head's first lane
  const bool lead = lh == 0 && lane_ok;        // writes the head's values
  const int t_max = a.t_lim > a.NMNV ? a.t_lim : a.NMNV;
  float* sc = smem + hl * t_max;                              // this lane's head's scores
  Acc* part = reinterpret_cast<Acc*>(smem + kHeadGroup * t_max);  // (warp, kDims) V sums
  float* span_m = reinterpret_cast<float*>(part + kCWarps * kHeadGroup * kHeadDim);  // (warp, head)
  Acc* span_l = reinterpret_cast<Acc*>(span_m + kCWarps * kHeadGroup);
  const int groups = (n_head + kHeads - 1) / kHeads;
  const long long t_stride = static_cast<long long>(a.b) * ld;
  for (int item = blockIdx.x; item < a.b * groups; item += gridDim.x) {
    const int row = item / groups, head = (item % groups) * kHeads + hl;
    const bool live = lane_ok && head < n_head;  // a lane of a head past the last
    int lo, hi;
    if (xattn) {
      const int tt = a.text_time[row];
      lo = (tt - 1) * a.n_visual;
      hi = tt <= 0 ? -1 : min(tt * a.n_visual, t_lim) - 1;
    } else {
      lo = a.npad[row];
      hi = min(a.cur, t_lim - 1);
    }
    const long long off = static_cast<long long>(row) * ld + head * kHD + dim;
    const bool beam = !xattn && a.anc != nullptr;
    const int fam0 = beam ? (row / a.kb) * a.kb : row;
    const int* anc_row = beam ? a.anc + static_cast<long long>(row) * a.anc_len : nullptr;
    auto phys = [&](int t) -> int {
      if (!beam) return row;
      const int j = t < a.anc_len ? anc_row[t] : 0;
      return (j >= 0 && j < a.kb) ? fam0 + j : -1;
    };
    float qv[8];
    {
      const uint4 u = live ? *reinterpret_cast<const uint4*>(q + off) : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        qv[2 * j] = f.x;
        qv[2 * j + 1] = f.y;
      }
    }

    // scores of this warp's span of positions, four slots' keys in flight
    const int per_t = (t_lim + kCWarps - 1) / kCWarps;
    const int t0 = warp * per_t, t1 = min(t_lim, t0 + per_t);
    float m = -FLT_MAX;
    for (int t = t0; t < t1; t += 4) {
      uint4 kv[4];
      int prow[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int tk = t + k;
        prow[k] = (tk < t1 && tk >= lo && tk <= hi) ? phys(tk) : -1;
        kv[k] = make_uint4(0u, 0u, 0u, 0u);
        if (prow[k] >= 0 && live)
          kv[k] = *reinterpret_cast<const uint4*>(
              K + tk * t_stride + off + static_cast<long long>(prow[k] - row) * ld);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (t + k >= t1) break;
        const uint32_t w[4] = {kv[k].x, kv[k].y, kv[k].z, kv[k].w};
        Acc dot = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
          if constexpr (kQ) {
            dot += static_cast<double>(__fmul_rn(qv[2 * j], f.x));
            dot += static_cast<double>(__fmul_rn(qv[2 * j + 1], f.y));
          } else {
            dot += qv[2 * j] * f.x;
            dot += qv[2 * j + 1] * f.y;
          }
        }
        dot = head_sum<kLanes>(dot, lane0);
        float s = -FLT_MAX;
        if (prow[k] >= 0) {
          if constexpr (kQ) s = __fmul_rn(__double2float_rn(dot), scale);
          else s = dot * scale;
          if (xattn) s = rbf(s);
        }
        if (lead) sc[t + k] = s;
        m = fmaxf(m, s);
      }
    }
    if (lead) span_m[warp * kHeadGroup + hl] = m;
    consumers_sync();
    for (int w = 0; w < kCWarps; ++w) m = fmaxf(m, span_m[w * kHeadGroup + hl]);
    // p = exp(s - max) in place over the span, the head's kLanes lanes
    // taking every kLanes-th position
    Acc l_sum = 0;
    for (int t = t0 + lh; lane_ok && t < t1; t += kLanes) {
      const float p = expf(sc[t] - m);
      sc[t] = p;
      l_sum += p;
    }
    l_sum = head_sum<kLanes>(l_sum, lane0);
    if (lead) span_l[warp * kHeadGroup + hl] = l_sum;
    consumers_sync();  // every p is in place before any span's V walk

    // V: this warp's span of the walk [u0, u1] (slot t = u of row phys(t),
    // or, an empty range in beam mode, slot u % t_lim of family row
    // u / t_lim), kV slots in flight (four beside the float64 sums)
    const bool spread = beam && lo > hi;
    const bool zero = xattn && a.text_time[row] == 0;
    Acc acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0;
    const int u0 = lo <= hi ? lo : 0;
    const int u1 = lo <= hi ? hi : (spread ? a.kb * t_lim : t_lim) - 1;
    const int per_u = (u1 - u0 + kCWarps) / kCWarps;
    const int v0 = u0 + warp * per_u, v1 = min(u1, v0 + per_u - 1);
    constexpr int kV = kQ ? 4 : 8;
    if (!zero && live) {
      for (int u = v0; u <= v1; u += kV) {
        uint4 vv[kV];
        float pk[kV];
#pragma unroll
        for (int k = 0; k < kV; ++k) {
          const int uk = u + k, t = spread ? uk % t_lim : uk;
          const int prow = uk > v1 ? -1
                                   : (spread ? fam0 + uk / t_lim : (lo <= hi ? phys(t) : row));
          pk[k] = 0.f;
          vv[k] = make_uint4(0u, 0u, 0u, 0u);
          if (prow >= 0) {
            vv[k] = *reinterpret_cast<const uint4*>(
                V + t * t_stride + off + static_cast<long long>(prow - row) * ld);
            pk[k] = rbf(sc[t]);
          }
        }
#pragma unroll
        for (int k = 0; k < kV; ++k) {
          if (u + k > v1) break;
          const uint32_t w[4] = {vv[k].x, vv[k].y, vv[k].z, vv[k].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
            if constexpr (kQ) {
              acc[2 * j] += static_cast<double>(__fmul_rn(pk[k], f.x));
              acc[2 * j + 1] += static_cast<double>(__fmul_rn(pk[k], f.y));
            } else {
              acc[2 * j] += pk[k] * f.x;
              acc[2 * j + 1] += pk[k] * f.y;
            }
          }
        }
      }
    }
    if (lane_ok) {
#pragma unroll
      for (int i = 0; i < 8; ++i) part[warp * kDims + hl * kHD + dim + i] = acc[i];
    }
    consumers_sync();

    // the spans added in warp order: a thread per dim of the group's heads
    {
      const int i = threadIdx.x, h = i / kHD, hd = (item % groups) * kHeads + h;
      float stored = 0.f;  // |the bf16 output| (w8a8's amax)
      if (i < kDims && hd < n_head) {
        Acc l = 0, o = 0;
        for (int w = 0; w < kCWarps; ++w) {
          l += span_l[w * kHeadGroup + h];
          o += part[w * kDims + i];
        }
        float lf, of;
        if constexpr (kQ) {
          lf = __double2float_rn(l);
          of = __double2float_rn(o);
        } else {
          lf = l;
          of = o;
        }
        if (spread) lf = __fmul_rn(lf, static_cast<float>(a.kb));
        lf = fmaxf(lf, 1e-30f);
        const bf16 v = __float2bfloat16_rn(zero ? 0.f : of / lf);
        out[static_cast<long long>(row) * ld + (item % groups) * kDims + i] = v;
        stored = fabsf(__bfloat162float(v));
      }
      if constexpr (kQ) {
        // the warps whose first dim is a live head's: each a row's 32
        // output dims, within one D-wide slice (the dims past the item's
        // or a live head's last hold 0)
        const int i0 = threadIdx.x & ~31;
        if (i0 < kDims && (kHD == kHeadDim || (item % groups) * kHeads + i0 / kHD < n_head)) {
          stored = warp_max(stored);
          if (lane == 0)
            atomicMax(amax + static_cast<long long>(row) * amax_ld +
                          ((item % groups) * kDims + i) / a.D,
                      __float_as_uint(stored));
        }
      }
    }
    consumers_sync();  // the scratch is reused by the next item
  }
}

// ---------------------------------------------------------------------------
// the kernel

// The producer's share of one linear phase (the map of linear `lin`, its
// weight stack's slot): the block's items' chunks into the ring, g counting
// the stages filled.
__device__ __forceinline__ void producer_phase(const MegaArgs& a, const CUtensorMap* map,
                                               uint32_t sbase, const Layout& L, int lin,
                                               int slot, int& g) {
  int n_out, K;
  lin_dims(a, lin, &n_out, &K);
  const int s = a.split[lin], nk = K / kTile;
  int tile, slice;
  for (int k = 0; item_at(n_out / kTile, s, k, &tile, &slice); ++k) {
    int c0, nc;
    slice_chunks(slice, s, nk, &c0, &nc);
    for (int ch = c0; ch < c0 + nc; ++ch, ++g) {
      const int stage = g % kRing, round = g / kRing;
      const uint32_t full = sbase + L.bars + 8 * stage;
      if (round > 0) producer_wait(sbase + L.bars + 8 * (kRing + stage), (round - 1) & 1);
      mbar_expect_tx(full, kChunkBytes);
      tma_load_2d(sbase + L.ring + stage * kChunkBytes, map, full, ch * kTile,
                  slot * n_out + tile * kTile);
    }
  }
}

// The producer of the w8a8 linear alone: one phase, slot 0. Out of line,
// as `producer` is: it runs with setmaxnreg's 24 registers.
__device__ __noinline__ void producer_linear(const MegaArgs& a, const CUtensorMap* map,
                                             uint32_t sbase, const Layout& L, int lin) {
  int g = 0;
  producer_phase(a, map, sbase, L, lin, 0, g);
}

// The producer: every linear phase of the step in the consumers' order,
// each item's chunks into the ring.
__device__ void producer(const MegaArgs& a, const Maps& maps, uint32_t sbase, const Layout& L) {
  for (int i = 0; i < kLinears; ++i) prefetch_map(&maps.m[i]);
  int g = 0;
  for (int l = 0, xs = 0; l < a.n_layer; ++l) {
    if (a.hasx[l]) {
      for (int lin = kXQ; lin <= kXF2; ++lin) producer_phase(a, &maps.m[lin], sbase, L, lin, xs, g);
      ++xs;
    }
    for (int lin = kQKV; lin <= kPR; ++lin) producer_phase(a, &maps.m[lin], sbase, L, lin, l, g);
  }
}

// The consumers: the layer loop, decode_megakernel's phases in its order
// (xq, xattn, xo, xf1, xf2 where the layer has a gated xattn block; qkv,
// attention, o, fc, pr), a grid barrier between each two; one call site
// each for the linear and the attention, so that both inline. kQ (w8a8):
// the amax words (abuf's, then hbuf's: nsA and nsH D-wide slices a row)
// are zeroed in each layer's first LayerNorm phase and in LN1's, noted by
// the attention and by the fc1 / fc epilogues, read by the next linear.
// kPhases: the phase timer's copies (note_phase) too, in a kernel of their
// own: in the step's kernels their stores cost 13-16 % of a step (the
// consumer body's register allocation moves with them). kHD: the trunk's
// head width (self-attention; xattn's heads are 64 wide): at 64 one
// attention call site serves both, at 80 and 128 a second one.
template <bool kQ, bool kPhases, int kHD>
__device__ __forceinline__ void consumer(Ctx& c) {
  const MegaArgs& a = c.a;
  const int D = a.D, QW = max(a.D, a.XI);
  bf16* qbuf = a.scratch;
  bf16* abuf = a.scratch + a.b * QW;
  bf16* hbuf = a.scratch + 2 * a.b * QW;
  const int nsA = (QW + D - 1) / D, nsH = (max(a.Dff, a.Dffx) + D - 1) / D;
  unsigned* amax_a = a.amax;
  unsigned* amax_h = kQ ? a.amax + a.b * nsA : nullptr;
  float* att = reinterpret_cast<float*>(c.base + c.L.uni);
  // x <- x_emb during the first phase, whose LayerNorm reads x_emb; nothing
  // reads x before the first barrier
  for (int i = blockIdx.x * kConsumers + threadIdx.x; i < a.b * D / 8; i += gridDim.x * kConsumers)
    reinterpret_cast<uint4*>(a.x)[i] = reinterpret_cast<const uint4*>(a.x_emb)[i];
  const bf16* ln_src = a.x_emb;
  const long long slab = static_cast<long long>(a.b) * D;
  bool first = true;
  unsigned long long* timer = timer_words();
  if (threadIdx.x == 0) {
    for (int k = 0; k < kSections; ++k) timer[k] = 0;
    timer[kSections] = clock64();
  }
  for (int l = 0, xs = -1; l < a.n_layer; ++l) {
    const bool hx = a.hasx[l] != 0;
    xs += hx;
    for (int ph = hx ? 0 : 5; ph < 10; ++ph) {
      if (!first) {
        mark(c, kSecOther);
        if constexpr (kPhases) note_phase(a, 5 * (l + xs) + ph - 1);  // the phase before
        grid_sync(a.sync);
        mark(c, kSecBarrier);
      }
      if constexpr (kQ) c.lnp_async = !first;
      first = false;
      if (kQ && (ph == 0 || ph == 5)) {
        // no reader of the last fill is left, no writer of the next yet
        for (int i = blockIdx.x * kConsumers + threadIdx.x; i < a.b * (nsA + nsH);
             i += gridDim.x * kConsumers)
          __stcg(a.amax + i, 0u);
      }
      if (kQ && (ph == 2 || ph == 4 || ph == 7 || (ph == 9 && l + 1 < a.n_layer))) {
        // the next phase is a LayerNorm phase: xf1's, LN1's, LN2's, or the
        // next layer's first (its xattn query's or its LN1's)
        const bool nx = ph == 9 && a.hasx[l + 1] != 0;
        const float* ln_s = ph == 2 ? a.xfn_s + xs * D
                          : ph == 4 ? a.ln1_s + l * D
                          : ph == 7 ? a.ln2_s + l * D
                          : nx ? a.xn_s + (xs + 1) * D : a.ln1_s + (l + 1) * D;
        const float* ln_b = ph == 2 ? a.xfn_b + xs * D
                          : ph == 4 ? a.ln1_b + l * D
                          : ph == 7 ? a.ln2_b + l * D
                          : nx ? a.xn_b + (xs + 1) * D : a.ln1_b + (l + 1) * D;
        prefetch_lnp(c, ln_s, ln_b);
      }
      if (ph == 1 || ph == 6) {  // attention: xattn over the image's latents, or self
        const bool x = ph == 1;
        const long long kv = x ? static_cast<long long>(l) * a.NMNV * a.b * a.XI
                               : static_cast<long long>(l) * a.T * slab;
        if constexpr (kHD == kHeadDim) {  // one call site: both widths 64
          attend<kQ, kHeadDim>(a, qbuf, x ? a.XI : D, (x ? a.xk : a.kc) + kv,
                               (x ? a.xv : a.vc) + kv, x ? a.x_heads : a.n_head,
                               x ? a.NMNV : a.t_lim, x ? 1.f : a.attn_scale, x, abuf, att,
                               amax_a, nsA);
        } else if (x) {
          attend<kQ, kHeadDim>(a, qbuf, a.XI, a.xk + kv, a.xv + kv, a.x_heads, a.NMNV, 1.f,
                               true, abuf, att, amax_a, nsA);
        } else {
          attend<kQ, kHD>(a, qbuf, D, a.kc + kv, a.vc + kv, a.n_head, a.t_lim, a.attn_scale,
                          false, abuf, att, amax_a, nsA);
        }
        mark(c, kSecAttention);
        continue;
      }
      Lin p{0, nullptr, nullptr, nullptr, Epi{}, nullptr, 0};
      Epi& e = p.e;
      switch (ph) {
        case 0:  // LN + to_q, the query scaled
          p = Lin{kXQ, ln_src, a.xn_s + xs * D, a.xn_b + xs * D, Epi{}, nullptr, 0};
          e.kind = EPI_XQ; e.scale = a.s_xq + xs * a.XI; e.out = qbuf; e.ld = a.XI;
          e.mul = a.xq_scale;
          break;
        case 2:  // to_out, gated into the stream
          p = Lin{kXO, abuf, nullptr, nullptr, Epi{}, amax_a, nsA};
          e.kind = EPI_GATED; e.scale = a.s_xo + xs * D; e.mul = a.gates[2 * xs];
          break;
        case 3:  // LN + the gated FFW's fc1 and activation
          p = Lin{kXF1, ln_src, a.xfn_s + xs * D, a.xfn_b + xs * D, Epi{}, nullptr, 0};
          e.kind = EPI_STORE; e.scale = a.s_xf1 + xs * a.Dffx; e.out = hbuf; e.ld = a.Dffx;
          e.act = a.xact; e.amax = amax_h; e.amax_ld = nsH;
          break;
        case 4:  // fc2, gated into the stream
          p = Lin{kXF2, hbuf, nullptr, nullptr, Epi{}, amax_h, nsH};
          e.kind = EPI_GATED; e.scale = a.s_xf2 + xs * D; e.mul = a.gates[2 * xs + 1];
          break;
        case 5:  // LN1 + q, k, v; the K/V rows written at cur
          p = Lin{kQKV, ln_src, a.ln1_s + l * D, a.ln1_b + l * D, Epi{}, nullptr, 0};
          e.kind = EPI_QKV; e.scale = a.s_qkv + l * 3 * D; e.bias = a.b_qkv + l * 3 * D;
          e.q = qbuf;
          e.krow = a.kc + (static_cast<long long>(l) * a.T + a.cur) * slab;
          e.vrow = a.vc + (static_cast<long long>(l) * a.T + a.cur) * slab;
          break;
        case 7:  // c_proj + the residual
          p = Lin{kO, abuf, nullptr, nullptr, Epi{}, amax_a, nsA};
          e.kind = EPI_RESID; e.scale = a.s_o + l * D; e.bias = a.b_o + l * D;
          break;
        case 8:  // LN2 + fc and the activation
          p = Lin{kFC, ln_src, a.ln2_s + l * D, a.ln2_b + l * D, Epi{}, nullptr, 0};
          e.kind = EPI_STORE; e.scale = a.s_fc + static_cast<long long>(l) * a.Dff;
          e.bias = a.b_fc + static_cast<long long>(l) * a.Dff; e.out = hbuf; e.ld = a.Dff;
          e.act = a.act; e.amax = amax_h; e.amax_ld = nsH;
          break;
        default:  // 9: mlp_proj + the residual
          p = Lin{kPR, hbuf, nullptr, nullptr, Epi{}, amax_h, nsH};
          e.kind = EPI_RESID; e.scale = a.s_pr + l * D; e.bias = a.b_pr + l * D;
      }
      linear_phase<kQ>(c, p);
      ln_src = a.x;
    }
  }
  mark(c, kSecOther);
  if constexpr (kPhases) note_phase(a, 5 * (a.n_layer + a.n_xattn) - 1);
  if (threadIdx.x == 0 && a.prof != nullptr)
    for (int k = 0; k < kSections; ++k) a.prof[blockIdx.x * kSections + k] = timer[k];
}

// The block's start, common to the kernels below: the ring's barriers
// initialised (a stage is released by the warpgroup that read it, or in
// the wide mode by every consumer thread), the producer warpgroup's
// registers lowered and the consumers' raised. Returns the aligned base's
// shared-space address.
__device__ __forceinline__ uint32_t block_start(const MegaArgs& a, const Layout& L,
                                                const uint8_t* smem_raw) {
  const uint32_t sbase = (smem_addr(smem_raw) + 1023u) & ~1023u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(sbase + L.bars + 8 * s, 1);
      mbar_init(sbase + L.bars + 8 * (kRing + s), wide(a) ? kConsumers : 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
  else asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n");
  return sbase;
}

// the whole step; kQ: the w8a8 mode (a.act_quant), else weight-only;
// kPhases: with the phase timer (a.phases set); kHD: the self-attention
// heads' width (a.D / a.n_head)
template <bool kQ, bool kPhases, int kHD>
__global__ void __launch_bounds__(kThreads, 1)
decode_megakernel_sm90(const __grid_constant__ MegaArgs a, const __grid_constant__ Maps maps) {
  extern __shared__ uint8_t smem_raw[];
  const Layout L = layout(a);
  const uint32_t sbase = block_start(a, L, smem_raw);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) producer(a, maps, sbase, L);
    return;
  }
  Ctx c{a, smem_raw + (sbase - smem_addr(smem_raw)), sbase, L, 0, false};
  consumer<kQ, kPhases, kHD>(c);
}

#if defined(FMT_MK_LINEAR)
// The w8a8 linear alone (fmt_w8a8_linear): the step's machinery with a
// schedule of one linear phase `p` (its weights in maps.m[p.lin], slot 0)
// and no grid barrier: staging with the quantizer, the int8 products, the
// split tiles' int32 combine and the epilogue.
__global__ void __launch_bounds__(kThreads, 1)
w8a8_linear_kernel(const __grid_constant__ MegaArgs a, const __grid_constant__ Maps maps,
                   const __grid_constant__ Lin p) {
  extern __shared__ uint8_t smem_raw[];
  const Layout L = layout(a);
  const uint32_t sbase = block_start(a, L, smem_raw);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) producer_linear(a, &maps.m[p.lin], sbase, L, p.lin);
    return;
  }
  if (threadIdx.x == 0) timer_words()[kSections] = clock64();
  Ctx c{a, smem_raw + (sbase - smem_addr(smem_raw)), sbase, L, 0, false};
  linear_phase<true>(c, p);
}
#endif

#if !defined(FMT_MK_PART)
// The barrier alone, for a card test: every block's consumers write a
// stamp in each of `phases` phases (two rows of slots, alternating), and
// after the barrier read every block's stamp back with plain loads;
// mismatches are added to *errors.
__global__ void __launch_bounds__(kThreads, 1)
grid_sync_test_kernel(unsigned* sync, unsigned* slots, unsigned* errors, int phases) {
  if (threadIdx.x >= kConsumers) return;
  unsigned bad = 0;
  for (int p = 0; p < phases; ++p) {
    unsigned* row = slots + (p & 1) * gridDim.x;
    const unsigned stamp = static_cast<unsigned>(p) * gridDim.x + 1u;
    if (threadIdx.x == 0) row[blockIdx.x] = stamp + blockIdx.x;
    grid_sync(sync);
    for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kConsumers)
      bad += row[i] != stamp + i;
  }
  if (bad) atomicAdd(errors, bad);
}
#endif

// ---------------------------------------------------------------------------
// host side

// a 2-D map over a (rows, k) int8 stack, box 64 x 64, no swizzle; a stack
// with no rows (no xattn layer) gets a zeroed map the schedule never reads
bool encode_weights(CUtensorMap* map, const int8_t* w, long long rows, int k) {
  if (rows == 0) {
    *map = CUtensorMap{};
    return true;
  }
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr || rows > 0x7fffffff) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {kTile, kTile}, unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w), dims, stride, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the self-attention heads' width, or 0 if the kernels take none of these
// shapes: 64, 80 or 128 wide, xattn's 64
int head_width(const MegaArgs& a) {
  if (a.n_head < 1 || a.x_heads < 1 || a.D % a.n_head || a.XI != a.x_heads * kHeadDim) return 0;
  const int hd = a.D / a.n_head;
  return hd == kHeadDim || hd == 80 || hd == 128 ? hd : 0;
}

// the plan's fields within the kernel's limits; w8a8: its amax words given,
// and no K-slice of a linear straddles a D-wide quantization slice
bool plan_ok(const MegaArgs& a) {
  if (a.parts == nullptr || a.sync == nullptr || a.D > 32 * 8 * kMaxUnits ||
      (a.act_quant && a.amax == nullptr))
    return false;
  for (int lin = a.n_xattn > 0 ? 0 : kQKV; lin < kLinears; ++lin) {
    int n, k;
    lin_dims(a, lin, &n, &k);
    const int s = a.split[lin];
    if (n % kTile || k % kTile || s < 1 || s > k / kTile) return false;
    for (int i = 0; a.act_quant && i < s; ++i) {
      int c0, nc;
      slice_chunks(i, s, k / kTile, &c0, &nc);
      if (quant_slice(a, c0) != quant_slice(a, c0 + nc - 1)) return false;
    }
  }
  // past one pass an item's chunks are held in the ring for every pass
  return a.b <= kPassRows || max_chunks(a) <= kRing;
}

// blocks of a grid of `kernel` with a's layout (one per SM), or 0 if a
// block cannot be resident
cudaError_t grid_size(const MegaArgs& a, const void* kernel, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // shared memory above 48 KB, allowed on whichever device is current
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               layout(a).bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, layout(a).bytes);
  *blocks = per_sm > 0 ? sms : 0;
  return err;
}

cudaError_t encode_all(const MegaArgs& a, Maps* maps) {
  const long long L = a.n_layer, NX = a.n_xattn;
  const int8_t* w[kLinears] = {a.w_xq, a.w_xo, a.w_xf1, a.w_xf2, a.w_qkv, a.w_o, a.w_fc, a.w_pr};
  for (int lin = 0; lin < kLinears; ++lin) {
    int n, k;
    lin_dims(a, lin, &n, &k);
    if (!encode_weights(&maps->m[lin], w[lin], (lin < kQKV ? NX : L) * n, k))
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

#if defined(FMT_MK_PART)
// a part's kernel on a's layout: its grid (*blocks), then, unless `params`
// is null, the launch, cooperative for the step
cudaError_t part_launch(const void* kernel, const MegaArgs& a, void** params, int* blocks,
                        void* stream, bool cooperative) {
  cudaError_t err = grid_size(a, kernel, blocks);
  if (err != cudaSuccess || params == nullptr) return err;
  if (*blocks == 0) return cudaErrorCooperativeLaunchTooLarge;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cooperative ? cudaLaunchCooperativeKernel(kernel, dim3(*blocks), dim3(kThreads), params,
                                                  layout(a).bytes, st)
                    : cudaLaunchKernel(kernel, dim3(*blocks), dim3(kThreads), params,
                                       layout(a).bytes, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}
#else
// the part whose kernel a launch with these arguments runs, or null (a
// head width the kernels do not take; the phase timer at 80 or 128)
int (*part_for(const MegaArgs& a))(const MegaArgs*, const void*, void*, int*) {
  switch (head_width(a)) {
    case kHeadDim:
      if (a.phases != nullptr) return a.act_quant ? fmt_mk_step_q_phases : fmt_mk_step_w_phases;
      return a.act_quant ? fmt_mk_step_q : fmt_mk_step_w;
    case 80:
      if (a.phases != nullptr) return nullptr;
      return a.act_quant ? fmt_mk_step_q80 : fmt_mk_step_w80;
    case 128:
      if (a.phases != nullptr) return nullptr;
      return a.act_quant ? fmt_mk_step_q128 : fmt_mk_step_w128;
    default:
      return nullptr;
  }
}

cudaError_t launch(const MegaArgs& a, void* stream) {
  if (!plan_ok(a) || part_for(a) == nullptr) return cudaErrorInvalidValue;
  Maps maps;
  const cudaError_t err = encode_all(a, &maps);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  return static_cast<cudaError_t>(part_for(a)(&a, &maps, stream, &blocks));
}

// a's grid: the blocks a launch takes (0 if a block cannot be resident)
cudaError_t step_grid(const MegaArgs& a, int* blocks) {
  if (part_for(a) == nullptr) return cudaErrorInvalidValue;
  return static_cast<cudaError_t>(part_for(a)(&a, nullptr, nullptr, blocks));
}

// the w8a8 linear alone: a's plan and shapes (b rows, linear p.lin's (n, K)
// from D and Dff), W the (n, K) weights of p.lin
cudaError_t launch_linear(const MegaArgs& a, const Lin& p, const int8_t* W, void* stream) {
  if (!a.act_quant || !plan_ok(a)) return cudaErrorInvalidValue;
  Maps maps{};
  int n, k, blocks = 0;
  lin_dims(a, p.lin, &n, &k);
  if (!encode_weights(&maps.m[p.lin], W, n, k)) return cudaErrorInvalidValue;
  return static_cast<cudaError_t>(fmt_mk_linear(&a, &maps, &p, stream, &blocks));
}
#endif

}  // namespace mk90
}  // namespace

#if defined(FMT_MK_STEP)
#if !defined(FMT_MK_HD)
#define FMT_MK_HD 64
#endif
// this part's step kernel: decode_megakernel_sm90<FMT_MK_Q, FMT_MK_PHASES, FMT_MK_HD>
extern "C" int FMT_MK_STEP(const MegaArgs* a, const void* maps, void* stream, int* blocks) {
  void* params[] = {const_cast<MegaArgs*>(a), const_cast<void*>(maps)};
  return static_cast<int>(mk90::part_launch(
      reinterpret_cast<const void*>(
          mk90::decode_megakernel_sm90<FMT_MK_Q, FMT_MK_PHASES, FMT_MK_HD>),
      *a, maps == nullptr ? nullptr : params, blocks, stream, true));
}
#endif

#if defined(FMT_MK_LINEAR)
extern "C" int fmt_mk_linear(const MegaArgs* a, const void* maps, const void* lin,
                             void* stream, int* blocks) {
  void* params[] = {const_cast<MegaArgs*>(a), const_cast<void*>(maps), const_cast<void*>(lin)};
  return static_cast<int>(mk90::part_launch(
      reinterpret_cast<const void*>(mk90::w8a8_linear_kernel), *a, params, blocks, stream,
      false));
}
#endif
