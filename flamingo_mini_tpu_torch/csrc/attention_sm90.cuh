// Hopper attention tile for bf16, head widths 64, 80 and 128 (kHD, a
// template parameter): fused_attention.cu's kFull and kStream modes for
// bf16 inputs (float32 inputs stay on attention_tile.cuh; bf16 kMedia runs
// media_xattn_sm90.cuh).
//
// Replaces, for bf16, flamingo_mini_tpu/ops/pallas_attn.py::fused_attention
// (_attn_kernel) and its streaming variant (_flash_kernel), with the same
// semantics as attention_tile.cuh's kernel in those modes: s = scale * q.k
// + bias + row_bias, causal positions float32 min; kStream keys in
// [n_kv, n_kv_pad) score float32 min with V = 0, kFull keys past n_kv -inf;
// online softmax from float32 min, so a fully masked row averages V over its
// masked keys; O = acc / max(l, 1e-30), rounded once to bf16.
//
// What bounds it: at the ViT's shape (32, 16, 257, 257) device memory (25
// MB, 0.020 ms at 3.35 TB/s), at (2, 16, 4000, 64) the tensor cores (131
// GFLOP, 0.13 ms at 989 TFLOP/s; P V in two parts makes it 197 executed).
// The design, for both:
//
// * Work items of 64 query rows of one (batch, head). A block is a producer
//   warpgroup and one consumer warpgroup, two blocks per SM, as many blocks
//   as fit at once; each walks the items blockIdx.x, + gridDim.x, ...
// * The producer, one thread of it, keeps TMA loads in flight: each item's
//   Q, then its K and V tiles of 128 keys through a ring of kStages stages
//   that runs on from one item into the next, each stage with a full
//   barrier (TMA's byte count) and an empty one (every consumer thread
//   arrives once its products are done). Its registers go to the consumer
//   (setmaxnreg 24 / 232).
// * TMA reads the inputs in place through 4-D tensor maps over (d, h, n, b)
//   built from the wrapper's strides, and writes shared memory in the
//   128-byte swizzle that wgmma's descriptors read (a row of 64 bf16 is 128
//   bytes). Rows past n are filled with zeros: the key tail and the
//   streaming padding need no copy of their own.
// * S = Q K^T by wgmma m64n128k16, both operands in shared memory (K-major);
//   an item's last tile only as wide as its keys need (16, 64 or 128: the
//   ViT's 257 keys leave 1). The softmax runs in registers, exp2 with
//   scale * log2(e) folded into one FMA; masks, bias and row bias only on
//   the tiles that need them (the key tail, tiles that reach past the
//   diagonal under causal, every tile under a bias or row bias).
// * O += P V with P kept in float32 as two bf16 parts (hi: P's top 16
//   bits, lo: the rest rounded; 16 significant bits) as attention_tile.cuh
//   keeps it: two wgmma m64n64k16 per 16 keys, A from registers (the S
//   accumulator is the A fragment layout), V MN-major from shared memory.
//   Each tile's P V is summed in a fresh accumulator and added as
//   o = o * alpha + t in float32.
//
// Why one consumer warpgroup and no overlap inside it: with two blocks per
// SM one block's softmax runs while the other's products do. Two consumer
// warpgroups sharing a 128-row block ran slower at the ViT's shape, and
// issuing tile i's Q K^T beside tile i - 1's P V needs both tiles' registers
// (S, P in two parts, t and o), which spilled. P in one bf16 part would
// halve P V's products but misses the 2-ulp check at the forwards' shapes.
//
// Wider heads (opt-2.7b's 80, opt-6.7b's 128; `Shape`): a row is two
// 64-dim halves, each in a region of its own in the 128-byte swizzle and
// loaded by a TMA box of its own (64 x 2 bytes, the swizzle's atom); at 80
// the second box reaches past the tensor's 80 dims and TMA fills dims
// 80-127 with zeros, which add nothing to Q K^T. Q K^T takes kHD / 16 K
// steps (5 or 8: the zeros past 80 are not multiplied), P V two m64n64k16
// products per part and 16 keys, one a half (at 80 dims 80-127 of the
// second are zeros and not stored). With two halves of o and t in the
// registers a tile is 64 keys (S and P of 64 keys), so the registers a
// thread holds stay those of the 64-wide tile.
//
// Every key tile is visited, causally masked ones too.
#pragma once

#include "attention_tile.cuh"
#include "sm90_common.cuh"

namespace {
namespace sm90 {

constexpr int kStages = 2;                       // K/V ring depth
constexpr int kHalfRow = 128;                    // 64 bf16 dims: the swizzle's atom
constexpr int kBlocksPerSM = 2;
constexpr int kThreads = 256;                    // producer and consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

// The tile's shape at head width kHD: a row's kHalves 64-dim halves, each
// a region of its own; keys per tile; and the shared memory: Q, then the K
// and V rings (a tile's halves one after the other).
template <int kHD>
struct Shape {
  static_assert(kHD == 64 || kHD == 80 || kHD == 128, "head widths 64, 80, 128");
  static constexpr int kHalves = (kHD + 63) / 64;
  static constexpr int kBlockK = kHalves == 1 ? 128 : 64;  // keys per tile
  static constexpr int kHalfQ = 64 * kHalfRow;             // a half of an item's Q rows
  static constexpr int kQBytes = kHalves * kHalfQ;
  static constexpr int kHalfTile = kBlockK * kHalfRow;     // a half of a K or V tile
  static constexpr int kTileBytes = kHalves * kHalfTile;
  static constexpr int q = 0;
  static constexpr int k = kQBytes;
  static constexpr int v = k + kStages * kTileBytes;
  static constexpr int bytes = v + kStages * kTileBytes;
  static constexpr int alloc = bytes + 1024;  // the base is rounded up to 1024
};

// where (h, n, b) go among a tensor map's dims 1-3 (sorted by stride)
struct MapOrder {
  int h, n, b;
};

struct Orders {
  MapOrder q, k, v;
};

// rows of (head, batch) from `row`, dims from d0, by the coordinates in a
// map's dim order
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, MapOrder o,
                                         uint32_t bar, int hd, int row, int b, int d0) {
  int c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) c[i] = o.h == i ? hd : (o.n == i ? row : b);
  tma_load_4d(dst, map, bar, d0, c[0], c[1], c[2]);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][2][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(r[i][j][k]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x N, float32) (+)= A (64 x 16) B^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, float32) (+)= A (64 x 16, bf16 fragments in registers) B,
// B MN-major (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int kN>
__device__ __forceinline__ void wgmma_ss(float (&d)[kN / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (kN == 16) wgmma_ss_n16(d, da, db, acc);
  if constexpr (kN == 64) wgmma_ss_n64(d, da, db, acc);
  if constexpr (kN == 128) wgmma_ss_n128(d, da, db, acc);
}

// S = Q K^T for the first kN keys of a tile, issued and committed (not
// waited for): acc[4 j + 2 h2 + c] is row g + 8 h2 of the warp, key
// 8 j + 2 t4 + c. K step kk (16 dims) is in half kk / 4 of each row.
template <int kN, int kHD>
__device__ __forceinline__ void issue_qk(float (&acc)[kN / 2], uint64_t dq, uint64_t dk) {
  using S = Shape<kHD>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk)
    wgmma_ss<kN>(acc, dq + (kk / 4) * (S::kHalfQ >> 4) + 2 * (kk % 4),
                 dk + (kk / 4) * (S::kHalfTile >> 4) + 2 * (kk % 4), kk > 0);
  wgmma_commit();
}

// t = P V over kN keys, P as two bf16 parts, issued and committed; t[h] the
// dims of half h
template <int kN, int kHD>
__device__ __forceinline__ void issue_pv(float (&t)[Shape<kHD>::kHalves][32],
                                         const uint32_t (&pa)[kN / 16][2][4], uint64_t dv) {
  using S = Shape<kHD>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
    for (int h = 0; h < S::kHalves; ++h) {
      wgmma_rs_n64(t[h], pa[kk][0], dv + h * (S::kHalfTile >> 4) + 128 * kk, kk > 0);
      wgmma_rs_n64(t[h], pa[kk][1], dv + h * (S::kHalfTile >> 4) + 128 * kk, 1);
    }
  wgmma_commit();
}

// P (float32, in acc) as A fragments of 16 keys in two bf16 parts, hi the
// top 16 bits of each float, lo = p - hi (exact in float32) rounded: reg r
// of step kk holds the pair acc[4 (2 kk + r / 2) + 2 (r % 2) + {0, 1}]
template <int kN>
__device__ __forceinline__ void pack_p(const float (&acc)[kN / 2], uint32_t (&pa)[kN / 16][2][4]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * (2 * kk + r / 2) + 2 * (r % 2);
      const uint32_t x0 = __float_as_uint(acc[i]), x1 = __float_as_uint(acc[i + 1]);
      const float h0 = __uint_as_float(x0 & 0xffff0000u), h1 = __uint_as_float(x1 & 0xffff0000u);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i] - h0, acc[i + 1] - h1);
      pa[kk][0][r] = __byte_perm(x0, x1, 0x7632);
      pa[kk][1][r] = *reinterpret_cast<const uint32_t*>(&lo);
    }
}

// what a consumer thread needs of its rows to mask a tile
struct Rows {
  int row[2];  // the thread's two query rows
  int row0;    // the item's first row
  int b, bh;
};

// The online softmax of kN keys from key0, first half: the new row max in
// m, alpha = exp(m_old - m_new). Returns whether the tile needs masks (the
// key tail, the diagonal under causal, a bias or row bias, scale <= 0):
// then acc now holds the scores scale * q.k + bias + row_bias, masked, else
// it still holds q.k. Keys at or past key0 + kN (past n_keys: a narrower
// last tile) weigh nothing.
template <int kMode, int kN>
__device__ __forceinline__ bool row_max(float (&acc)[kN / 2], float (&m)[2], float (&alpha)[2],
                                        const AttnArgs& a, const Rows& r, int key0, int n_keys,
                                        bool plain) {
  const bool edge = !plain || key0 + kN > a.n_kv || (a.causal && key0 + kN - 1 > r.row0);
  const int t4 = threadIdx.x % 4;
  float rb[kN / 8][2];  // the row bias of this thread's keys, read once for both rows
  if (edge) {
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = key0 + 8 * j + 2 * t4 + c;
        rb[j][c] = a.row_bias != nullptr && key < a.n_kv
                       ? a.row_bias[static_cast<long long>(r.b) * a.n_kv + key] : 0.f;
      }
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float mx = kNeg;
    if (!edge) {
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
        mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * h2], acc[4 * j + 2 * h2 + 1]));
      mx = quad_max(mx) * a.scale;  // scale > 0
    } else {
      const int i = r.row[h2];
      const float* brow = kMode == kFull && a.bias != nullptr && i < a.n_q
                              ? a.bias + (static_cast<long long>(r.bh) * a.n_q + i) * a.n_kv
                              : nullptr;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = key0 + 8 * j + 2 * t4 + c;
          float x = acc[4 * j + 2 * h2 + c] * a.scale;
          if (key >= a.n_kv) {
            x = (kMode == kStream && key < n_keys) ? kNeg : -INFINITY;
          } else {
            if (brow != nullptr) x += brow[key];
            x += rb[j][c];
            if (a.causal && key > i) x = kNeg;
          }
          acc[4 * j + 2 * h2 + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = quad_max(mx);
    }
    const float m_new = fmaxf(m[h2], mx);
    alpha[h2] = ex2((m[h2] - m_new) * kLog2e);
    m[h2] = m_new;
  }
  return edge;
}

// second half: acc to P in place, sum = this thread's part of each row's
// sum. Without masks one FMA per key: 2^(q.k * scale * log2 e - m log2 e).
template <int kN>
__device__ __forceinline__ void exps(float (&acc)[kN / 2], const float (&m)[2], bool edge,
                                     float scale, float (&sum)[2]) {
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const float sc = edge ? kLog2e : scale * kLog2e;
    if (!edge) {
      const float ml = m[h2] * kLog2e;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = ex2(fmaf(acc[4 * j + 2 * h2 + c], sc, -ml));
          acc[4 * j + 2 * h2 + c] = e;
          sum[h2] += e;
        }
    } else {
      // (x - m) first: x = m = float32 min is a fully masked row's 1
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = ex2((acc[4 * j + 2 * h2 + c] - m[h2]) * sc);
          acc[4 * j + 2 * h2 + c] = e;
          sum[h2] += e;
        }
    }
  }
}

// the consumer's view of the ring, and its running softmax. Tile `it` of
// the current item is the ring's tile g0 + it.
template <int kHD>
struct Consumer {
  using S = Shape<kHD>;
  static constexpr int kH = S::kHalves;
  uint32_t k, v, bar_k, bar_v, bar_e, bar_qe;  // shared-memory addresses
  uint64_t dq;                          // Q's descriptor (its first half's)
  int g0, n_keys;
  bool plain;                           // no bias, no row bias, scale > 0
  Rows r;
  float m[2], l[2];
  float o[kH][32], t[kH][32];           // o and a tile's P V, a half each

  __device__ __forceinline__ int stage(int it) const { return (g0 + it) % kStages; }
  __device__ __forceinline__ uint32_t phase(int it) const {
    return static_cast<uint32_t>(((g0 + it) / kStages) & 1);
  }
  __device__ __forceinline__ uint64_t desc(uint32_t ring, int it) const {
    return desc_sw128(ring + stage(it) * S::kTileBytes);
  }

  // Tile `it`, kN of its keys: Q K^T; the softmax; P V in a fresh
  // accumulator; then o = o * alpha + t and the stage released. last: the
  // item's last tile, whose Q K^T done releases Q.
  template <int kMode, int kN>
  __device__ __forceinline__ void tile(const AttnArgs& a, int it, bool last) {
    float acc[kN / 2], alpha[2], sum[2] = {0.f, 0.f};
    uint32_t pa[kN / 16][2][4];
    mbar_wait(bar_k + 8 * stage(it), phase(it));
    issue_qk<kN, kHD>(acc, dq, desc(k, it));
    wgmma_wait_all();
    fence_regs(acc);
    if (last) mbar_arrive(bar_qe);
    const bool edge = row_max<kMode, kN>(acc, m, alpha, a, r, it * S::kBlockK, n_keys, plain);
    exps<kN>(acc, m, edge, a.scale, sum);
    pack_p<kN>(acc, pa);
    mbar_wait(bar_v + 8 * stage(it), phase(it));
    issue_pv<kN, kHD>(t, pa, desc(v, it));
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) l[h2] = l[h2] * alpha[h2] + quad_sum(sum[h2]);
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < kH; ++h) fence_regs(t[h]);
    fence_regs(pa);
    mbar_arrive(bar_e + 8 * stage(it));
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[h][i] = o[h][i] * alpha[(i / 2) % 2] + t[h][i];
  }
};

// an item's tiles, the last one kTail keys wide (16, 64 or 128: the fewest
// that hold its keys; the rest of the tile is not computed). Q is released
// once the last Q K^T is done, so that the next item's Q can arrive.
template <int kMode, int kTail, int kHD>
__device__ __forceinline__ void consume(Consumer<kHD>& c, const AttnArgs& a, int n_tiles) {
  for (int it = 0; it + 1 < n_tiles; ++it)
    c.template tile<kMode, Shape<kHD>::kBlockK>(a, it, false);
  c.template tile<kMode, kTail>(a, n_tiles - 1, true);
}

struct Items {
  int n, row_blocks;  // items, and 64-row blocks per (batch, head)
};

// the consumer's walk over the items, every last tile kTail wide
template <int kMode, int kTail, int kHD>
__device__ __forceinline__ void consumer_loop(Consumer<kHD>& c, const AttnArgs& a, Items items,
                                              int n_tiles, uint32_t bar_qf) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, t4 = tid % 4;
  int j = 0;  // this block's items so far
  for (int item = blockIdx.x; item < items.n; item += gridDim.x, ++j, c.g0 += n_tiles) {
    const int bh = item / items.row_blocks;
    c.r.b = bh / a.h;
    c.r.bh = bh;
    c.r.row0 = (item % items.row_blocks) * 64;
    c.r.row[0] = c.r.row0 + warp * 16 + g;
    c.r.row[1] = c.r.row[0] + 8;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      c.m[h2] = kNeg;
      c.l[h2] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < Consumer<kHD>::kH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) c.o[h][i] = 0.f;
    mbar_wait(bar_qf, j & 1);
    consume<kMode, kTail>(c, a, n_tiles);

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + c.r.b * a.stride[3][0] +
                         (bh % a.h) * a.stride[3][1];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      if (c.r.row[h2] >= a.n_q) continue;
      const float den = fmaxf(c.l[h2], 1e-30f);
      __nv_bfloat16* orow = out + c.r.row[h2] * a.stride[3][2];
#pragma unroll
      for (int h = 0; h < Consumer<kHD>::kH; ++h)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          if (64 * h + 8 * jj < kHD)  // at 80 the second half's dims 80-127 are not stored
            store2(orow + 64 * h + 8 * jj + 2 * t4, c.o[h][4 * jj + 2 * h2] / den,
                   c.o[h][4 * jj + 2 * h2 + 1] / den);
    }
  }
}

template <int kMode, int kHD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const AttnArgs a,
                      const Orders ord, const Items items) {
  using S = Shape<kHD>;
  extern __shared__ uint8_t smem_raw[];
  // Q full, Q empty; K full, V full, empty per stage
  __shared__ __align__(8) uint64_t bars[2 + 3 * kStages];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_qf = smem_addr(&bars[0]);
  const uint32_t bar_qe = smem_addr(&bars[1]);
  const uint32_t bar_k = smem_addr(&bars[2]);  // + 8 * stage
  const uint32_t bar_v = smem_addr(&bars[2 + kStages]);
  const uint32_t bar_e = smem_addr(&bars[2 + 2 * kStages]);
  const int n_keys = kMode == kStream ? a.n_kv_pad : a.n_kv;
  const int n_tiles = (n_keys + S::kBlockK - 1) / S::kBlockK;

  if (threadIdx.x == 0) {
    prefetch_map(&tq);
    prefetch_map(&tk);
    prefetch_map(&tv);
    mbar_init(bar_qf, 1);
    mbar_init(bar_qe, 128);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int g = 0, j = 0;  // ring tiles and items so far
      for (int item = blockIdx.x; item < items.n; item += gridDim.x, ++j) {
        const int bh = item / items.row_blocks, b = bh / a.h, hd = bh % a.h;
        if (j > 0) mbar_wait(bar_qe, (j - 1) & 1);
        mbar_expect_tx(bar_qf, S::kQBytes);
        for (int h = 0; h < S::kHalves; ++h)
          tma_rows(base + S::q + h * S::kHalfQ, &tq, ord.q, bar_qf, hd,
                   (item % items.row_blocks) * 64, b, 64 * h);
        for (int it = 0; it < n_tiles; ++it, ++g) {
          const int s = g % kStages, round = g / kStages;
          if (round > 0) mbar_wait(bar_e + 8 * s, (round - 1) & 1);
          mbar_expect_tx(bar_k + 8 * s, S::kTileBytes);
          for (int h = 0; h < S::kHalves; ++h)
            tma_rows(base + S::k + s * S::kTileBytes + h * S::kHalfTile, &tk, ord.k,
                     bar_k + 8 * s, hd, it * S::kBlockK, b, 64 * h);
          mbar_expect_tx(bar_v + 8 * s, S::kTileBytes);
          for (int h = 0; h < S::kHalves; ++h)
            tma_rows(base + S::v + s * S::kTileBytes + h * S::kHalfTile, &tv, ord.v,
                     bar_v + 8 * s, hd, it * S::kBlockK, b, 64 * h);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  Consumer<kHD> c;
  c.k = base + S::k;
  c.v = base + S::v;
  c.bar_k = bar_k;
  c.bar_v = bar_v;
  c.bar_e = bar_e;
  c.bar_qe = bar_qe;
  c.dq = desc_sw128(base + S::q);
  c.g0 = 0;
  c.n_keys = n_keys;
  c.plain = a.scale > 0.f && a.bias == nullptr && a.row_bias == nullptr;
  const int tail = n_keys - (n_tiles - 1) * S::kBlockK;
  if (tail <= 16) {
    consumer_loop<kMode, 16>(c, a, items, n_tiles, bar_qf);
  } else if (S::kBlockK == 64 || tail <= 64) {
    consumer_loop<kMode, 64>(c, a, items, n_tiles, bar_qf);
  } else {
    consumer_loop<kMode, S::kBlockK>(c, a, items, n_tiles, bar_qf);
  }
}

// ---------------------------------------------------------------------------
// host side

// a 4-D map over (d, h, n, b) of a bf16 tensor of d dims with element
// strides (b, h, n) and a contiguous d, its box 64 x 1 x rows x 1, 128-byte
// swizzle, rows past n and dims past d zero-filled. Dims 1-3 are ordered by
// stride (size-1 dims last), `order` says where each went.
bool encode_map(CUtensorMap* map, const void* ptr, const long long (&stride)[3], int b, int h,
                int n, int d, int rows, MapOrder* order) {
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const long long size[3] = {h, n, b}, el[3] = {stride[1], stride[2], stride[0]};
  long long widest = d;
  for (int i = 0; i < 3; ++i)
    if (size[i] > 1 && el[i] > widest) widest = el[i];
  int idx[3] = {0, 1, 2};
  auto key = [&](int i) { return size[i] > 1 ? el[i] : (1LL << 62) + i; };
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (key(idx[j]) < key(idx[i])) {
        const int t = idx[i];
        idx[i] = idx[j];
        idx[j] = t;
      }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), 0, 0, 0};
  cuuint64_t bytes[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(kHalfRow / 2), 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int pos[3];
  for (int p = 0; p < 3; ++p) {
    const int i = idx[p];
    pos[i] = p;
    dims[p + 1] = static_cast<cuuint64_t>(size[i]);
    bytes[p] = static_cast<cuuint64_t>(size[i] > 1 ? el[i] : widest) * 2;
    if (i == 1) box[p + 1] = static_cast<cuuint32_t>(rows);
  }
  *order = MapOrder{pos[0], pos[1], pos[2]};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, bytes,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

}  // namespace sm90

// bf16 attention in the kFull or kStream mode on the Hopper tile at head
// width kHD; a shape its tensor maps refuse returns cudaErrorInvalidValue
// (nothing launched)
template <int kMode, int kHD = kD>
cudaError_t launch_attention_sm90(const AttnArgs* args, void* stream) {
  static_assert(kMode == kFull || kMode == kStream,
                "bf16 kMedia runs media_xattn_sm90.cuh, float32 kMedia attention_tile.cuh");
  using S = sm90::Shape<kHD>;
  const AttnArgs& a = *args;
  CUtensorMap tq, tk, tv;
  sm90::Orders ord;
  if (!sm90::encode_map(&tq, a.q, a.stride[0], a.b, a.h, a.n_q, kHD, 64, &ord.q) ||
      !sm90::encode_map(&tk, a.k, a.stride[1], a.b, a.h, a.n_kv, kHD, S::kBlockK, &ord.k) ||
      !sm90::encode_map(&tv, a.v, a.stride[2], a.b, a.h, a.n_kv, kHD, S::kBlockK, &ord.v))
    return cudaErrorInvalidValue;
  // shared memory above 48 KB, allowed on whichever device is current
  const cudaError_t attr = cudaFuncSetAttribute(sm90::attention_sm90_kernel<kMode, kHD>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                S::alloc);
  if (attr != cudaSuccess) return attr;
  const int row_blocks = (a.n_q + 63) / 64;
  const long long n_items = static_cast<long long>(a.b) * a.h * row_blocks;
  const long long slots = static_cast<long long>(sm90::sm_count()) * sm90::kBlocksPerSM;
  if (slots <= 0 || n_items > 0x7fffffff) return cudaErrorInvalidValue;
  const sm90::Items items{static_cast<int>(n_items), row_blocks};
  const int grid = static_cast<int>(n_items < slots ? n_items : slots);
  sm90::attention_sm90_kernel<kMode, kHD>
      <<<grid, sm90::kThreads, S::alloc, static_cast<cudaStream_t>(stream)>>>(
          tq, tk, tv, a, ord, items);
  return cudaGetLastError();
}

}  // namespace
