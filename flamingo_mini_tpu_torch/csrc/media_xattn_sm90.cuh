// Media-masked cross-attention for bf16 on Hopper, head dim 64:
// media_xattn.cu's route for every bf16 call (float32 stays on
// attention_tile.cuh's kMedia mode).
//
// Replaces, for bf16, flamingo_mini_tpu/ops/pallas_xattn.py::
// fused_media_xattn (kernel _xattn_kernel) with its semantics: scores
// scale * q.k in float32; key j valid for row i iff text_time[i] ==
// j / n_visual + 1, else float32 min; a max-subtracted float32 softmax,
// normalised before the V product; rows with text_time 0 zeroed; P V summed
// in float32 and rounded once. A row past the media count (or below 1 and
// not 0) is fully masked and averages V over every key.
//
// What bounds it: nothing the card runs out of. The model paths' calls move
// 2-5 MB (0.0013 ms at 3.35 TB/s at the prefill's (32, 8, 4 -> 64)) and do
// 17-67 MFLOP (under 0.1 us at the bf16 rate), so the time is the length
// of each block's serial chain and how much of the card holds a chain. The
// tile this replaces gave every (batch, head) a block of four warps over
// 64 query rows (at the prefill 3 of 4 warps hold no row, at the forward
// half the card idles), walked the keys a 64-key tile at a time with an
// online softmax, and masked every key it visited. Here:
//
// * Items sized to the rows there are. A warp owns one 16-row slice of one
//   (batch, head) on mma.sync m16n8k16 (bf16 operands, float32
//   accumulation): the prefill's 4 rows are padded to 16 in registers, not
//   to 64. A block holds `slices` slices of one (batch, head) (the plan,
//   ops/media_xattn.py's plan(): one at under 32 rows, two sharing a slab
//   from 32 rows; 256 blocks at the prefill, 128 at the forwards, one wave).
// * Only the keys the rows need. The keys are cut into tiles of 16. A row
//   with 1 <= text_time <= n_media needs its medium's tiles, a row past
//   the media count every tile, a row with text_time 0 none. Each slice's
//   need within a window of 64 tiles is a 64-bit mask; the block loads the
//   union of its slices' masks, packed, and each warp computes only its own
//   slice's tiles. A slice whose rows all have text_time 0 (or lie past
//   n_q) reads no K or V and writes zeros without a product. This is exact:
//   a row with a valid key has a finite max m, a masked score is float32
//   min, and exp(float32 min - m) is 0 in float32, so a key outside the
//   row's medium adds exactly 0 to its sum and its P V. Keys of a loaded
//   tile past n_kv are zero-filled and score -inf (weight 0).
// * The whole needed slab in flight at once. Q is read into registers
//   first; then text_time; then every needed K and V row is issued by
//   16-byte cp.async (one commit group) before any product. K and V are read
//   in place through their strides (the (b, n, h * d) projection layout
//   that split_heads views), the output written (b, n, h, d) through its
//   own. A block's shared memory holds min(n_kv / 16, kMaxSlots) tiles
//   (16 at most: 256 keys, 72 KB), fixed at launch.
// * Any n_kv. A window starts at the least tile at or after the previous
//   window's end that some row of the block needs, so a block's first
//   window holds every need of rows that attend media within 1,024 keys of
//   each other. Where the first window holds every need and their union
//   fits the slots (always up to 256 keys, so on every model path), the
//   slab is loaded once and stays resident. Otherwise the block streams:
//   for each of three passes (max, sum, P V) it walks its windows and each
//   window's union kMaxSlots tiles at a time, loading each group, then
//   computing on it, every warp in step. Up to 256 keys every block is
//   resident, and the kernel is built without the walk (kStreams false), so
//   the model paths' calls carry none of its state in registers.
// * A one-pass softmax over resident scores. A warp holds the scores of up
//   to kChunk tiles (64 keys: one medium of 64 latents) in registers: the
//   row max, then exp, sum and P = e x (1 / sum) before P V, as
//   _xattn_kernel normalises; no online rescale. A slice that needs more
//   tiles, or a block that streams, recomputes Q K^T in three passes (max,
//   sum, P V), each over chunks of kChunk tiles in the same order. Every
//   path shares one loop body: each instruction of the chain costs its
//   latency on one warp, and a second copy of the body (or 128-key chunks)
//   measured slower (PERF.md §6 row 7). P enters P V in float32 as two
//   bf16 parts against bf16 V (16 significant bits), as attention_tile.cuh
//   keeps it, so no path rounds P to bf16.
//
// Where the time goes at the model paths' shapes (PERF.md §6 row 7): the
// launch, then the slab's load after text_time, then one warp's serial
// mma.sync chain.
//
// NaN contract. The TPU kernel multiplies every key's V by its weight, so
// a NaN or inf in the V of a medium a row does not attend turns that row
// into NaN (0 x inf); this kernel reads only the tiles some row of the slice
// needs, so where no row of the slice attends that medium the row stays
// finite. A row in a slice whose other rows attend other media gets its
// zero weights multiplied by the V the slice loaded, as on the TPU. (A NaN
// in K of a medium a row does not attend is masked away on both, since the
// mask replaces the score.) No model path makes a non-finite K or V.
#pragma once

#include <climits>

#include "attention_tile.cuh"

namespace {
namespace mx {

constexpr int kTileKeys = 16;                        // one k-step of P V
constexpr int kWindowTiles = 64;                     // a window's need mask: 64 bits
constexpr int kMaxSlots = 16;                        // tiles a block holds in shared memory
constexpr int kChunk = 4;                            // tiles whose scores a warp holds
constexpr int kMaxWarps = 8;                         // slices a block
constexpr int kTileBytes = kTileKeys * kPitch * 2;   // one K or V tile in shared memory
constexpr int kSlotBytes = 2 * kTileBytes;           // a loaded tile: K, then V

typedef __nv_bfloat16 bf16;

// the tiles a block's shared memory holds; mirrored by ops/media_xattn.make_plan
__host__ __device__ constexpr int slots(int n_kv) {
  return (n_kv + kTileKeys - 1) / kTileKeys < kMaxSlots ? (n_kv + kTileKeys - 1) / kTileKeys
                                                         : kMaxSlots;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "r"(in ? 16 : 0));
}

// four 8x8 bf16 matrices from shared memory, one row address per lane;
// trans: each matrix transposed
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  if (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  }
}

// tiles [lo, hi) as bits, 0 <= lo < hi <= 64
__device__ __forceinline__ unsigned long long tile_bits(int lo, int hi) {
  const unsigned long long below = hi >= 64 ? ~0ull : (1ull << hi) - 1;
  return below & ~((1ull << lo) - 1);
}

// the keys [lo, hi) a row attends: its medium's, none for text_time 0 or a
// row past the media count (whose keys are all masked)
__device__ __forceinline__ int2 valid_keys(int tt, int n_kv, int n_visual) {
  const int n_media = (n_kv + n_visual - 1) / n_visual;
  if (tt < 1 || tt > n_media) return make_int2(0, 0);
  return make_int2((tt - 1) * n_visual, min(tt * n_visual, n_kv));
}

// the tiles [lo, hi) a row needs: its medium's, every tile past the media
// count, none for text_time 0
__device__ __forceinline__ int2 row_tiles(int tt, int n_kv, int n_visual) {
  if (tt == 0) return make_int2(0, 0);
  const int2 r = valid_keys(tt, n_kv, n_visual);
  if (r.x == r.y) return make_int2(0, (n_kv + kTileKeys - 1) / kTileKeys);
  return make_int2(r.x / kTileKeys, (r.y + kTileKeys - 1) / kTileKeys);
}

// the first `n` tiles of `bits`
__device__ __forceinline__ unsigned long long first_tiles(unsigned long long bits, int n) {
  unsigned long long out = 0;
  for (int i = 0; i < n && bits; ++i, bits &= bits - 1) out |= bits & (~bits + 1);
  return out;
}

// the next kChunk tiles of `rest` (-1 past its last), taken off it
__device__ __forceinline__ void next_chunk(unsigned long long& rest, int (&tl)[kChunk]) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    tl[i] = rest ? __ffsll(static_cast<long long>(rest)) - 1 : -1;
    rest &= rest - 1;
  }
}

// The block's window from tile `from` on, every thread of the block calling:
// its first tile w0 (-1 where no row needs a tile at or past `from`), each
// slice's need of tiles [w0, w0 + 64) as bits from w0 (s_need), their union
// (`loaded`), and whether a row needs a tile past the window (`more`). `r`:
// this thread's row's tiles (threads past the block's rows: none).
template <bool kStreams>
__device__ __forceinline__ int window(int from, int2 r, int slices, int n_tiles,
                                      unsigned long long* s_need, int* s_first,
                                      unsigned long long& loaded, bool& more) {
  const int t = threadIdx.x;
  int w0 = 0;
  if (kStreams && n_tiles > kWindowTiles) {
    const int first = __reduce_min_sync(0xffffffffu, r.y > from ? max(r.x, from) : INT_MAX);
    __syncthreads();  // the last call's readers of s_first are done
    if ((t & 31) == 0) s_first[t >> 5] = first;
    __syncthreads();
    w0 = INT_MAX;
    for (int w = 0; w < (slices + 1) / 2; ++w) w0 = min(w0, s_first[w]);
    if (w0 == INT_MAX) return -1;
  } else if (from > 0) {
    return -1;  // one window from tile 0 holds every need
  }
  const int lo = max(r.x, w0), hi = min(r.y, w0 + kWindowTiles);
  unsigned long long need = lo < hi ? tile_bits(lo - w0, hi - w0) : 0ull;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) need |= __shfl_xor_sync(0xffffffffu, need, o);
  if (t < slices * 16 && (t & 15) == 0) s_need[t >> 4] = need;
  more = __syncthreads_or(r.y > w0 + kWindowTiles);
  loaded = 0;
  for (int s = 0; s < slices; ++s) loaded |= s_need[s];
  return loaded ? w0 : -1;
}

// Where a warp's operands are: the block's packed slab and what it holds,
// `loaded` tiles counted from the window's first tile w0 (a tile's slot is
// the count of loaded tiles below it).
struct Slab {
  const unsigned char* base;
  unsigned long long loaded;
  __device__ __forceinline__ const bf16* k(int tile) const {
    const int slot = __popcll(loaded & ((1ull << tile) - 1));
    return reinterpret_cast<const bf16*>(base + slot * kSlotBytes);
  }
  __device__ __forceinline__ const bf16* v(int tile) const {
    return reinterpret_cast<const bf16*>(reinterpret_cast<const unsigned char*>(k(tile)) +
                                         kTileBytes);
  }
};

// s[2i + half][C reg] = the scaled, masked score of this warp's row g + 8 *
// (reg / 2) and key key0 + tl[i] * 16 + half * 8 + 2 * t4 + reg % 2:
// float32 min off the row's keys [kr.x, kr.y), -inf past n_kv and on tiles
// past the chunk's end
__device__ __forceinline__ void scores(const Slab& slab, const uint32_t (&qa)[4][4],
                                       const int (&tl)[kChunk], const int2 (&kr)[2],
                                       int key0, int n_kv, float scale,
                                       float (&s)[2 * kChunk][4]) {
  const int lane = threadIdx.x & 31, t4 = lane & 3, j = lane >> 3;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) s[2 * i][r] = s[2 * i + 1][r] = 0.f;
    if (tl[i] < 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) s[2 * i][r] = s[2 * i + 1][r] = -INFINITY;
      continue;
    }
    const bf16* kt = slab.k(tl[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // matrices: (keys 0-7, dims lo), (0-7, hi), (8-15, lo), (8-15, hi)
      uint32_t b[4];
      ldmatrix_x4<false>(b, kt + ((j >> 1) * 8 + (lane & 7)) * kPitch + kk * 16 + (j & 1) * 8);
      mma_bf16(s[2 * i], qa[kk], b[0], b[1]);
      mma_bf16(s[2 * i + 1], qa[kk], b[2], b[3]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = key0 + tl[i] * kTileKeys + half * 8 + 2 * t4 + (r & 1);
        const int2 rk = kr[r >> 1];
        float x = s[2 * i + half][r] * scale;
        if (key >= n_kv) x = -INFINITY;
        else if (key < rk.x || key >= rk.y) x = kNeg;
        s[2 * i + half][r] = x;
      }
    }
  }
}

__device__ __forceinline__ void row_max(const float (&s)[2 * kChunk][4], float (&m)[2]) {
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float x = m[h2];
#pragma unroll
    for (int nt = 0; nt < 2 * kChunk; ++nt) x = fmaxf(x, fmaxf(s[nt][2 * h2], s[nt][2 * h2 + 1]));
    m[h2] = quad_max(x);
  }
}

// s = exp(s - m); with `add`, l += the rows' sums of it
__device__ __forceinline__ void exp_sum(float (&s)[2 * kChunk][4], const float (&m)[2],
                                        float (&l)[2], bool add) {
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2 * kChunk; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e = __expf(s[nt][2 * h2 + c] - m[h2]);
        s[nt][2 * h2 + c] = e;
        sum += e;
      }
    }
    if (add) l[h2] += quad_sum(sum);
  }
}

// o[dim n-tile][C reg] += P V over the chunk's tiles, P in two bf16 parts
__device__ __forceinline__ void pv(const Slab& slab, const int (&tl)[kChunk],
                                   const float (&p)[2 * kChunk][4], float (&o)[8][4]) {
  const int lane = threadIdx.x & 31, j = lane >> 3;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (tl[i] < 0) continue;
    // A fragments of the tile's 16 keys: (row g, keys 2t4..), (row g + 8,
    // ..), (row g, keys 8 + 2t4..), (row g + 8, ..)
    uint32_t pa[2][4];
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const float* src = &p[2 * i + (reg >> 1)][2 * (reg & 1)];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(src[0], src[1]);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(src[0] - hf.x, src[1] - hf.y);
      pa[0][reg] = *reinterpret_cast<const uint32_t*>(&hi);
      pa[1][reg] = *reinterpret_cast<const uint32_t*>(&lo);
    }
    const bf16* vt = slab.v(tl[i]);
#pragma unroll
    for (int dn = 0; dn < 8; dn += 2) {
      // matrices, transposed: (keys 0-7, dims dn), (8-15, dn), (0-7, dn + 1), (8-15, dn + 1)
      uint32_t b[4];
      ldmatrix_x4<true>(b, vt + ((j & 1) * 8 + (lane & 7)) * kPitch + (dn + (j >> 1)) * 8);
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        mma_bf16(o[dn], pa[part], b[0], b[1]);
        mma_bf16(o[dn + 1], pa[part], b[2], b[3]);
      }
    }
  }
}

// the K and V rows of the tiles `tiles` (counted from tile w0) of one
// (batch row, head) into shared memory by 16-byte cp.async: packed in tile
// order, K then V, 16 keys x 8 chunks of 16 bytes a tile, keys past n_kv
// zero-filled
__device__ __forceinline__ void issue_slab(unsigned char* smem, const AttnArgs& a, int b,
                                           int head, int w0, unsigned long long tiles) {
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.stride[1][0] + head * a.stride[1][1];
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.stride[2][0] + head * a.stride[2][1];
  int slot = 0;
  for (unsigned long long bits = tiles; bits; bits &= bits - 1, ++slot) {
    const int tile = w0 + __ffsll(static_cast<long long>(bits)) - 1;
    for (int c = threadIdx.x; c < 2 * kTileKeys * 8; c += blockDim.x) {
      const int col = (c & 7) * 8, r = (c >> 3) & 15, kv = c >> 7;
      const int key = tile * kTileKeys + r;
      const bool in = key < a.n_kv;
      const long long at = (in ? key : 0);
      const bf16* src = kv ? v + at * a.stride[2][2] + col : k + at * a.stride[1][2] + col;
      cp_async16(smem + slot * kSlotBytes + kv * kTileBytes + (r * kPitch + col) * 2, src, in);
    }
  }
}

// blockIdx.x = (batch row * h + head) * slice groups + slice group; warp w
// holds slice w of the block's group. kStreams: n_kv past the slots, where
// a block may stream (without it every block is resident, and the walk's
// state is left out of the registers of the model paths' calls)
template <bool kStreams>
__global__ void __launch_bounds__(kMaxWarps * 32)
    media_xattn_sm90_kernel(const AttnArgs a, const int slices) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_slices = (a.n_q + 15) / 16, n_groups = (n_slices + slices - 1) / slices;
  const int n_tiles = (a.n_kv + kTileKeys - 1) / kTileKeys, n_slots = slots(a.n_kv);
  const int sg = blockIdx.x % n_groups, head = (blockIdx.x / n_groups) % a.h;
  const int b = blockIdx.x / n_groups / a.h;
  const int row0 = (sg * slices + warp) * 16;
  const bool live = row0 < a.n_q;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_tt[kMaxWarps * 16];
  __shared__ unsigned long long s_need[kMaxWarps];
  __shared__ int s_first[kMaxWarps];

  // Q as A fragments qa[k-step][reg], rows past n_q zeros: issued first
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.stride[0][0] + head * a.stride[0][1];
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int row = row0 + g + 8 * (reg & 1), dim = kk * 16 + 2 * t4 + 8 * (reg >> 1);
      qa[kk][reg] = row < a.n_q
                        ? *reinterpret_cast<const uint32_t*>(q + row * a.stride[0][2] + dim)
                        : 0u;
    }
  }

  // a thread per row of the block reads its text_time; the first window
  int2 rt = make_int2(0, 0);
  if (threadIdx.x < slices * 16) {
    const int row = sg * slices * 16 + threadIdx.x;
    const int tt = row < a.n_q ? a.text_time[static_cast<long long>(b) * a.n_q + row] : 0;
    s_tt[threadIdx.x] = tt;
    rt = row_tiles(tt, a.n_kv, a.n_visual);
  }
  unsigned long long loaded;
  bool more;
  const int w0 = window<kStreams>(0, rt, slices, n_tiles, s_need, s_first, loaded, more);
  // resident: the first window holds every need and its union fits the slots
  const bool resident = !kStreams || w0 < 0 || (!more && __popcll(loaded) <= n_slots);
  if (resident && w0 >= 0) issue_slab(smem, a, b, head, w0, loaded);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (resident && !live) return;  // a warp with no rows (the last slice group's)

  int2 kr[2];
  bool zero[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int tt = s_tt[warp * 16 + g + 8 * h2];
    kr[h2] = valid_keys(tt, a.n_kv, a.n_visual);
    zero[h2] = tt == 0;
  }
  float o[8][4];
#pragma unroll
  for (int dn = 0; dn < 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[dn][r] = 0.f;

  if (w0 >= 0) {
    // one pass where the slab is resident and the slice's tiles fit one
    // chunk; else the max, the sum, then P V, each pass recomputing the
    // scores chunk by chunk (streaming: window by window, group by group)
    const bool one = resident && __popcll(s_need[warp]) <= kChunk;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, s[2 * kChunk][4];
    int tl[kChunk];
#pragma unroll 1
    for (int pass = one ? 2 : 0; pass < 3; ++pass) {
      int w = w0;
#pragma unroll 1
      for (int from = 0;; from = w + kWindowTiles) {
        if (!resident) {
          w = window<kStreams>(from, rt, slices, n_tiles, s_need, s_first, loaded, more);
          if (w < 0) break;
        }
        const unsigned long long need = live ? s_need[warp] : 0ull;
#pragma unroll 1
        for (unsigned long long rest = loaded; rest;) {
          const unsigned long long group = resident ? rest : first_tiles(rest, n_slots);
          rest &= ~group;
          if (!resident) {
            __syncthreads();  // every warp is done with the previous group
            issue_slab(smem, a, b, head, w, group);
            cp_async_commit();
            cp_async_wait<0>();
            __syncthreads();
          }
          const Slab slab{smem, group};
#pragma unroll 1
          for (unsigned long long c = need & group; c;) {
            next_chunk(c, tl);
            scores(slab, qa, tl, kr, w * kTileKeys, a.n_kv, a.scale, s);
            if (pass == 0 || one) row_max(s, m);
            if (pass == 0) continue;
            exp_sum(s, m, l, pass == 1 || one);
            if (pass == 1) continue;
            // P = e / l before P V, 0 on rows with text_time 0
            float inv[2];
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) inv[h2] = zero[h2] ? 0.f : 1.f / l[h2];
#pragma unroll
            for (int nt = 0; nt < 2 * kChunk; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r) s[nt][r] *= inv[r >> 1];
            pv(slab, tl, s, o);
          }
        }
        if (resident) break;
      }
    }
  }
  if (!live) return;

  bf16* out = static_cast<bf16*>(a.out) + b * a.stride[3][0] + head * a.stride[3][1];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = row0 + g + 8 * h2;
    if (row >= a.n_q) continue;
    bf16* orow = out + row * a.stride[3][2];
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) store2(orow + dn * 8 + 2 * t4, o[dn][2 * h2], o[dn][2 * h2 + 1]);
  }
}

}  // namespace mx

// bf16 media xattn with `slices` 16-row slices a block; a plan or shape the
// kernel does not take returns cudaErrorInvalidValue (nothing launched)
cudaError_t launch_media_xattn_sm90(const AttnArgs* args, int slices, void* stream) {
  const AttnArgs& a = *args;
  if (slices < 1 || slices > mx::kMaxWarps || a.n_q < 1 || a.n_kv < 1 || a.n_visual < 1)
    return cudaErrorInvalidValue;
  const long long groups = ((a.n_q + 15) / 16 + slices - 1) / slices;
  const long long blocks = static_cast<long long>(a.b) * a.h * groups;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int smem = mx::slots(a.n_kv) * mx::kSlotBytes;
  const bool streams = a.n_kv > mx::kMaxSlots * mx::kTileKeys;
  auto kernel = streams ? mx::media_xattn_sm90_kernel<true> : mx::media_xattn_sm90_kernel<false>;
  if (smem > 48 * 1024) {  // past 160 keys: granted on the current device
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), slices * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      a, slices);
  return cudaGetLastError();
}

}  // namespace
