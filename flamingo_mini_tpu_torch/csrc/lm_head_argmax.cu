// Fused int8 tied lm_head + greedy argmax.
//
// Replaces flamingo_mini_tpu/ops/pallas_lmhead.py::lm_head_argmax. For each
// hidden row x[b] it returns
//
//   tok[b] = argmax_r  f32(bf16((x[b] . w8[r])_f32 * scale[r]))
//
// over the padded vocab rows r, with rows r >= n_valid at -FLT_MAX and the
// first index winning ties, without ever writing the (B, V) logits.
//
// Bound: device memory. The int8 head is Vp * D bytes (52 MB at Vp=51200,
// D=1024: 0.0157 ms at 3.35 TB/s) and every row is read once per decode
// step, while the products (2 * B * Vp * D = 3.4 GFLOP at B=32) are small
// work for the tensor cores. What held the first design (a grid of
// (Vp / 64, B / 32) small blocks, mma.sync on 2-byte weight loads) back was
// the reads: half-used sectors with nothing in flight ahead of the
// products, and the hidden rows re-read from L2 by every block (as many
// bytes as the weights). The design:
//
// * A persistent grid, one block per SM, each taking a contiguous share of
//   the 64-row vocab tiles. A block is a producer warpgroup and four
//   consumer warpgroups; consumer warpgroup w takes the share's tiles w, w
//   + 4, ... (the consumers fit the launch's 96 registers: no setmaxnreg)
// * One producer thread streams the share's weights by TMA, one 64 vocab
//   rows x 64 k int8 box (4 KB) per stage, into a ring of kPer stages for
//   each consumer warpgroup (mbarriers), in the consumers' order: per round
//   of four tiles, chunk by chunk, a chunk of each tile in turn, so that
//   the four warpgroups consume together. A stage is only ever read by its
//   warpgroup, which waits on every phase of its barrier in turn: a ring
//   shared by the warpgroups of a round of fewer than four tiles would let
//   a warpgroup two phases ahead pass a wait on a stage whose load had not
//   landed (the parity is all a waiter sees).
// * The hidden rows are staged once per block (per row group) in shared
//   memory: bf16, K-major, in the 128-byte swizzle, the wgmma B operand.
//   Where a group's rows of D outgrow kStageBytes (D past 3,072 at 32
//   rows, past 12,288 at 8) they are staged a K-slice at a time instead,
//   every slice once per round of four tiles, the consumers meeting at a
//   barrier around each; a warpgroup's sums run on over the slices.
// * Any width D. The weights' last chunk past D (a K tail) is zero-filled
//   by the TMA box (the map's width is D), and the staged rows past D are
//   zeros. A TMA row stride is a multiple of 16 bytes: where D is not,
//   pad_head_weights pads the weight's columns with zeros once per
//   generate (ldw, the stride, is then D rounded up to 16).
// * Each warpgroup runs Y^T = W X^T on wgmma m64nNk16: the tile's 64 vocab
//   rows are M, their int8 weights the A operand from registers (converted
//   to bf16 exactly, sm90_common's i8x4_to_bf16x4, the k order permuted
//   alike in A and the staged B), the hidden rows N (up to kMaxN), one
//   float32 chain over the tile's chunks.
// * The epilogue per tile: scale, round to bf16 and back, mask, and a
//   running (max, first index) per hidden row in registers; at the end
//   each block's warps merge theirs in shared memory and the block writes
//   one pair per hidden row. A second small launch merges the blocks'
//   pairs in block (vocab) order with (larger value, then smaller index),
//   which is argmax's first-index rule: the order of merging does not
//   change the pick.
// * Any B >= 1: up to kMaxN rows a call reads every weight byte once; past
//   it, the rows go in groups of kMaxN, each group streaming the weights
//   again.
//
// The float32 sums run in another order than the plain version's, so a
// logit can round to the neighbouring bf16 value: the documented +-1 bf16
// ulp envelope of the JAX kernel (pallas_lmhead.py).
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kGroups = 4;                    // consumer warpgroups
constexpr int kConsumers = 128 * kGroups;
constexpr int kThreads = kConsumers + 128;    // and the producer warpgroup
constexpr int kTile = 64;                     // vocab rows per tile, k per chunk
constexpr int kChunkBytes = kTile * kTile;    // one ring stage: 64 x 64 int8
constexpr int kRing = 16;                     // weight ring stages
constexpr int kPer = kRing / kGroups;         // a consumer warpgroup's
constexpr int kMaxN = 32;                     // hidden rows of a group
constexpr int kStageBytes = 96 * 1024;        // the staged rows' budget
constexpr int kBestWarps = kGroups * 4;

// torch.argmax's order: NaN above every number, ties (between NaNs too) to
// the lower index; a row of NaN logits picks its first row, never INT_MAX
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// the wgmma N of a group of `rows` rows
__host__ __device__ inline int group_n(int rows) { return (rows + 7) / 8 * 8; }

// the 64-k weight chunks of a row of width D, the last one zero-filled past D
__host__ __device__ inline int n_chunks(int D) { return (D + kTile - 1) / kTile; }

// the chunks of a K-slice of a group N rows wide: every chunk where the
// group's rows fit kStageBytes whole, else as many as fit
__host__ __device__ inline int slice_chunks(int D, int n) {
  const int fit = kStageBytes / (n * 128), nk = n_chunks(D);
  return fit < nk ? fit : nk;
}

// byte offsets from the 1024-aligned base: the ring, the staged rows (a
// tile of N rows x 128 bytes per chunk of a slice: the first, widest
// group's), the warps' best pairs, the ring's full and empty barriers
struct Layout {
  int ring, stage, best, bars, bytes;
};

__host__ __device__ inline Layout layout(int D, int B) {
  const int n = group_n(B < kMaxN ? B : kMaxN);
  Layout l;
  l.ring = 0;
  l.stage = kRing * kChunkBytes;
  l.best = l.stage + n * slice_chunks(D, n) * 128;
  l.bars = l.best + kBestWarps * kMaxN * 8;
  l.bytes = 1024 + l.bars + 2 * kRing * 8;
  return l;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// the producer's wait for a free stage, sleeping between polls
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

// this block's tiles [t0, t1) of n_tiles
__device__ __forceinline__ void share(int n_tiles, int* t0, int* t1) {
  *t0 = static_cast<int>(static_cast<long long>(blockIdx.x) * n_tiles / gridDim.x);
  *t1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * n_tiles / gridDim.x);
}

// One warpgroup's tile over a slice's nk chunks (the staged B tiles of the
// slice, in order; the warpgroup's chunks j0, j0 + 1, ... since the call
// began) into acc, two chunks' fragments in turn.
template <int N>
__device__ __forceinline__ void tile_products(const uint8_t* base, uint32_t sbase, const Layout& L,
                                              int nk, int j0, int tr, float (&acc)[N / 2]) {
  const int tid = threadIdx.x & 127, wg = threadIdx.x >> 7;
  const int wq = tid >> 5, g8 = (tid & 31) >> 2, t4 = tid & 3;
  auto issue = [&](int c, uint32_t (&af)[4][4]) {
    const int j = j0 + c, stage = wg * kPer + j % kPer;
    mbar_wait(sbase + L.bars + 8 * stage, (j / kPer) & 1);
    const uint8_t* w = base + L.ring + stage * kChunkBytes + 16 * t4;
    const uint4 lo = *reinterpret_cast<const uint4*>(w + (16 * wq + g8) * kTile);
    const uint4 hi = *reinterpret_cast<const uint4*>(w + (16 * wq + g8 + 8) * kTile);
    const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w}, wh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      i8x4_to_bf16x4(wl[j], af[j][0], af[j][2]);
      i8x4_to_bf16x4(wh[j], af[j][1], af[j][3]);
    }
    mbar_arrive(sbase + L.bars + 8 * (kRing + stage));
    const uint64_t db = desc_sw128(sbase + L.stage + c * tr * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) WgmmaBf16<N>::mma(acc, af[kk], db + 2 * kk);
    wgmma_commit();
  };
  uint32_t af0[4][4], af1[4][4];
  for (int c = 0; c < nk; c += 2) {
    issue(c, af0);
    wgmma_wait<1>();
    fence_regs(af1);
    if (c + 1 < nk) {
      issue(c + 1, af1);
      wgmma_wait<1>();
      fence_regs(af0);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(af0);
  fence_regs(af1);
}

// rows [r0, r0 + rows) of x (B, D), chunks [c0, c0 + nc), into the staged
// B tiles (chunk c0 + i: n rows x 128 bytes at i n 128), zeros past D;
// then fenced for wgmma's reads, the consumers meeting after
__device__ __forceinline__ void stage_rows(uint8_t* base, const Layout& L,
                                          const __nv_bfloat16* __restrict__ x, int r0, int rows,
                                          int n, int D, int c0, int nc) {
  const int per_row = nc * 8, units = rows * per_row;
  for (int u = threadIdx.x; u < units; u += kConsumers) {
    const int r = u / per_row, q = u - r * per_row, k = (q & 7) * 8;
    const int gk = (c0 + (q >> 3)) * kTile + k;
    const __nv_bfloat16* src = x + static_cast<long long>(r0 + r) * D + gk;
    uint4 v;
    if ((D & 7) == 0 && gk + 8 <= D) {
      v = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned short lo =
            gk + 2 * e < D ? __bfloat16_as_ushort(src[2 * e]) : static_cast<unsigned short>(0);
        const unsigned short hi = gk + 2 * e + 1 < D ? __bfloat16_as_ushort(src[2 * e + 1])
                                                     : static_cast<unsigned short>(0);
        w[e] = static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    uint8_t* tile = base + L.stage + (q >> 3) * n * 128;
    *reinterpret_cast<uint32_t*>(tile + b_offset(r, k)) = v.x;
    *reinterpret_cast<uint32_t*>(tile + b_offset(r, k + 2)) = v.y;
    *reinterpret_cast<uint32_t*>(tile + b_offset(r, k + 4)) = v.z;
    *reinterpret_cast<uint32_t*>(tile + b_offset(r, k + 6)) = v.w;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();
}

// A group of `rows` hidden rows from r0 (N their wgmma width), staged
// whole before (sk == nk) or in K-slices of sk chunks here, each round of
// four tiles staging them again: every tile of the warpgroup's share (j:
// the warpgroup's chunks so far), then the block's pair per row into
// part_*.
template <int N>
__device__ __forceinline__ void group(uint8_t* base, uint32_t sbase, const Layout& L,
                                      const float* __restrict__ scale,
                                      const __nv_bfloat16* __restrict__ x, int D, int nk, int sk,
                                      int n_valid, int t0, int t1, int& j, int r0, int rows,
                                      int B, float* part_max, int* part_idx) {
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int wq = tid >> 5, g8 = (tid & 31) >> 2, t4 = tid & 3;
  float bv[N / 4];
  int bi[N / 4];
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    bv[i] = -INFINITY;
    bi[i] = INT_MAX;
  }
  // sliced: every warpgroup walks every round, for the stagings' barriers
  const int rounds = sk < nk ? (t1 - t0 + kGroups - 1) / kGroups : 0;
  for (int r = 0; t0 + 4 * r + wg < t1 || r < rounds; ++r) {
    const int tile = t0 + 4 * r + wg;
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    if (sk == nk) {
      tile_products<N>(base, sbase, L, nk, j, N, acc);
      j += nk;
    } else {
      for (int c0 = 0; c0 < nk; c0 += sk) {
        const int nc = min(sk, nk - c0);
        consumers_sync();  // the last slice's products are done
        stage_rows(base, L, x, r0, rows, N, D, c0, nc);
        if (tile < t1) {
          tile_products<N>(base, sbase, L, nc, j, N, acc);
          j += nc;
        }
      }
      if (tile >= t1) continue;
    }
    // acc[4 j + 2 h + e]: vocab row tile * 64 + 16 wq + g8 + 8 h, hidden
    // row 8 j + 2 t4 + e
    const int v0 = tile * kTile + 16 * wq + g8;
    const float s0 = scale[v0], s1 = scale[v0 + 8];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float l0 = __bfloat162float(__float2bfloat16_rn(acc[4 * j + e] * s0));
        float l1 = __bfloat162float(__float2bfloat16_rn(acc[4 * j + 2 + e] * s1));
        if (v0 >= n_valid) l0 = -FLT_MAX;
        if (v0 + 8 >= n_valid) l1 = -FLT_MAX;
        float v = l0;
        int idx = v0;
        if (l1 > v) {
          v = l1;
          idx = v0 + 8;
        }
        // the warp's 16 vocab rows: the lanes of other g8
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, o);
          const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
          if (better(ov, oi, v, idx)) {
            v = ov;
            idx = oi;
          }
        }
        if (better(v, idx, bv[2 * j + e], bi[2 * j + e])) {
          bv[2 * j + e] = v;
          bi[2 * j + e] = idx;
        }
      }
  }
  // the block's 16 warps' pairs per hidden row, merged
  float* s_max = reinterpret_cast<float*>(const_cast<uint8_t*>(base) + L.best);
  int* s_idx = reinterpret_cast<int*>(s_max + kBestWarps * kMaxN);
  const int warp = threadIdx.x >> 5;
  if (g8 == 0) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s_max[warp * kMaxN + 8 * j + 2 * t4 + e] = bv[2 * j + e];
        s_idx[warp * kMaxN + 8 * j + 2 * t4 + e] = bi[2 * j + e];
      }
  }
  consumers_sync();
  if (static_cast<int>(threadIdx.x) < rows) {
    float v = s_max[threadIdx.x];
    int idx = s_idx[threadIdx.x];
    for (int w = 1; w < kBestWarps; ++w)
      if (better(s_max[w * kMaxN + threadIdx.x], s_idx[w * kMaxN + threadIdx.x], v, idx)) {
        v = s_max[w * kMaxN + threadIdx.x];
        idx = s_idx[w * kMaxN + threadIdx.x];
      }
    const long long o = static_cast<long long>(blockIdx.x) * B + r0 + threadIdx.x;
    part_max[o] = v;
    part_idx[o] = idx;
  }
  consumers_sync();  // the pairs are rewritten by the next group
}

#define LMH_GROUP(n)                                                                     \
  case n:                                                                                \
    group<n>(base, sbase, L, scale, x, D, nk, sk, n_valid, t0, t1, j, r0, rows, B, part_max, \
             part_idx);                                                                  \
    break;

__global__ void __launch_bounds__(kThreads, 1)
lm_head_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ scale,
               const __nv_bfloat16* __restrict__ x, float* __restrict__ part_max,
               int* __restrict__ part_idx, int n_tiles, int D, int B, int n_valid) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* base = smem_raw + (sbase - raw);
  const Layout L = layout(D, B);
  const int nk = n_chunks(D);
  int t0, t1;
  share(n_tiles, &t0, &t1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(sbase + L.bars + 8 * s, 1);
      mbar_init(sbase + L.bars + 8 * (kRing + s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x != kConsumers) return;
    // the producer: per group, per round of four tiles, per chunk, the
    // round's tiles in turn, each into its warpgroup's ring
    prefetch_map(&map);
    int n_w[kGroups] = {0, 0, 0, 0};  // each warpgroup's chunks so far
    for (int r0 = 0; r0 < B; r0 += kMaxN)
      for (int t = t0; t < t1; t += kGroups) {
        const int active = min(kGroups, t1 - t);
        for (int c = 0; c < nk; ++c)
          for (int w = 0; w < active; ++w) {
            const int j = n_w[w]++, stage = w * kPer + j % kPer, round = j / kPer;
            const uint32_t full = sbase + L.bars + 8 * stage;
            if (round > 0) producer_wait(sbase + L.bars + 8 * (kRing + stage), (round - 1) & 1);
            mbar_expect_tx(full, kChunkBytes);
            tma_load_2d(sbase + L.ring + stage * kChunkBytes, &map, full, c * kTile,
                        (t + w) * kTile);
          }
      }
    return;
  }
  int j = 0;  // this warpgroup's chunks so far
  for (int r0 = 0; r0 < B; r0 += kMaxN) {
    const int rows = min(kMaxN, B - r0), n = group_n(rows), sk = slice_chunks(D, n);
    // the group's rows whole into the B tiles, or a slice at a time in
    // `group`
    if (sk == nk) stage_rows(base, L, x, r0, rows, n, D, 0, nk);
    switch (n) {
      LMH_GROUP(8) LMH_GROUP(16) LMH_GROUP(24) LMH_GROUP(32)
    }
  }
}

#undef LMH_GROUP

// the blocks' pairs of each hidden row, in block order: one warp per row
__global__ void lm_head_reduce_kernel(const float* __restrict__ part_max,
                                      const int* __restrict__ part_idx,
                                      int* __restrict__ out, int n_blocks, int B) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int c = lane; c < n_blocks; c += 32) {
    const float v = part_max[static_cast<long long>(c) * B + b];
    const int i = part_idx[static_cast<long long>(c) * B + b];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) out[b] = bi;
}

// the grid: one block per SM, at most one per tile
cudaError_t grid_blocks(int n_tiles, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = sms < n_tiles ? sms : n_tiles;
  return err;
}

}  // namespace

// w8: (Vp, ldw) int8, the first D columns the weights (ldw >= D, a
// multiple of 16: a TMA row stride); part_max / part_idx: (Vp / 64, B)
// scratch (the grid takes at most one block per tile); returns the CUDA
// error
extern "C" int fmt_lm_head_argmax(const void* w8, const void* scale,
                                  const void* x, void* part_max,
                                  void* part_idx, void* out, int Vp, int D, int ldw,
                                  int B, int n_valid, void* stream) {
  if (Vp % kTile || D < 1 || ldw < D || ldw % 16 || B < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return cudaErrorInvalidValue;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Vp)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(ldw)};
  const cuuint32_t box[2] = {kTile, kTile}, unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w8), dims, stride, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int n_tiles = Vp / kTile, bytes = layout(D, B).bytes;
  int blocks = 0;
  cudaError_t err = grid_blocks(n_tiles, &blocks);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lm_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  lm_head_kernel<<<blocks, kThreads, bytes, s>>>(
      map, static_cast<const float*>(scale), static_cast<const __nv_bfloat16*>(x),
      static_cast<float*>(part_max), static_cast<int*>(part_idx), n_tiles, D, B, n_valid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lm_head_reduce_kernel<<<B, 32, 0, s>>>(static_cast<const float*>(part_max),
                                         static_cast<const int*>(part_idx),
                                         static_cast<int*>(out), blocks, B);
  return static_cast<int>(cudaGetLastError());
}

// vocab rows per tile: the wrapper checks Vp and sizes its scratch with it
extern "C" int fmt_lm_head_rows_per_block() { return kTile; }

// the dynamic shared memory a launch over B hidden rows of width D takes
// (its layout; the wrapper compares it with the card's limit before any
// work), or -1 for no rows or no width: what ops/lm_head.py's smem_bytes
// mirrors
extern "C" int fmt_lm_head_smem(int D, int B) {
  return D >= 1 && B >= 1 ? layout(D, B).bytes : -1;
}
