// Tiled softmax attention in float32, shared by fused_attention.cu and
// media_xattn.cu: every float32 call, in all three modes, at head width 64
// (kD), and in the kFull and kStream modes also at 80 and 128 (the
// template parameter kHD: the trunks of opt-2.7b and opt-6.7b). bf16 calls run Hopper kernels instead, chosen by dtype alone: kFull
// and kStream attention_sm90.cuh's tile (TMA, wgmma, warp-specialised),
// kMedia media_xattn_sm90.cuh's kernel (a warp per 16-row slice,
// only the attended media's keys loaded); both reuse the fragment helpers
// here.
//
// One block of 4 warps owns 64 query rows of one (batch, head); each warp
// owns 16 rows. The block walks the keys in tiles of 64 (32 at 128-wide
// heads, `F32Tile`) with an online
// softmax (running max from float32 min, running sum, rescaled
// accumulator), and computes every product with mma.sync m16n8k16 (bf16
// operands, float32 accumulation):
//
//   S = Q K^T   Q in registers (the A operand), K from shared memory
//   O = P V     P straight from S's accumulator registers (the C fragment
//               of two 8-key n-tiles is the A fragment of one 16-key k-step)
//
// The TPU kernels keep the scores and the probabilities in float32 and take
// float32 products (pallas_attn.py:34-58, pallas_xattn.py:32-54). A float32
// operand is carried as a sum of bf16 parts, x = x0 + x1 + x2 (24
// significant bits), which the tensor cores multiply exactly, and a product
// as the terms x_i y_j with i + j < 3, which leaves a relative error near
// 2^-24. Each key tile's P V is summed in a fresh fragment and added with
// float32 adds (the tensor cores' own accumulation truncates at every mma).
//
// Three modes, one per TPU kernel:
//
// * kFull (pallas_attn.py:_attn_kernel): s = scale * q.k + bias + row_bias,
//   causal positions set to float32 min; O = softmax(s) V. The TPU kernel
//   normalises P before the V product with the row's true max; the online
//   pass computes the same function (it rescales by exp(m_old - m_new) and
//   divides once at the end), which differs by float32 rounding.
// * kStream (pallas_attn.py:_flash_kernel): the same without `bias`,
//   O = acc / max(l, 1e-30). The TPU kernel pads the keys to its kv block
//   and gives the padded keys a row bias of float32 min; here keys in
//   [n_kv, n_kv_pad) are those padded keys: score float32 min, V 0.
// * kMedia (pallas_xattn.py:_xattn_kernel): s = scale * q.k where
//   text_time[row] == key / n_visual + 1, float32 min elsewhere; rows with
//   text_time 0 get zero probabilities. The media time comes from the key
//   index; no mask tensor exists.
//
// Fully masked rows. A masked score is float32 min, not -inf, and the
// running max starts at float32 min, so a row whose every key is masked
// averages V over those keys uniformly, as the TPU kernels do; a key at
// -inf (a padding bias) weighs 0 next to them. Every key tile is visited,
// causally masked ones too. (A row whose every score is -inf comes out 0
// here, NaN in the TPU kernel; no model path makes one.)
//
// Bound: float32 calls are off the model paths (which run bf16); each K/V
// tile is read once per 64-row query tile by cp.async, one tile at a time
// (two float32 tiles fill the 48 KB of static shared memory), and read
// element by element; Q, S and P never leave registers (at 128-wide heads
// Q's fragments and the output's take most of them).
#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;            // head dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;
constexpr int kPitch = kD + 8;    // shared-memory row: conflict-free fragment reads
constexpr float kNeg = -FLT_MAX;  // float32 min, the TPU kernels' fill

enum Mode { kFull = 0, kStream = 1, kMedia = 2 };

// Mirrored by ops/fused_attention._Args; its size is checked at load time.
struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const float* bias;       // kFull: (b * h, n_q, n_kv) float32, or null
  const float* row_bias;   // kFull, kStream: (b, n_kv) float32, or null
  const int* text_time;    // kMedia: (b, n_q)
  long long stride[4][3];  // q, k, v, out: element strides of (b, h, n); d is 1
  int b, h, n_q, n_kv, n_kv_pad, causal, n_visual;
  float scale;
};

constexpr int kParts = 3;  // bf16 parts of a float32 operand

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two floats already exact in bf16 -> packed bf16x2 (low half = lo)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (lo, hi) -> N packed bf16x2 parts whose sum is (lo, hi) to 8N bits
template <int N>
__device__ __forceinline__ void split2(float lo, float hi, uint32_t (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float a = bf16_round(lo), b = bf16_round(hi);
    out[i] = pack(a, b);
    lo -= a;
    hi -= b;
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b over the part products a_i b_j with i + j < max(NA, NB)
template <int NA, int NB>
__device__ __forceinline__ void mma_parts(float (&c)[4],
                                          const uint32_t (&a)[NA][4],
                                          const uint32_t (&b0)[NB],
                                          const uint32_t (&b1)[NB]) {
  constexpr int kTerms = NA > NB ? NA : NB;
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (i + j < kTerms) mma_bf16(c, a[i], b0[j], b1[j]);
}

// the float32 tile's shape at head width kHD: shared-memory rows of kHD
// floats padded by 8 (conflict-free fragment reads), key tiles of 64 keys
// (32 at 128, so that two float32 tiles stay within the 48 KB of static
// shared memory)
template <int kHD>
struct F32Tile {
  static_assert(kHD % 16 == 0, "whole k-steps of 16 dims");
  static constexpr int kPitch = kHD + 8;
  static constexpr int kKeys = kHD > 80 ? 32 : 64;
};

// rows [key0, key0 + kKeys) of an (n, kHD) slice with row stride sn ->
// shared memory, rows at or past n as zeros: 16-byte cp.async copies, which
// the caller commits and waits for
template <int kHD, int kKeys = F32Tile<kHD>::kKeys>
__device__ __forceinline__ void load_tile(float (*dst)[F32Tile<kHD>::kPitch], const float* src,
                                          long long sn, int key0, int n) {
  constexpr int kChunks = kHD * 4 / 16;  // per row
  for (int c = threadIdx.x; c < kKeys * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    const bool in = key0 + r < n;
    const float* from = in ? src + (key0 + r) * sn + col : src;
    const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(&dst[r][col]));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(to), "l"(from), "r"(in ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// the largest of a row's values across the 4 lanes that hold it
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// s[n-tile][C reg] = Q K^T for this warp's 16 rows and the key tile in
// shared memory: row g + 8 * (r / 2), key nt * 8 + 2 * t4 + r % 2
template <int kHD, int kKeys>
__device__ __forceinline__ void qk(const float (*s_k)[F32Tile<kHD>::kPitch],
                                   const uint32_t (&qa)[kHD / 16][kParts][4],
                                   float (&s)[kKeys / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
      // B fragment of n-tile nt: key nt * 8 + g, dims kk * 16 + 2 * t4 (+1)
      // and (+8, +9)
      uint32_t b0[kParts], b1[kParts];
      const float* kr = &s_k[nt * 8 + g][kk * 16 + 2 * t4];
      const float2 lo = load2(kr), hi = load2(kr + 8);
      split2<kParts>(lo.x, lo.y, b0);
      split2<kParts>(hi.x, hi.y, b1);
      mma_parts<kParts, kParts>(s[nt], qa[kk], b0, b1);
    }
  }
}

// o[dim n-tile][C reg] = o * alpha + P V for the V tile in shared memory,
// the tile's products summed in a fresh fragment
template <int kHD, int kKeys>
__device__ __forceinline__ void pv(const float (*s_v)[F32Tile<kHD>::kPitch],
                                   const float (&p)[kKeys / 8][4], const float (&alpha)[2],
                                   float (&o)[kHD / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float t[kHD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kHD / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) t[dn][r] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    // A fragment of keys kk * 16 ..: regs (row g, keys 2t4..), (row g + 8,
    // ..), (row g, keys 8 + 2t4..), (row g + 8, ..)
    uint32_t pa[kParts][4];
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const float* src = &p[2 * kk + (reg >> 1)][2 * (reg & 1)];
      uint32_t parts[kParts];
      split2<kParts>(src[0], src[1], parts);
#pragma unroll
      for (int i = 0; i < kParts; ++i) pa[i][reg] = parts[i];
    }
    const int key = kk * 16 + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < kHD / 8; ++dn) {
      // B fragment of dim tile dn: keys kk * 16 + 2 * t4 (+1) and (+8, +9),
      // dim dn * 8 + g
      uint32_t b0[kParts], b1[kParts];
      const int dim = dn * 8 + g;
      split2<kParts>(s_v[key][dim], s_v[key + 1][dim], b0);
      split2<kParts>(s_v[key + 8][dim], s_v[key + 9][dim], b1);
      mma_parts<kParts, kParts>(t[dn], pa, b0, b1);
    }
  }
#pragma unroll
  for (int dn = 0; dn < kHD / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[dn][r] = o[dn][r] * alpha[r >> 1] + t[dn][r];
}

// kHD: the head width (64; 80 and 128 in the kFull and kStream modes)
template <int kMode, int kHD>
__global__ void __launch_bounds__(kThreads) attention_kernel(const AttnArgs a) {
  constexpr int kKeys = F32Tile<kHD>::kKeys, kP = F32Tile<kHD>::kPitch;
  const int bh = blockIdx.x;
  const int b = bh / a.h, hd = bh % a.h;
  const int q0 = blockIdx.y * kBlockQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const float* q = static_cast<const float*>(a.q) + b * a.stride[0][0] + hd * a.stride[0][1];
  const float* k = static_cast<const float*>(a.k) + b * a.stride[1][0] + hd * a.stride[1][1];
  const float* v = static_cast<const float*>(a.v) + b * a.stride[2][0] + hd * a.stride[2][1];
  float* out = static_cast<float*>(a.out) + b * a.stride[3][0] + hd * a.stride[3][1];
  const long long k_sn = a.stride[1][2], v_sn = a.stride[2][2];
  const int n_keys = kMode == kStream ? a.n_kv_pad : a.n_kv;
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;

  __shared__ __align__(16) float s_k[kKeys][kP];
  __shared__ __align__(16) float s_v[kKeys][kP];

  // the first tile's copy starts before Q is read
  load_tile<kHD>(s_k, k, k_sn, 0, a.n_kv);
  load_tile<kHD>(s_v, v, v_sn, 0, a.n_kv);
  cp_async_commit();

  // this thread's two query rows: C fragment rows g and g + 8
  int row[2], tt[2] = {0, 0};
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    row[h2] = q0 + warp * 16 + g + 8 * h2;
    if (kMode == kMedia && row[h2] < a.n_q) tt[h2] = a.text_time[b * a.n_q + row[h2]];
  }
  const bool live = q0 + warp * 16 < a.n_q;  // warp-uniform: has a real row

  // Q as A fragments qa[k-step][part][reg]; rows past n_q are zeros
  uint32_t qa[kHD / 16][kParts][4];
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk) {
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int h2 = reg & 1, dim = kk * 16 + 2 * t4 + 8 * (reg >> 1);
      float2 x = make_float2(0.f, 0.f);
      if (row[h2] < a.n_q) x = load2(q + row[h2] * a.stride[0][2] + dim);
      uint32_t parts[kParts];
      split2<kParts>(x.x, x.y, parts);
#pragma unroll
      for (int i = 0; i < kParts; ++i) qa[kk][i][reg] = parts[i];
    }
  }

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float o[kHD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kHD / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[dn][r] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int key0 = it * kKeys;
    cp_async_wait<0>();
    __syncthreads();  // this tile is in shared memory
    if (live) {
      float s[kKeys / 8][4];
      qk<kHD, kKeys>(s_k, qa, s);
      float alpha[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int i = row[h2];
        float mx = kNeg;
#pragma unroll
        for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = key0 + nt * 8 + 2 * t4 + c;
            float x = s[nt][2 * h2 + c] * a.scale;
            if (j >= a.n_kv) {
              x = (kMode == kStream && j < n_keys) ? kNeg : -INFINITY;
            } else if (kMode == kMedia) {
              if (tt[h2] != j / a.n_visual + 1) x = kNeg;
            } else {
              if (kMode == kFull && a.bias != nullptr && i < a.n_q)
                x += a.bias[(static_cast<long long>(bh) * a.n_q + i) * a.n_kv + j];
              if (a.row_bias != nullptr) x += a.row_bias[static_cast<long long>(b) * a.n_kv + j];
              if (a.causal && j > i) x = kNeg;
            }
            s[nt][2 * h2 + c] = x;
            mx = fmaxf(mx, x);
          }
        }
        const float m_new = fmaxf(m[h2], quad_max(mx));
        const bool zero = kMode == kMedia && tt[h2] == 0;  // no preceding media
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float e = zero ? 0.f : expf(s[nt][2 * h2 + c] - m_new);
            s[nt][2 * h2 + c] = e;
            sum += e;
          }
        }
        alpha[h2] = expf(m[h2] - m_new);
        l[h2] = l[h2] * alpha[h2] + quad_sum(sum);
        m[h2] = m_new;
      }
      pv<kHD, kKeys>(s_v, s, alpha, o);
    }
    __syncthreads();  // done reading the tile before it is refilled
    if (it + 1 < n_tiles) {
      load_tile<kHD>(s_k, k, k_sn, key0 + kKeys, a.n_kv);
      load_tile<kHD>(s_v, v, v_sn, key0 + kKeys, a.n_kv);
      cp_async_commit();
    }
  }

  if (!live) return;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if (row[h2] >= a.n_q) continue;
    const float den = fmaxf(l[h2], 1e-30f);
    float* orow = out + row[h2] * a.stride[3][2];
#pragma unroll
    for (int dn = 0; dn < kHD / 8; ++dn)
      store2(orow + dn * 8 + 2 * t4, o[dn][2 * h2] / den, o[dn][2 * h2 + 1] / den);
  }
}

// float32 attention in one of the three modes at head width kHD
template <int kMode, int kHD = kD>
cudaError_t launch_attention(const AttnArgs* args, void* stream) {
  const dim3 grid(args->b * args->h, (args->n_q + kBlockQ - 1) / kBlockQ);
  attention_kernel<kMode, kHD>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return cudaGetLastError();
}

}  // namespace
