// Single-query decode attention over the T-major flat KV cache, greedy and
// lazy-beam.
//
// Greedy: replaces flamingo_mini_tpu/ops/pallas_decode.py::decode_attention
// (the Pallas kernel _decode_kernel). For each batch row and head it
// computes
//
//   s[t]  = scale * <q, K[t]>                  float32, scaled after the dot
//   s[t]  = -FLT_MAX unless npad[row] <= t <= cur
//   out   = sum_t T(exp(s[t] - m)) * V[t] / sum_t exp(s[t] - m)
//
// with an online (running max / running sum) softmax over chunks of 64
// positions, the probabilities rounded to the cache dtype T before the V
// product and float32 accumulation, as _decode_kernel does. Only the live
// prefix [0, t_lim) is read, t_lim = min(kv_limit, cache length).
//
// Beam: replaces pallas_decode.py::decode_attention_beam (the Pallas kernel
// _decode_kernel_beam). Rows come in families of kb physical cache rows
// that never move; logical beam i of family f reads, at position t, the
// K/V of the family row its ancestry table names:
//
//   physical row = f * kb + anc[row * anc_len + t]       (anc = 0 past anc_len)
//
// over npad[row] <= t <= cur. The TPU kernel had to compute every family
// row's scores and mask those whose ancestor differs, building the
// per-element ancestor with an exact 0/1 selection matmul: a layout for the
// MXU. Here the block that owns (head, row) loads anc[row, t] itself and
// reads only the ancestor's K/V: the same softmax (a masked entry adds an
// exact 0) from 1/kb of the bytes the mask reads, and any b * kb (the TPU's
// lcm(8, kb) row-group rule was a Mosaic sublane rule). Positions outside
// [npad, cur] and entries outside [0, kb) are never read. If [npad, cur] is
// empty the reference's softmax is uniform over all kb * t_lim family
// entries, and so is this one.
//
// Bound: device memory. A greedy call reads 2 * t_lim * b * D * sizeof(T)
// bytes of K/V (about 17 MB at b=32, D=1024, t_lim=132, bf16); a beam call
// reads the live positions [npad, cur] of each row's ancestors, shared
// ancestors once (at most about 25 MB at b * kb = 96, cur = 127, bf16).
// Two multiply-adds per byte pair are far below the card's ridge point. The
// design spends nothing on math tricks: one thread block per (head, row)
// streams that head's 128-byte K and V slices position by position (one
// warp per position, 4 bytes a lane, warp-shuffle dot product), and nothing
// but the (rows, D) output is written. The Pallas kernels' grouped cross-
// batch score matrices were an MXU layout device and are not carried over.
// Splitting T across blocks (flash-decoding) is later work; at these
// lengths 512 (greedy) and 1536 (beam) blocks already cover the 132 SMs.
#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kChunk = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float load_one(const float* p) { return *p; }

__device__ __forceinline__ float load_one(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// the probabilities take the cache dtype before the V product
__device__ __forceinline__ float round_like(float x, const float*) { return x; }

__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }

__device__ __forceinline__ void store_one(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// kBeam false: anc, kb and anc_len are unused (the greedy kernel).
template <typename T, bool kBeam>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ npad,
                        const int* __restrict__ anc, T* __restrict__ out, int b,
                        int D, int t_lim, int cur, float scale, int kb,
                        int anc_len) {
  const int head = blockIdx.x;
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t_stride = static_cast<long long>(b) * D;
  const int hoff = head * kHeadDim;
  const long long base = static_cast<long long>(row) * D + hoff;
  const int lo = npad[row];

  // The walk: positions p in [p0, p1). Greedy: every slot t = p < t_lim of
  // the row itself, masked by [lo, cur]. Beam: the slots t = p in [lo, hi]
  // of each one's ancestor row, or, when that range is empty, every slot of
  // every family row (t = p % t_lim, row p / t_lim), all at -FLT_MAX.
  int p0 = 0, p1 = t_lim;
  bool all_masked = false;
  const int fam0 = kBeam ? (row / kb) * kb : row;
  if (kBeam) {
    const int hi = min(cur, t_lim - 1);
    if (lo <= hi) {
      p0 = lo;
      p1 = hi + 1;
    } else {
      all_masked = true;
      p1 = kb * t_lim;
    }
  }

  __shared__ float s_score[kChunk];
  __shared__ float s_p[kChunk];
  __shared__ float s_half[kHeadDim];
  __shared__ int s_row[kChunk];  // beam: physical cache row, -1: not read
  __shared__ int s_t[kChunk];    // beam: cache slot

  // each lane holds two of the head's 64 query values
  const float2 qv = load_pair(q + base + 2 * lane);

  // V accumulation: thread (d, half) owns output dim d over positions of
  // parity `half` within each chunk
  const int d = threadIdx.x & (kHeadDim - 1);
  const int half = threadIdx.x / kHeadDim;

  float m = -FLT_MAX;  // running max (every thread holds the same value)
  float l = 0.f;       // running sum of exp
  float acc = 0.f;

  for (int c0 = p0; c0 < p1; c0 += kChunk) {
    const int n = min(kChunk, p1 - c0);
    for (int j = warp; j < n; j += kWarps) {
      const int p = c0 + j;
      int t = p, prow = row;
      bool valid = t >= lo && t <= cur;
      if (kBeam) {
        if (all_masked) {
          t = p % t_lim;
          prow = fam0 + p / t_lim;
          valid = false;
        } else {
          const int a = t < anc_len ? anc[static_cast<long long>(row) * anc_len + t] : 0;
          prow = (a >= 0 && a < kb) ? fam0 + a : -1;
          valid = prow >= 0;
        }
      }
      float s = -FLT_MAX;
      if (prow >= 0) {  // warp-uniform
        const float2 kv = load_pair(k + t * t_stride + static_cast<long long>(prow) * D
                                    + hoff + 2 * lane);
        float dot = qv.x * kv.x + qv.y * kv.y;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (valid) s = dot * scale;
      }
      if (lane == 0) {
        s_score[j] = s;
        if (kBeam) {
          s_row[j] = prow;
          s_t[j] = t;
        }
      }
    }
    __syncthreads();

    float cmax = -FLT_MAX;
    for (int j = 0; j < n; ++j) cmax = fmaxf(cmax, s_score[j]);
    const float m_new = fmaxf(m, cmax);
    const float alpha = expf(m - m_new);
    if (threadIdx.x < n) s_p[threadIdx.x] = expf(s_score[threadIdx.x] - m_new);
    __syncthreads();

    float psum = 0.f;
    for (int j = 0; j < n; ++j) psum += s_p[j];
    l = l * alpha + psum;
    m = m_new;

    float part = 0.f;
    for (int j = half; j < n; j += 2) {
      const int prow = kBeam ? s_row[j] : row;
      if (prow < 0) continue;  // exp(-FLT_MAX - m) == 0 exactly: not read
      const int t = kBeam ? s_t[j] : c0 + j;
      const float p = round_like(s_p[j], k);
      part += p * load_one(v + t * t_stride + static_cast<long long>(prow) * D + hoff + d);
    }
    acc = acc * alpha + part;
    __syncthreads();  // the chunk's shared arrays are rewritten by the next
  }

  if (half == 1) s_half[d] = acc;
  __syncthreads();
  if (half == 0) {
    const float total = acc + s_half[d];
    store_one(out + base + d, total / fmaxf(l, 1e-30f));
  }
}

template <bool kBeam>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* npad, const void* anc, void* out, int b, int D,
                   int n_head, int t_lim, int cur, float scale, int kb,
                   int anc_len, int is_bf16, void* stream) {
  const dim3 grid(n_head, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* np = static_cast<const int*>(npad);
  const int* an = static_cast<const int*>(anc);
  if (is_bf16) {
    typedef __nv_bfloat16 T;
    decode_attention_kernel<T, kBeam><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), np, an, static_cast<T*>(out), b, D, t_lim,
        cur, scale, kb, anc_len);
  } else {
    decode_attention_kernel<float, kBeam><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), np, an, static_cast<float*>(out), b, D,
        t_lim, cur, scale, kb, anc_len);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int fmt_decode_attention(const void* q, const void* k,
                                    const void* v, const void* npad, void* out,
                                    int b, int D, int n_head, int t_lim,
                                    int cur, float scale, int is_bf16,
                                    void* stream) {
  return static_cast<int>(launch<false>(q, k, v, npad, nullptr, out, b, D,
                                        n_head, t_lim, cur, scale, 1, 0,
                                        is_bf16, stream));
}

// b: all rows (families * kb); anc: (b / kb, kb, anc_len) int32
extern "C" int fmt_decode_attention_beam(const void* q, const void* k,
                                         const void* v, const void* npad,
                                         const void* anc, void* out, int b,
                                         int D, int n_head, int t_lim, int cur,
                                         float scale, int kb, int anc_len,
                                         int is_bf16, void* stream) {
  return static_cast<int>(launch<true>(q, k, v, npad, anc, out, b, D, n_head,
                                       t_lim, cur, scale, kb, anc_len, is_bf16,
                                       stream));
}
