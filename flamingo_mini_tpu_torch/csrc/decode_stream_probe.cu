// Stream-only decode probes: the decode-attention kernel's reads with the
// attention math replaced by a running sum, over three cache layouts.
//
// Replaces the three TPU kernels of tools/probe_decode_kernel.py:
//   attn_stream_only        (:37)   b-major cache   K, V (b, T, D)
//   make_tmajor_stream      (:76)   T-major cache   K, V (T, b, D)
//   make_tmajor_packed_loop (:149)  one packed cache KV (T, b, 2D),
//                                   K = [..., :D], V = [..., D:]
// Each computes, for q (b, D) bf16 and n = ceil(kv_limit / block_t) chunks
// of block_t cache rows,
//
//   out[b] = bf16(sum_{t < n block_t} (f32 K[b, t] + f32 V[b, t]) + f32 q[b])
//
// in float32, cast once (round to nearest even).
//
// Bound: device memory. The chunks read 2 b (n block_t) D bf16 (at b=32,
// D=1024, 128 rows: 16.78 MB, 0.0050 ms at 3.35 TB/s); one float32 add per
// value read. The TPU kernel walks the chunks in order on one core; here
// the rows are cut into groups of R (8 where block_t allows, else the
// largest of 4, 2, 1 that divides it) and every (group, row b, 8 columns)
// is one thread: 16-byte loads, all R K and R V vectors in flight before
// the adds, 65,536 threads at the probe's shape, so the whole read is in
// flight at once over the 132 SMs. Each thread sums its group's K rows in
// row order and its V rows in row order and stores the float32 partial
// sK + sV; a second launch folds the partials, chunk by chunk in order
// (within a chunk the groups in order, then acc += chunk), adds q and
// casts. No atomics: the order is fixed, and the plain version in
// tools/probe_decode_kernel.py repeats it, so the kernel equals it bit for
// bit. The partials (n block_t / R) b D float32 (2 MB at the probe's shape)
// are written and read back through L2.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// eight bf16 (one 16-byte vector) -> eight float32, element 0 first
__device__ __forceinline__ void widen8(const uint4& v, float f[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

// One thread per (group g, row bi, 8-column vector dv): partial[g, bi,
// 8 dv .. 8 dv + 7] = (K rows in order) + (V rows in order). Strides in
// 16-byte vectors: t_stride between cache rows t and t + 1 of one batch
// row, b_stride between batch rows.
template <int R>
__global__ void __launch_bounds__(kThreads)
group_sums(const uint4* __restrict__ k, const uint4* __restrict__ v,
           long long t_stride, long long b_stride, int b, int dvec, int n_groups,
           float* __restrict__ partial) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(n_groups) * b * dvec) return;
  const int dv = static_cast<int>(i % dvec);
  const long long gb = i / dvec;  // g * b + bi
  const int bi = static_cast<int>(gb % b);
  const long long g = gb / b;
  const long long base = g * R * t_stride + bi * b_stride + dv;
  uint4 kr[R], vr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    kr[r] = load_stream(k + base + r * t_stride);
    vr[r] = load_stream(v + base + r * t_stride);
  }
  float sk[8], sv[8], f[8];
  widen8(kr[0], sk);
  widen8(vr[0], sv);
#pragma unroll
  for (int r = 1; r < R; ++r) {
    widen8(kr[r], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sk[e] += f[e];
    widen8(vr[r], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sv[e] += f[e];
  }
  float4* out = reinterpret_cast<float4*>(partial + i * 8);
  out[0] = make_float4(sk[0] + sv[0], sk[1] + sv[1], sk[2] + sv[2], sk[3] + sv[3]);
  out[1] = make_float4(sk[4] + sv[4], sk[5] + sv[5], sk[6] + sv[6], sk[7] + sv[7]);
}

__device__ __forceinline__ void add4(float4& a, const float4& x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}

// One thread per 4 output columns (bd4 = b D / 4 of them): the chunks in
// order, each the sum of its gpc group partials in order; then + q, cast.
__global__ void __launch_bounds__(kThreads)
fold_chunks(const float4* __restrict__ partial, const uint2* __restrict__ q,
            uint2* __restrict__ out, int bd4, int n_chunks, int gpc) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= bd4) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < n_chunks; ++c) {
    const float4* p = partial + static_cast<long long>(c) * gpc * bd4 + i;
    float4 cs = p[0];
    for (int j = 1; j < gpc; ++j) add4(cs, p[static_cast<long long>(j) * bd4]);
    add4(acc, cs);
  }
  const uint2 qw = q[i];
  const float2 q01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qw.x));
  const float2 q23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qw.y));
  const __nv_bfloat162 o01 = __floats2bfloat162_rn(acc.x + q01.x, acc.y + q01.y);
  const __nv_bfloat162 o23 = __floats2bfloat162_rn(acc.z + q23.x, acc.w + q23.y);
  uint2 o;
  o.x = *reinterpret_cast<const uint32_t*>(&o01);
  o.y = *reinterpret_cast<const uint32_t*>(&o23);
  out[i] = o;
}

int launch(const void* q, const void* k, const void* v, long long t_stride,
           long long b_stride, float* partial, void* out, int b, int D, int n_rows,
           int block_t, int group_rows, void* stream) {
  if (D % 8 || block_t < 1 || n_rows % block_t || block_t % group_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dvec = D / 8;
  const int n_groups = n_rows / group_rows;
  const long long n_threads = static_cast<long long>(n_groups) * b * dvec;
  const unsigned blocks = static_cast<unsigned>((n_threads + kThreads - 1) / kThreads);
  const uint4* k4 = static_cast<const uint4*>(k);
  const uint4* v4 = static_cast<const uint4*>(v);
  switch (group_rows) {
    case 8:
      group_sums<8><<<blocks, kThreads, 0, st>>>(k4, v4, t_stride, b_stride, b, dvec,
                                                  n_groups, partial);
      break;
    case 4:
      group_sums<4><<<blocks, kThreads, 0, st>>>(k4, v4, t_stride, b_stride, b, dvec,
                                                  n_groups, partial);
      break;
    case 2:
      group_sums<2><<<blocks, kThreads, 0, st>>>(k4, v4, t_stride, b_stride, b, dvec,
                                                  n_groups, partial);
      break;
    case 1:
      group_sums<1><<<blocks, kThreads, 0, st>>>(k4, v4, t_stride, b_stride, b, dvec,
                                                  n_groups, partial);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bd4 = b * D / 4;
  fold_chunks<<<(bd4 + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(partial), static_cast<const uint2*>(q),
      static_cast<uint2*>(out), bd4, n_rows / block_t, block_t / group_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All: q, out (b, D) bf16; partial: (n_rows / group_rows, b, D) float32
// scratch; n_rows = n block_t, the rows the chunks cover; group_rows
// divides block_t and is 1, 2, 4 or 8. Each returns the CUDA error.

// K, V: (T, b, D) bf16 (make_tmajor_stream)
extern "C" int fmt_stream_tmajor(const void* q, const void* k, const void* v,
                                 float* partial, void* out, int b, int D, int n_rows,
                                 int block_t, int group_rows, void* stream) {
  const long long dvec = D / 8;
  return launch(q, k, v, b * dvec, dvec, partial, out, b, D, n_rows, block_t,
                group_rows, stream);
}

// K, V: (b, T, D) bf16 (attn_stream_only)
extern "C" int fmt_stream_bmajor(const void* q, const void* k, const void* v,
                                 float* partial, void* out, int b, int T, int D,
                                 int n_rows, int block_t, int group_rows, void* stream) {
  const long long dvec = D / 8;
  return launch(q, k, v, dvec, static_cast<long long>(T) * dvec, partial, out, b, D,
                n_rows, block_t, group_rows, stream);
}

// KV: (T, b, 2D) bf16, K = [..., :D], V = [..., D:] (make_tmajor_packed_loop)
extern "C" int fmt_stream_packed(const void* q, const void* kv, float* partial,
                                 void* out, int b, int D, int n_rows, int block_t,
                                 int group_rows, void* stream) {
  const long long dvec = D / 8;
  const uint4* k = static_cast<const uint4*>(kv);
  return launch(q, k, k + dvec, b * 2 * dvec, 2 * dvec, partial, out, b, D, n_rows,
                block_t, group_rows, stream);
}
