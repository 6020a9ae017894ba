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
// value read. The TPU kernel walks the chunks in order on one core. Here
// the rows are cut into groups of R (8 where block_t allows, else the
// largest of 4, 2, 1 that divides it) and the output into 16-byte column
// vectors (8 columns), dealt to blocks in slices of `width` vectors (the
// plan: `plan()` in tools/probe_decode_kernel.py). One launch; a thread
// owns one (group, column vector) of its block's slice and issues all R K
// and R V loads (16 bytes each) before any add, so at the probe's shape
// 65,536 threads (256 blocks of 256, two an SM) hold the whole read in
// flight at once. Each thread sums its group's K rows in row order and its
// V rows in row order and writes the float32 partial sK + sV to shared
// memory. After a barrier one thread per column vector folds the block's
// groups in order: a chunk's groups into the chunk's sum, the chunks in
// order into the accumulator (both in registers), then + q and one cast.
// Where the cache has more groups than the block has threads, the block
// walks windows of groups in order (whole chunks wherever a chunk fits the
// block; a longer chunk's sum is carried from one window to the next) and
// issues a window's loads before it waits for the fold of the one before.
// No partial sums in device memory, no atomics, no scratch: the order is
// fixed and the plain version repeats it, so the kernel equals it bit for
// bit.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;

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

// A block owns the column vectors [blockIdx.x width, + width) of the
// output (b D / 8 of them, vector c = row bi, columns 8 dv .. 8 dv + 7 with
// c = bi dvec + dv) and walks the groups in windows of `window`. Thread
// (gl, s) = (tid / width, tid % width) sums group (window start + gl) of
// vector s; threads (0, s) fold. Strides in 16-byte vectors: t_stride
// between cache rows t and t + 1 of one batch row, b_stride between batch
// rows. part: window x width partials of 8 float32 (dynamic shared memory).
template <int R>
__global__ void __launch_bounds__(kMaxThreads)
stream_sum(const uint4* __restrict__ q, const uint4* __restrict__ k,
           const uint4* __restrict__ v, long long t_stride, long long b_stride,
           int dvec, int n_vec, int n_groups, int gpc, int width, int window,
           uint4* __restrict__ out) {
  extern __shared__ float4 part[];
  const int s = threadIdx.x % width;
  const int gl = threadIdx.x / width;
  const int c = blockIdx.x * width + s;
  const bool col = c < n_vec;
  const bool folds = gl == 0 && col;
  const long long col_off = static_cast<long long>(c / dvec) * b_stride + c % dvec;
  float4* mine = part + 2 * (gl * width + s);
  float acc[8], cs[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = cs[e] = 0.f;
  int in_chunk = 0;  // the fold's place in the current chunk
  for (int g0 = 0; g0 < n_groups; g0 += window) {
    const int g = g0 + gl;
    const bool live = col && g < n_groups;
    uint4 kr[R], vr[R];
    if (live) {
      const long long base = static_cast<long long>(g) * R * t_stride + col_off;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        kr[r] = load_stream(k + base + r * t_stride);
        vr[r] = load_stream(v + base + r * t_stride);
      }
    }
    if (g0) __syncthreads();  // the fold of the window before has read part
    if (live) {
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
      mine[0] = make_float4(sk[0] + sv[0], sk[1] + sv[1], sk[2] + sv[2], sk[3] + sv[3]);
      mine[1] = make_float4(sk[4] + sv[4], sk[5] + sv[5], sk[6] + sv[6], sk[7] + sv[7]);
    }
    __syncthreads();
    if (folds) {
      const int n = min(window, n_groups - g0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float4 p0 = part[2 * (j * width + s)];
        const float4 p1 = part[2 * (j * width + s) + 1];
        const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        if (in_chunk == 0) {
#pragma unroll
          for (int e = 0; e < 8; ++e) cs[e] = p[e];
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) cs[e] += p[e];
        }
        if (++in_chunk == gpc) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += cs[e];
          in_chunk = 0;
        }
      }
    }
  }
  if (!folds) return;
  const uint4 qw = q[c];
  const uint32_t qv[4] = {qw.x, qw.y, qw.z, qw.w};
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 qf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qv[j]));
    const __nv_bfloat162 r = __floats2bfloat162_rn(acc[2 * j] + qf.x, acc[2 * j + 1] + qf.y);
    o[j] = *reinterpret_cast<const uint32_t*>(&r);
  }
  out[c] = make_uint4(o[0], o[1], o[2], o[3]);
}

int launch(const void* q, const void* k, const void* v, long long t_stride,
           long long b_stride, void* out, int b, int D, int n_rows, int block_t,
           int group_rows, int width, int window, void* stream) {
  if (D % 8 || b < 1 || D < 8 || block_t < 1 || n_rows < block_t || n_rows % block_t ||
      group_rows < 1 || block_t % group_rows || width < 1 || window < 1 ||
      width * window > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dvec = D / 8;
  const long long n_vec = static_cast<long long>(b) * dvec;
  const long long blocks = (n_vec + width - 1) / width;
  if (n_vec > 0x7fffffff || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_groups = n_rows / group_rows;
  const int gpc = block_t / group_rows;
  const int threads = width * window;
  const size_t smem = static_cast<size_t>(threads) * 2 * sizeof(float4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* q4 = static_cast<const uint4*>(q);
  const uint4* k4 = static_cast<const uint4*>(k);
  const uint4* v4 = static_cast<const uint4*>(v);
  uint4* o4 = static_cast<uint4*>(out);
  const dim3 grid(static_cast<unsigned>(blocks));
  const int nv = static_cast<int>(n_vec);
  switch (group_rows) {
    case 8:
      stream_sum<8><<<grid, threads, smem, st>>>(q4, k4, v4, t_stride, b_stride, dvec, nv,
                                                 n_groups, gpc, width, window, o4);
      break;
    case 4:
      stream_sum<4><<<grid, threads, smem, st>>>(q4, k4, v4, t_stride, b_stride, dvec, nv,
                                                 n_groups, gpc, width, window, o4);
      break;
    case 2:
      stream_sum<2><<<grid, threads, smem, st>>>(q4, k4, v4, t_stride, b_stride, dvec, nv,
                                                 n_groups, gpc, width, window, o4);
      break;
    case 1:
      stream_sum<1><<<grid, threads, smem, st>>>(q4, k4, v4, t_stride, b_stride, dvec, nv,
                                                 n_groups, gpc, width, window, o4);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All: q, out (b, D) bf16; n_rows = n block_t, the rows the chunks cover;
// group_rows divides block_t and is 1, 2, 4 or 8; the plan (width, window):
// column vectors a block owns and groups it holds at once, width x window
// <= 512 threads. One launch; each returns the CUDA error.

// K, V: (T, b, D) bf16 (make_tmajor_stream)
extern "C" int fmt_stream_tmajor(const void* q, const void* k, const void* v, void* out,
                                 int b, int D, int n_rows, int block_t, int group_rows,
                                 int width, int window, void* stream) {
  const long long dvec = D / 8;
  return launch(q, k, v, b * dvec, dvec, out, b, D, n_rows, block_t, group_rows, width,
                window, stream);
}

// K, V: (b, T, D) bf16 (attn_stream_only)
extern "C" int fmt_stream_bmajor(const void* q, const void* k, const void* v, void* out,
                                 int b, int T, int D, int n_rows, int block_t,
                                 int group_rows, int width, int window, void* stream) {
  const long long dvec = D / 8;
  return launch(q, k, v, dvec, static_cast<long long>(T) * dvec, out, b, D, n_rows,
                block_t, group_rows, width, window, stream);
}

// KV: (T, b, 2D) bf16, K = [..., :D], V = [..., D:] (make_tmajor_packed_loop)
extern "C" int fmt_stream_packed(const void* q, const void* kv, void* out, int b, int D,
                                 int n_rows, int block_t, int group_rows, int width,
                                 int window, void* stream) {
  const long long dvec = D / 8;
  const uint4* k = static_cast<const uint4*>(kv);
  return launch(q, k, k + dvec, b * 2 * dvec, 2 * dvec, out, b, D, n_rows, block_t,
                group_rows, width, window, stream);
}
