// Device-memory streaming probe: a sum over an (N, 1024) bf16 buffer that
// reads every byte once.
//
// Replaces tools/probe_stream.py::pallas_stream, the TPU's bandwidth probe.
// Its result, for x (N, 1024) bf16, a float32 carry acc and the TPU grid's
// chunk_rows (N / chunk_rows grid steps, each adding acc * 1e-30 to each of
// its 128 accumulators):
//
//   sum_{j < 128} (sum_i x[i, j] + (N / chunk_rows) * acc * 1e-30)
//
// The carry keeps repeated calls dependent on each other (the probe chains
// them). Columns 128.. are read but do not enter the sum, as on the TPU.
//
// Bound: device memory, 2 N 1024 bytes at 3.35 TB/s (512 MB: 0.160 ms); the
// sum adds one float32 per 16 bf16 read. What the probe measures is how much
// of that rate one plain kernel reaches: the bounds of every other kernel
// assume 3.35 TB/s.
//
// Design: a grid-stride loop over 16-byte vectors, four loads in flight
// per thread; each block reduces its threads' sums to one partial; a second
// launch of one block sums the partials in a fixed order and adds the
// carry's term. Every loaded word also enters an xor fold that each warp
// stores: the columns that do not enter the sum are read all the same (a
// load whose value fed only the sum, under the column test, may be
// predicated off by the compiler for the threads whose columns never
// enter it, and the probe would then count bytes it never read).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kVecPerRow = 1024 * 2 / 16;  // 128 vectors of 8 bf16 per row
constexpr int kSumVecs = 128 / 8;          // the first 16 vectors: columns < 128

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float sum8(const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    s += f.x + f.y;
  }
  return s;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += red[w];
  return s;  // valid in thread 0
}

__global__ void __launch_bounds__(kThreads)
stream_partials(const uint4* __restrict__ x, long long n_vec, float* partial,
                uint32_t* fold) {
  __shared__ float red[kThreads / 32];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  float s = 0.f;
  uint32_t f = 0u;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load_stream(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      f ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
      if (((i + u * stride) % kVecPerRow) < kSumVecs) s += sum8(v[u]);
    }
  }
  for (; i < n_vec; i += stride) {
    const uint4 v = load_stream(x + i);
    f ^= v.x ^ v.y ^ v.z ^ v.w;
    if ((i % kVecPerRow) < kSumVecs) s += sum8(v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) f ^= __shfl_xor_sync(0xffffffffu, f, o);
  if ((threadIdx.x & 31) == 0) fold[blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)] = f;
  s = block_sum(s, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void __launch_bounds__(1024)
stream_finish(const float* partial, int n_part, const float* acc, float steps,
              float* out) {
  __shared__ float red[32];
  float s = 0.f;
  for (int i = threadIdx.x; i < n_part; i += blockDim.x) s += partial[i];
  s = block_sum(s, red);
  if (threadIdx.x == 0) out[0] = s + 128.f * (steps * (acc[0] * 1e-30f));
}

}  // namespace

// x: (n_rows, 1024) bf16; acc, out: float32 scalars; scratch: n_blocks
// floats of partials, then n_blocks * 8 words of folds; steps = n_rows /
// chunk_rows. Returns the CUDA error.
extern "C" int fmt_stream_sum(const void* x, const float* acc, float* scratch,
                              float* out, long long n_rows, int n_blocks, int steps,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* partial = scratch;
  stream_partials<<<n_blocks, kThreads, 0, st>>>(
      static_cast<const uint4*>(x), n_rows * kVecPerRow, partial,
      reinterpret_cast<uint32_t*>(scratch + n_blocks));
  stream_finish<<<1, 1024, 0, st>>>(partial, n_blocks, acc, static_cast<float>(steps),
                                     out);
  return static_cast<int>(cudaGetLastError());
}
