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
// with the probabilities rounded to the cache dtype T before the V product
// and float32 accumulation, as _decode_kernel does. Only the live prefix
// [0, t_lim) is read, t_lim = min(kv_limit, cache length).
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
// MXU. Here a block reads each (family row, slot) that some beam of the
// family names once, and each beam scores only its ancestor's: the same
// softmax (a masked entry adds an exact 0) from at most 1/kb of the bytes
// the mask reads, and any b * kb (the TPU's lcm(8, kb) row-group rule was a
// Mosaic sublane rule). Positions outside [npad, cur] and entries outside
// [0, kb) are never read. If [npad, cur] is empty the reference's softmax
// is uniform over all kb * t_lim family entries, and so is this one.
//
// Head widths: 16, 32, 64, 80 and 128 (kHD, a template parameter; the
// wrapper refuses any other). GPT-2 and OPT up to 1.3B are 64 wide,
// opt-2.7b 80 and opt-6.7b 128; 16 and 32 are the narrow test-scale
// models', which run the same kernels. 80 is not a power of two: a head row
// is 10 16-byte chunks in bf16 (20 in float32), so K's swizzle keeps the
// power-of-two part of the row on the XOR rule and gives the tail its own
// (`swz`), and the V product's lanes form 3 groups of 10 (1 of 20) with the
// rest of the warp idle, folded by shuffles down (`fold`).
//
// Bound: device memory, and the bytes in flight that reach it. A greedy
// call reads 2 * t_lim * b * D * sizeof(T) bytes of K/V (about 17 MB at
// b=32, D=1024, t_lim=132, bf16); a beam call the live positions [npad,
// cur] of each family's distinct ancestors. Two multiply-adds per element
// pair are two orders of magnitude under the card's ridge point, so the
// design is about bytes in flight (about 2.3 MB across the card at 3.35
// TB/s and ~0.7 us of latency):
// - Blocks. A block owns one (family, head group, split): `heads` (1, 2 or
//   4) adjacent heads of its kb rows, 32-1,024 contiguous bytes a row and
//   slot, over `positions` slots [t0, t1) of the live prefix, `splits`
//   blocks along it (flash-decoding). ops/decode_attention.py's plan()
//   picks the layout per shape: a grid the card holds in one wave with a
//   block for every SM and the fewest splits, else the shortest walk a
//   warp makes. At the decode paths' shapes the whole slab fits one
//   resident wave unsplit (a split's second launch costs ~2 us there and
//   saves nothing); small grids and longer prefixes split.
// - Loads. A block issues its whole K/V slab at once, 16-byte cp.async into
//   shared memory, K as one group and V as the next, before any math.
//   Greedy issues at entry (nothing waits on npad); beam first loads the
//   split's ancestry and npad in one coalesced pass, marks each (family
//   row, slot) some beam needs, and issues those alone, each once. K lands
//   swizzled within its head (16-byte chunk c of slot t at c ^ (t & 7)
//   within the row's whole groups of 8 chunks, a shorter row or tail at
//   c ^ (t & (its chunks - 1)): `swz`), so a lane per slot reads its row
//   without bank conflicts.
// - Math. One warp a (beam, head) pair: a lane an entry computes a whole
//   kHD-wide dot from shared memory (q read by broadcast, not held in
//   registers: registers bound how many blocks an SM holds at once), max
//   and sum come from warp shuffles, and the V product runs on 16-byte
//   reads of V, 8 lanes (bf16) a slot, reduced by shuffles. (Several warps
//   a pair, folded in shared memory, measured slower: their syncs cost more
//   than the shorter walk saves.)
// - Combine. With more than one split, a split writes its (max, sum,
//   unnormalised float32 accumulator) to scratch, and a second small launch
//   (programmatic dependent launch: scheduled while the first runs, waiting
//   on its end) folds each (row, head)'s partials in split order, never in
//   order of arrival, so the bits do not depend on timing.
#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxRows = 32;     // kb: the family rows a block holds
// floats a partial: kHD accumulators, max, sum, pad to 16 bytes
__host__ __device__ constexpr int part_stride(int hd) { return hd + 4; }
constexpr int kCombineWarps = 8;
constexpr int kMaxSplits = 32;   // a combine warp holds a split a lane
constexpr int kMaxPairs = kMaxRows * 4;  // (beam, head) pairs a block
// the card's 227 KB a block less the kernel's static arrays (2 KB)
constexpr int kMaxDynamicSmem = 232448 - 2048;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a 16-byte chunk as float32 values: 8 bf16 or 4 float
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(&u);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  uint4 u;
  *reinterpret_cast<float4*>(&u) = make_float4(f[0], f[1], f[2], f[3]);
  return u;
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// K's swizzle: chunk c of a head row of kCH chunks at slot t. The row's
// whole groups of 8 chunks XOR with t & 7; the tail (or a row under 8
// chunks) with t & (its length - 1), a power of two at every width taken
// (kCH % 8 is 0, 2 or 4, or kCH is 2 or 4), so a chunk never leaves its
// group or the row.
template <int kCH>
__device__ __forceinline__ int swz(int c, int t) {
  constexpr int kBase = kCH & ~7, kTail = kCH - kBase;
  static_assert((kTail & (kTail - 1)) == 0, "the tail must be a power of two");
  if constexpr (kTail == 0) return c ^ (t & 7);
  else if constexpr (kBase == 0) return c ^ (t & (kTail - 1));
  else return c < kBase ? c ^ (t & 7) : c ^ (t & (kTail - 1));
}

// The plan of one launch (ops/decode_attention.py's plan()).
struct Plan {
  int heads;      // heads a block holds: 1, 2 or 4
  int splits;     // blocks along the live prefix
  int positions;  // slots a split holds
  int warps;      // warps a block
};

// Dynamic shared memory of a block, in bytes; the plan's smem in
// ops/decode_attention.py is the same sum. K and V slabs (kb rows x
// positions x heads * hd values each), q (kb rows x heads * hd), scores
// (kb * heads warps' rows of `positions` floats); beam: the ancestry
// (kb x positions ints) and need flags (kb x positions bytes).
size_t smem_bytes(const Plan& p, int kb, int hd, size_t itemsize, bool beam) {
  const size_t slab = static_cast<size_t>(p.heads) * hd * itemsize;
  const size_t n = static_cast<size_t>(kb) * p.positions;
  return 2 * n * slab + kb * slab + 4 * n * p.heads + (beam ? 5 * n : 0);
}

// kBeam false: the greedy kernel (kb = 1, anc unused); kHD the head width.
template <typename T, bool kBeam, int kHD>
__global__ void __launch_bounds__(kMaxThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ npad,
                        const int* __restrict__ anc, T* __restrict__ out,
                        float* __restrict__ part, int b, int D, int t_lim, int cur,
                        float scale, int kb, int anc_len, Plan plan) {
  constexpr int kE = 16 / sizeof(T);     // values a 16-byte chunk
  constexpr int kCH = kHD / kE;          // chunks a head row: 2-16 bf16, 4-32 float
  constexpr int kNPG = 32 / kCH;         // positions a warp step of the V product
  constexpr int kPart = part_stride(kHD);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_lo[kMaxRows];

  const int heads = plan.heads, positions = plan.positions, splits = plan.splits;
  const int split = blockIdx.x % splits;
  const int group = blockIdx.x / splits;
  const int fam = blockIdx.y;
  const int n_head = D / kHD;
  const int t0 = split * positions;
  const int t1 = min(t0 + positions, t_lim);
  const int n_pos = t1 - t0;
  const int hi = min(cur, t_lim - 1);
  const int slab = heads * kCH;          // 16-byte chunks a (row, slot)
  const long long t_stride = static_cast<long long>(b) * D;
  const int col0 = group * heads * kHD;
  const int row0 = fam * kb;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  // the combine launch may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  uint4* ks = reinterpret_cast<uint4*>(smem);
  uint4* vs = ks + kb * positions * slab;
  uint4* qs = vs + kb * positions * slab;
  float* sc = reinterpret_cast<float*>(qs + kb * slab);
  int* ancs = reinterpret_cast<int*>(sc + kb * heads * positions);
  unsigned char* need = reinterpret_cast<unsigned char*>(ancs + kb * positions);

  // every thread issues one chunk column of the slabs: nthr % slab == 0
  const int my_ch = tid % slab;
  const int my_c = my_ch % kCH, my_h0 = my_ch - my_c;  // its chunk in its head's row
  const int t_step = nthr / slab;

  for (int x = tid; x < kb * slab; x += nthr)
    cp_async16(qs + x, q + static_cast<long long>(row0 + x / slab) * D + col0
                           + (x % slab) * kE);
  if (!kBeam) {
    // every slot of the split: nothing waits on npad
    for (int tl = tid / slab; tl < n_pos; tl += t_step)
      cp_async16(ks + tl * slab + my_h0 + swz<kCH>(my_c, tl),
                 k + (t0 + tl) * t_stride + static_cast<long long>(row0) * D + col0
                   + my_ch * kE);
    cp_async_commit();
    for (int tl = tid / slab; tl < n_pos; tl += t_step)
      cp_async16(vs + tl * slab + my_ch,
                 v + (t0 + tl) * t_stride + static_cast<long long>(row0) * D + col0
                   + my_ch * kE);
    cp_async_commit();
    if (tid == 0) s_lo[0] = npad[row0];
  } else {
    // the split's ancestry and the rows' npad in one pass
    if (tid < kb) s_lo[tid] = npad[row0 + tid];
    for (int x = tid; x < kb * positions; x += nthr) {
      const int i = x / positions, t = t0 + x % positions;
      ancs[x] = (t < t1 && t < anc_len)
                    ? anc[static_cast<long long>(row0 + i) * anc_len + t] : 0;
    }
    __syncthreads();
    // (family row j, slot) is read iff a beam names it at a valid position,
    // or a beam of the family has no valid position (uniform over them all)
    for (int x = tid; x < kb * positions; x += nthr) {
      const int j = x / positions, tl = x % positions, t = t0 + tl;
      bool nd = false;
      for (int i = 0; i < kb && tl < n_pos; ++i) {
        const int lo = s_lo[i];
        nd |= lo > hi || (lo <= t && t <= hi && ancs[i * positions + tl] == j);
      }
      need[x] = nd;
    }
    __syncthreads();
    for (int j = 0; j < kb; ++j)
      for (int tl = tid / slab; tl < n_pos; tl += t_step)
        if (need[j * positions + tl])
          cp_async16(ks + (j * positions + tl) * slab + my_h0 + swz<kCH>(my_c, tl),
                     k + (t0 + tl) * t_stride + static_cast<long long>(row0 + j) * D
                       + col0 + my_ch * kE);
    cp_async_commit();
    for (int j = 0; j < kb; ++j)
      for (int tl = tid / slab; tl < n_pos; tl += t_step)
        if (need[j * positions + tl])
          cp_async16(vs + (j * positions + tl) * slab + my_ch,
                     v + (t0 + tl) * t_stride + static_cast<long long>(row0 + j) * D
                       + col0 + my_ch * kE);
    cp_async_commit();
  }
  cp_async_wait<1>();  // q and K
  __syncthreads();

  // One warp a (beam i, head h) pair. A beam's entries are its valid slots
  // [e0, e0 + n_e) or, if it has none, the kb * n_pos family entries of the
  // split, each at exp(0) = 1. Scores: a lane an entry; q is read from
  // shared memory (every lane the same chunk: a broadcast), not held in
  // registers, which bound how many blocks an SM holds at once.
  const int pairs = kb * heads;
  __shared__ float s_max[kMaxPairs], s_sum[kMaxPairs];
  for (int pr = warp; pr < pairs; pr += nwarps) {
    const int i = pr / heads, h = pr % heads, lo = s_lo[i];
    float m = -FLT_MAX, l = 0.f;
    if (lo <= hi) {
      const int e0 = max(t0, lo), n_e = max(0, min(t1, hi + 1) - e0);
      const uint4* qr = qs + i * slab + h * kCH;
      float* s = sc + pr * positions;
      float mloc = -FLT_MAX;
      for (int e = lane; e < n_e; e += 32) {
        const int tl = e0 - t0 + e;
        const int j = kBeam ? ancs[i * positions + tl] : 0;
        float x = -FLT_MAX;
        if (j >= 0 && j < kb) {
          const uint4* kr = ks + (j * positions + tl) * slab + h * kCH;
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < kCH; ++c) {
            float f[kE], g[kE];
            unpack(kr[swz<kCH>(c, tl)], f);
            unpack(qr[c], g);
#pragma unroll
            for (int e2 = 0; e2 < kE; ++e2) dot += g[e2] * f[e2];
          }
          x = dot * scale;
        }
        s[e] = x;
        mloc = fmaxf(mloc, x);
      }
      m = warp_max(mloc);
      float lsum = 0.f;
      for (int e = lane; e < n_e; e += 32) {
        const float p = expf(s[e] - m);
        s[e] = p;
        lsum += p;
      }
      l = warp_sum(lsum);
    } else {
      l = static_cast<float>(kb * n_pos);
    }
    if (lane == 0) {
      s_max[pr] = m;
      s_sum[pr] = l;
    }
  }
  cp_async_wait<0>();  // V
  __syncthreads();

  // The V product: lane (position group pg, chunk c) sums 16-byte chunks of
  // V over the entries pg, pg + kNPG, ...; the groups meet by shuffles. At
  // a width whose kCH does not divide 32 the lanes past kNPG * kCH idle.
  const int c = lane % kCH, pg = lane / kCH;
  const int n_pg = pg < kNPG ? kNPG : 0;  // this lane's step; 0: it idles
  for (int pr = warp; pr < pairs; pr += nwarps) {
    const int i = pr / heads, h = pr % heads, lo = s_lo[i];
    float acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
    if (lo <= hi) {
      const int e0 = max(t0, lo), n_e = max(0, min(t1, hi + 1) - e0);
      const float* s = sc + pr * positions;
      for (int e = pg; n_pg && e < n_e; e += kNPG) {
        const int tl = e0 - t0 + e;
        const int j = kBeam ? ancs[i * positions + tl] : 0;
        if (j < 0 || j >= kb) continue;  // exp(-FLT_MAX - m) == 0: not read
        const float p = round_like(s[e], k);
        float f[kE];
        unpack(vs[(j * positions + tl) * slab + h * kCH + c], f);
#pragma unroll
        for (int e2 = 0; e2 < kE; ++e2) acc[e2] += p * f[e2];
      }
    } else {
      for (int e = pg; n_pg && e < kb * n_pos; e += kNPG) {
        const int j = e / n_pos, tl = e % n_pos;
        float f[kE];
        unpack(vs[(j * positions + tl) * slab + h * kCH + c], f);
#pragma unroll
        for (int e2 = 0; e2 < kE; ++e2) acc[e2] += f[e2];
      }
    }
    if constexpr ((kCH & (kCH - 1)) == 0) {
#pragma unroll
      for (int o = kCH; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    } else {
      // fold: group g's sums onto group 0, in group order
#pragma unroll
      for (int g = 1; g < kNPG; ++g)
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float x = __shfl_down_sync(0xffffffffu, acc[e], g * kCH);
          if (pg == 0) acc[e] += x;
        }
    }
    const int row = row0 + i, head = group * heads + h;
    const float m = s_max[pr], l = s_sum[pr];
    if (pg == 0 && splits == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      float o[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) o[e] = acc[e] * inv;
      *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * D + head * kHD
                                + c * kE) = pack(o);
    } else if (pg == 0) {
      float* pp = part + (static_cast<long long>(row * n_head + head) * splits + split)
                             * kPart;
#pragma unroll
      for (int e = 0; e < kE; e += 4)
        *reinterpret_cast<float4*>(pp + c * kE + e) =
            make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
      if (c == 0) {
        pp[kHD] = m;
        pp[kHD + 1] = l;
      }
    }
  }
}

// Fold each (row, head)'s partials in split order: one warp a pair, lane s
// holding split s's max and sum; output value d on lane d % 32.
template <typename T, int kHD>
__global__ void __launch_bounds__(kCombineWarps * 32)
combine_kernel(const float* __restrict__ part, T* __restrict__ out, int n_pairs,
               int n_head, int splits) {
  constexpr int kPart = part_stride(kHD);
  constexpr int kPer = (kHD + 31) / 32;  // output values a lane
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int pair = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;
  const float* pp = part + static_cast<long long>(pair) * splits * kPart;
  const float m = lane < splits ? pp[lane * kPart + kHD] : -FLT_MAX;
  const float ls = lane < splits ? pp[lane * kPart + kHD + 1] : 0.f;
  const float w = expf(m - warp_max(m));
  float l = 0.f, a[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) a[i] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float ws = __shfl_sync(0xffffffffu, w, s);
    l += ws * __shfl_sync(0xffffffffu, ls, s);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (lane + 32 * i < kHD) a[i] += ws * pp[s * kPart + lane + 32 * i];
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  const int row = pair / n_head, head = pair % n_head;
  T* o = out + static_cast<long long>(row) * n_head * kHD + head * kHD + lane;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (lane + 32 * i < kHD) store_one(o + 32 * i, a[i] * inv);
}

template <typename T, bool kBeam, int kHD>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* npad, const int* anc, void* out, void* scratch,
                         int b, int D, int n_head, int t_lim, int cur, float scale,
                         int kb, int anc_len, const Plan& p, cudaStream_t s) {
  const size_t smem = smem_bytes(p, kb, kHD, sizeof(T), kBeam);
  static bool granted = false;  // per instantiation: the most a plan may take
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T, kBeam, kHD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
    if (err != cudaSuccess) return err;
    granted = true;
  }
  const dim3 grid((n_head / p.heads) * p.splits, b / kb);
  decode_attention_kernel<T, kBeam, kHD><<<grid, p.warps * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      npad, anc, static_cast<T*>(out), static_cast<float*>(scratch), b, D, t_lim, cur,
      scale, kb, anc_len, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const int n_pairs = b * n_head;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_pairs + kCombineWarps - 1) / kCombineWarps);
  cfg.blockDim = dim3(kCombineWarps * 32);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, combine_kernel<T, kHD>, static_cast<const float*>(scratch),
                            static_cast<T*>(out), n_pairs, n_head, p.splits);
}

template <typename T, bool kBeam>
cudaError_t launch_width(const void* q, const void* k, const void* v, const int* npad,
                         const int* anc, void* out, void* scratch, int b, int D,
                         int n_head, int t_lim, int cur, float scale, int kb,
                         int anc_len, const Plan& p, cudaStream_t s) {
  switch (D / n_head) {
    case 16:
      return launch_typed<T, kBeam, 16>(q, k, v, npad, anc, out, scratch, b, D, n_head,
                                        t_lim, cur, scale, kb, anc_len, p, s);
    case 32:
      return launch_typed<T, kBeam, 32>(q, k, v, npad, anc, out, scratch, b, D, n_head,
                                        t_lim, cur, scale, kb, anc_len, p, s);
    case 64:
      return launch_typed<T, kBeam, 64>(q, k, v, npad, anc, out, scratch, b, D, n_head,
                                        t_lim, cur, scale, kb, anc_len, p, s);
    case 80:
      return launch_typed<T, kBeam, 80>(q, k, v, npad, anc, out, scratch, b, D, n_head,
                                        t_lim, cur, scale, kb, anc_len, p, s);
    case 128:
      return launch_typed<T, kBeam, 128>(q, k, v, npad, anc, out, scratch, b, D, n_head,
                                         t_lim, cur, scale, kb, anc_len, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kBeam>
cudaError_t launch(const void* q, const void* k, const void* v, const void* npad,
                   const void* anc, void* out, void* scratch, int b, int D,
                   int n_head, int t_lim, int cur, float scale, int kb, int anc_len,
                   int is_bf16, void* stream, Plan p) {
  // the plan's own rules (the wrapper's plan() keeps them; a plan that
  // breaks one is refused here rather than launched)
  const size_t itemsize = is_bf16 ? 2 : 4;
  const int hd = n_head > 0 ? D / n_head : 0;
  const int chunks = hd * static_cast<int>(itemsize) / 16 * p.heads;  // a (row, slot)
  if (n_head < 1 || D != n_head * hd
      || (hd != 16 && hd != 32 && hd != 64 && hd != 80 && hd != 128)
      || p.heads < 1 || p.heads > 4 || n_head % p.heads || kb < 1
      || kb > kMaxRows || b % kb || t_lim < 1 || p.positions < 1 || p.splits < 1
      || p.splits * p.positions < t_lim || (p.splits - 1) * p.positions >= t_lim
      || p.warps < 1 || p.warps * 32 > kMaxThreads || (p.warps * 32) % chunks
      || (p.splits > 1 && scratch == nullptr)
      || p.splits > kMaxSplits || smem_bytes(p, kb, hd, itemsize, kBeam) > kMaxDynamicSmem)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* np = static_cast<const int*>(npad);
  const int* an = static_cast<const int*>(anc);
  if (is_bf16)
    return launch_width<__nv_bfloat16, kBeam>(q, k, v, np, an, out, scratch, b, D,
                                              n_head, t_lim, cur, scale, kb,
                                              anc_len, p, s);
  return launch_width<float, kBeam>(q, k, v, np, an, out, scratch, b, D, n_head,
                                    t_lim, cur, scale, kb, anc_len, p, s);
}

}  // namespace

// scratch: (b * n_head * splits * (D / n_head + 4)) float32 partials (unused
// at one split); heads, splits, positions, warps: the plan
extern "C" int fmt_decode_attention(const void* q, const void* k,
                                    const void* v, const void* npad, void* out,
                                    int b, int D, int n_head, int t_lim,
                                    int cur, float scale, int is_bf16,
                                    void* stream, void* scratch, int heads,
                                    int splits, int positions, int warps) {
  return static_cast<int>(launch<false>(q, k, v, npad, nullptr, out, scratch, b, D,
                                        n_head, t_lim, cur, scale, 1, 0, is_bf16,
                                        stream, Plan{heads, splits, positions, warps}));
}

// b: all rows (families * kb); anc: (b / kb, kb, anc_len) int32
extern "C" int fmt_decode_attention_beam(const void* q, const void* k,
                                         const void* v, const void* npad,
                                         const void* anc, void* out, int b,
                                         int D, int n_head, int t_lim, int cur,
                                         float scale, int kb, int anc_len,
                                         int is_bf16, void* stream, void* scratch,
                                         int heads, int splits, int positions,
                                         int warps) {
  return static_cast<int>(launch<true>(q, k, v, npad, anc, out, scratch, b, D, n_head,
                                       t_lim, cur, scale, kb, anc_len, is_bf16, stream,
                                       Plan{heads, splits, positions, warps}));
}
