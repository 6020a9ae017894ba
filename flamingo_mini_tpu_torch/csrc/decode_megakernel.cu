// One whole decode step in one launch: for every layer the gated
// cross-attention block (where the layer has one) and the pre-norm decoder
// block of a GPT-2 or OPT trunk.
//
// Replaces flamingo_mini_tpu/ops/pallas_megadecode.py::decode_step_megakernel
// (_mega_call -> _build_kernel) in all its modes: greedy (kb=1, anc null)
// and lazy beam (beam_anc, kb > 1), GPT-2 and pre-norm OPT alike, each
// weight-only (act_quant=0) or w8a8 (act_quant=1). One body serves both
// trunks, as on the TPU: OPT's
// separate q/k/v projections arrive packed as the qkv projection's three
// column blocks, attn_ln / final_ln as LN1 / LN2, out_proj / fc1 / fc2 as
// c_proj / mlp_fc / mlp_proj, and its ReLU as the `act` code (ACT_RELU).
// Per layer l, on the residual stream x (b, D) bf16:
//
//   gated xattn, if hasx[l]:
//     y  = LN(x);  q = bf16(lin(y, to_q) * bf16(xdh^-0.5))
//     s  = bf16(q . k) per (row, head), valid iff latent / n_visual + 1 ==
//          text_time[row], else -FLT_MAX; softmax; bf16(p) . v, normalised;
//          rows with text_time == 0 give 0
//     x += bf16(g_attn * lin(att, to_out))
//     x += bf16(g_ffw * lin(gelu_erf_rational(lin(LN(x), fc1)), fc2))
//   decoder block (GPT-2 names):
//     q, k, v = lin(LN1(x), c_attn) + b;  K/V rows written at slot `cur`
//     att = softmax(q . K[t] * dh^-0.5 over npad <= t <= cur) . bf16(p) V
//     (beam mode: K[t], V[t] of row r are those of the family row
//     (r / kb) * kb + anc[r * anc_len + t]: the ancestry of the lazy beam
//     reorder, read as a gather where the TPU kernel built a family mask
//     with an exact 0/1 selection matmul; see decode_attention.cu)
//     x += lin(att, c_proj) + b
//     x += lin(act(lin(LN2(x), mlp_fc) + b), mlp_proj) + b
//     act: gelu_new (GPT-2) or ReLU (OPT), on the bf16 value, rounded once
//
// where, weight-only, lin(a, W) = bf16((a . W^T)_f32 * scale): int8 weights
// converted to bf16 exactly, bf16 products accumulated in float32, the
// float32 per-output-channel scale, one rounding; a bias is added in bf16,
// and every residual add is a bf16 add. LayerNorm takes float32
// statistics, eps 1e-5, each op rounded as the plain version's, its sums in
// the order megadecode._layer_norm repeats (both kernels).
//
// w8a8 (act_quant, pallas_megadecode.py's aquant / mm_cols / mm_rows): a
// linear's bf16 input is quantized per row, s = max(amax, 1e-30) *
// f32(1/127), q = round_half_even(a * (1/s)) as int8, and the int8 x int8
// dot is summed in int32. Column form (to_q, fc1, c_attn, c_proj, mlp_fc:
// one scale per row over the whole input) lin = bf16((f32(p) * s) * scale).
// Row form (to_out, fc2, mlp_proj): each D-wide slice of the input has its
// own per-row scale s_j, acc = sum_j f32(p_j) * s_j in slice order (from
// 0), lin = bf16(acc * scale). Attention stays bf16.
//
// Bound: device memory. A step at flamingo-mini width (b=32, D=1024,
// Dff=4096, XI=512, 24 layers, 64 latents, kv_limit 132) reads 528.5 MB of
// int8 weights, 100.7 MB of xattn K/V and 415.2 MB of self K/V, 1.044 GB in
// all: 0.312 ms at 3.35 TB/s. Its 34 GFLOP (two per weight per batch row)
// take 0.035 ms at the tensor cores' 989 TFLOP/s (0.017 ms as int8 at
// 1,979 TOP/s). At OPT-1.3B width (b=8,
// D=2048, Dff=8192, 32 heads, xattn XI=512 with Dffx=8192 on 12 of 24
// layers) the int8 weights alone are 1.21 GB (trunk) + 0.43 GB (xattn):
// about 0.49 ms. The w8a8 mode reads the same bytes: the same bound.
//
// Two kernels, chosen by mode alone (fmt_decode_megakernel): the
// weight-only mode runs decode_megakernel_sm90.cuh (TMA weight ring,
// wgmma, its own grid barrier; its note says what bounds it and what the
// design does about it); the w8a8 mode runs decode_megakernel below. Each
// raises through its error code; neither gives way to the other.
//
// The w8a8 kernel (the simple version: right first). One persistent
// cooperative grid (at most 2 blocks of 8 warps per SM, fixed by the
// occupancy calculator) runs the layer loop that the TPU ran as its
// sequential grid; a grid-wide barrier separates the ten phases of a layer:
//
//   LN+to_q | xattn | to_out+gate | LN+fc1+GELU | fc2+gate |
//   LN1+qkv+K/V write | attention | c_proj+residual | LN2+fc+act |
//   mlp_proj+residual
//
// * Linears: a block owns 8 output columns at a time (one mma n-tile); its
//   8 warps split K in 64-wide chunks and run mma.sync m16n8k32 (s8 x s8 ->
//   s32) over 32-row groups of the batch, rows past b read as zeros and
//   never stored. Each lane loads 16 contiguous int8 weights of one output
//   column, which feed the mma as they are, and quantizes its 16
//   activations in registers with its row's 1/s; the k order inside a
//   64-chunk is permuted identically for A and B, which a dot product does
//   not see. The warps' K-split partials of one slice are added in int32 in
//   shared memory, so the owner casts the slice's whole sum to float32 once
//   (__int2float_rn): the linear is bitwise the plain version's for the
//   same inputs, also at D >= 2048 where the sum passes 2^24 and the cast
//   rounds. The owner of a column applies scale, bias, activation and the
//   residual add, so no phase reads a column that another block writes in
//   it. A phase after a LayerNorm walks the batch one 32-row group at a
//   time: it normalises the group into shared memory (each working block
//   redundantly: min(b, 32)*D*2 bytes), then runs its columns over that
//   group. fmt_decode_megakernel_smem states the shared memory a call needs
//   without launching, so that the wrapper refuses a trunk too wide for
//   the card before anything runs.
// * Row scales need each row's amax before any product. The LayerNorm
//   phases take it from the normalised group in shared memory (128 bytes
//   more). The phases that read abuf / hbuf get it from their producer: the
//   attention and the fc / fc1 epilogues reduce |bf16 value| over a head or
//   an 8-column tile and atomicMax its bit pattern (a max of non-negative
//   floats is exact in any order) into a per-(row, slice) word of `amax`,
//   zeroed by the LN phase before; no barrier is added.
// * Rows: nothing on the card grows with b but device memory and the LN
//   stage; the kernel's 32-bit element offsets into the (b, width)
//   activation buffers are the one limit, b * max(2 * max(D, XI),
//   max(Dff, Dffx)) < 2^31 (524,287 rows at flamingo-mini width, 262,143 at
//   OPT-1.3B's), which the wrapper checks (for both kernels). Offsets into
//   the weight and cache stacks are 64-bit.
// * Attention (head dim 64): one warp per (row, head). Scores a lane per
//   position into shared memory, the row's global max, then the V product
//   over 4 positions at a time, 8 lanes x 8 dims each, in 16-byte loads.
//   The dot products, the softmax denominator and the V sums are summed in
//   float64 (bf16 x bf16 products are exact) and rounded once: the order of
//   the terms does not change them. The LayerNorm sums in float32 in an
//   order its plain version repeats. So the w8a8 mode agrees with its plain
//   version bit for bit, which its chaos needs: one activation rounded the
//   other way can flip a quantized value and move the step by ~1e-2
//   normwise at 24 layers. Masked positions are never loaded and contribute
//   an exact 0, so stale or uninitialised cache rows cannot leak a NaN.
// * Everything written inside the step (x, q, the K/V rows, h, amax) is
//   read with plain coherent loads after a grid barrier; only weights use
//   the read-only path.
//
// What holds it back (later work): about 240 grid barriers a step, weight
// reads that are not prefetched across phases or layers, the A operand
// re-read through L2 and re-quantized by every block that reads it for
// every 8 columns, and one warp walking each attention row serially.
#include <cfloat>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBlocksPerSm = 2;
constexpr int kKChunk = 64;    // k values per warp iteration: 16 int8 a lane
constexpr int kGroupRows = 32; // batch rows per pass: two 16-row m-tiles
constexpr int kRedBytes = kWarps * kGroupRows * 8 * 4;
constexpr int kHeadDim = 64;   // attention head dim, self and cross
constexpr int kRowMaxBytes = kGroupRows * 4;  // w8a8: an LN group's amax words
// the w8a8 quantizer's constants as JAX folds them: float32 roundings of
// the Python doubles
constexpr float kAmaxFloor = static_cast<float>(1e-30);
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

enum { ACT_GELU_TANH = 0, ACT_GELU_ERF = 1, ACT_RELU = 2 };
enum { EPI_STORE = 0, EPI_XQ = 1, EPI_RESID = 2, EPI_GATED = 3, EPI_QKV = 4 };

}  // namespace

// Field for field the ctypes structure _Args in ops/megadecode.py.
struct MegaArgs {
  const int8_t* w_qkv; const float* s_qkv; const bf16* b_qkv;
  const int8_t* w_o; const float* s_o; const bf16* b_o;
  const int8_t* w_fc; const float* s_fc; const bf16* b_fc;
  const int8_t* w_pr; const float* s_pr; const bf16* b_pr;
  const float* ln1_s; const float* ln1_b; const float* ln2_s; const float* ln2_b;
  const int8_t* w_xq; const float* s_xq;
  const int8_t* w_xo; const float* s_xo;
  const int8_t* w_xf1; const float* s_xf1;
  const int8_t* w_xf2; const float* s_xf2;
  const float* xn_s; const float* xn_b; const float* xfn_s; const float* xfn_b;
  const float* gates;            // (NX, 2) bf16-rounded tanh(alpha)
  const int* hasx;               // (L,)
  const bf16* xk; const bf16* xv;  // (L, NMNV, b, XI)
  bf16* kc; bf16* vc;            // (L, T, b, D), row `cur` written in place
  const bf16* x_emb;             // (b, D)
  const int* npad; const int* text_time;  // (b,)
  bf16* x;                       // (b, D): the residual stream and the output
  bf16* scratch;                 // q (b, QW) | att (b, QW) | h (b, HW)
  const int* anc;                // (b / kb, kb, anc_len) beam ancestry, or null
  unsigned* amax;                // w8a8: (b) abuf | (b, nsH) hbuf row-slice amax
  int b, D, Dff, Dffx, XI, n_layer, n_head, x_heads, n_visual, NMNV, T, cur,
      t_lim, act, xact, kb, anc_len, act_quant;
  float attn_scale;              // dh^-0.5, applied to the scores
  float xq_scale;                // bf16(xdh^-0.5), applied to the xattn query
  // the weight-only kernel's tile plan (ops/megadecode.py's plan,
  // decode_megakernel_sm90.cuh); the w8a8 mode reads none of it
  float* parts;                  // split-K partials, float32
  unsigned* sync;                // the grid barrier's 64-bit arrival count, then per-tile counters
  int split[8];                  // K-slices per 64-column tile: xq xo xf1 xf2 qkv o fc pr
  int n_xattn;                   // layers with a gated xattn block
  unsigned long long* prof;      // (blocks, 7) section timer cycles, or null
};

namespace {

struct Epi {
  int kind;
  const float* scale;  // (N,)
  const bf16* bias;    // (N,) or null
  bf16* out;           // EPI_STORE / EPI_XQ: (b, ld)
  int ld;
  int act;             // EPI_STORE: activation code, or -1
  float mul;           // EPI_XQ: the query scale; EPI_GATED: the gate
  bf16* q; bf16* krow; bf16* vrow;  // EPI_QKV targets, each (b, D)
  // w8a8: where the next linear's quantizer finds each row's amax; the
  // stored |value| of (row, column n) is noted at amax[row * amax_ld +
  // n / amax_width]; null: not noted
  unsigned* amax;
  int amax_ld, amax_width;
};

// w8a8: the quantized A operand of a linear. Row r's scale over its k-slice
// j (k in [j * slice, (j + 1) * slice)) comes from amax[r * ld + j], the bit
// pattern of max |A[r][k]|. Column form: slice = K (one scale per row), the
// owner hands f32(p) * s to the epilogue; row form (rows): the slices' f32(p_j)
// * s_j summed in slice order.
struct Quant {
  const unsigned* amax;
  int ld, slice;
  bool rows;
};

// floats of shared memory per warp in an attention phase: q, then scores
__device__ __host__ __forceinline__ int att_stride(const MegaArgs& a) {
  return (kHeadDim + (a.t_lim > a.NMNV ? a.t_lim : a.NMNV) + 3) & ~3;
}

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// HF gelu_new / torch gelu(approximate="tanh"), in float32
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float x3 = x * x * x;
  const float inner = kBeta * (x + 0.044715f * x3);
  return 0.5f * x * (1.f + tanhf(inner));
}

// exact-erf GELU through the Abramowitz-Stegun 7.1.26 rational erf, as
// pallas_megadecode.py's _gelu_erf_mosaic computes it; every step one
// float32 op in the plain version's order (no contraction), the constants
// its float32 roundings of the same doubles
__device__ __forceinline__ float gelu_erf_rational(float x) {
  const float z = __fmul_rn(x, static_cast<float>(0.70710678118654752));
  const float a = fabsf(z);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(static_cast<float>(0.3275911), a)));
  float poly = __fmul_rn(t, static_cast<float>(1.061405429));
  poly = __fmul_rn(t, __fadd_rn(static_cast<float>(-1.453152027), poly));
  poly = __fmul_rn(t, __fadd_rn(static_cast<float>(1.421413741), poly));
  poly = __fmul_rn(t, __fadd_rn(static_cast<float>(-0.284496736), poly));
  poly = __fmul_rn(t, __fadd_rn(static_cast<float>(0.254829592), poly));
  float erf = __fsub_rn(1.f, __fmul_rn(poly, expf(__fmul_rn(-a, a))));
  erf = z > 0.f ? erf : (z < 0.f ? -erf : 0.f);
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, erf));
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_GELU_TANH) return gelu_tanh(v);
  if (act == ACT_GELU_ERF) return gelu_erf_rational(v);
  return v > 0.f ? v : 0.f;  // ACT_RELU (NaN -> 0; the input is finite)
}

// pallas_megadecode.py's aquant: s = max(amax, 1e-30) * f32(1/127); every
// step rounded as JAX's float32 ops are (no contraction)
__device__ __forceinline__ float quant_scale(unsigned amax_bits) {
  return __fmul_rn(fmaxf(__uint_as_float(amax_bits), kAmaxFloor), kInv127);
}

__device__ __forceinline__ float quant_inv(float s) { return __fdiv_rn(1.f, s); }

// four bf16 values (two bf16x2, lower k first) -> round_half_even(v * inv)
// as four int8 in one word, lowest k in the lowest byte
__device__ __forceinline__ uint32_t quant4(uint32_t lo, uint32_t hi, float inv) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  const int q0 = __float2int_rn(__fmul_rn(a.x, inv));
  const int q1 = __float2int_rn(__fmul_rn(a.y, inv));
  const int q2 = __float2int_rn(__fmul_rn(c.x, inv));
  const int q3 = __float2int_rn(__fmul_rn(c.y, inv));
  return (static_cast<uint32_t>(q0) & 0xffu) | ((static_cast<uint32_t>(q1) & 0xffu) << 8) |
         ((static_cast<uint32_t>(q2) & 0xffu) << 16) | (static_cast<uint32_t>(q3) << 24);
}

// a non-negative |value| into a row-slice amax word: the bit patterns of
// non-negative floats order as the floats, so the max is exact in any order
__device__ __forceinline__ void note_amax(unsigned* p, float abs_value) {
  atomicMax(p, __float_as_uint(abs_value));
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bf16 activations of one row (32 bytes), or zeros past the batch
__device__ __forceinline__ void load_a(const bf16* p, bool ok, uint32_t* w) {
  if (ok) {
    const uint4 u0 = reinterpret_cast<const uint4*>(p)[0];
    const uint4 u1 = reinterpret_cast<const uint4*>(p)[1];
    w[0] = u0.x; w[1] = u0.y; w[2] = u0.z; w[3] = u0.w;
    w[4] = u1.x; w[5] = u1.y; w[6] = u1.z; w[7] = u1.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = 0u;
  }
}

// -> |the stored value| for EPI_STORE (what a w8a8 consumer quantizes), else 0
__device__ float epilogue(const Epi& e, bf16* x, int D, int row, int n, float acc) {
  float y = rbf(acc * e.scale[n]);
  if (e.bias != nullptr) y = rbf(y + ldf(e.bias + n));
  switch (e.kind) {
    case EPI_STORE: {
      if (e.act >= 0) y = activate(y, e.act);
      const bf16 v = __float2bfloat16_rn(y);
      e.out[row * e.ld + n] = v;
      return fabsf(__bfloat162float(v));
    }
    case EPI_XQ:
      e.out[row * e.ld + n] = __float2bfloat16_rn(y * e.mul);
      break;
    case EPI_RESID: {
      bf16* p = x + row * D + n;
      *p = __float2bfloat16_rn(ldf(p) + y);
      break;
    }
    case EPI_GATED: {
      bf16* p = x + row * D + n;
      *p = __float2bfloat16_rn(ldf(p) + rbf(e.mul * y));
      break;
    }
    default: {  // EPI_QKV
      const bf16 v = __float2bfloat16_rn(y);
      if (n < D) e.q[row * D + n] = v;
      else if (n < 2 * D) e.krow[row * D + n - D] = v;
      else e.vrow[row * D + n - 2 * D] = v;
    }
  }
  return 0.f;
}

// The owner thread (row, n0 + col) of an 8-column tile: its epilogue, then,
// if e.amax is set, the max |stored value| over the row's 8 columns noted
// for the next linear's quantizer. Every thread of the block calls it: the
// shuffles span the 8 threads of a row, neighbours in one warp.
__device__ __forceinline__ void finish(const Epi& e, bf16* x, int D, int row, bool valid,
                                       int n0, int col, float acc) {
  const float stored = valid ? epilogue(e, x, D, row, n0 + col, acc) : 0.f;
  if (e.amax != nullptr) {
    float m = stored;
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
    if (valid && col == 0) note_amax(e.amax + row * e.amax_ld + n0 / e.amax_width, m);
  }
}

// the w8a8 linear (struct Quant): y[r][n] = the int8 x int8 sum of each
// k-slice in int32, cast once, scaled; tiling as `linear`'s. red: int32.
__device__ void linear_w8a8(const bf16* A, const int8_t* __restrict__ W, int N, int K,
                            int b, const Epi& e, bf16* x, int D, int* red, int row0,
                            const Quant& q) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int orow = threadIdx.x >> 3;  // the owner's row and column (kThreads == 32 * 8)
  const int ocol = threadIdx.x & 7;
  const int n_slices = (K + q.slice - 1) / q.slice;
  for (int unit = blockIdx.x; unit < N / 8; unit += gridDim.x) {
    const int n0 = unit * 8;
    const int8_t* wrow = W + static_cast<long long>(n0 + g) * K + 16 * t;
    for (int b0 = 0; b0 < b; b0 += kGroupRows) {
      const bool valid = b0 + orow < b;
      float acc_f = 0.f;
      for (int s = 0; s < n_slices; ++s) {
        const int c_end = min(K, (s + 1) * q.slice) / kKChunk;
        float inv[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = b0 + mt * 16 + g + 8 * h;
            inv[mt][h] = r < b ? quant_inv(quant_scale(q.amax[r * q.ld + s])) : 0.f;
          }
        int acc[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][i] = 0;
        // lane (g, t) holds k = k0 + 16t + 8j + {0..3} in the mma's k-slots
        // 4t..4t+3 of step j, and k0 + 16t + 8j + {4..7} in 16+4t..16+4t+3,
        // for A and B alike
#pragma unroll 1
        for (int c = s * q.slice / kKChunk + warp; c < c_end; c += kWarps) {
          const int k0 = c * kKChunk;
          const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wrow + k0));
          const uint32_t wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (b0 + mt * 16 >= b) continue;  // an m-tile past the batch adds 0
            const int r0 = b0 + mt * 16 + g;
            uint32_t a_lo[8], a_hi[8], q_lo[4], q_hi[4];
            load_a(A + static_cast<long long>(r0) * K + k0 + 16 * t, r0 < b, a_lo);
            load_a(A + static_cast<long long>(r0 + 8) * K + k0 + 16 * t, r0 + 8 < b, a_hi);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              q_lo[i] = quant4(a_lo[2 * i], a_lo[2 * i + 1], inv[mt][0]);
              q_hi[i] = quant4(a_hi[2 * i], a_hi[2 * i + 1], inv[mt][1]);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
              mma_s8(acc[mt], q_lo[2 * j], q_hi[2 * j], q_lo[2 * j + 1], q_hi[2 * j + 1],
                     wq[2 * j], wq[2 * j + 1]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            red[(warp * kGroupRows + mt * 16 + g + 8 * (i >> 1)) * 8 + 2 * t + (i & 1)] =
                acc[mt][i];
        __syncthreads();
        if (valid) {
          int sum = 0;  // int32: exact in any order
          for (int w = 0; w < kWarps; ++w) sum += red[(w * kGroupRows + orow) * 8 + ocol];
          const float p = __int2float_rn(sum);  // the slice's one cast
          const float sc = quant_scale(q.amax[(b0 + orow) * q.ld + s]);
          acc_f = q.rows ? __fadd_rn(acc_f, __fmul_rn(p, sc)) : __fmul_rn(p, sc);
        }
        __syncthreads();  // red is rewritten by the next slice or group
      }
      finish(e, x, D, row0 + b0 + orow, valid, n0, ocol, acc_f);
    }
  }
}

// the w8a8 mode's linear (linear_w8a8) under the name its phases call; the
// weight-only mode's linear is decode_megakernel_sm90.cuh's
__device__ void linear(const bf16* A, const int8_t* __restrict__ W, int N, int K,
                       int b, const Epi& e, bf16* x, int D, float* red,
                       int row0, const Quant* q) {
  linear_w8a8(A, W, N, K, b, e, x, D, reinterpret_cast<int*>(red), row0, *q);
}

// LayerNorm (float32 statistics, eps 1e-5) of every row of x into shared
// memory: one warp per row; rowmax (w8a8, or null): each row's max |bf16
// output| as its bit pattern
__device__ void layer_norm_rows(const bf16* x, const float* __restrict__ s,
                                const float* __restrict__ bias, bf16* out, int b,
                                int D, unsigned* rowmax) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < b; r += kWarps) {
    const bf16* xr = x + static_cast<long long>(r) * D;
    // each op one float32 op, no contraction, the sums in this order: lane
    // l adds elements l, l + 32, ... from 0, then the warp's xor butterfly.
    // The plain version (megadecode._layer_norm) repeats it, so both round
    // alike. (Every working block recomputes the group's statistics: float64
    // sums, order-free, cost 0.2-0.6 ms a step there.)
    float sum = 0.f;
    for (int i = lane; i < D; i += 32) sum = __fadd_rn(sum, ldf(xr + i));
    const float mean = __fdiv_rn(warp_sum(sum), static_cast<float>(D));
    float sq = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float d = __fsub_rn(ldf(xr + i), mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), static_cast<float>(D)),
                                        static_cast<float>(1e-5)));
    float m = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float y = __fmul_rn(__fmul_rn(__fsub_rn(ldf(xr + i), mean), rstd), s[i]);
      const bf16 v = __float2bfloat16_rn(__fadd_rn(y, bias[i]));
      out[r * D + i] = v;
      m = fmaxf(m, fabsf(__bfloat162float(v)));
    }
    if (rowmax != nullptr) {
      m = warp_max(m);
      if (lane == 0) rowmax[r] = __float_as_uint(m);
    }
  }
}

// bytes of shared memory an LN phase stages: one group of rows of (., D)
__device__ __host__ __forceinline__ int ln_stage_bytes(const MegaArgs& a) {
  return ((a.b < kGroupRows ? a.b : kGroupRows) * a.D * 2 + 15) & ~15;
}

// LN of the stream, then a linear from it (K = D), one 32-row group at a
// time (the epilogues of these phases never write x); blocks without
// columns to own skip both. Column form, each row's amax from the
// normalised group (smem: stage | red | rowmax)
__device__ void ln_linear(const MegaArgs& a, const float* s, const float* bias,
                          const int8_t* W, int N, const Epi& e, char* smem) {
  if (static_cast<int>(blockIdx.x) >= N / 8) return;
  bf16* sA = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + ln_stage_bytes(a));
  unsigned* rowmax = reinterpret_cast<unsigned*>(smem + ln_stage_bytes(a) + kRedBytes);
  const Quant q{rowmax, 1, a.D, false};
  for (int b0 = 0; b0 < a.b; b0 += kGroupRows) {
    const int rows = min(kGroupRows, a.b - b0);
    layer_norm_rows(a.x + static_cast<long long>(b0) * a.D, s, bias, sA, rows, a.D,
                    rowmax);
    __syncthreads();
    linear(sA, W, N, a.D, rows, e, a.x, a.D, red, b0, &q);
    __syncthreads();  // sA is rewritten by the next group
  }
}

// One warp per (row, head), head dim 64: softmax over the positions
// t < t_lim of (q . K[t]) * scale (rounded to bf16 for xattn), positions
// outside [lo, hi] at -FLT_MAX; out = sum_t bf16(p_t) V[t] / sum_t p_t.
// Row `row` of position t is at (t * b + row) * ld_kv + head * 64.
// Self-attention: lo = npad[row], hi = cur; in beam mode (a.anc set)
// position t is read from the family row (row / kb) * kb + anc[row, t]
// (anc = 0 past anc_len; entries outside [0, kb) are masked and not read).
// Cross-attention: the latents of image text_time[row]; rows with
// text_time == 0 give 0. Positions outside [lo, hi] are never read (their
// weight is exactly 0), unless the range is empty: then every weight is 1,
// as the reference's all-masked softmax has, over t < t_lim of the row, or
// in beam mode of every family row.
// amax: each row's max |bf16 output| noted at amax[row]. The dot
// products, the denominator and the V sums in float64, rounded once (see
// the source note). (The weight-only mode's attention is
// decode_megakernel_sm90.cuh's `attend`.)
__device__ void attention(const MegaArgs& a, const bf16* q, int ld, const bf16* K,
                          const bf16* V, int n_head, int t_lim, float scale,
                          bool xattn, bf16* out, float* smem, unsigned* amax) {
  typedef double Acc;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* qs = smem + warp * att_stride(a);
  float* sc = qs + kHeadDim;
  const int n_warps = gridDim.x * kWarps;
  const long long t_stride = static_cast<long long>(a.b) * ld;
  for (int u = blockIdx.x * kWarps + warp; u < a.b * n_head; u += n_warps) {
    const int row = u / n_head;
    const int head = u % n_head;
    int lo, hi;
    if (xattn) {
      const int tt = a.text_time[row];
      lo = (tt - 1) * a.n_visual;
      hi = tt <= 0 ? -1 : min(tt * a.n_visual, t_lim) - 1;
    } else {
      lo = a.npad[row];
      hi = min(a.cur, t_lim - 1);
    }
    const long long off = static_cast<long long>(row) * ld + head * kHeadDim;
    // beam mode: the physical row of position t, or -1
    const bool beam = !xattn && a.anc != nullptr;
    const int fam0 = beam ? (row / a.kb) * a.kb : row;
    const int* anc_row = beam ? a.anc + static_cast<long long>(row) * a.anc_len : nullptr;
    auto phys = [&](int t) -> int {
      if (!beam) return row;
      const int j = t < a.anc_len ? anc_row[t] : 0;
      return (j >= 0 && j < a.kb) ? fam0 + j : -1;
    };
    qs[2 * lane] = ldf(q + off + 2 * lane);
    qs[2 * lane + 1] = ldf(q + off + 2 * lane + 1);
    __syncwarp();

    // scores: a lane per position, the head's 128 bytes of K in 16-byte loads
    float m = -FLT_MAX;
    for (int t = lane; t < t_lim; t += 32) {
      float s = -FLT_MAX;
      const int prow = (t >= lo && t <= hi) ? phys(t) : -1;
      if (prow >= 0) {
        const uint4* kp = reinterpret_cast<const uint4*>(
            K + t * t_stride + off + static_cast<long long>(prow - row) * ld);
        uint4 kv[kHeadDim / 8];
#pragma unroll
        for (int i = 0; i < kHeadDim / 8; ++i) kv[i] = kp[i];
        // bf16 x bf16 products are exact in float32 and their sum exact
        // in float64: the score is the exact dot rounded once, in any
        // order (four chains)
        double dot[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int i = 0; i < kHeadDim / 8; ++i) {
          const uint32_t w[4] = {kv[i].x, kv[i].y, kv[i].z, kv[i].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
            dot[j] += static_cast<double>(__fmul_rn(qs[8 * i + 2 * j], f.x));
            dot[j] += static_cast<double>(__fmul_rn(qs[8 * i + 2 * j + 1], f.y));
          }
        }
        s = __fmul_rn(__double2float_rn((dot[0] + dot[1]) + (dot[2] + dot[3])), scale);
        if (xattn) s = rbf(s);
      }
      sc[t] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    Acc l_sum = 0;
    for (int t = lane; t < t_lim; t += 32) {
      const float p = expf(sc[t] - m);
      sc[t] = p;
      l_sum += p;
    }
    float l = static_cast<float>(warp_sum(l_sum));
    // beam mode, empty range: every family row's t_lim positions weigh 1
    const bool spread = beam && lo > hi;
    if (spread) l = __fmul_rn(l, static_cast<float>(a.kb));
    l = fmaxf(l, 1e-30f);
    __syncwarp();

    // V product: 4 positions at a time, 8 lanes x 8 dims each
    const bool zero = xattn && a.text_time[row] == 0;
    const int grp = lane >> 3;
    const int dim = (lane & 7) * 8;
    Acc acc[8];  // bf16 x bf16 products, exact, summed in float64
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0;
    // walk u in [u0, u1]: slot t = u of row phys(t), or, spread, slot
    // u % t_lim of family row u / t_lim
    const int u0 = lo <= hi ? lo : 0;
    const int u1 = lo <= hi ? hi : (spread ? a.kb * t_lim : t_lim) - 1;
    if (!zero) {
#pragma unroll 4
      for (int u = u0 + grp; u <= u1; u += 4) {
        const int t = spread ? u % t_lim : u;
        const int prow = spread ? fam0 + u / t_lim : (lo <= hi ? phys(t) : row);
        if (prow < 0) continue;
        const uint4 vv = *reinterpret_cast<const uint4*>(
            V + t * t_stride + off + static_cast<long long>(prow - row) * ld + dim);
        const float p = rbf(sc[t]);
        const uint32_t w[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
          acc[2 * j] += static_cast<double>(__fmul_rn(p, f.x));
          acc[2 * j + 1] += static_cast<double>(__fmul_rn(p, f.y));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 8);
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
    }
    float out_max = 0.f;  // max |bf16 output| of the lane's 8 dims
    if (grp == 0) {
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(
            zero ? 0.f : static_cast<float>(acc[2 * j]) / l,
            zero ? 0.f : static_cast<float>(acc[2 * j + 1]) / l);
        o[j] = *reinterpret_cast<const uint32_t*>(&h);
        out_max = fmaxf(out_max, fmaxf(fabsf(__low2float(h)), fabsf(__high2float(h))));
      }
      *reinterpret_cast<uint4*>(out + off + dim) = make_uint4(o[0], o[1], o[2], o[3]);
    }
    if (amax != nullptr) {
      out_max = warp_max(out_max);
      if (lane == 0) note_amax(amax + row, out_max);
    }
    __syncwarp();  // qs / sc are rewritten by the warp's next unit
  }
}

// The w8a8 mode (a.act_quant); the weight-only mode is
// decode_megakernel_sm90.cuh's kernel
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
decode_megakernel(const MegaArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) char smem[];
  const int D = a.D;
  const int QW = max(a.D, a.XI);
  bf16* qbuf = a.scratch;
  bf16* abuf = a.scratch + a.b * QW;
  bf16* hbuf = a.scratch + 2 * a.b * QW;
  float* red = reinterpret_cast<float*>(smem);
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int n_threads = gridDim.x * kThreads;
  // w8a8: amax words of abuf (one per row: its whole width is one slice or
  // the one slice of a row-form input at most D wide) and of hbuf (nsH
  // D-wide slices per row); null in the weight-only mode
  const int nsH = (max(a.Dff, a.Dffx) + D - 1) / D;
  unsigned* amax_a = a.amax;
  unsigned* amax_h = a.amax + a.b;
  const Quant q_o{amax_a, 1, D, false};   // c_proj: column form, K = D
  const Quant q_xo{amax_a, 1, D, true};   // to_out: row form, K = XI
  const Quant q_h{amax_h, nsH, D, true};  // fc2 / mlp_proj: row form, K = Dff(x)
  // the LN phases zero the amax words that the next two phases fill: every
  // reader of the previous fill is behind a grid barrier
  auto zero_amax = [&]() {
    for (int i = tid; i < a.b * (1 + nsH); i += n_threads) a.amax[i] = 0u;
  };

  for (int i = tid; i < a.b * D; i += n_threads) a.x[i] = a.x_emb[i];
  grid.sync();

  int xs = 0;  // this layer's slot in the xattn weight stacks
  for (int l = 0; l < a.n_layer; ++l) {
    if (a.hasx[l]) {
      const long long DX = static_cast<long long>(D) * a.XI;
      const long long DF = static_cast<long long>(D) * a.Dffx;
      const bf16* xk = a.xk + static_cast<long long>(l) * a.NMNV * a.b * a.XI;
      const bf16* xv = a.xv + static_cast<long long>(l) * a.NMNV * a.b * a.XI;
      Epi e{};
      e.kind = EPI_XQ; e.scale = a.s_xq + xs * a.XI; e.out = qbuf; e.ld = a.XI;
      e.mul = a.xq_scale;
      zero_amax();
      ln_linear(a, a.xn_s + xs * D, a.xn_b + xs * D, a.w_xq + xs * DX, a.XI, e,
                        smem);
      grid.sync();
      attention(a, qbuf, a.XI, xk, xv, a.x_heads, a.NMNV, 1.f, true, abuf,
                reinterpret_cast<float*>(smem), amax_a);
      grid.sync();
      e = Epi{};
      e.kind = EPI_GATED; e.scale = a.s_xo + xs * D; e.mul = a.gates[2 * xs];
      linear(abuf, a.w_xo + xs * DX, D, a.XI, a.b, e, a.x, D, red, 0,
             &q_xo);
      grid.sync();
      e = Epi{};
      e.kind = EPI_STORE; e.scale = a.s_xf1 + xs * a.Dffx; e.out = hbuf; e.ld = a.Dffx;
      e.act = a.xact; e.amax = amax_h; e.amax_ld = nsH; e.amax_width = D;
      ln_linear(a, a.xfn_s + xs * D, a.xfn_b + xs * D, a.w_xf1 + xs * DF, a.Dffx,
                        e, smem);
      grid.sync();
      e = Epi{};
      e.kind = EPI_GATED; e.scale = a.s_xf2 + xs * D; e.mul = a.gates[2 * xs + 1];
      linear(hbuf, a.w_xf2 + xs * DF, D, a.Dffx, a.b, e, a.x, D, red, 0,
             &q_h);
      grid.sync();
      ++xs;
    }
    const long long DD = static_cast<long long>(D) * D;
    const long long DF = static_cast<long long>(D) * a.Dff;
    const long long slab = static_cast<long long>(a.b) * D;
    bf16* krow = a.kc + (static_cast<long long>(l) * a.T + a.cur) * slab;
    bf16* vrow = a.vc + (static_cast<long long>(l) * a.T + a.cur) * slab;
    Epi e{};
    e.kind = EPI_QKV; e.scale = a.s_qkv + l * 3 * D; e.bias = a.b_qkv + l * 3 * D;
    e.q = qbuf; e.krow = krow; e.vrow = vrow;
    zero_amax();
    ln_linear(a, a.ln1_s + l * D, a.ln1_b + l * D, a.w_qkv + 3 * l * DD, 3 * D, e,
                      smem);
    grid.sync();
    attention(a, qbuf, D, a.kc + static_cast<long long>(l) * a.T * slab,
              a.vc + static_cast<long long>(l) * a.T * slab, a.n_head, a.t_lim,
              a.attn_scale, false, abuf, reinterpret_cast<float*>(smem), amax_a);
    grid.sync();
    e = Epi{};
    e.kind = EPI_RESID; e.scale = a.s_o + l * D; e.bias = a.b_o + l * D;
    linear(abuf, a.w_o + l * DD, D, D, a.b, e, a.x, D, red, 0, &q_o);
    grid.sync();
    e = Epi{};
    e.kind = EPI_STORE; e.scale = a.s_fc + l * a.Dff; e.bias = a.b_fc + l * a.Dff;
    e.out = hbuf; e.ld = a.Dff; e.act = a.act;
    e.amax = amax_h; e.amax_ld = nsH; e.amax_width = D;
    ln_linear(a, a.ln2_s + l * D, a.ln2_b + l * D, a.w_fc + l * DF, a.Dff, e,
                      smem);
    grid.sync();
    e = Epi{};
    e.kind = EPI_RESID; e.scale = a.s_pr + l * D; e.bias = a.b_pr + l * D;
    linear(hbuf, a.w_pr + l * DF, D, a.Dff, a.b, e, a.x, D, red, 0,
           &q_h);
    grid.sync();
  }
}

}  // namespace

#include "decode_megakernel_sm90.cuh"

namespace {

// the dynamic shared memory of a launch: w8a8, the larger of an LN phase's
// (the staged group, the reduction buffer and the group's amax words) and
// an attention phase's (b, D, t_lim, NMNV); weight-only,
// decode_megakernel_sm90.cuh's layout (the plan's fields too)
size_t smem_bytes(const MegaArgs& a) {
  if (!a.act_quant) return static_cast<size_t>(mk90::layout(a).bytes);
  const size_t ln = static_cast<size_t>(ln_stage_bytes(a)) + kRedBytes + kRowMaxBytes;
  const size_t att = static_cast<size_t>(kWarps) * att_stride(a) * 4;
  return ln > att ? ln : att;
}

const void* kernel_for(const MegaArgs&) {
  return reinterpret_cast<const void*>(decode_megakernel);
}

// blocks of the cooperative grid, or 0 if the kernel cannot be co-resident
cudaError_t grid_size(const MegaArgs& a, int* blocks, size_t* smem) {
  *smem = smem_bytes(a);
  if (!a.act_quant) return mk90::grid_size(a, blocks);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel_for(a), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for(a), kThreads,
                                                      *smem);
  if (err != cudaSuccess) return err;
  *blocks = min(per_sm, kMaxBlocksPerSm) * sms;
  return cudaSuccess;
}

}  // namespace

// weight-only: decode_megakernel_sm90.cuh; w8a8: decode_megakernel.
// Either raises through its error code; neither gives way to the other.
extern "C" int fmt_decode_megakernel(const MegaArgs* args, void* stream) {
  if (!args->act_quant) return static_cast<int>(mk90::launch(*args, stream));
  int blocks = 0;
  size_t smem = 0;
  cudaError_t err = grid_size(*args, &blocks, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* params[] = {const_cast<MegaArgs*>(args)};
  err = cudaLaunchCooperativeKernel(kernel_for(*args), dim3(blocks), dim3(kThreads), params, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the cooperative grid's block count and dynamic shared memory for these
// arguments (for reports); returns the CUDA error code
extern "C" int fmt_decode_megakernel_grid(const MegaArgs* args, int* blocks,
                                          int* smem) {
  size_t s = 0;
  const cudaError_t err = grid_size(*args, blocks, &s);
  *smem = static_cast<int>(s);
  return static_cast<int>(err);
}

// the shared memory a block of a launch with these arguments needs, in
// bytes (dynamic, and the weight-only kernel's static timer words): reads
// the shapes, act_quant and the weight-only plan; launches nothing and sets
// no attribute (the wrapper compares it with the card's opt-in limit)
extern "C" int fmt_decode_megakernel_smem(const MegaArgs* args) {
  return static_cast<int>(smem_bytes(*args) + (args->act_quant ? 0 : mk90::kTimerBytes));
}

// The w8a8 linear alone, through the megakernel's own device functions:
// out (b, N) bf16 = linear_w8a8 of A (b, K) bf16 and W (N, K) int8 with the
// per-channel scale and an optional bias, the amax words (b, ceil(K /
// slice)) noted by note_amax first. slice = K: column form; rows_form: the
// row form over slice-wide k-slices. For tests; returns the CUDA error.
namespace {

__global__ void w8a8_note_amax(const bf16* A, unsigned* amax, int b, int K, int slice,
                               int ld) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < b * K; i += gridDim.x * blockDim.x)
    note_amax(amax + (i / K) * ld + (i % K) / slice, fabsf(ldf(A + i)));
}

__global__ void __launch_bounds__(kThreads)
w8a8_linear_kernel(const bf16* A, const int8_t* W, const Epi e, int N, int K, int b,
                   const Quant q) {
  extern __shared__ __align__(16) char smem[];
  linear(A, W, N, K, b, e, nullptr, 0, reinterpret_cast<float*>(smem), 0, &q);
}

}  // namespace

extern "C" int fmt_w8a8_linear(const void* A, const void* W, const float* scale,
                               const void* bias, void* out, unsigned* amax, int b, int N,
                               int K, int slice, int rows_form, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ld = (K + slice - 1) / slice;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned) * b * ld, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  w8a8_note_amax<<<min((b * K + 255) / 256, 1024), 256, 0, st>>>(
      static_cast<const bf16*>(A), amax, b, K, slice, ld);
  Epi e{};
  e.kind = EPI_STORE; e.scale = scale; e.bias = static_cast<const bf16*>(bias);
  e.out = static_cast<bf16*>(out); e.ld = N; e.act = -1;
  const Quant q{amax, ld, slice, rows_form != 0};
  w8a8_linear_kernel<<<min(N / 8, 1024), kThreads, kRedBytes, st>>>(
      static_cast<const bf16*>(A), static_cast<const int8_t*>(W), e, N, K, b, q);
  return static_cast<int>(cudaGetLastError());
}

// The weight-only kernel's grid barrier alone (for a card test): `phases`
// barriers on `sync` (two words, zeroed, left zeroed), every block writing
// a stamp into `slots` (2 x blocks words) before each and reading every
// block's back after it; mismatches counted into *errors. One block per SM
// of the megakernel's shape, launched cooperatively.
extern "C" int fmt_grid_sync_test(unsigned* sync, unsigned* slots, unsigned* errors,
                                  int phases, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&sync, &slots, &errors, &phases};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(mk90::grid_sync_test_kernel),
                                    dim3(sms), dim3(mk90::kThreads), params, 0,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// sizeof(MegaArgs): the wrapper checks its ctypes structure against it
extern "C" int fmt_decode_megakernel_args_size() {
  return static_cast<int>(sizeof(MegaArgs));
}
