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
// the order megadecode._layer_norm repeats (both modes).
//
// w8a8 (act_quant, pallas_megadecode.py's aquant / mm_cols / mm_rows): a
// linear's bf16 input is quantized per row, s = max(amax, 1e-30) *
// f32(1/127), q = round_half_even(a * (1/s)) as int8, and the int8 x int8
// dot is summed in int32. Column form (to_q, fc1, c_attn, c_proj, mlp_fc:
// one scale per row over the whole input) lin = bf16((f32(p) * s) * scale).
// Row form (to_out, fc2, mlp_proj): each D-wide slice of the input has its
// own per-row scale s_j, acc = sum_j f32(p_j) * s_j in slice order (from
// 0), lin = bf16(acc * scale). Attention stays bf16; its dot products,
// softmax denominator and V sums are taken in float64 and rounded once.
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
// One kernel serves both modes: decode_megakernel_sm90.cuh (TMA weight
// ring, wgmma, its own grid barrier; the mode and the self-attention head
// width (64, 80 or 128; xattn's stays 64) template parameters; its note
// says what bounds it and what the design does about it). This file
// is also the body of the decode_megakernel_part_*.cu units, each of which
// compiles one of the kernels (FMT_MK_PART; the note in the .cuh says why);
// the C interface below is this unit's alone.
// fmt_decode_megakernel routes every call there and raises through its
// error code. What both modes share of the arithmetic:
//
// * Rows: the kernel's 32-bit element offsets into the (b, width)
//   activation buffers are the one limit on the rows, b * max(2 * max(D,
//   XI), max(Dff, Dffx)) < 2^31 (524,287 rows at flamingo-mini width,
//   262,143 at OPT-1.3B's), which the wrapper checks. Offsets into the
//   weight and cache stacks are 64-bit. fmt_decode_megakernel_smem states
//   the shared memory a call needs without launching, so that the wrapper
//   refuses a trunk too wide for the card before anything runs.
// * The w8a8 mode agrees with its plain version bit for bit, which its
//   chaos needs: one activation rounded the other way can flip a quantized
//   value and move the step by ~1e-2 normwise at 24 layers. Its int8 sums
//   are exact (int32), its attention sums float64 (order-free), its
//   LayerNorm float32 in the order the plain version repeats. Masked
//   positions are never loaded and contribute an exact 0, so stale or
//   uninitialised cache rows cannot leak a NaN.
// * Everything written inside the step (x, q, the K/V rows, h, the amax
//   words) is read with coherent loads after a grid barrier; only weights
//   and parameters use the read-only path.
#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kHeadDim = 64;   // xattn's head width, and the self-attention's but at 80, 128
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
  // w8a8: row-slice amax words, (b, nsA) of att then (b, nsH) of h, one per
  // D-wide slice (nsA = ceil(QW / D), nsH = ceil(HW / D)); null weight-only
  unsigned* amax;
  int b, D, Dff, Dffx, XI, n_layer, n_head, x_heads, n_visual, NMNV, T, cur,
      t_lim, act, xact, kb, anc_len, act_quant;
  float attn_scale;              // dh^-0.5, applied to the scores
  float xq_scale;                // bf16(xdh^-0.5), applied to the xattn query
  // the tile plan (ops/megadecode.py's plan, decode_megakernel_sm90.cuh)
  float* parts;                  // split-K partials, float32 (w8a8: int32)
  unsigned* sync;                // the grid barrier's 64-bit arrival count, then per-tile counters
  int split[8];                  // K-slices per 64-column tile: xq xo xf1 xf2 qkv o fc pr
  int n_xattn;                   // layers with a gated xattn block
  unsigned long long* prof;      // (blocks, 7) section timer cycles, or null
  unsigned long long* phases;    // (phases, blocks, 7) the timer at each phase's end, or null
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
  // w8a8, EPI_STORE: where the next linear's quantizer finds each row's
  // amax; |stored value| of (row, column n) is noted at amax[row * amax_ld
  // + n / D]; null: not noted
  unsigned* amax;
  int amax_ld;
};

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float warp_sum(float v) {
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
// as four int8 in one word, lowest k in the lowest byte. |v * inv| <= 127
// (to a few ulps), so adding 1.5 * 2^23 rounds it half to even into the low
// bits of the sum, whose low byte is the int8's two's complement: an FADD
// where F2I runs at a quarter of the rate.
__device__ __forceinline__ uint32_t quant4(uint32_t lo, uint32_t hi, float inv) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  const float kRound = 12582912.f;  // 1.5 * 2^23
  const uint32_t q0 = __float_as_uint(__fadd_rn(__fmul_rn(a.x, inv), kRound));
  const uint32_t q1 = __float_as_uint(__fadd_rn(__fmul_rn(a.y, inv), kRound));
  const uint32_t q2 = __float_as_uint(__fadd_rn(__fmul_rn(c.x, inv), kRound));
  const uint32_t q3 = __float_as_uint(__fadd_rn(__fmul_rn(c.y, inv), kRound));
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040), 0x5410);
}

}  // namespace

#include "decode_megakernel_sm90.cuh"

#if !defined(FMT_MK_PART)
// both modes: decode_megakernel_sm90.cuh's kernel; raises through its error
// code
extern "C" int fmt_decode_megakernel(const MegaArgs* args, void* stream) {
  return static_cast<int>(mk90::launch(*args, stream));
}

// the cooperative grid's block count and dynamic shared memory for these
// arguments (for reports); returns the CUDA error code
extern "C" int fmt_decode_megakernel_grid(const MegaArgs* args, int* blocks,
                                          int* smem) {
  *smem = mk90::layout(*args).bytes;
  return static_cast<int>(mk90::step_grid(*args, blocks));
}

// the shared memory a block of a launch with these arguments needs, in
// bytes (dynamic, and the static section timer words): reads the shapes,
// act_quant and the plan; launches nothing and sets no attribute (the
// wrapper compares it with the card's opt-in limit)
extern "C" int fmt_decode_megakernel_smem(const MegaArgs* args) {
  return mk90::layout(*args).bytes + mk90::kTimerBytes;
}

namespace {

// the amax words (b, ld) of A (b, K) over D-wide slices, zeroed before
__global__ void w8a8_note_amax(const bf16* A, unsigned* amax, int b, int K, int D, int ld) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < b * K; i += gridDim.x * blockDim.x)
    atomicMax(amax + (i / K) * ld + (i % K) / D, __float_as_uint(fabsf(ldf(A + i))));
}

}  // namespace

// The w8a8 linear alone, through the megakernel's own machinery (for
// tests): out (b, n) bf16 = the w8a8 linear `lin` (4 qkv ... 7 pr, its
// shapes (n, K) from args' D and Dff, row form over D-wide slices for pr,
// the column form otherwise) of A (b, K) bf16 and W (n, K) int8, with the
// per-channel scale and an optional bias; args carry b, D, Dff, the plan
// (split, parts, sync: zeroed) and the input's amax words (b, ceil(K /
// D)), which are noted first. Returns the CUDA error.
extern "C" int fmt_w8a8_linear(const MegaArgs* args, int lin, const void* A, const void* W,
                               const float* scale, const void* bias, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MegaArgs& a = *args;
  int n, K;
  mk90::lin_dims(a, lin, &n, &K);
  const int ld = (K + a.D - 1) / a.D;
  cudaError_t err = cudaMemsetAsync(a.amax, 0, sizeof(unsigned) * a.b * ld, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  w8a8_note_amax<<<min((a.b * K + 255) / 256, 1024), 256, 0, st>>>(
      static_cast<const bf16*>(A), a.amax, a.b, K, a.D, ld);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mk90::Lin p{lin, static_cast<const bf16*>(A), nullptr, nullptr, Epi{}, a.amax, ld};
  p.e.kind = EPI_STORE; p.e.scale = scale; p.e.bias = static_cast<const bf16*>(bias);
  p.e.out = static_cast<bf16*>(out); p.e.ld = n; p.e.act = -1;
  return static_cast<int>(mk90::launch_linear(a, p, static_cast<const int8_t*>(W), stream));
}

// The kernel's grid barrier alone (for a card test): `phases`
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
#endif  // !FMT_MK_PART
