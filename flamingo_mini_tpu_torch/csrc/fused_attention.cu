// Fused softmax attention, full-KV and streaming.
//
// fmt_fused_attention replaces flamingo_mini_tpu/ops/pallas_attn.py::
// fused_attention's full-KV kernel (_pallas_attention_fwd_impl, kernel
// _attn_kernel): softmax(scale * Q K^T + bias + row_bias, causal) V with
// float32 scores and probabilities and one rounding of the output.
//
// fmt_flash_attention replaces its streaming variant
// (_flash_attention_fwd_impl, kernel _flash_kernel): the same without
// `bias`, by online softmax, the keys padded to the TPU kernel's kv block.
//
// The route is by dtype alone: bf16 inputs run attention_sm90.cuh's Hopper
// tile (TMA, wgmma, a producer warpgroup and one consumer warpgroup per 64
// query rows; its note says what bounds it and what the design does about
// it), float32 inputs attention_tile.cuh's mma.sync tile, in the kFull and
// kStream modes. A bf16 call the Hopper tile refuses returns its error; it
// never goes to the other tile.
//
// Head widths: 64 here; 80 and 128 (the trunks of opt-2.7b and opt-6.7b)
// in translation units of their own, fused_attention_w80.cu and
// fused_attention_w128.cu (the same templates at kHD 80 and 128, built
// beside this one). Any other width returns cudaErrorInvalidValue.
#include "attention_sm90.cuh"

// the wide units' entries (fused_attention_wide.cuh)
extern "C" int fmt_attention_w80(const void* args, int is_bf16, int mode, void* stream);
extern "C" int fmt_attention_w128(const void* args, int is_bf16, int mode, void* stream);

namespace {

template <int kMode>
cudaError_t launch(const void* args, int is_bf16, int hd, void* stream) {
  if (hd == 80) return static_cast<cudaError_t>(fmt_attention_w80(args, is_bf16, kMode, stream));
  if (hd == 128) return static_cast<cudaError_t>(fmt_attention_w128(args, is_bf16, kMode, stream));
  if (hd != kD) return cudaErrorInvalidValue;
  const AttnArgs* a = static_cast<const AttnArgs*>(args);
  return is_bf16 ? launch_attention_sm90<kMode>(a, stream) : launch_attention<kMode>(a, stream);
}

}  // namespace

// hd: the head width (64, 80 or 128)
extern "C" int fmt_fused_attention(const void* args, int is_bf16, int hd, void* stream) {
  return static_cast<int>(launch<kFull>(args, is_bf16, hd, stream));
}

extern "C" int fmt_flash_attention(const void* args, int is_bf16, int hd, void* stream) {
  return static_cast<int>(launch<kStream>(args, is_bf16, hd, stream));
}

// the wrapper checks its mirror of AttnArgs against this
extern "C" int fmt_attention_args_size() { return static_cast<int>(sizeof(AttnArgs)); }
