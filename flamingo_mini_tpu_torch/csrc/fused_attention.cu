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
// Both are attention_tile.cuh's kernel (its note says what bounds them and
// what the design does about it), in its kFull and kStream modes.
#include "attention_tile.cuh"

extern "C" int fmt_fused_attention(const void* args, int is_bf16, void* stream) {
  return static_cast<int>(launch_attention<kFull>(
      static_cast<const AttnArgs*>(args), is_bf16, stream));
}

extern "C" int fmt_flash_attention(const void* args, int is_bf16, void* stream) {
  return static_cast<int>(launch_attention<kStream>(
      static_cast<const AttnArgs*>(args), is_bf16, stream));
}

// the wrapper checks its mirror of AttnArgs against this
extern "C" int fmt_attention_args_size() { return static_cast<int>(sizeof(AttnArgs)); }
