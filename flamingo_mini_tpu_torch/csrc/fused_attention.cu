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
#include "attention_sm90.cuh"

namespace {

template <int kMode>
cudaError_t launch(const void* args, int is_bf16, void* stream) {
  const AttnArgs* a = static_cast<const AttnArgs*>(args);
  return is_bf16 ? launch_attention_sm90<kMode>(a, stream) : launch_attention<kMode>(a, stream);
}

}  // namespace

extern "C" int fmt_fused_attention(const void* args, int is_bf16, void* stream) {
  return static_cast<int>(launch<kFull>(args, is_bf16, stream));
}

extern "C" int fmt_flash_attention(const void* args, int is_bf16, void* stream) {
  return static_cast<int>(launch<kStream>(args, is_bf16, stream));
}

// the wrapper checks its mirror of AttnArgs against this
extern "C" int fmt_attention_args_size() { return static_cast<int>(sizeof(AttnArgs)); }
