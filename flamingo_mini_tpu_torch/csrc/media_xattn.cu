// Media-masked cross-attention.
//
// fmt_media_xattn replaces flamingo_mini_tpu/ops/pallas_xattn.py::
// fused_media_xattn (_impl, kernel _xattn_kernel): a text token attends the
// n_visual latents of image j iff text_time[row] == j + 1, masked scores are
// float32 min, the softmax is max-subtracted, and rows with text_time 0 are
// zeroed. A row past the media count is fully masked and averages V.
//
// This is attention_tile.cuh's kernel in its kMedia mode (its note says
// what bounds it and what the design does about it). The media time of a
// key is key / n_visual + 1, computed from the index: no mask is built.
#include "attention_tile.cuh"

extern "C" int fmt_media_xattn(const void* args, int is_bf16, void* stream) {
  const AttnArgs* a = static_cast<const AttnArgs*>(args);
  return static_cast<int>(is_bf16 ? launch_attention<__nv_bfloat16, kMedia>(a, stream)
                                  : launch_attention<float, kMedia>(a, stream));
}
