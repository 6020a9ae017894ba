// Media-masked cross-attention.
//
// fmt_media_xattn replaces flamingo_mini_tpu/ops/pallas_xattn.py::
// fused_media_xattn (_impl, kernel _xattn_kernel): a text token attends the
// n_visual latents of image j iff text_time[row] == j + 1, masked scores are
// float32 min, the softmax is max-subtracted, and rows with text_time 0 are
// zeroed. A row past the media count is fully masked and averages V.
//
// The route is by dtype alone: bf16 inputs run media_xattn_sm90.cuh's
// kernel with the wrapper's plan (16-row slices a block; its note says what
// bounds it and what the design does about it), float32 inputs
// attention_tile.cuh's kernel in its kMedia mode (the plan is not read). A
// bf16 call the new kernel refuses returns its error; it never goes to the
// other tile. Neither builds a mask: the media time of a key is
// key / n_visual + 1, from its index.
#include "media_xattn_sm90.cuh"

extern "C" int fmt_media_xattn(const void* args, int is_bf16, int slices, void* stream) {
  const AttnArgs* a = static_cast<const AttnArgs*>(args);
  return static_cast<int>(is_bf16 ? launch_media_xattn_sm90(a, slices, stream)
                                  : launch_attention<kMedia>(a, stream));
}
