// The attention kernels of fused_attention.cu at one wider head width,
// FMT_ATTN_HD (80 or 128: fused_attention_w80.cu, fused_attention_w128.cu):
// attention_sm90.cuh's Hopper tile for bf16 and attention_tile.cuh's
// mma.sync tile for float32, in the kFull and kStream modes, each unit
// compiled beside the others. Its entry FMT_ATTN_ENTRY(args, is_bf16,
// mode, stream) returns the CUDA error (cudaErrorInvalidValue for another
// mode).
#pragma once

#include "attention_sm90.cuh"

namespace {

template <int kMode>
cudaError_t launch_wide(const void* args, int is_bf16, void* stream) {
  const AttnArgs* a = static_cast<const AttnArgs*>(args);
  return is_bf16 ? launch_attention_sm90<kMode, FMT_ATTN_HD>(a, stream)
                 : launch_attention<kMode, FMT_ATTN_HD>(a, stream);
}

}  // namespace

extern "C" int FMT_ATTN_ENTRY(const void* args, int is_bf16, int mode, void* stream) {
  if (mode == kFull) return static_cast<int>(launch_wide<kFull>(args, is_bf16, stream));
  if (mode == kStream) return static_cast<int>(launch_wide<kStream>(args, is_bf16, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}
