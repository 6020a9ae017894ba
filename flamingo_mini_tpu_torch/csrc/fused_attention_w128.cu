// fused_attention and flash_attention at 128-wide heads, in a translation
// unit of their own (fused_attention_wide.cuh; the entry
// fmt_attention_w128, which fused_attention.cu calls).
#define FMT_ATTN_HD 128
#define FMT_ATTN_ENTRY fmt_attention_w128
#include "fused_attention_wide.cuh"
