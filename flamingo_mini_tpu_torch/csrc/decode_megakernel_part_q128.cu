// The w8a8 step at 128-wide self-attention heads
// (decode_megakernel_sm90<true, false, 128>) in a translation unit of its
// own, compiled beside the other sources (see the build note in
// decode_megakernel_sm90.cuh); its entry fmt_mk_step_q128.
#define FMT_MK_PART
#define FMT_MK_STEP fmt_mk_step_q128
#define FMT_MK_Q true
#define FMT_MK_PHASES false
#define FMT_MK_HD 128
#include "decode_megakernel.cu"
