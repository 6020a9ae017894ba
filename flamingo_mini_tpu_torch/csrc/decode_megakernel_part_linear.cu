// The w8a8 linear alone (w8a8_linear_kernel, for tests) in a translation
// unit of its own, compiled beside the other sources (see the build note in
// decode_megakernel_sm90.cuh); its entry fmt_mk_linear.
#define FMT_MK_PART
#define FMT_MK_LINEAR
#include "decode_megakernel.cu"
