// The weight-only step with the phase timer (decode_megakernel_sm90<false, true>) in a
// translation unit of its own, compiled beside the other sources (see the
// build note in decode_megakernel_sm90.cuh); its entry fmt_mk_step_w_phases.
#define FMT_MK_PART
#define FMT_MK_STEP fmt_mk_step_w_phases
#define FMT_MK_Q false
#define FMT_MK_PHASES true
#include "decode_megakernel.cu"
