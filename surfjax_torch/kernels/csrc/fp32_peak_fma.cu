// The FP32 roofline probe's two mixes once more, built with -fmad=true
// (kernels/_build.py gives this source that flag): fp_bulb_mix_fma and
// fp_cheb_mix_fma, whose multiply-adds the compiler may contract. Only the
// probe runs them; the render kernels stay without contraction.
#define FP32_PEAK_CONTRACTED 1
#include "fp32_peak.cu"
