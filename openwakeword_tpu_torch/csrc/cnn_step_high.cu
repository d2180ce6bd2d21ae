// The 3-pass bf16 variants of the CNN step and prime (K3-high and K4-high),
// the TPU kernel's "high" mode (openwakeword_tpu/ops/cnn_pallas.py::_dot), the
// default of its CnnStepKernel: the tensor-core kernels of cnn_step_mma.cuh in
// 3-pass arithmetic, built as their own translation unit so that nvcc
// compiles their 40 instantiations in parallel with the other variants'.

#include "cnn_step_mma.cuh"

// C entry point: as owwt_cnn_forward (cnn_step.cu), for weights that the host
// split once into bf16 hi and lo planes, per conv (2, Cout, K padded to 16)
// in the tap order (dt, dw, c) (ops/cnn_step.py::prep_params).
extern "C" int owwt_cnn_forward_high(const float* mel, int t_in, const float* const* caches_in,
                                     float* const* caches_out, const __nv_bfloat16* const* planes,
                                     const float* const* biases, const float* scale, const float* shift,
                                     float* emb, float* scratch0, float* scratch1, int n_streams,
                                     void* stream) {
    return cnn_forward_mma<kThreePass>(mel, t_in, caches_in, caches_out, planes, biases, scale, shift, emb,
                                       scratch0, scratch1, n_streams, stream);
}
