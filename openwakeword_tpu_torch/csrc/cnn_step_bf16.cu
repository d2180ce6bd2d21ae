// The 1-pass bf16 variants of the CNN step and prime (K3-bf16 and K4-bf16),
// the TPU kernel's "bf16" mode (openwakeword_tpu/ops/cnn_pallas.py::_dot):
// the tensor-core kernels of cnn_step_mma.cuh in 1-pass arithmetic, built as
// their own translation unit so that nvcc compiles their 40 instantiations in
// parallel with the other variants'.

#include "cnn_step_mma.cuh"

// C entry point: as owwt_cnn_forward (cnn_step.cu), for weights that the host
// rounded once to bf16, per conv one (1, Cout, K padded to 16) plane in the
// tap order (dt, dw, c) (ops/cnn_step.py::prep_params).
extern "C" int owwt_cnn_forward_bf16(const float* mel, int t_in, const float* const* caches_in,
                                     float* const* caches_out, const __nv_bfloat16* const* planes,
                                     const float* const* biases, const float* scale, const float* shift,
                                     float* emb, float* scratch0, float* scratch1, int n_streams,
                                     void* stream) {
    return cnn_forward_mma<kOnePass>(mel, t_in, caches_in, caches_out, planes, biases, scale, shift, emb, scratch0,
                                     scratch1, n_streams, stream);
}
