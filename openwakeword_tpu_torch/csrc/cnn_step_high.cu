// The 3-pass bf16 variants of the CNN step and prime (kernels 3 and 4), the
// TPU kernel's "high" mode (openwakeword_tpu/ops/cnn_pallas.py::_dot), the
// default of its CnnStepKernel: the kernel of cnn_step.cuh with the weights
// and every staged input split into bf16 (hi, lo) halves, built as its own
// translation unit so that nvcc compiles its 40 instantiations in parallel
// with the other variants'.

#include "cnn_step.cuh"

// C entry point: as owwt_cnn_forward (cnn_step.cu), for weights that the host
// split into packed bf16 (hi, lo) words (ops/cnn_step.py::prep_params).
extern "C" int owwt_cnn_forward_high(const float* mel, int t_in, const float* const* caches_in,
                                     float* const* caches_out, const float* const* taps,
                                     const float* const* biases, const float* scale, const float* shift,
                                     float* emb, float* scratch0, float* scratch1, int n_streams,
                                     void* stream) {
    return cnn_forward<kThreePass>(mel, t_in, caches_in, caches_out, taps, biases, scale, shift, emb, scratch0,
                                   scratch1, n_streams, stream);
}
