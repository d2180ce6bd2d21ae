// The fp32 CNN step and prime (kernels 3 and 4) of the port: the kernel is in
// cnn_step.cuh, whose walk over the program cnn_step_bf16.cu and
// cnn_step_high.cu share (through cnn_step_mma.cuh).

#include "cnn_step.cuh"

// Floats of scratch per stream that owwt_cnn_forward needs in each of its two
// ping-pong buffers for a `t_in`-row input (8 for a step, 76 for a prime);
// -1 if the program does not fit that input.
extern "C" long long owwt_cnn_scratch_floats(int t_in, int prime) {
    int tx = t_in;
    int wx = 32;
    long long most = 0;
    for (int i = 0; i < kNumConvs; ++i) {
        Geometry g;
        if (!conv_geometry(kConvs[i], prime != 0, tx, wx, &g)) {
            return -1;
        }
        if (i < kNumConvs - 1) {
            const long long n = static_cast<long long>(kConvs[i].cout) * g.t_pooled * g.w_pooled;
            most = n > most ? n : most;
        }
        tx = g.t_pooled;
        wx = g.w_pooled;
    }
    return most;
}

// C entry point: the whole program for `n_streams` streams, one launch per
// conv on `stream`. `caches_in` is null for a prime (K4) and holds the eleven
// old caches for a step (K3); `caches_out` the eleven new ones, which must not
// alias the old. Returns the first launch error (0 = every launch accepted).
// Pointers are device pointers to contiguous float32; the pointer arrays live
// on the host. Each conv runs the 16-byte-copy variant of its kernel when S is
// a multiple of 4 and every activation, cache and scratch pointer is 16-byte
// aligned, and the 4-byte-copy variant otherwise.
extern "C" int owwt_cnn_forward(const float* mel, int t_in, const float* const* caches_in,
                                float* const* caches_out, const float* const* taps,
                                const float* const* biases, const float* scale, const float* shift,
                                float* emb, float* scratch0, float* scratch1, int n_streams,
                                void* stream) {
    return cnn_forward(mel, t_in, caches_in, caches_out, taps, biases, scale, shift, emb, scratch0, scratch1,
                       n_streams, stream);
}
