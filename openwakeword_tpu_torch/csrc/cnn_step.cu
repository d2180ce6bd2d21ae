// Streaming embedding-CNN step and prime for Hopper (sm_90a), fp32 on the CUDA
// cores.
//
// Replaces the TPU kernel openwakeword_tpu/ops/cnn_pallas.py::_make_kernel,
// launched by _run(prime=False) (CnnStepKernel.step) and _run(prime=True)
// (CnnStepKernel.prime(use_pallas=True)): the 20-conv program of the
// speech-embedding CNN in stream-minor layout. Activations are (C, T, W, S)
// float32 with the stream index fastest; caches are the 2-row input tails
// (C, 2, W, S) of the eleven convs that span time. A step takes 8 new mel rows
// (8, 32, S) and the caches; a prime takes the full (76, 32, S) window and
// reads no cache. Both write every new cache and the (96, S) embedding.
//
// What bounds it: about 5.6 M MAC per stream per step, against ~38 KB of
// cache and 1 KB of mel per stream, so the convs are compute-bound on the
// CUDA cores; the inter-layer activations (~380 KB per stream per step) go
// through device memory, one launch per conv. TF32 would break the
// 'highest' budget, so every product is an fp32 FFMA. The design:
//   * one templated kernel per conv, an implicit GEMM with M = Cout,
//     N = output positions x streams, K = kh*kw*Cin in the tap order
//     (dt, dw, c) of the TPU kernel; no im2col in memory;
//   * a block covers 32 streams (one per lane, so every global load and store
//     is a 128-byte line over S) and 4 output positions, for all Cout; each
//     of its 8 warps owns Cout/8 channels. K runs in chunks of 8: the weight
//     chunk (Cout x 8) and the input chunk (8 x 4 positions x 32 streams) go
//     through shared memory, and each thread keeps a (Cout/8) x 4 tile of sums
//     in registers;
//   * prologue: the input of a time conv is read from two pointers, the old
//     cache for rows 0..1 and the new rows after them, with the zero width
//     padding applied on the fly; no concat in memory;
//   * epilogue: bias, then for the stem ReLU -> affine -> clipped leaky, for
//     every other conv but the last the clipped leaky; the 2x2 and 1x2 max
//     pools are fused, since a thread's 4 positions are whole pool windows;
//   * the new caches go to separate buffers, written by the blocks of the
//     first position tile, so no block reads a cache row another has already
//     overwritten.
// No tensor cores, no cross-layer fusion: faster designs are later work.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <utility>

namespace {

constexpr int kStreamTile = 32;                      // streams per block, one per lane
constexpr int kRowGroups = 8;                        // warps; each owns Cout / 8 channels
constexpr int kThreads = kStreamTile * kRowGroups;   // 256
constexpr int kPositions = 4;                        // output positions per block (whole pool windows)
constexpr int kChunk = 8;                            // K per shared-memory chunk
constexpr int kCacheRows = 2;

enum Epilogue { kStem = 0, kLeaky = 1, kBiasOnly = 2 };

// The layer program, one entry per conv: kernel (kh, kw), channels, the max
// pool that follows (1 x 1 = none) and the epilogue. cnn_program.h is written
// at build time from the port's layer spec (ops/cnn_step.py::conv_table, by
// utils/cuda_build.py), so the kernels and the plain versions share one
// program. Every conv pads its width by kw / 2 on each side (the stem by the
// program's leading width pad, the 1x3 convs as 'SAME'), so a conv keeps its
// input width. The eleven convs with kh = 3 keep a cache.
struct ConvSpec {
    int kh, kw, cin, cout, ph, pw, epi;
};

constexpr ConvSpec kConvs[] = {
#include "cnn_program.h"
};
constexpr int kNumConvs = sizeof(kConvs) / sizeof(kConvs[0]);
constexpr int kNumCaches = 11;
constexpr int kEmbDim = 96;

__device__ __forceinline__ float clipped_leaky(float v) {
    return fmaxf(fmaxf(0.2f * v, v), -0.4f);
}

template <int KH, int KW, int CIN, int COUT, int PH, int PW, int EPI>
__global__ void __launch_bounds__(kThreads)
conv_layer_kernel(const float* __restrict__ x,        // (CIN, tx, wx, S) new rows
                  const float* __restrict__ cache,    // (CIN, 2, wv, S) or null: no rows before x
                  float* __restrict__ new_cache,      // (CIN, 2, wv, S) or null: not a time conv
                  const float* __restrict__ taps,     // (KH*KW, COUT, CIN)
                  const float* __restrict__ bias,     // (COUT)
                  const float* __restrict__ scale,    // (COUT), the stem's affine
                  const float* __restrict__ shift,    // (COUT)
                  float* __restrict__ out,            // (COUT, t_out/PH, w_out/PW, S)
                  int tx, int wx, int n_streams) {
    constexpr int K = KH * KW * CIN;
    constexpr int PAD_W = KW / 2;
    constexpr int TM = COUT / kRowGroups;
    constexpr int WIN = PH * PW;
    constexpr int GROUPS = kPositions / WIN;         // pooled outputs per block
    static_assert(COUT % kRowGroups == 0, "Cout splits over the warps");
    static_assert(kPositions % WIN == 0, "a block holds whole pool windows");
    static_assert(kThreads * (kChunk / 2) == kChunk * kPositions * kStreamTile, "one input chunk");

    __shared__ float a_tile[kChunk][COUT];
    __shared__ float b_tile[kChunk][kPositions][kStreamTile];

    const int lane = threadIdx.x % kStreamTile;
    const int row = threadIdx.x / kStreamTile;
    const int s = blockIdx.x * kStreamTile + lane;
    const bool stream_ok = s < n_streams;
    const size_t S = static_cast<size_t>(n_streams);
    const int rows_cached = cache != nullptr ? kCacheRows : 0;
    const int wv = wx + 2 * PAD_W;
    const int t_out = rows_cached + tx - KH + 1;
    const int w_pooled = (wv - KW + 1) / PW;
    const int t_pooled = t_out / PH;
    const int n_pooled = t_pooled * w_pooled;

    // Row r, column v of this conv's (cache ++ width-padded x) input.
    auto input_at = [&](int c, int r, int v) -> float {
        if (r < rows_cached) {
            return cache[((static_cast<size_t>(c) * kCacheRows + r) * wv + v) * S + s];
        }
        const int w = v - PAD_W;
        if (w < 0 || w >= wx) {
            return 0.0f;
        }
        return x[((static_cast<size_t>(c) * tx + (r - rows_cached)) * wx + w) * S + s];
    };

    // The new cache: the input's last 2 rows, every channel and column.
    if (new_cache != nullptr && blockIdx.y == 0 && stream_ok) {
        const int r0 = rows_cached + tx - kCacheRows;
        for (int i = row; i < CIN * kCacheRows * wv; i += kRowGroups) {
            const int c = i / (kCacheRows * wv);
            const int rem = i - c * kCacheRows * wv;
            const int rr = rem / wv;
            new_cache[static_cast<size_t>(i) * S + s] = input_at(c, r0 + rr, rem - rr * wv);
        }
    }

    // This thread stages position `pos` of the block for its lane's stream.
    const int pos = row % kPositions;
    const int q = blockIdx.y * GROUPS + pos / WIN;
    const int e = pos % WIN;
    const bool load_ok = stream_ok && q < n_pooled;
    const int qt = q / w_pooled;
    const int t0 = qt * PH + e / PW;
    const int w0 = (q - qt * w_pooled) * PW + e % PW;

    float acc[TM][kPositions];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < kPositions; ++j) {
            acc[i][j] = 0.0f;
        }
    }

    for (int k0 = 0; k0 < K; k0 += kChunk) {
        for (int i = threadIdx.x; i < COUT * kChunk; i += kThreads) {
            const int o = i / kChunk;
            const int kk = i - o * kChunk;
            const int k = k0 + kk;
            float a = 0.0f;
            if (k < K) {
                const int tap = k / CIN;
                a = taps[(static_cast<size_t>(tap) * COUT + o) * CIN + (k - tap * CIN)];
            }
            a_tile[kk][o] = a;
        }
#pragma unroll
        for (int r = 0; r < kChunk / 2; ++r) {
            const int kk = row / kPositions + 2 * r;
            const int k = k0 + kk;
            float b = 0.0f;
            if (load_ok && k < K) {
                const int tap = k / CIN;
                const int dt = tap / KW;
                b = input_at(k - tap * CIN, t0 + dt, w0 + (tap - dt * KW));
            }
            b_tile[kk][pos][lane] = b;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kChunk; ++kk) {
            float a[TM];
            float b[kPositions];
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                a[i] = a_tile[kk][row * TM + i];
            }
#pragma unroll
            for (int j = 0; j < kPositions; ++j) {
                b[j] = b_tile[kk][j][lane];
            }
#pragma unroll
            for (int i = 0; i < TM; ++i) {
#pragma unroll
                for (int j = 0; j < kPositions; ++j) {
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
                }
            }
        }
        __syncthreads();
    }

    if (!stream_ok) {
        return;
    }
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
        const int qg = blockIdx.y * GROUPS + g;
        if (qg >= n_pooled) {
            break;
        }
        const int qgt = qg / w_pooled;
        const int qgw = qg - qgt * w_pooled;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int o = row * TM + i;
            float m = -FLT_MAX;
#pragma unroll
            for (int p = 0; p < WIN; ++p) {
                float v = acc[i][g * WIN + p] + bias[o];
                if (EPI == kStem) {
                    v = fmaxf(v, 0.0f);
                    v = clipped_leaky(__fadd_rn(__fmul_rn(v, scale[o]), shift[o]));
                } else if (EPI == kLeaky) {
                    v = clipped_leaky(v);
                }
                m = fmaxf(m, v);
            }
            out[((static_cast<size_t>(o) * t_pooled + qgt) * w_pooled + qgw) * S + s] = m;
        }
    }
}

// Output extents of one conv (after its pool) for an input of tx x wx rows and
// columns; false if the program does not fit that input.
struct Geometry {
    int t_pooled, w_pooled, position_tiles;
};

bool conv_geometry(const ConvSpec& c, bool prime, int tx, int wx, Geometry* g) {
    const int rows = (c.kh > 1 && !prime) ? kCacheRows : 0;
    const int t_out = rows + tx - c.kh + 1;
    const int w_out = wx + 2 * (c.kw / 2) - c.kw + 1;
    if (tx < 1 || t_out < 1 || t_out % c.ph != 0 || w_out % c.pw != 0) {
        return false;
    }
    if (c.kh > 1 && rows + tx < kCacheRows) {
        return false;
    }
    g->t_pooled = t_out / c.ph;
    g->w_pooled = w_out / c.pw;
    const int groups = kPositions / (c.ph * c.pw);
    g->position_tiles = (g->t_pooled * g->w_pooled + groups - 1) / groups;
    return true;
}

struct Program {
    const float* const* caches_in;     // null for a prime
    float* const* caches_out;
    const float* const* taps;
    const float* const* biases;
    const float* scale;
    const float* shift;
    float* emb;
    float* scratch[2];
    int n_streams;
    cudaStream_t stream;
    // walk state
    const float* x;
    int tx, wx, cache_i, ping;
    cudaError_t err;
};

template <int I>
void launch_conv(Program& p) {
    constexpr ConvSpec c = kConvs[I];
    if (p.err != cudaSuccess) {
        return;
    }
    Geometry g;
    if (!conv_geometry(c, p.caches_in == nullptr, p.tx, p.wx, &g) || g.position_tiles > 65535) {
        p.err = cudaErrorInvalidValue;
        return;
    }
    const float* cache = nullptr;
    float* new_cache = nullptr;
    if (c.kh > 1) {
        cache = p.caches_in != nullptr ? p.caches_in[p.cache_i] : nullptr;
        new_cache = p.caches_out[p.cache_i];
        ++p.cache_i;
    }
    float* out;
    if (I == kNumConvs - 1) {
        if (g.t_pooled * g.w_pooled * c.cout != kEmbDim) {
            p.err = cudaErrorInvalidValue;
            return;
        }
        out = p.emb;
    } else {
        out = p.scratch[p.ping];
        p.ping ^= 1;
    }
    const dim3 grid((p.n_streams + kStreamTile - 1) / kStreamTile, g.position_tiles);
    conv_layer_kernel<c.kh, c.kw, c.cin, c.cout, c.ph, c.pw, c.epi>
        <<<grid, kThreads, 0, p.stream>>>(p.x, cache, new_cache, p.taps[I], p.biases[I], p.scale,
                                          p.shift, out, p.tx, p.wx, p.n_streams);
    p.err = cudaGetLastError();
    p.x = out;
    p.tx = g.t_pooled;
    p.wx = g.w_pooled;
}

template <std::size_t... I>
void run_program(Program& p, std::index_sequence<I...>) {
    (launch_conv<I>(p), ...);
}

}  // namespace

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
// on the host.
extern "C" int owwt_cnn_forward(const float* mel, int t_in, const float* const* caches_in,
                                float* const* caches_out, const float* const* taps,
                                const float* const* biases, const float* scale, const float* shift,
                                float* emb, float* scratch0, float* scratch1, int n_streams,
                                void* stream) {
    if (n_streams <= 0) {
        return 0;
    }
    Program p{caches_in, caches_out, taps, biases, scale, shift, emb, {scratch0, scratch1},
              n_streams, static_cast<cudaStream_t>(stream), mel, t_in, 32, 0, 0, cudaSuccess};
    run_program(p, std::make_index_sequence<kNumConvs>{});
    if (p.err == cudaSuccess && p.cache_i != kNumCaches) {
        p.err = cudaErrorInvalidValue;
    }
    return static_cast<int>(p.err);
}
