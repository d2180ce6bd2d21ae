// Streaming embedding-CNN step and prime for Hopper (sm_90a), on the CUDA
// cores' fp32 FFMA: the kernel and its launch plan, built by cnn_step.cu (the
// fp32 kernels, entry point owwt_cnn_forward). The walk over the program
// (Program, conv_io, run_forward) also serves the 1-pass and 3-pass bf16
// variants on the tensor cores (cnn_step_mma.cuh, built by cnn_step_bf16.cu
// and cnn_step_high.cu).
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
// What bounds it: 11.2 MFLOP per stream per step (83.9 per prime) against
// ~38 KB of cache and 1 KB of mel, so on this card the work is compute on the
// fp32 pipes (TF32 would break the 'highest' budget, so every product is an
// fp32 FFMA); the inter-layer activations (~300 KB per stream per step) go
// through L2 and device memory, one launch per conv. The FFMAs run at the
// pipes' rate only if their operands come from registers and shared memory
// at well under one 16-byte load per 16 FFMAs, and if staging stays off the
// critical path. The design:
//   * one templated kernel per conv, an implicit GEMM with M = Cout,
//     N = output positions x streams, K = kh*kw*Cin in the tap order
//     (dt, dw, c) of the TPU kernel; no im2col in memory;
//   * a thread holds 8 output channels (mg, mg + Cout/8, ...) x NC output
//     positions (1 or 2) x 4 consecutive streams in registers (64 sums at
//     NC = 2). Per 4 K steps it reads one 16-byte weight load per channel
//     (weights sit [Cout][K slice + 4], as in memory, so they are copied
//     16 bytes at a time; a warp reads 1, 2 or 4 distinct rows) and per
//     K step and position one 16-byte load of its 4 streams (inputs sit
//     [k][cell][4 streams]; a quarter warp reads 8 consecutive cells):
//     16 shared loads per 256 FFMAs;
//   * a block holds all Cout and a tile of 32 streams x G*NC positions
//     (128-512 outputs), G, NC and the K slice per conv from the generated
//     table cnn_tiles.h (ops/cnn_step_cuda.py::conv_tiles). Positions are
//     numbered pool window by window, so a thread's positions are whole pool
//     windows (1x2), or half of a 2x2 window whose other half a thread of
//     the same warp holds (one shuffle); the pools stay fused in the
//     epilogue;
//   * K runs in slices of 8-24 through a 3-deep cp.async ring: 16-byte
//     copies along S, or 4-byte copies masked per stream where S % 4 or a
//     pointer's alignment rules the 16-byte ones out (a variant of the same
//     kernel that the host picks). Each input cell is staged by fixed
//     threads that keep its row offsets in registers; a tap's offsets come
//     from a per-block table, so a copy is a multiply-add and a select. The
//     time convs read rows 0..1 from the old cache and the rest from the new
//     rows (no concat in memory); the width padding, padded taps and the
//     ragged stream tile come from cp.async zero-fill;
//   * epilogue: bias, then for the stem ReLU -> affine -> clipped leaky, for
//     every other conv but the last the clipped leaky, then the max pool,
//     stored 16 bytes at a time along S;
//   * the new caches go to separate buffers. Every block copies its share of
//     the rows of its own stream tile, 8 loads in flight per thread, so no
//     block reads a cache row that another writes.
// No tensor cores, no cross-layer fusion.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <utility>

#include "smem.cuh"

namespace {

constexpr int kCacheRows = 2;
constexpr int kCopyBatch = 8;                        // new-cache loads in flight per thread
constexpr int kFar = 1 << 20;                        // a row offset that marks a zero cell or tap
constexpr size_t kSmemLimit = 227 * 1024;            // shared memory one block may take

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

// Each conv's block tile (ops/cnn_step_cuda.py::conv_tiles): G position
// groups of kStreamQuads threads per channel group, NC positions per thread,
// K slices of KS. The generated cnn_tiles.h defines kTiles and the tile
// constants kStreamQuads (a block's streams, in quads of 4), kThreadChannels
// (output channels per thread) and kStages (K slices in flight).
struct ConvTile {
    int groups, per_thread, k_slice;
};

#include "cnn_tiles.h"

constexpr int kStreamTile = 4 * kStreamQuads;        // streams per block
static_assert(sizeof(kTiles) / sizeof(kTiles[0]) == kNumConvs, "one tile per conv");

constexpr int tile_threads(const ConvSpec& c, const ConvTile& t) {
    return (c.cout / kThreadChannels) * kStreamQuads * t.groups;
}

// The dynamic shared memory of one block: kStages input slices, kStages
// weight slices and the tap table.
constexpr size_t tile_smem_bytes(const ConvSpec& c, const ConvTile& t) {
    const int k = c.kh * c.kw * c.cin;
    const int k_pad = (k + t.k_slice - 1) / t.k_slice * t.k_slice;
    const int cells = kStreamQuads * t.groups * t.per_thread;
    return kStages * (static_cast<size_t>(t.k_slice) * cells * 16 + static_cast<size_t>(c.cout) * (t.k_slice + 4) * 4) +
           static_cast<size_t>(k_pad) * 16;
}

__device__ __forceinline__ float clipped_leaky(float v) {
    return fmaxf(fmaxf(0.2f * v, v), -0.4f);
}

// One conv for one block: 32 streams x G*NC positions x all COUT channels.
// VEC: S % 4 == 0 and every pointer 16-byte aligned, so a stream quad moves
// as one 16-byte copy; otherwise as four 4-byte copies masked per stream.
template <int KH, int KW, int CIN, int COUT, int PH, int PW, int EPI, int G, int NC, int KS, bool VEC>
__global__ void __launch_bounds__((COUT / kThreadChannels) * kStreamQuads * G,
                                  (COUT / kThreadChannels) * kStreamQuads * G <= 192 ? 2 : 1)
conv_layer_kernel(const float* __restrict__ x,        // (CIN, tx, wx, S) new rows
                  const float* __restrict__ cache,    // (CIN, 2, wv, S) or null: no rows before x
                  float* __restrict__ new_cache,      // (CIN, 2, wv, S) or null: not a time conv
                  const float* __restrict__ taps,     // (KH*KW, COUT, CIN)
                  const float* __restrict__ bias,     // (COUT)
                  const float* __restrict__ scale,    // (COUT), the stem's affine
                  const float* __restrict__ shift,    // (COUT)
                  float* __restrict__ out,            // (COUT, t_out/PH, w_out/PW, S)
                  int tx, int wx, int n_streams) {
    constexpr int TM = kThreadChannels;
    constexpr int MG = COUT / TM;                    // channel groups: group mg holds channels mg + MG*i
    constexpr int K = KH * KW * CIN;
    constexpr int KPAD = (K + KS - 1) / KS * KS;
    constexpr int PAD_W = KW / 2;
    constexpr int WIN = PH * PW;
    constexpr int NT = kStreamQuads * G;             // threads per channel group
    constexpr int THREADS = MG * NT;
    constexpr int NCELL = NT * NC;                   // (position, stream quad) cells per tile
    constexpr int NPT = G * NC;                      // positions per tile
    constexpr int WKS = KS + 4;                      // floats per channel row of a weight slice
    constexpr int COPIERS = THREADS / NCELL;         // threads that stage each cell's inputs
    static_assert(KS % 4 == 0 && COPIERS >= 1, "16-byte weight rows; every cell has a copier");
    static_assert(CIN % 4 != 0 || K % KS == 0, "16-byte weight copies never reach past K");

    extern __shared__ __align__(16) unsigned char smem[];
    float4* xs = reinterpret_cast<float4*>(smem);                   // [kStages][KS][NCELL] stream quads
    float* ws = reinterpret_cast<float*>(xs + kStages * KS * NCELL);  // [kStages][COUT][WKS]
    int4* ktab = reinterpret_cast<int4*>(ws + kStages * COUT * WKS);  // [KPAD] per tap k

    const int tid = threadIdx.x;
    const int S = n_streams;
    const size_t SS = static_cast<size_t>(n_streams);
    const int rc = cache != nullptr ? kCacheRows : 0;
    const int wv = wx + 2 * PAD_W;
    const int t_out = rc + tx - KH + 1;
    const int w_pooled = (wv - KW + 1) / PW;
    const int n_pooled = (t_out / PH) * w_pooled;
    const int n_pos = n_pooled * WIN;
    const int s_tile = blockIdx.x * kStreamTile;
    const int p_tile = blockIdx.y * NPT;

    // Row r, column v of the virtual input (cache rows, then x padded by PAD_W)
    // for tap k and a cell at (t0, w0): r = t0 + dt, v = w0 + dw. The cache row
    // is (c*2 + r)*wv + v, the x row (c*tx + r - rc)*wx + v - PAD_W; each splits
    // into a tap part, kept in ktab[k] = {x part, cache part, dt, dw}, and a
    // cell part, kept in the copying thread's registers. dt = -kFar marks a
    // padded tap, t0 = -kFar a cell past the end of the positions or streams.
    for (int k = tid; k < KPAD; k += THREADS) {
        int4 e = make_int4(0, 0, -kFar, 0);
        if (k < K) {
            const int tap = k / CIN;
            const int c = k - tap * CIN;
            const int dt = tap / KW;
            const int dw = tap - dt * KW;
            e = make_int4((c * tx + dt) * wx + dw, (c * kCacheRows + dt) * wv + dw, dt, dw);
        }
        ktab[k] = e;
    }
    // Cell = j*NT + tn with tn = pg*8 + sq: stream quad sq, tile position
    // pg*NC + j. Tile positions are numbered pool window by window. Thread
    // tid < COPIERS*NCELL stages cell tid % NCELL at K steps tid / NCELL,
    // tid / NCELL + COPIERS, ...
    const int cell = tid % NCELL;
    const bool copier = tid < COPIERS * NCELL;
    const int cs0 = s_tile + 4 * (cell % kStreamQuads);
    int ct0 = -kFar;
    int cw0 = 0;
    long long cx = 0;
    long long cc = 0;
    {
        const int pos = p_tile + (cell % NT / kStreamQuads) * NC + cell / NT;
        if (copier && pos < n_pos && cs0 < S) {
            const int q = pos / WIN;
            const int el = pos - q * WIN;
            const int qt = q / w_pooled;
            ct0 = qt * PH + el / PW;
            const int w0 = (q - qt * w_pooled) * PW + el % PW;
            cw0 = w0 - PAD_W;
            cx = static_cast<long long>((ct0 - rc) * wx + cw0) * S + cs0;
            cc = static_cast<long long>(ct0 * wv + w0) * S + cs0;
        }
    }
    __syncthreads();

    // Starts the copies of K slice `sl` into buffer `buf` as one cp.async group.
    auto load_slice = [&](int sl, int buf) {
        const int k0 = sl * KS;
        if (copier) {
            float4* xd = xs + buf * KS * NCELL + cell;
            for (int kk = tid / NCELL; kk < KS; kk += COPIERS) {
                const int4 kt = ktab[k0 + kk];
                const int r = ct0 + kt.z;
                const bool from_cache = r < rc;
                const bool ok = r >= 0 && (from_cache || static_cast<unsigned>(cw0 + kt.w) < static_cast<unsigned>(wx));
                const float* src = x;
                if (ok) {
                    src = from_cache ? cache + (cc + static_cast<long long>(kt.y) * S)
                                     : x + (cx + static_cast<long long>(kt.x) * S);
                }
                if (VEC) {
                    cp_async16_fill(xd + kk * NCELL, src, ok ? 16 : 0);
                } else {
                    float* d = reinterpret_cast<float*>(xd + kk * NCELL);
#pragma unroll
                    for (int l = 0; l < 4; ++l) {
                        const bool okl = ok && cs0 + l < S;
                        cp_async4_fill(d + l, okl ? src + l : x, okl ? 4 : 0);
                    }
                }
            }
        }
        // weights [o][k]: 16-byte copies of 4 consecutive input channels
        float* wd = ws + buf * COUT * WKS;
        if constexpr (CIN % 4 == 0) {
            for (int i = tid; i < COUT * (KS / 4); i += THREADS) {
                const int o = i / (KS / 4);
                const int kk = 4 * (i - o * (KS / 4));
                const int tap = (k0 + kk) / CIN;
                cp_async16_fill(wd + o * WKS + kk,
                                taps + (static_cast<size_t>(tap) * COUT + o) * CIN + (k0 + kk - tap * CIN), 16);
            }
        } else {
            for (int i = tid; i < COUT * KS; i += THREADS) {
                const int o = i / KS;
                const int kk = i - o * KS;
                const int tap = (k0 + kk) / CIN;
                const bool ok = k0 + kk < K;
                cp_async4_fill(wd + o * WKS + kk,
                               ok ? taps + (static_cast<size_t>(tap) * COUT + o) * CIN + (k0 + kk - tap * CIN) : taps,
                               ok ? 4 : 0);
            }
        }
        cp_async_commit();
    };

    constexpr int kSlices = KPAD / KS;
#pragma unroll
    for (int sl = 0; sl < kStages - 1; ++sl) {
        if (sl < kSlices) {
            load_slice(sl, sl);
        } else {
            cp_async_commit();
        }
    }

    // The new cache: the virtual input's last 2 rows, every channel and
    // column. Rows blockIdx.y, blockIdx.y + gridDim.y, ... of this stream
    // tile, one stream quad per thread and unit, kCopyBatch units in flight.
    if (new_cache != nullptr) {
        const int n_rows = CIN * kCacheRows * wv;
        const int r0 = rc + tx - kCacheRows;
        const int rows_here = (n_rows - static_cast<int>(blockIdx.y) + static_cast<int>(gridDim.y) - 1) /
                              static_cast<int>(gridDim.y);
        for (int u0 = tid; u0 < rows_here * kStreamQuads; u0 += kCopyBatch * THREADS) {
            float v[kCopyBatch][4];
            float* dst[kCopyBatch];
            int n_valid[kCopyBatch];
#pragma unroll
            for (int b = 0; b < kCopyBatch; ++b) {
                const int u = u0 + b * THREADS;
                const int row = blockIdx.y + (u / kStreamQuads) * gridDim.y;
                const int s0 = s_tile + 4 * (u % kStreamQuads);
                n_valid[b] = u < rows_here * kStreamQuads ? min(4, S - s0) : 0;
                dst[b] = new_cache + static_cast<size_t>(row) * SS + s0;
                const float* src = nullptr;
                if (n_valid[b] > 0) {
                    const int c = row / (kCacheRows * wv);
                    const int rem = row - c * kCacheRows * wv;
                    const int rr = rem / wv;
                    const int col = rem - rr * wv;
                    const int r = r0 + rr;
                    if (r < rc) {
                        src = cache + (static_cast<size_t>(c * kCacheRows + r) * wv + col) * SS + s0;
                    } else if (col >= PAD_W && col - PAD_W < wx) {
                        src = x + (static_cast<size_t>(c * tx + r - rc) * wx + col - PAD_W) * SS + s0;
                    }
                }
                if (VEC) {
                    const float4 f = src != nullptr ? *reinterpret_cast<const float4*>(src)
                                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                    v[b][0] = f.x;
                    v[b][1] = f.y;
                    v[b][2] = f.z;
                    v[b][3] = f.w;
                } else {
#pragma unroll
                    for (int l = 0; l < 4; ++l) {
                        v[b][l] = src != nullptr && l < n_valid[b] ? src[l] : 0.0f;
                    }
                }
            }
#pragma unroll
            for (int b = 0; b < kCopyBatch; ++b) {
                if (VEC) {
                    if (n_valid[b] > 0) {
                        *reinterpret_cast<float4*>(dst[b]) = make_float4(v[b][0], v[b][1], v[b][2], v[b][3]);
                    }
                } else {
#pragma unroll
                    for (int l = 0; l < 4; ++l) {
                        if (l < n_valid[b]) {
                            dst[b][l] = v[b][l];
                        }
                    }
                }
            }
        }
    }

    const int mg = tid / NT;
    const int tn = tid - mg * NT;
    float acc[TM][NC][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
#pragma unroll
            for (int l = 0; l < 4; ++l) {
                acc[i][j][l] = 0.0f;
            }
        }
    }

    for (int sl = 0; sl < kSlices; ++sl) {
        // slice sl + kStages - 1 goes into the buffer that slice sl - 1 used
        if (sl + kStages - 1 < kSlices) {
            load_slice(sl + kStages - 1, (sl + kStages - 1) % kStages);
        } else {
            cp_async_commit();
        }
        cp_async_wait<kStages - 1>();
        const int buf = sl % kStages;
        __syncthreads();
        const float4* xb = xs + buf * KS * NCELL + tn;
        const float* wb = ws + buf * COUT * WKS + mg * WKS;
#pragma unroll
        for (int kq = 0; kq < KS / 4; ++kq) {
            float4 w4[TM];                           // channel mg + MG*i, K steps 4kq .. 4kq + 3
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                w4[i] = *reinterpret_cast<const float4*>(wb + i * MG * WKS + 4 * kq);
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
                for (int j = 0; j < NC; ++j) {
                    const float4 b = xb[(4 * kq + kk) * NCELL + j * NT];
#pragma unroll
                    for (int i = 0; i < TM; ++i) {
                        const float w = kk == 0 ? w4[i].x : kk == 1 ? w4[i].y : kk == 2 ? w4[i].z : w4[i].w;
                        acc[i][j][0] = fmaf(w, b.x, acc[i][j][0]);
                        acc[i][j][1] = fmaf(w, b.y, acc[i][j][1]);
                        acc[i][j][2] = fmaf(w, b.z, acc[i][j][2]);
                        acc[i][j][3] = fmaf(w, b.w, acc[i][j][3]);
                    }
                }
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int o = mg + MG * i;
        const float b = bias[o];
        float sc = 1.0f;
        float sh = 0.0f;
        if (EPI == kStem) {
            sc = scale[o];
            sh = shift[o];
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
#pragma unroll
            for (int l = 0; l < 4; ++l) {
                float v = acc[i][j][l] + b;
                if (EPI == kStem) {
                    v = fmaxf(v, 0.0f);
                    v = clipped_leaky(__fadd_rn(__fmul_rn(v, sc), sh));
                } else if (EPI == kLeaky) {
                    v = clipped_leaky(v);
                }
                acc[i][j][l] = v;
            }
        }
    }

    const int pos0 = p_tile + (tn / kStreamQuads) * NC;   // this thread's first position
    const int s0 = s_tile + 4 * (tn % kStreamQuads);
    auto store = [&](int o, int q, float v0, float v1, float v2, float v3) {
        if (q >= n_pooled || s0 >= S) {
            return;
        }
        float* dst = out + (static_cast<size_t>(o) * n_pooled + q) * SS + s0;
        if (VEC) {
            *reinterpret_cast<float4*>(dst) = make_float4(v0, v1, v2, v3);
        } else {
            const float v[4] = {v0, v1, v2, v3};
            for (int l = 0; l < 4 && s0 + l < S; ++l) {
                dst[l] = v[l];
            }
        }
    };
    if constexpr (WIN == 1) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
            for (int j = 0; j < NC; ++j) {
                store(mg + MG * i, pos0 + j, acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
            }
        }
    } else {
        // NC == 2: the thread's two positions are one 1x2 window, or the
        // top (even position group) or bottom half of a 2x2 window whose
        // other half is held by the thread kStreamQuads lanes away.
        float m[TM][4];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
            for (int l = 0; l < 4; ++l) {
                m[i][l] = fmaxf(acc[i][0][l], acc[i][1][l]);
                if (WIN == 4) {
                    m[i][l] = fmaxf(m[i][l], __shfl_xor_sync(0xffffffffu, m[i][l], kStreamQuads));
                }
            }
        }
        const int q = pos0 / WIN;
        const int half = WIN == 4 ? (tn / kStreamQuads) & 1 : 0;   // a 2x2 pair splits the channels
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            if (WIN != 4 || (i < TM / 2) == (half == 0)) {
                store(mg + MG * i, q, m[i][0], m[i][1], m[i][2], m[i][3]);
            }
        }
    }
}

// Output extents of one conv (after its pool) for an input of tx x wx rows and
// columns; false if the program does not fit that input.
struct Geometry {
    int t_pooled, w_pooled, n_pos;
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
    g->n_pos = t_out * w_out;
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
    bool vec;                          // 16-byte copies along S
    // walk state
    const float* x;
    int tx, wx, cache_i, ping;
    cudaError_t err;
};

// Conv I's buffers in the walk: the old cache it reads (null for a prime or a
// conv without one), the new cache it writes and its output.
struct ConvIo {
    const float* cache;
    float* new_cache;
    float* out;
};

// Conv I's geometry on the walk's input and its buffers; false (with p.err
// set) if an earlier launch failed or the program does not fit the input.
template <int I>
bool conv_io(Program& p, Geometry* g, ConvIo* io) {
    constexpr ConvSpec c = kConvs[I];
    if (p.err != cudaSuccess) {
        return false;
    }
    if (!conv_geometry(c, p.caches_in == nullptr, p.tx, p.wx, g)) {
        p.err = cudaErrorInvalidValue;
        return false;
    }
    io->cache = nullptr;
    io->new_cache = nullptr;
    if (c.kh > 1) {
        io->cache = p.caches_in != nullptr ? p.caches_in[p.cache_i] : nullptr;
        io->new_cache = p.caches_out[p.cache_i];
        ++p.cache_i;
    }
    if (I == kNumConvs - 1) {
        if (g->t_pooled * g->w_pooled * c.cout != kEmbDim) {
            p.err = cudaErrorInvalidValue;
            return false;
        }
        io->out = p.emb;
    } else {
        io->out = p.scratch[p.ping];
        p.ping ^= 1;
    }
    return true;
}

// Moves the walk on: conv I's output is the next conv's input.
void advance(Program& p, const ConvIo& io, const Geometry& g) {
    p.x = io.out;
    p.tx = g.t_pooled;
    p.wx = g.w_pooled;
}

template <int I, bool VEC>
cudaError_t launch_tile(const Program& p, const ConvIo& io, int position_tiles) {
    constexpr ConvSpec c = kConvs[I];
    constexpr ConvTile t = kTiles[I];
    constexpr int threads = tile_threads(c, t);
    constexpr size_t smem = tile_smem_bytes(c, t);
    constexpr int win = c.ph * c.pw;
    static_assert(c.cout % kThreadChannels == 0, "channel groups of 8 divide Cout");
    static_assert(threads % 32 == 0 && threads <= 1024, "whole warps, one block");
    static_assert(t.per_thread == 1 || t.per_thread == 2, "one or two positions per thread");
    static_assert(win == 1 || (win == 2 && t.per_thread == 2) ||
                      (win == 4 && t.per_thread == 2 && t.groups % 2 == 0),
                  "a thread holds whole 2-position windows, a thread pair of one warp a 2x2 window");
    static_assert(t.k_slice >= 1, "a K slice");
    static_assert(smem <= kSmemLimit, "the block's shared memory fits an SM");
    static std::atomic<unsigned long long> allowed{0};
    auto kernel =
        conv_layer_kernel<c.kh, c.kw, c.cin, c.cout, c.ph, c.pw, c.epi, t.groups, t.per_thread, t.k_slice, VEC>;
    const cudaError_t err = allow_smem(kernel, smem, &allowed);
    if (err != cudaSuccess) {
        return err;
    }
    const dim3 grid((p.n_streams + kStreamTile - 1) / kStreamTile, position_tiles);
    kernel<<<grid, threads, smem, p.stream>>>(p.x, io.cache, io.new_cache, p.taps[I], p.biases[I], p.scale, p.shift,
                                              io.out, p.tx, p.wx, p.n_streams);
    return cudaGetLastError();
}

template <int I>
void launch_conv(Program& p) {
    constexpr ConvTile t = kTiles[I];
    Geometry g;
    ConvIo io;
    if (!conv_io<I>(p, &g, &io)) {
        return;
    }
    const int npt = t.groups * t.per_thread;
    const int tiles = (g.n_pos + npt - 1) / npt;
    if (tiles > 65535) {
        p.err = cudaErrorInvalidValue;
        return;
    }
    p.err = p.vec ? launch_tile<I, true>(p, io, tiles) : launch_tile<I, false>(p, io, tiles);
    advance(p, io, g);
}

template <std::size_t... I>
void run_program(Program& p, std::index_sequence<I...>) {
    (launch_conv<I>(p), ...);
}

bool aligned16(const void* ptr) {
    return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

// The whole program for `n_streams` streams, one launch per conv on `stream`,
// each by `launch(p)` in program order (see owwt_cnn_forward in cnn_step.cu).
template <typename Launch>
int run_forward(Launch launch, const float* mel, int t_in, const float* const* caches_in, float* const* caches_out,
                const float* const* taps, const float* const* biases, const float* scale, const float* shift,
                float* emb, float* scratch0, float* scratch1, int n_streams, void* stream) {
    if (n_streams <= 0) {
        return 0;
    }
    bool vec = n_streams % 4 == 0 && aligned16(mel) && aligned16(emb) && aligned16(scratch0) && aligned16(scratch1);
    for (int i = 0; i < kNumCaches; ++i) {
        vec = vec && aligned16(caches_out[i]) && (caches_in == nullptr || aligned16(caches_in[i]));
    }
    Program p{caches_in, caches_out, taps, biases, scale, shift, emb, {scratch0, scratch1},
              n_streams, static_cast<cudaStream_t>(stream), vec, mel, t_in, 32, 0, 0, cudaSuccess};
    launch(p);
    if (p.err == cudaSuccess && p.cache_i != kNumCaches) {
        p.err = cudaErrorInvalidValue;
    }
    return static_cast<int>(p.err);
}

int cnn_forward(const float* mel, int t_in, const float* const* caches_in, float* const* caches_out,
                const float* const* taps, const float* const* biases, const float* scale, const float* shift,
                float* emb, float* scratch0, float* scratch1, int n_streams, void* stream) {
    return run_forward([](Program& p) { run_program(p, std::make_index_sequence<kNumConvs>{}); }, mel, t_in,
                       caches_in, caches_out, taps, biases, scale, shift, emb, scratch0, scratch1, n_streams, stream);
}

}  // namespace
