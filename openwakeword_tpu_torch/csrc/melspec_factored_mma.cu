// Kernel 2's bf16 variants on Hopper's tensor cores: K2-1pass and K2-3pass.
//
// They replace the TPU kernel openwakeword_tpu/ops/melspec_pallas.py::_make_factored_kernel
// (melspectrogram_pallas, dft="factored") at precision None/DEFAULT (1-pass) and at
// Precision.HIGH (3-pass). Its function, for the 8 frames j of each (S, 1760) f32 window:
//   Z_b[d] = sum_a x[160 j + 4 a + b] B_b[a, d]        branches b < 4, taps a < 128
//   E = Z0 + Z2, O = Z1 + Z3, D = Z0 - Z2, F = Z1 - Z3  (fp32, in that order)
//   p0[d] = |E + O|^2 (bin d), p1[d] = |D - i F|^2 (bin 128 + d), p2 = |E - O|^2 at d = 0 (bin 256)
//   mel = p0 W0 + p1 W1 + p2 w256, out = ln(max(mel, 1e-10)) * 10/ln(10), (S, 8, 32) raw dB,
// each product in the variant's arithmetic (1-pass: both operands rounded to bf16; 3-pass:
// hi*hi + hi*lo + lo*hi of the bf16 splits; fp32 sums), p0 and p1 rounded or split before
// their mel products and p2 kept fp32 against the fp32 bin-256 row, as the body takes them.
// The host rounds or splits the stage-1 bases B_b (ops/melspec.py::factored_dft_bases) and
// the mel weights once (ops/melspec_cuda.py::_device_consts); the kernel rounds or splits
// the window samples as it stages them and the power in registers.
//
// What bounds it: the function is kernel 1's (chip_smoke.py::mel_work). At S = 4096 the
// 1-pass variant is bound by bytes, 0.0093 ms (the 1632 samples a stream's frames read,
// the output, the constants), the 3-pass one by operations at 3x the dense bf16 rate,
// 0.0245 ms. The MMA work as run is K1-1pass's: rows 8 S, K = 512, N = 2 x 128 padded
// live columns per pass. The design, one GEMM per 32-column pass with a fused epilogue:
//   * only the stage-1 columns that feed a live bin (mel_program.h: kFactoredCol0 ..,
//     from ops/melspec_cuda.py::factored_columns): 2..121 at the default range, where no
//     bin of the c = 1 half and not bin 256 is live, so only X = E + O is formed. D, F
//     and p1 are formed only with kFactoredHalf1, p2 only with kFactoredNyquist;
//   * A: each stream's window is staged once per block as four branch planes of 408 bf16
//     (branch b = samples b::4; hi, and lo for 3-pass), so frame j's branch-b operand is
//     plane b at [40 j, 40 j + 128): ldmatrix takes one row address per lane, the 8 frame
//     rows of one 8x8 matrix start 80 bytes apart and hit 8 distinct bank quads, and a
//     16-deep K step never straddles a branch (128 % 16 == 0);
//   * B: the (N, K) basis of the live columns, per 8-column group 8 Re rows then 8 Im
//     rows (one ldmatrix.x4 gives both n8 tiles), K in (b, a) order, streamed in K
//     slices (a whole branch, or half of one where two stages do not fit beside the
//     rest) with cp.async, double buffered behind one barrier per slice; each slice
//     feeds the block's 128 rows (16 streams x 8 frames);
//   * the branch loop is outermost: branch 0 sums into E, branch 1 into O, branches 2 and
//     3 into a fresh tile that FADD folds into E and O (and D = E - t, F = O - t where
//     the c = 1 half is live), so the butterfly keeps the body's fp32 order. With three
//     sets of accumulators (four with the c = 1 half) a warp takes 32 rows x 16 columns,
//     2 m16 tiles x 2 groups of 8 columns (an Re and an Im n8 tile each): 32 floats a
//     set, and 8 warps a block (4 row warps x 2 column warps);
//   * the epilogue of each pass forms the power in registers, where the m16n8 tiles of
//     the warp's two groups are the m16k16 A fragment of the mel projection, rounded or
//     split to bf16 pairs, against the (32 mels x columns) weight tile staged with the
//     first basis slice. A warp's (32 rows x 32 mels) tile sums its passes, p0's and
//     p1's products alike (the body's two separate sums would cost 32 more registers),
//     in shared memory that only its own threads touch: held in registers through the
//     K loop, it pushed the 3-pass variant past 255 registers into spills. The block
//     adds its two column warps' tiles in a fixed order, then p2 w256 in fp32, takes
//     the log and writes the (128, 32) dB tile with 16-byte stores.
// The 3-pass product sums each 16-deep K step's three passes into a fresh tile and adds
// that tile with FADD (mma_bf16.cuh::product; csrc/melspec_mma.cu says why not in place).
// Any S >= 1: streams past the end of the last block read zeros and are not written.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mel_program.h"
#include "mma_bf16.cuh"
#include "smem.cuh"

namespace {

constexpr float kAmin = 1e-10f;
constexpr float kDbPerLn = 4.342944819032518f;           // 10 / ln(10)

constexpr int kRadix = 4;
constexpr int kSub = kNfft / kRadix;                     // taps per branch, and stage-1 columns
constexpr int kBranchHop = kHop / kRadix;                // a frame further into a branch plane
constexpr int kSpan = (kFrames - 1) * kHop + kNfft;      // the window samples the frames read
constexpr int kBranchLen = kSpan / kRadix;               // bf16 per stream in a branch plane
constexpr int kMTiles = 2;                               // a warp's m16 tiles: 4 streams x 8 frames
constexpr int kGroups = 2;                               // a warp's groups of 8 columns
constexpr int kColWarps = kFactoredChunk / (8 * kGroups);
constexpr int kRowWarps = 4;
constexpr int kStreams = kRowWarps * 2 * kMTiles;        // 16 streams per block
constexpr int kRows = kStreams * kFrames;                // 128 GEMM rows per block
constexpr int kWarps = kRowWarps * kColWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kPasses = kFactoredColsPad / kFactoredChunk;
constexpr int kPassRows = 2 * kFactoredChunk;            // basis rows (N) of one pass
constexpr int kWinPlane = kRadix * kStreams * kBranchLen;   // bf16 of one staged window plane
constexpr int kBranchPlane = kStreams * kBranchLen;      // bf16 of one branch in a window plane
constexpr int kHalves = kFactoredHalf1 ? 2 : 1;          // mel weights of bins d, and of 128 + d
constexpr int kMelRows = kHalves * kMels;
constexpr int kMelStride = kFactoredColsPad + 8;         // bf16 per staged mel-weight row
constexpr int kAccStride = kMels + 8;                    // floats per row of a warp's mel tile
constexpr int kAccBytes = 4 * kColWarps * kRows * kAccStride;
constexpr int kMaxSmem = 227 * 1024;

static_assert(kFrames == 8, "an 8x8 matrix of A is the 8 frames of one stream");
static_assert(kNfft % (16 * kRadix) == 0 && kHop % kRadix == 0, "whole 16-deep K steps in each branch");
static_assert(kBranchHop % 16 == 8, "16-byte aligned frame rows that start in distinct bank quads");
static_assert(kSpan % (2 * kRadix) == 0 && kBranchLen % 8 == 0 && kSpan <= kWindow,
              "the window is staged in pairs per branch, in 16-byte aligned stream rows");
static_assert(kFactoredChunk == 32 && kColWarps == 2 && kFactoredColsPad % kFactoredChunk == 0,
              "a pass is two column warps of two 8-column groups");
static_assert(kFactoredCol0 + kFactoredCols <= kSub && kFactoredCols <= kFactoredColsPad, "live stage-1 columns");
static_assert(!kFactoredNyquist || kFactoredCol0 == 0, "bin 256 is the butterfly of column 0, which must be computed");
static_assert(kMels % 16 == 0, "the mel projection takes 16 mels per ldmatrix");
static_assert(kMelStride % 16 == 8, "the 8 rows of an ldmatrix start in distinct bank quads");
static_assert(kThreads <= 1024 && kRows * 4 <= 2 * kWinPlane, "one block; p2 per row fits the freed window");

// Shared memory of a block with `planes` bf16 planes (2 for 3-pass) and basis K
// slices of `slice_k`: the window and two basis stages (rows padded by 8 bf16),
// the mel weights, and the warps' mel tiles.
constexpr int block_bytes(int planes, int slice_k) {
    return 2 * planes * (kWinPlane + 2 * kPassRows * (slice_k + 8) + kMelRows * kMelStride) + kAccBytes;
}

// basis K per cp.async stage: the deepest of 128 (a whole branch), 64 and 32 whose
// two stages fit beside the rest
constexpr int slice_k(int planes) {
    return block_bytes(planes, 128) <= kMaxSmem ? 128 : block_bytes(planes, 64) <= kMaxSmem ? 64 : 32;
}

template <int ARITH>
struct Smem {
    static constexpr int kPlanes = ARITH == kThreePass ? 2 : 1;   // hi, and lo for 3-pass
    static constexpr int kSliceK = slice_k(kPlanes);
    static constexpr int kSlices = kSub / kSliceK;                 // stages per branch
    static constexpr int kStages = kPasses * kRadix * kSlices;
    static constexpr int kSliceStride = kSliceK + 8;               // bf16 per staged basis row
    static constexpr int kSlicePlane = kPassRows * kSliceStride;
    static constexpr int kStage = kPlanes * kSlicePlane;           // bf16 of one basis stage
    static constexpr int kMelPlane = kMelRows * kMelStride;
    static constexpr int kMelOffset = 2 * (kPlanes * kWinPlane + 2 * kStage);
    static constexpr int kAccOffset = kMelOffset + 2 * kPlanes * kMelPlane;
    static constexpr int kBytes = block_bytes(kPlanes, kSliceK);
    static_assert(kSliceStride % 16 == 8, "the 8 rows of an ldmatrix start in distinct bank quads");
    static_assert(kWinPlane % 8 == 0 && kStage % 8 == 0 && kMelPlane % 8 == 0, "16-byte aligned regions");
    static_assert(kBytes <= kMaxSmem, "the block's shared memory fits an SM");
};

// Starts the copy of stage i, K slice i % kSlices of branch (i / kSlices) % 4 of pass
// i / (4 kSlices): that K range of the pass's basis rows in each plane, into dst
// ([plane][row][kSliceStride]), committed as one cp.async group with whatever this
// thread issued before.
template <int ARITH>
__device__ __forceinline__ void load_stage(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ basis, int i) {
    using L = Smem<ARITH>;
    constexpr int kChunks = L::kSliceK / 8;              // 16-byte chunks per row
    const int pass = i / (kRadix * L::kSlices);
    const int k0 = L::kSliceK * (i - pass * kRadix * L::kSlices);   // K offset in (b, a) order
    for (int c = threadIdx.x; c < L::kPlanes * kPassRows * kChunks; c += kThreads) {
        const int row = c / kChunks;                     // plane * kPassRows + row of the pass
        const int chunk = c - row * kChunks;
        const int plane = row / kPassRows;
        const size_t src_row = static_cast<size_t>(plane) * 2 * kFactoredColsPad + kPassRows * pass +
                               (row - plane * kPassRows);
        cp_async16(dst + row * L::kSliceStride + 8 * chunk, basis + src_row * kNfft + k0 + 8 * chunk);
    }
    cp_async_commit();
}

// acc += the warp's tile of one branch's product: A from the staged window at `a`
// (this lane's ldmatrix row in the branch's hi plane), B from the branch's kSlices
// basis stages, the first of them `stage` (arrive(i) waits for stage i and returns
// this lane's row in its hi plane), in steps of K 16.
template <int ARITH, typename Arrive>
__device__ __forceinline__ void branch_product(float (&acc)[kMTiles][2 * kGroups][4], const __nv_bfloat16* a,
                                               Arrive& arrive, int stage) {
    using L = Smem<ARITH>;
    constexpr bool kSplit = ARITH == kThreePass;
#pragma unroll
    for (int sl = 0; sl < L::kSlices; ++sl) {
        const __nv_bfloat16* b = arrive(stage + sl);
#pragma unroll
        for (int kk = 0; kk < L::kSliceK / 16; ++kk) {
            const int k = L::kSliceK * sl + 16 * kk;
            unsigned a_hi[kMTiles][4];
            unsigned a_lo[kMTiles][4];
#pragma unroll
            for (int mi = 0; mi < kMTiles; ++mi) {
                ldmatrix_x4(a_hi[mi], a + 2 * mi * kBranchLen + k);
                if constexpr (kSplit) {
                    ldmatrix_x4(a_lo[mi], a + kWinPlane + 2 * mi * kBranchLen + k);
                }
            }
#pragma unroll
            for (int gi = 0; gi < kGroups; ++gi) {
                unsigned b_hi[4];
                unsigned b_lo[4];
                ldmatrix_x4(b_hi, b + 16 * gi * L::kSliceStride + 16 * kk);
                if constexpr (kSplit) {
                    ldmatrix_x4(b_lo, b + L::kSlicePlane + 16 * gi * L::kSliceStride + 16 * kk);
                }
#pragma unroll
                for (int mi = 0; mi < kMTiles; ++mi) {
                    product<ARITH>(acc[mi][2 * gi], a_hi[mi], a_lo[mi], b_hi, b_lo);
                    product<ARITH>(acc[mi][2 * gi + 1], a_hi[mi], a_lo[mi], b_hi + 2, b_lo + 2);
                }
            }
        }
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][2 * kGroups][4]) {
#pragma unroll
    for (int mi = 0; mi < N; ++mi) {
#pragma unroll
        for (int j = 0; j < 2 * kGroups; ++j) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                acc[mi][j][q] = 0.0f;
            }
        }
    }
}

__device__ __forceinline__ float norm2(float re, float im) {
    return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

// mel += the variant's product of the power p (8 values of one m16k16 A fragment:
// rows g and g + 8, the warp's 16 columns) and the 32 mels' weights at w (this
// lane's ldmatrix row in the hi plane; the lo plane kMelPlane further).
template <int ARITH>
__device__ __forceinline__ void mel_product(float (&mel)[kMels / 8][4], const float (&p)[8],
                                            const __nv_bfloat16* w) {
    unsigned p_hi[4];
    unsigned p_lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        pair_operand<ARITH>(p_hi[r], p_lo[r], p[2 * r], p[2 * r + 1]);
    }
#pragma unroll
    for (int h = 0; h < kMels / 16; ++h) {
        unsigned w_hi[4];
        unsigned w_lo[4];
        ldmatrix_x4(w_hi, w + 16 * h * kMelStride);
        if constexpr (ARITH == kThreePass) {
            ldmatrix_x4(w_lo, w + Smem<ARITH>::kMelPlane + 16 * h * kMelStride);
        }
        product<ARITH>(mel[2 * h], p_hi, p_lo, w_hi, w_lo);
        product<ARITH>(mel[2 * h + 1], p_hi, p_lo, w_hi + 2, w_lo + 2);
    }
}

template <int ARITH>
__global__ void __launch_bounds__(kThreads, 1)
melspec_frames_factored_mma_kernel(const float* __restrict__ windows,          // (S, kWindow)
                                   const __nv_bfloat16* __restrict__ basis,    // (planes, N, kNfft)
                                   const __nv_bfloat16* __restrict__ melw,     // (planes, halves, kMels, cols), then
                                                                               // the fp32 bin-256 row
                                   float* __restrict__ out,                    // (S, kFrames, kMels)
                                   int n_streams) {
    using L = Smem<ARITH>;
    constexpr bool kSplit = ARITH == kThreePass;
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem);     // [plane][branch][stream][kBranchLen]
    __nv_bfloat16* stage = win + L::kPlanes * kWinPlane;               // [buffer][plane][row][kSliceStride]
    __nv_bfloat16* mel_w = reinterpret_cast<__nv_bfloat16*>(smem + L::kMelOffset);   // [plane][half][mel][col]
    float* acc = reinterpret_cast<float*>(smem + L::kAccOffset);       // [column warp][row][mel]
    float* nyquist = reinterpret_cast<float*>(smem);                   // after the passes: p2 per row
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int rg = warp / kColWarps;                   // rows: streams 4 rg .. 4 rg + 3 of the block
    const int cw = warp - rg * kColWarps;              // columns: 16 cw .. 16 cw + 15 of each pass
    const int s0 = blockIdx.x * kStreams;
    const int n_valid = min(kStreams, n_streams - s0);

    // the mel weights and basis stage 0 arrive as the first cp.async group
    constexpr int kMelChunks = kFactoredColsPad / 8;
    for (int c = tid; c < L::kPlanes * kMelRows * kMelChunks; c += kThreads) {
        const int row = c / kMelChunks;
        const int chunk = c - row * kMelChunks;
        cp_async16(mel_w + row * kMelStride + 8 * chunk, melw + row * kFactoredColsPad + 8 * chunk);
    }
    load_stage<ARITH>(stage, basis, 0);

    // Sample 8 u + e of stream s (e < 8) goes to branch plane e % 4 at position
    // 2 u + e / 4: unit u of a stream is one bf16 pair in each plane. A thread stages
    // units tid + kThreads * v, loading a batch of them before it stores them, so that
    // enough bytes are in flight while the block waits for its window.
    constexpr int kUnits = kSpan / (2 * kRadix);
    constexpr int kUnitsPerThread = (kStreams * kUnits + kThreads - 1) / kThreads;
    constexpr int kBatch = 4;
    for (int v0 = 0; v0 < kUnitsPerThread; v0 += kBatch) {
        float x[kBatch][2 * kRadix];
#pragma unroll
        for (int v = 0; v < kBatch; ++v) {
            const int i = tid + kThreads * (v0 + v);
            const int s = i / kUnits;
#pragma unroll
            for (int e = 0; e < 2 * kRadix; ++e) {
                x[v][e] = 0.0f;
            }
            if (s < n_valid) {
                const float* src = windows + static_cast<size_t>(s0 + s) * kWindow + 2 * kRadix * (i - s * kUnits);
#pragma unroll
                for (int e = 0; e < 2 * kRadix; ++e) {
                    x[v][e] = src[e];
                }
            }
        }
#pragma unroll
        for (int v = 0; v < kBatch; ++v) {
            const int i = tid + kThreads * (v0 + v);
            const int s = i / kUnits;
            if (s < kStreams) {
#pragma unroll
                for (int b = 0; b < kRadix; ++b) {
                    unsigned hi;
                    unsigned lo;
                    pair_operand<ARITH>(hi, lo, x[v][b], x[v][kRadix + b]);
                    const int at = b * kBranchPlane + s * kBranchLen + 2 * (i - s * kUnits);
                    *reinterpret_cast<unsigned*>(win + at) = hi;
                    if constexpr (kSplit) {
                        *reinterpret_cast<unsigned*>(win + kWinPlane + at) = lo;
                    }
                }
            }
        }
    }

    // ldmatrix row addresses: for A, lane l gives frame l % 8 of stream (l / 8) % 2 of
    // an m16 tile at K offset 8 (l / 16), in branch 0; for B, row l % 8 of the Re
    // (l < 16) or Im half of a group at K offset 8 ((l / 8) % 2); for the mel weights,
    // mel l % 8 (+ 8 for l >= 16) at column offset 8 ((l / 8) % 2)
    const __nv_bfloat16* a_lane =
        win + (2 * kMTiles * rg + ((lane >> 3) & 1)) * kBranchLen + kBranchHop * (lane & 7) + 8 * (lane >> 4);
    const int b_lane = (16 * kGroups * cw + (lane & 7) + 8 * (lane >> 4)) * L::kSliceStride + 8 * ((lane >> 3) & 1);
    const __nv_bfloat16* w_lane =
        mel_w + ((lane & 7) + 8 * (lane >> 4)) * kMelStride + 8 * kGroups * cw + 8 * ((lane >> 3) & 1);
    const int g = lane >> 2;
    const int t4 = lane & 3;

    // stage i is in, and every warp is done with stage i - 1, whose buffer now takes
    // stage i + 1; returns this lane's B row in stage i
    auto arrive = [&](int i) {
        cp_async_wait<0>();
        __syncthreads();
        if (i + 1 < L::kStages) {
            load_stage<ARITH>(stage + ((i + 1) & 1) * L::kStage, basis, i + 1);
        }
        return stage + (i & 1) * L::kStage + b_lane;
    };

    float p2[kMTiles][2] = {};                         // |E - O|^2 of column 0, rows g and g + 8
    for (int pass = 0; pass < kPasses; ++pass) {
        const int first = kRadix * L::kSlices * pass;
        float e[kMTiles][2 * kGroups][4];
        float o[kMTiles][2 * kGroups][4];
        float t[kMTiles][2 * kGroups][4];              // branches 2 and 3, then F
        float d[kFactoredHalf1 ? kMTiles : 1][2 * kGroups][4];
        zero(e);
        branch_product<ARITH>(e, a_lane, arrive, first);
        zero(o);
        branch_product<ARITH>(o, a_lane + kBranchPlane, arrive, first + L::kSlices);
        zero(t);
        branch_product<ARITH>(t, a_lane + 2 * kBranchPlane, arrive, first + 2 * L::kSlices);
#pragma unroll
        for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
            for (int j = 0; j < 2 * kGroups; ++j) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    if constexpr (kFactoredHalf1) {
                        d[mi][j][q] = e[mi][j][q] - t[mi][j][q];
                    }
                    e[mi][j][q] += t[mi][j][q];
                }
            }
        }
        zero(t);
        branch_product<ARITH>(t, a_lane + 3 * kBranchPlane, arrive, first + 3 * L::kSlices);
#pragma unroll
        for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
            for (int j = 0; j < 2 * kGroups; ++j) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float z1 = o[mi][j][q];
                    const float z3 = t[mi][j][q];
                    o[mi][j][q] = z1 + z3;
                    t[mi][j][q] = z1 - z3;
                }
            }
        }

        // The power of the warp's 16 columns, one m16 tile at a time: the Re and Im
        // tiles of group 0 give A fragment values 0..3 (rows g, g + 8; columns 2 t,
        // 2 t + 1), those of group 1 values 4..7 (8 columns further). The warp's mel
        // tile (rows g, g + 8; mels 8 nt + 2 t, + 1) is this thread's own in shared
        // memory.
#pragma unroll
        for (int mi = 0; mi < kMTiles; ++mi) {
            float p0[8];
            float p1[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const int re = 2 * (q / 4);
                const int r = q % 4;
                p0[q] = norm2(e[mi][re][r] + o[mi][re][r], e[mi][re + 1][r] + o[mi][re + 1][r]);
                if constexpr (kFactoredHalf1) {
                    p1[q] = norm2(d[mi][re][r] + t[mi][re + 1][r], d[mi][re + 1][r] - t[mi][re][r]);
                }
            }
            float* tile = acc + (cw * kRows + 32 * rg + 16 * mi + g) * kAccStride + 2 * t4;
            float mel[kMels / 8][4];
#pragma unroll
            for (int nt = 0; nt < kMels / 8; ++nt) {
                const float2 m0 = pass ? *reinterpret_cast<const float2*>(tile + 8 * nt) : make_float2(0.0f, 0.0f);
                const float2 m8 = pass ? *reinterpret_cast<const float2*>(tile + 8 * kAccStride + 8 * nt)
                                       : make_float2(0.0f, 0.0f);
                mel[nt][0] = m0.x;
                mel[nt][1] = m0.y;
                mel[nt][2] = m8.x;
                mel[nt][3] = m8.y;
            }
            mel_product<ARITH>(mel, p0, w_lane + kFactoredChunk * pass);
            if constexpr (kFactoredHalf1) {
                mel_product<ARITH>(mel, p1, w_lane + kMels * kMelStride + kFactoredChunk * pass);
            }
#pragma unroll
            for (int nt = 0; nt < kMels / 8; ++nt) {
                *reinterpret_cast<float2*>(tile + 8 * nt) = make_float2(mel[nt][0], mel[nt][1]);
                *reinterpret_cast<float2*>(tile + 8 * kAccStride + 8 * nt) = make_float2(mel[nt][2], mel[nt][3]);
            }
            if constexpr (kFactoredNyquist) {
                // column 0 is column 2 t of group 0 in column warp 0 of pass 0: lanes t == 0
                if (pass == 0 && cw == 0) {
                    p2[mi][0] = norm2(e[mi][0][0] - o[mi][0][0], e[mi][1][0] - o[mi][1][0]);
                    p2[mi][1] = norm2(e[mi][0][2] - o[mi][0][2], e[mi][1][2] - o[mi][1][2]);
                }
            }
        }
    }
    __syncthreads();                                   // the window is read, the mel tiles written
    if constexpr (kFactoredNyquist) {
        if (cw == 0 && t4 == 0) {
#pragma unroll
            for (int mi = 0; mi < kMTiles; ++mi) {
                nyquist[32 * rg + 16 * mi + g] = p2[mi][0];
                nyquist[32 * rg + 16 * mi + g + 8] = p2[mi][1];
            }
        }
        __syncthreads();
    }

    // Row r = 8 s + f of the block is out[s0 + s, f]: the block's valid rows are one
    // contiguous run of the output. The two column warps' tiles are added in order,
    // then bin 256's fp32 product, as the body adds p2 * mel_last after its two dots.
    const float* w256 = reinterpret_cast<const float*>(melw + L::kPlanes * kMelRows * kFactoredColsPad);
    float* dst = out + static_cast<size_t>(s0) * kFrames * kMels;
    for (int i = 4 * tid; i < n_valid * kFrames * kMels; i += 4 * kThreads) {
        const int r = i / kMels;
        const float* src = acc + r * kAccStride + (i - r * kMels);
        float4 v = *reinterpret_cast<const float4*>(src);
#pragma unroll
        for (int w = 1; w < kColWarps; ++w) {
            const float4 u = *reinterpret_cast<const float4*>(src + w * kRows * kAccStride);
            v.x += u.x;
            v.y += u.y;
            v.z += u.z;
            v.w += u.w;
        }
        if constexpr (kFactoredNyquist) {
            const float p = nyquist[r];
            const float4 w = *reinterpret_cast<const float4*>(w256 + (i - r * kMels));
            v.x = __fadd_rn(v.x, __fmul_rn(p, w.x));
            v.y = __fadd_rn(v.y, __fmul_rn(p, w.y));
            v.z = __fadd_rn(v.z, __fmul_rn(p, w.z));
            v.w = __fadd_rn(v.w, __fmul_rn(p, w.w));
        }
        v.x = logf(fmaxf(v.x, kAmin)) * kDbPerLn;
        v.y = logf(fmaxf(v.y, kAmin)) * kDbPerLn;
        v.z = logf(fmaxf(v.z, kAmin)) * kDbPerLn;
        v.w = logf(fmaxf(v.w, kAmin)) * kDbPerLn;
        *reinterpret_cast<float4*>(dst + i) = v;
    }
}

template <int ARITH>
int launch(const float* windows, const __nv_bfloat16* basis, const __nv_bfloat16* melw, float* out, int n_streams,
           void* stream) {
    if (n_streams <= 0) {
        return 0;
    }
    static std::atomic<unsigned long long> allowed{0};
    const cudaError_t err = allow_smem(melspec_frames_factored_mma_kernel<ARITH>, Smem<ARITH>::kBytes, &allowed);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int grid = (n_streams + kStreams - 1) / kStreams;
    melspec_frames_factored_mma_kernel<ARITH>
        <<<grid, kThreads, Smem<ARITH>::kBytes, static_cast<cudaStream_t>(stream)>>>(windows, basis, melw, out,
                                                                                     n_streams);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: launch on `stream` and return cudaGetLastError() (0 = the launch
// was accepted). `windows` and `out` are contiguous float32 device tensors; `basis` and
// `melw` the bf16 planes of ops/melspec_cuda.py::_device_consts, rounded (1-pass) or
// split into a hi plane and a lo plane (3-pass), `melw` followed by the float32 mel row
// of bin 256.
extern "C" int owwt_melspec_frames_factored_1pass(const float* windows, const __nv_bfloat16* basis,
                                                  const __nv_bfloat16* melw, float* out, int n_streams,
                                                  void* stream) {
    return launch<kOnePass>(windows, basis, melw, out, n_streams, stream);
}

extern "C" int owwt_melspec_frames_factored_3pass(const float* windows, const __nv_bfloat16* basis,
                                                  const __nv_bfloat16* melw, float* out, int n_streams,
                                                  void* stream) {
    return launch<kThreePass>(windows, basis, melw, out, n_streams, stream);
}
