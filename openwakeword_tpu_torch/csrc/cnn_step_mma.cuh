// The bf16 CNN step and prime for Hopper (sm_90a) on the tensor cores: one
// implicit-GEMM kernel per conv whose products are mma.sync.m16n8k16 bf16
// tiles with fp32 sums, in either bf16 arithmetic (ARITH): 1-pass (K3-bf16,
// K4-bf16, built by cnn_step_bf16.cu) and 3-pass (K3-high, K4-high, built by
// cnn_step_high.cu).
//
// Replaces the TPU kernel openwakeword_tpu/ops/cnn_pallas.py::_make_kernel in
// its "bf16" and "high" modes (_dot, cnn_pallas.py:116-128; "high" is the
// default of its CnnStepKernel): the 20-conv program of cnn_step.cuh (the same
// layouts, caches, epilogues and pools, the same walk, one launch per conv),
// with every product taken as JAX takes it (bf16_arith.cuh). 1-pass: each
// operand rounded to bf16, the product exact, the sums fp32. 3-pass
// (Precision.HIGH): each operand x split into bf16 halves hi = bf16(x), lo =
// bf16(x - hi), the product hi*hi + hi*lo + lo*hi with fp32 sums, lo*lo
// dropped. The host prepares the weights once as bf16 planes per conv
// (ops/cnn_step.py::weight_planes: the rounded plane, or the hi and the lo
// plane), laid [Cout][K padded to 16] in the TPU kernel's tap order (dt, dw,
// c), zero past K; the kernel rounds or splits every staged input as it
// stages it. Sums, epilogue, pools, caches and embedding stay fp32; the
// caches hold the inputs unrounded, as the TPU kernel's do.
//
// What bounds it: 45.98 GFLOP per step at S = 4096 (343.7 per prime), three
// passes of them at 3-pass: 0.046 / 0.139 ms at the dense bf16 rate, against
// 1.18 GB of activations that each conv writes and the next reads (9.78 GB
// per prime), 0.353 ms at the HBM rate; L2 holds part of the later convs'.
// The early convs, with 24 channels and 8-32 columns, move the most bytes per
// product, the middle ones do most of the products. The design:
//   * M = output positions x streams, N = Cout, K = kh*kw*Cin. An item is 16
//     streams x a rectangle of output positions (whole pool windows) x Cout /
//     n_blocks channels; an m16 tile is one output position of the 16
//     streams, a warp holds warp_positions such tiles (whole pool windows) x
//     3 n8 tiles (24 channels). Tiles per conv and arithmetic from the
//     generated cnn_mma_tiles.h (ops/cnn_step_cuda.py::conv_mma_tiles);
//   * no im2col: an item's input patch is staged once, the tile's rows plus
//     kh - 1 and columns plus kw - 1 (the width padding, rows past the input
//     and streams past S as zeros), as PLANES bf16 planes (the rounded
//     operand, or hi and lo), each as two regions (streams 0-7 and 8-15) of
//     16-byte rows, row (cell * CC + c) holding channel c of a cell for 8
//     streams. ldmatrix.x4.trans takes one row address per lane, so a lane
//     points straight at its (tap, channel) row: the A fragment of a k16
//     step is gathered from the patch with no copy. The 8 rows of one 8x8
//     matrix are 8 consecutive channels of one cell, 128 contiguous bytes
//     (for the stem, Cin = 1, 8 taps whose cells a row stride of 3 mod 8
//     cells spreads over the bank quads);
//   * the patch goes through in chunks of CC input channels: cp.async copies
//     each chunk's fp32 cells (16 bytes along S, or 4 bytes masked per stream
//     where S % 4 or a pointer's alignment rules the 16-byte copies out: a
//     variant the host picks; zero-fill for the padding) into a 2-deep ring
//     of per-thread slots, and the thread that copied a cell rounds or splits
//     it into a 2-deep ring of bf16 chunk buffers once its group lands
//     (cp.async cannot convert). Two chunks are in flight while the warps
//     multiply a third, and no register holds a load across the products. K
//     runs chunk by chunk, tap by tap within a chunk; a chunk's last k16 step
//     points its missing rows at a zero row;
//   * persistent blocks: as many as the card holds at once, each on one Cout
//     split with its weights loaded once, walking items (stream tile,
//     position tile); the chunk pipeline runs on across items, so an item's
//     epilogue and first loads overlap its neighbours' products;
//   * the weights of the block's channels stay in shared memory for all its
//     items ([plane][Cout / n_blocks][K + 8]: 8 rows of an ldmatrix in
//     distinct bank quads), copied by cp.async while the first chunk stages;
//   * 1-pass: each k16 step is one ldmatrix per operand fragment and one MMA
//     into the accumulators. 3-pass: each k16 step takes lo*hi, hi*lo and
//     hi*hi into a fresh tile that FADD adds to the accumulators
//     (mma_bf16.cuh::product), so the tensor cores' own summation rounds a
//     step's three terms against each other only;
//   * epilogue in registers: bias, then for the stem ReLU -> affine ->
//     clipped leaky, for the other convs but the last the clipped leaky, then
//     the max pool over the warp's m16 tiles of a window (a thread holds the
//     same stream and channel in each). A warp's 4-byte stores cover whole
//     32-byte sectors (8 consecutive streams per channel);
//   * the new caches (the virtual input's last 2 rows) go to separate
//     buffers, written from the fp32 slots of the last row tile's patch as it
//     is converted: no extra reads, and no block reads a cache row that
//     another writes.
// No cross-layer fusion, no wgmma.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <utility>

#include "cnn_step.cuh"
#include "mma_bf16.cuh"

namespace {

// Each conv's tile per arithmetic (ops/cnn_step_cuda.py::conv_mma_tiles). The
// generated cnn_mma_tiles.h defines kMmaStreams (streams per block), kMmaNTiles
// (n8 tiles per warp), kMmaTilesOnePass and kMmaTilesThreePass.
struct MmaTile {
    int pooled_rows, pooled_cols, warp_positions, n_blocks, chunk_channels, min_blocks;
};

#include "cnn_mma_tiles.h"

static_assert(sizeof(kMmaTilesOnePass) / sizeof(kMmaTilesOnePass[0]) == kNumConvs, "one 1-pass tile per conv");
static_assert(sizeof(kMmaTilesThreePass) / sizeof(kMmaTilesThreePass[0]) == kNumConvs, "one 3-pass tile per conv");
static_assert(kMmaStreams == 16, "an m16 tile is one position of 16 streams");

template <int ARITH>
constexpr MmaTile mma_tile(int i) {
    static_assert(ARITH == kOnePass || ARITH == kThreePass, "the tensor-core kernels take bf16 arithmetic");
    return ARITH == kThreePass ? kMmaTilesThreePass[i] : kMmaTilesOnePass[i];
}

// The compile-time geometry of conv I's tile in arithmetic ARITH
// (ops/cnn_step_cuda.py::mma_layout).
template <int I, int ARITH>
struct MmaPlan {
    static constexpr ConvSpec c = kConvs[I];
    static constexpr MmaTile t = mma_tile<ARITH>(I);
    static constexpr int PLANES = ARITH == kThreePass ? 2 : 1;   // the rounded operand, or hi and lo
    static constexpr int KH = c.kh, KW = c.kw, CIN = c.cin, COUT = c.cout, PH = c.ph, PW = c.pw;
    static constexpr int WIN = PH * PW;
    static constexpr int PAD_W = KW / 2;
    static constexpr int TR = t.pooled_rows * PH;          // output rows per block
    static constexpr int TC = t.pooled_cols * PW;          // output columns per block
    static constexpr int P = TR * TC;                      // output positions per block
    static constexpr int MT = t.warp_positions;            // m16 tiles (positions) per warp
    static constexpr int NB = t.n_blocks;
    static constexpr int NBLK = COUT / NB;                 // output channels per block
    static constexpr int NT = kMmaNTiles;                  // n8 tiles per warp
    static constexpr int WN = NBLK / (8 * NT);             // warps across the block's channels
    static constexpr int WM = P / MT;                      // warps across its positions
    static constexpr int THREADS = 32 * WM * WN;
    static constexpr int TAPS = KH * KW;
    static constexpr int KPAD = (TAPS * CIN + 15) / 16 * 16;
    static constexpr int CC = t.chunk_channels;            // input channels per staged chunk
    static constexpr int NCH = CIN / CC;
    static constexpr int KC = TAPS * CC;                   // k per chunk: (tap, channel), tap outer
    static constexpr int STEPS = (KC + 15) / 16;           // k16 steps per chunk
    static constexpr int PR = TR + KH - 1;                 // patch rows and columns
    static constexpr int PC = TC + KW - 1;
    static constexpr int PCS = CIN % 8 == 0 ? PC : PC + ((3 - PC) % 8 + 8) % 8;   // cells per patch row
    static constexpr int ZERO = PR * PCS * CC;             // the zero row of a region
    static constexpr int REGION = ZERO + 1 + ((4 - (ZERO + 1)) % 8 + 8) % 8;       // 16-byte rows, 4 mod 8
    static constexpr int CHUNK = 2 * PLANES * REGION * 8;  // bf16 of a chunk buffer: [plane][half][REGION][8]
    static constexpr int WSTRIDE = KPAD + 8;               // bf16 per staged weight row
    static constexpr int UNITS = PR * PC * CC * (kMmaStreams / 4);                 // stream quads per chunk
    static constexpr int UPT = (UNITS + THREADS - 1) / THREADS;                    // per thread
    static constexpr size_t SMEM = 2 * (static_cast<size_t>(CHUNK) * 2 + static_cast<size_t>(UPT) * THREADS * 16) +
                                   PLANES * static_cast<size_t>(NBLK) * WSTRIDE * 2;

    static_assert(COUT % (8 * NT * NB) == 0 && WN >= 1, "whole 24-channel warps in each block's channels");
    static_assert(P % MT == 0 && MT % WIN == 0, "a warp holds whole pool windows");
    static_assert(THREADS <= 1024, "one block");
    static_assert(CIN % CC == 0 && (CC % 8 == 0 || CC == CIN), "whole 8-channel groups per chunk");
    static_assert(CIN % 8 == 0 || NCH == 1, "a stem with Cin < 8 stages one chunk");
    static_assert(CIN % 8 == 0 || ((PCS % 8) == 3 && PCS >= PC),
                  "the stem's 8 taps of a matrix hit distinct bank quads");
    static_assert(REGION % 8 == 4, "a staging store's two stream halves sit 64 bytes apart in the banks");
    static_assert((WSTRIDE / 8) % 2 == 1, "the 8 rows of a weight ldmatrix start in distinct bank quads");
    static_assert(SMEM <= kSmemLimit, "the block's shared memory fits an SM");
};

// 4 streams of a patch cell's channel as the variant's operand: the rounded
// pairs at hi, and for 3-pass the residual pairs at lo.
template <int ARITH>
__device__ __forceinline__ void store_operand(__nv_bfloat16* hi, __nv_bfloat16* lo, float4 v) {
    unsigned h0, l0, h1, l1;
    pair_operand<ARITH>(h0, l0, v.x, v.y);
    pair_operand<ARITH>(h1, l1, v.z, v.w);
    *reinterpret_cast<uint2*>(hi) = make_uint2(h0, h1);
    if constexpr (ARITH == kThreePass) {
        *reinterpret_cast<uint2*>(lo) = make_uint2(l0, l1);
    }
}

// One conv. The work is items (stream tile of 16 streams, position tile) for
// each of NB Cout splits. A block takes split blockIdx.x % NB, loads its
// weights once, and walks items blockIdx.x / NB, + gridDim.x / NB, ... chunk by
// chunk: stage s is chunk s % NCH of the block's item s / NCH, and the
// cp.async pipeline runs across items, so one item's epilogue overlaps the
// next one's loads. The host launches as many blocks as the card holds at
// once.
// VEC: S % 4 == 0 and every activation pointer 16-byte aligned, so a stream
// quad moves as one 16-byte copy; otherwise as four 4-byte copies masked per
// stream.
template <int I, bool VEC, int ARITH>
__global__ void __launch_bounds__(MmaPlan<I, ARITH>::THREADS, mma_tile<ARITH>(I).min_blocks)
conv_mma_kernel(const float* __restrict__ x,               // (CIN, tx, wx, S) new rows
                const float* __restrict__ cache,           // (CIN, 2, wv, S) or null: no rows before x
                float* __restrict__ new_cache,             // (CIN, 2, wv, S) or null: not a time conv
                const __nv_bfloat16* __restrict__ planes,  // (PLANES, COUT, KPAD): rounded, or hi and lo
                const float* __restrict__ bias,            // (COUT)
                const float* __restrict__ scale,           // (COUT), the stem's affine
                const float* __restrict__ shift,           // (COUT)
                float* __restrict__ out,                   // (COUT, t_out/PH, w_out/PW, S)
                int tx, int wx, int n_streams) {
    using L = MmaPlan<I, ARITH>;
    constexpr int EPI = L::c.epi;
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);      // [2][plane][half][REGION][8 streams]
    float4* slots = reinterpret_cast<float4*>(ring + 2 * L::CHUNK);     // [2][UPT][THREADS]
    __nv_bfloat16* wts = reinterpret_cast<__nv_bfloat16*>(slots + 2 * L::UPT * L::THREADS);   // [plane][NBLK][WSTRIDE]

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int S = n_streams;
    const size_t SS = static_cast<size_t>(n_streams);
    const int rc = cache != nullptr ? kCacheRows : 0;
    const int wv = wx + 2 * L::PAD_W;
    const int t_out = rc + tx - L::KH + 1;
    const int w_pooled = wx / L::PW;
    const int t_pooled = t_out / L::PH;
    const int n_pooled = t_pooled * w_pooled;
    const int tiles_w = wx / L::TC;
    const int tiles = (t_out + L::TR - 1) / L::TR * tiles_w;            // position tiles
    const int items = (S + kMmaStreams - 1) / kMmaStreams * tiles;
    const int nb = blockIdx.x % L::NB;
    const int first = blockIdx.x / L::NB;
    const int stride = gridDim.x / L::NB;
    const int stages = first < items ? (items - first + stride - 1) / stride * L::NCH : 0;
    // the new cache is the virtual input's last 2 rows: the patch of the last
    // row tile holds them, and split 0 writes them from there (columns past
    // the tile's own only in the last column tile)
    const int cache_row0 = rc + tx - kCacheRows;
    const int last_row_tile = (t_out - 1) / L::TR;

    // Item of stage st: its first output row and column, its first stream,
    // and its position tile's row and column tile.
    struct Item {
        int t_a, w_a, s_tile, row_tile, col_tile;
    };
    auto item_of = [&](int st) {
        const int r = first + (st / L::NCH) * stride;
        const int y = r / tiles;
        const int pt = r - y * tiles;
        Item it;
        it.row_tile = pt / tiles_w;
        it.col_tile = pt - it.row_tile * tiles_w;
        it.t_a = it.row_tile * L::TR;
        it.w_a = it.col_tile * L::TC;
        it.s_tile = y * kMmaStreams;
        return it;
    };

    // the block's weights: every plane, rows nb * NBLK .., one cp.async group
    {
        constexpr int kChunks = L::KPAD / 8;
        for (int i = tid; i < L::PLANES * L::NBLK * kChunks; i += L::THREADS) {
            const int row = i / kChunks;                 // plane * NBLK + o
            const int ch = i - row * kChunks;
            const int plane = row / L::NBLK;
            cp_async16(wts + row * L::WSTRIDE + 8 * ch,
                       planes + (static_cast<size_t>(plane) * L::COUT + nb * L::NBLK + (row - plane * L::NBLK)) *
                                    L::KPAD + 8 * ch);
        }
        cp_async_commit();
    }
    if (tid < 4 * L::PLANES) {                           // the zero row of each region of both buffers
        *reinterpret_cast<uint4*>(ring + (tid * L::REGION + L::ZERO) * 8) = make_uint4(0u, 0u, 0u, 0u);
    }

    // Patch unit u of a stage: stream quad u % 4 of channel j * CC + (u / 4) % CC
    // of cell u / (4 CC), the cell (pr, pc) = virtual input row t_a + pr,
    // padded column w_a + pc. Thread tid copies units tid, tid + THREADS, ...
    // into its slots of ring buffer st % 2, then rounds or splits them into
    // chunk buffer st % 2; no other thread touches its slots.
    auto issue_stage = [&](int st) {
        const Item it = item_of(st);
        const int j = st % L::NCH;
        float4* slot = slots + (st & 1) * L::UPT * L::THREADS + tid;
#pragma unroll
        for (int e = 0; e < L::UPT; ++e) {
            const int u = tid + e * L::THREADS;
            if (u >= L::UNITS) {
                break;
            }
            const int sq = u & 3;
            const int rest = u >> 2;
            const int cell = rest / L::CC;
            const int c = j * L::CC + (rest - cell * L::CC);
            const int pr = cell / L::PC;
            const int r = it.t_a + pr;
            const int col = it.w_a + (cell - pr * L::PC);
            const int s0 = it.s_tile + 4 * sq;
            const float* src = nullptr;
            if (s0 < S && r < rc + tx) {
                if (r < rc) {
                    src = cache + (static_cast<size_t>(c * kCacheRows + r) * wv + col) * SS + s0;
                } else if (col >= L::PAD_W && col - L::PAD_W < wx) {
                    src = x + (static_cast<size_t>(c * tx + r - rc) * wx + col - L::PAD_W) * SS + s0;
                }
            }
            if (VEC) {
                cp_async16_fill(slot + e * L::THREADS, src != nullptr ? src : x, src != nullptr ? 16 : 0);
            } else {
                float* d = reinterpret_cast<float*>(slot + e * L::THREADS);
#pragma unroll
                for (int l = 0; l < 4; ++l) {
                    const bool ok = src != nullptr && s0 + l < S;
                    cp_async4_fill(d + l, ok ? src + l : x, ok ? 4 : 0);
                }
            }
        }
    };
    auto convert_stage = [&](int st) {
        const Item it = item_of(st);
        const int j = st % L::NCH;
        const bool cache_tile = new_cache != nullptr && nb == 0 && it.row_tile == last_row_tile;
        const int cols_here = it.col_tile == tiles_w - 1 ? L::PC : L::TC;   // new-cache columns this tile writes
        const float4* slot = slots + (st & 1) * L::UPT * L::THREADS + tid;
        __nv_bfloat16* buf = ring + (st & 1) * L::CHUNK;
#pragma unroll
        for (int e = 0; e < L::UPT; ++e) {
            const int u = tid + e * L::THREADS;
            if (u >= L::UNITS) {
                break;
            }
            const int sq = u & 3;
            const int rest = u >> 2;
            const int cell = rest / L::CC;
            const int c_local = rest - cell * L::CC;
            const int pr = cell / L::PC;
            const int pc = cell - pr * L::PC;
            const int row = (pr * L::PCS + pc) * L::CC + c_local;
            const float4 v = slot[e * L::THREADS];
            __nv_bfloat16* hi = buf + ((sq >> 1) * L::REGION + row) * 8 + 4 * (sq & 1);
            store_operand<ARITH>(hi, hi + 2 * L::REGION * 8, v);
            const int rr = it.t_a + pr - cache_row0;
            const int s0 = it.s_tile + 4 * sq;
            if (cache_tile && rr >= 0 && rr < kCacheRows && pc < cols_here && s0 < S) {
                const int c = j * L::CC + c_local;
                float* dst = new_cache + (static_cast<size_t>(c * kCacheRows + rr) * wv + it.w_a + pc) * SS + s0;
                if (VEC) {
                    *reinterpret_cast<float4*>(dst) = v;
                } else {
                    const float f[4] = {v.x, v.y, v.z, v.w};
                    for (int l = 0; l < 4 && s0 + l < S; ++l) {
                        dst[l] = f[l];
                    }
                }
            }
        }
    };

    // cp.async groups: the weights, then one per stage (empty past the last),
    // so that before stage st + 1 is converted exactly one later group is pending
    if (stages > 0) {
        issue_stage(0);
    }
    cp_async_commit();
    if (stages > 1) {
        issue_stage(1);
    }
    cp_async_commit();
    cp_async_wait<1>();                                  // the weights and stage 0 (this thread's copies)
    if (stages > 0) {
        convert_stage(0);
    }
    if (stages > 2) {
        issue_stage(2);
    }
    cp_async_commit();

    // Warp (wm, wn): tile positions wm * MT .., channels wn * 24 .. of the
    // block's. Position p of the tile (numbered pool window by window) sits at
    // output row t_a + tr, column w_a + tc; its rows of a chunk buffer start
    // at a_base = (tr * PCS + tc) * CC.
    const int wm = warp / L::WN;
    const int wn = warp - wm * L::WN;
    int a_base[L::MT];
#pragma unroll
    for (int i = 0; i < L::MT; ++i) {
        const int p = wm * L::MT + i;
        const int q = p / L::WIN;
        const int el = p - q * L::WIN;
        const int qr = q / L::t.pooled_cols;
        const int qc = q - qr * L::t.pooled_cols;
        a_base[i] = ((qr * L::PH + el / L::PW) * L::PCS + qc * L::PW + el % L::PW) * L::CC;
    }
    // ldmatrix rows: for A, lane l gives row l % 8 of the 8-group l / 16 of
    // the step in stream half (l / 8) % 2; for B, output channel (l % 8) + 8 (l / 16)
    // of an n8 pair in the 8-group (l / 8) % 2
    const int a_half = (lane >> 3) & 1;
    const int a_k = 8 * (lane >> 4) + (lane & 7);
    const int b_k = 8 * ((lane >> 3) & 1);
    const __nv_bfloat16* b_hi = wts + (wn * 8 * L::NT + (lane & 7) + 8 * (lane >> 4)) * L::WSTRIDE;
    const __nv_bfloat16* b_lo = b_hi + L::NBLK * L::WSTRIDE;    // 3-pass only
    const int g = lane >> 2;
    const int o0 = nb * L::NBLK + wn * 8 * L::NT + 2 * (lane & 3);   // this lane's first output channel

    float acc[L::MT][L::NT][4];
#pragma unroll
    for (int i = 0; i < L::MT; ++i) {
#pragma unroll
        for (int n = 0; n < L::NT; ++n) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                acc[i][n][q] = 0.0f;
            }
        }
    }

#pragma unroll 1
    for (int st = 0; st < stages; ++st) {
        __syncthreads();                                 // stage st is converted; every warp is done with st - 1
        const int j = st % L::NCH;
        const __nv_bfloat16* a_hi = ring + (st & 1) * L::CHUNK + a_half * L::REGION * 8;
        const __nv_bfloat16* a_lo = a_hi + 2 * L::REGION * 8;     // 3-pass only
#pragma unroll
        for (int ks = 0; ks < L::STEPS; ++ks) {
            // A: this lane's k of the chunk, (tap, channel) with the tap outer;
            // past the chunk's k, the zero row
            const int ka = 16 * ks + a_k;
            const int tap_a = ka / L::CC;
            const int off_a = ((tap_a / L::KW) * L::PCS + tap_a % L::KW) * L::CC + ka % L::CC;
            // B: the weight column of this lane's 8-group (8 consecutive k of
            // one tap); a group past the chunk's k meets zero rows of A, so it
            // reads column 0
            const int kb = 16 * ks + b_k;
            const int col_b = kb < L::KC ? (kb / L::CC) * L::CIN + j * L::CC + kb % L::CC : 0;
            unsigned bh[L::NT][2];
            unsigned bl[L::NT][2];                       // 3-pass only
#pragma unroll
            for (int n = 0; n + 1 < L::NT; n += 2) {
                unsigned r[4];
                ldmatrix_x4(r, b_hi + 8 * n * L::WSTRIDE + col_b);
                bh[n][0] = r[0];
                bh[n][1] = r[1];
                bh[n + 1][0] = r[2];
                bh[n + 1][1] = r[3];
                if constexpr (L::PLANES == 2) {
                    ldmatrix_x4(r, b_lo + 8 * n * L::WSTRIDE + col_b);
                    bl[n][0] = r[0];
                    bl[n][1] = r[1];
                    bl[n + 1][0] = r[2];
                    bl[n + 1][1] = r[3];
                }
            }
            if constexpr (L::NT % 2 == 1) {
                // lanes 16-31 address channels 8 on, which x2 does not read
                ldmatrix_x2(bh[L::NT - 1], b_hi + 8 * (L::NT - 1) * L::WSTRIDE + col_b);
                if constexpr (L::PLANES == 2) {
                    ldmatrix_x2(bl[L::NT - 1], b_lo + 8 * (L::NT - 1) * L::WSTRIDE + col_b);
                }
            }
#pragma unroll
            for (int i = 0; i < L::MT; ++i) {
                const int row = ka < L::KC ? a_base[i] + off_a : L::ZERO;
                unsigned ah[4];
                unsigned al[4];                          // 3-pass only
                ldmatrix_x4_trans(ah, a_hi + row * 8);
                if constexpr (L::PLANES == 2) {
                    ldmatrix_x4_trans(al, a_lo + row * 8);
                }
#pragma unroll
                for (int n = 0; n < L::NT; ++n) {
                    product<ARITH>(acc[i][n], ah, al, bh[n], bl[n]);
                }
            }
        }

        if (j == L::NCH - 1) {
            // Epilogue of the item: acc[i][n] holds streams g and g + 8 (g =
            // lane / 4) of channels 8n + 2 (lane % 4) and + 1 of the warp's,
            // at the warp's position i. Each value takes its bias and
            // activation, then the max over the window's positions, and goes
            // out 4 bytes at a time: 8 lanes cover 8 consecutive streams of a
            // channel, one 32-byte sector. The accumulators start over.
            const Item it = item_of(st);
#pragma unroll
            for (int wi = 0; wi < L::MT / L::WIN; ++wi) {
                const int q = (wm * L::MT) / L::WIN + wi;        // the window's index in the tile
                const int qr = q / L::t.pooled_cols;
                const int qt = it.t_a / L::PH + qr;              // its pooled output row
                const int qg = qt * w_pooled + it.w_a / L::PW + (q - qr * L::t.pooled_cols);
#pragma unroll
                for (int n = 0; n < L::NT; ++n) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int o = o0 + 8 * n + (e & 1);
                        auto activated = [&](float v) {
                            v += bias[o];
                            if (EPI == kStem) {
                                v = clipped_leaky(__fadd_rn(__fmul_rn(fmaxf(v, 0.0f), scale[o]), shift[o]));
                            } else if (EPI == kLeaky) {
                                v = clipped_leaky(v);
                            }
                            return v;
                        };
                        float m = activated(acc[wi * L::WIN][n][e]);
#pragma unroll
                        for (int el = 1; el < L::WIN; ++el) {
                            m = fmaxf(m, activated(acc[wi * L::WIN + el][n][e]));
                        }
                        const int s = it.s_tile + g + 8 * (e >> 1);
                        if (qt < t_pooled && s < S) {
                            out[(static_cast<size_t>(o) * n_pooled + qg) * SS + s] = m;
                        }
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < L::MT; ++i) {
#pragma unroll
                for (int n = 0; n < L::NT; ++n) {
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        acc[i][n][q] = 0.0f;
                    }
                }
            }
        }
        if (st + 1 < stages) {
            // stage st + 1 lands and is converted into the buffer that stage st - 1
            // left; stage st + 3 takes its slots
            cp_async_wait<1>();
            convert_stage(st + 1);
            if (st + 3 < stages) {
                issue_stage(st + 3);
            }
            cp_async_commit();
        }
    }
}

template <int I, bool VEC, int ARITH>
cudaError_t launch_mma_tile(const Program& p, const ConvIo& io, int items) {
    using L = MmaPlan<I, ARITH>;
    static std::atomic<unsigned long long> allowed{0};
    static std::atomic<int> resident[64];                // blocks the card holds at once, per device
    auto kernel = conv_mma_kernel<I, VEC, ARITH>;
    cudaError_t err = allow_smem(kernel, L::SMEM, &allowed);
    if (err != cudaSuccess) {
        return err;
    }
    int device = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) {
        return err;
    }
    int held = device < 64 ? resident[device].load(std::memory_order_relaxed) : 0;
    if (held == 0) {
        int per_sm = 0;
        int sms = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, L::THREADS, L::SMEM);
        if (err == cudaSuccess) {
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        }
        if (err != cudaSuccess) {
            return err;
        }
        held = per_sm * sms > 0 ? per_sm * sms : 1;
        if (device < 64) {
            resident[device].store(held, std::memory_order_relaxed);
        }
    }
    const int per_split = held / L::NB > 0 ? held / L::NB : 1;
    const int blocks = (items < per_split ? items : per_split) * L::NB;
    kernel<<<blocks, L::THREADS, L::SMEM, p.stream>>>(p.x, io.cache, io.new_cache,
                                                      reinterpret_cast<const __nv_bfloat16*>(p.taps[I]),
                                                      p.biases[I], p.scale, p.shift, io.out, p.tx, p.wx, p.n_streams);
    return cudaGetLastError();
}

template <int I, int ARITH>
void launch_mma_conv(Program& p) {
    using L = MmaPlan<I, ARITH>;
    Geometry g;
    ConvIo io;
    if (!conv_io<I>(p, &g, &io)) {
        return;
    }
    const int t_out = g.t_pooled * L::PH;
    const long long items = static_cast<long long>((t_out + L::TR - 1) / L::TR) * (p.wx / L::TC) *
                            ((p.n_streams + kMmaStreams - 1) / kMmaStreams);
    if (p.wx % L::TC != 0 || items * L::NB > 0x7fffffffLL) {
        p.err = cudaErrorInvalidValue;
        return;
    }
    p.err = p.vec ? launch_mma_tile<I, true, ARITH>(p, io, static_cast<int>(items))
                  : launch_mma_tile<I, false, ARITH>(p, io, static_cast<int>(items));
    advance(p, io, g);
}

template <int ARITH, std::size_t... I>
void run_mma_program(Program& p, std::index_sequence<I...>) {
    (launch_mma_conv<I, ARITH>(p), ...);
}

// The whole program in arithmetic ARITH: as cnn_step.cuh::cnn_forward, for
// `planes`, per conv the (PLANES, Cout, K padded to 16) bf16 weight planes.
template <int ARITH>
int cnn_forward_mma(const float* mel, int t_in, const float* const* caches_in, float* const* caches_out,
                    const __nv_bfloat16* const* planes, const float* const* biases, const float* scale,
                    const float* shift, float* emb, float* scratch0, float* scratch1, int n_streams, void* stream) {
    return run_forward([](Program& p) { run_mma_program<ARITH>(p, std::make_index_sequence<kNumConvs>{}); }, mel,
                       t_in, caches_in, caches_out, reinterpret_cast<const float* const*>(planes), biases, scale,
                       shift, emb, scratch0, scratch1, n_streams, stream);
}

}  // namespace
