// Streaming mel frontend for Hopper (sm_90a), fp32 on the CUDA cores: kernel 1
// (direct DFT over the live bins) and, further down, kernel 2 (radix-4
// factored DFT). Their bf16 variants run on the tensor cores: kernel 1's in
// csrc/melspec_mma.cu, kernel 2's in csrc/melspec_factored_mma.cu.
//
// Kernel 1 replaces the TPU kernel openwakeword_tpu/ops/melspec_pallas.py::_make_kernel
// (melspectrogram_pallas, dft="direct"): for each stream, the 8 new 512-sample
// frames (hop 160) of a 1760-sample window -> windowed cos/sin DFT -> power
// re^2 + im^2 -> Slaney mel projection -> 10*log10(max(mel, 1e-10)), written
// as ln(.) * 10/ln(10) like the TPU kernel. Input (S, 1760) f32, output
// (S, 8, 32) f32 raw dB. The top_db clamp and the /10+2 affine stay outside
// (they need the engine's first-frame mask).
//
// Only the DFT bins on which the filterbank has a non-zero weight are
// computed: [kLiveBin0, kLiveBin0 + kLiveBins) from the generated header
// mel_program.h (ops/melspec_cuda.py::live_bins; under half of the bins at
// the default FMIN/FMAX), padded with zero columns to a whole number of
// kBinTile-bin tiles; every other bin adds an exact zero to every band.
//
// What bounds it: 8 frames x 512 samples x kLiveBins bins x 2 (cos, sin)
// FMAs, about 2 MFLOP per stream per step against 7 KB of input: compute on
// the fp32 pipes (fp32 FFMA keeps the "highest" tier exact). The design is
// one GEMM with a fused epilogue. Rows are (stream, frame), 8 * S of them,
// implicit: row (s, f) is window[s, 160 f : 160 f + 512]. Columns are the
// cos and -sin of each live bin with the Hann window folded in (the
// (512, 2 * kLiveBinsPad) basis, zero past the live bins). K = 512.
//   * one block per 8 streams, all 8 frames: 64 rows x all live columns.
//     Each stream's window is staged in shared memory once, transposed to
//     [sample][stream] with 4 floats of padding every 160 samples, so the 8
//     frames of a warp read distinct bank quads;
//   * 16-row K slices of the basis stream in with cp.async, double
//     buffered; each basis element feeds the block's 64 rows;
//   * a warp is 8 frames x 4 bin groups; a thread holds 8 streams x 4 bins,
//     cos and sin side by side, in 64 registers. Per K step it does 64 FMAs
//     from four 16-byte shared loads (two broadcast window reads, two basis
//     reads that hit distinct banks);
//   * the epilogue forms the power in registers, writes the (64, bins)
//     power tile to the freed window buffer and the mel weights to the freed
//     basis buffer, and warp w projects rows w, w + kWarps, ... onto the
//     32 bands (one band per lane). Only the (64, 32) dB tile leaves the
//     chip.
// Any S >= 1: streams past the end of the last block read zeros and are
// not written.

#include <atomic>

#include <cuda_runtime.h>

#include "mel_program.h"
#include "smem.cuh"

namespace {

constexpr int kFreqs = kNfft / 2 + 1;
constexpr float kAmin = 1e-10f;
constexpr float kDbPerLn = 4.342944819032518f;      // 10 / ln(10)

constexpr int kStreams = 8;                          // streams per block, and per thread
constexpr int kRows = kStreams * kFrames;            // 64 GEMM rows per block
constexpr int kBinsPerThread = 4;                    // two float4 basis loads of (cos, -sin) pairs
constexpr int kGroupsPerWarp = 32 / kFrames;         // a warp: 8 frames x 4 bin groups
constexpr int kWarps = kLiveBinsPad / kBinTile;      // one warp per kBinTile bins
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 2 * kLiveBinsPad;              // a basis row: (cos, -sin) per bin
constexpr int kSliceK = 16;                          // basis rows per cp.async stage
constexpr int kSlices = kNfft / kSliceK;
constexpr int kSliceFloats = kSliceK * kCols;
constexpr int kSpan = (kFrames - 1) * kHop + kNfft;  // the window samples the frames read
constexpr int kPad = 4;                              // floats of padding after every kHop samples
constexpr int kWinFloats = kStreams * kSpan + kPad * ((kSpan + kHop - 1) / kHop);
constexpr int kFrameFloats = kStreams * kHop + kPad; // one frame further into the staged window
constexpr int kPowStride = kLiveBinsPad + 4;
constexpr int kStageFloats = kWinFloats > kRows * kPowStride ? kWinFloats : kRows * kPowStride;
constexpr int kSmemFloats = kStageFloats + 2 * kSliceFloats;
constexpr int kRowsPerWarp = (kRows + kWarps - 1) / kWarps;   // mel projection: rows warp + kWarps * i

static_assert(kFrames == 8 && kStreams == 8, "a warp spans the 8 frames; a thread holds 8 streams");
static_assert(kMels == 32, "the mel projection runs one band per lane");
static_assert(kBinsPerThread * kGroupsPerWarp == kBinTile && kLiveBinsPad % kBinTile == 0,
              "a warp's bins are one kBinTile tile of the padded live range");
static_assert(kThreads <= 1024, "one block");
static_assert(kLiveBins <= kLiveBinsPad && kLiveBin0 + kLiveBins <= kFreqs, "live bins inside the spectrum");
static_assert(kNfft % kSliceK == 0 && kHop % kSliceK == 0, "a K slice never straddles a pad");
static_assert(kHop % 4 == 0 && kStageFloats % 4 == 0 && kPowStride % 4 == 0, "16-byte shared accesses");
static_assert(kLiveBinsPad * kMels <= 2 * kSliceFloats, "the mel weights fit the basis stages");
static_assert(kSmemFloats * sizeof(float) <= 227 * 1024, "the block's shared memory fits an SM");

// Starts the copy of basis rows [kSliceK * slice, kSliceK * (slice + 1)) into
// `dst` as one cp.async group.
__device__ __forceinline__ void load_slice(float* dst, const float* __restrict__ basis, int slice) {
    const float* src = basis + static_cast<size_t>(slice) * kSliceFloats;
    for (int c = 4 * threadIdx.x; c < kSliceFloats; c += 4 * kThreads) {
        cp_async16(dst + c, src + c);
    }
    cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, kThreads <= 256 ? 2 : 1)
melspec_frames_kernel(const float* __restrict__ windows,   // (S, kWindow)
                      const float* __restrict__ basis,     // (kNfft, kCols): cos, -sin per live bin
                      const float* __restrict__ melw,      // (kLiveBinsPad, kMels)
                      float* __restrict__ out,             // (S, kFrames, kMels)
                      int n_streams) {
    extern __shared__ __align__(16) float smem[];
    float* win = smem;                               // [sample (+pad)][stream]; then the power
    float* stage = smem + kStageFloats;              // two basis slices; then the mel weights
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int f = lane & 7;                          // the thread's frame
    const int g = warp * kGroupsPerWarp + (lane >> 3);   // its bins: 4g .. 4g + 3 of the live range
    const int s0 = blockIdx.x * kStreams;
    const int n_valid = min(kStreams, n_streams - s0);

    load_slice(stage, basis, 0);
    for (int i = tid; i < kStreams * kSpan; i += kThreads) {
        const int s = i / kSpan;
        const int n = i - s * kSpan;
        const float v = s < n_valid ? windows[static_cast<size_t>(s0 + s) * kWindow + n] : 0.0f;
        win[kStreams * n + kPad * (n / kHop) + s] = v;
    }

    float re[kStreams][kBinsPerThread];
    float im[kStreams][kBinsPerThread];
#pragma unroll
    for (int s = 0; s < kStreams; ++s) {
#pragma unroll
        for (int q = 0; q < kBinsPerThread; ++q) {
            re[s][q] = 0.0f;
            im[s][q] = 0.0f;
        }
    }
    // sample kHop * f + n of the staged window sits at
    // kFrameFloats * f + kStreams * n + kPad * (n / kHop)
    const float* a_frame = win + kFrameFloats * f;
    for (int j = 0; j < kSlices; ++j) {
        if (j + 1 < kSlices) {
            load_slice(stage + ((j + 1) & 1) * kSliceFloats, basis, j + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                             // slice j (and, first, the window) is in
        const float* a = a_frame + kStreams * kSliceK * j + kPad * (kSliceK * j / kHop);
        const float* b = stage + (j & 1) * kSliceFloats + 2 * kBinsPerThread * g;
#pragma unroll
        for (int kk = 0; kk < kSliceK; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(a + kStreams * kk);
            const float4 a1 = *reinterpret_cast<const float4*>(a + kStreams * kk + 4);
            const float4 b0 = *reinterpret_cast<const float4*>(b + kCols * kk);
            const float4 b1 = *reinterpret_cast<const float4*>(b + kCols * kk + 4);
            const float x[kStreams] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float c[kBinsPerThread] = {b0.x, b0.z, b1.x, b1.z};
            const float sn[kBinsPerThread] = {b0.y, b0.w, b1.y, b1.w};
#pragma unroll
            for (int s = 0; s < kStreams; ++s) {
#pragma unroll
                for (int q = 0; q < kBinsPerThread; ++q) {
                    re[s][q] = fmaf(c[q], x[s], re[s][q]);
                    im[s][q] = fmaf(sn[q], x[s], im[s][q]);
                }
            }
        }
        __syncthreads();                             // slice j is read: its buffer is free
    }

    // The power tile [row = kFrames * s + f][bin] goes where the window was,
    // the mel weights where the basis slices were.
    float* power = smem;
#pragma unroll
    for (int s = 0; s < kStreams; ++s) {
        float4 p;
        p.x = re[s][0] * re[s][0] + im[s][0] * im[s][0];
        p.y = re[s][1] * re[s][1] + im[s][1] * im[s][1];
        p.z = re[s][2] * re[s][2] + im[s][2] * im[s][2];
        p.w = re[s][3] * re[s][3] + im[s][3] * im[s][3];
        *reinterpret_cast<float4*>(power + (kFrames * s + f) * kPowStride + kBinsPerThread * g) = p;
    }
    for (int i = 4 * tid; i < kLiveBinsPad * kMels; i += 4 * kThreads) {
        *reinterpret_cast<float4*>(stage + i) = *reinterpret_cast<const float4*>(melw + i);
    }
    __syncthreads();

    // Warp w projects rows w, w + kWarps, ... onto band `lane`.
    float acc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
        acc[i] = 0.0f;
    }
#pragma unroll 2
    for (int k = 0; k < kLiveBinsPad; k += 4) {
        const float w0 = stage[(k + 0) * kMels + lane];
        const float w1 = stage[(k + 1) * kMels + lane];
        const float w2 = stage[(k + 2) * kMels + lane];
        const float w3 = stage[(k + 3) * kMels + lane];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
            const int r = warp + kWarps * i;
            if (kRows % kWarps == 0 || r < kRows) {
                const float4 p = *reinterpret_cast<const float4*>(power + r * kPowStride + k);
                acc[i] = fmaf(w0, p.x, acc[i]);
                acc[i] = fmaf(w1, p.y, acc[i]);
                acc[i] = fmaf(w2, p.z, acc[i]);
                acc[i] = fmaf(w3, p.w, acc[i]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
        if ((kRows % kWarps == 0 || r < kRows) && r / kFrames < n_valid) {
            out[(static_cast<size_t>(s0) * kFrames + r) * kMels + lane] = logf(fmaxf(acc[i], kAmin)) * kDbPerLn;
        }
    }
}

// Kernel 2: the same output by the radix-4 factored DFT, fp32 on the CUDA cores.
// Replaces the TPU kernel openwakeword_tpu/ops/melspec_pallas.py::_make_factored_kernel
// (melspectrogram_pallas, dft="factored") at precision=HIGHEST. Its function, for the
// 8 frames j of each (S, 1760) f32 window:
//   Z_b[d] = sum_a x[160 j + 4 a + b] B_b[a, d]        branches b < 4, taps a < 128
//   E = Z0 + Z2, O = Z1 + Z3, D = Z0 - Z2, F = Z1 - Z3  (fp32, in that order)
//   p0[d] = |E + O|^2 (bin d), p1[d] = |D - i F|^2 (bin 128 + d), p2 = |E - O|^2 at d = 0 (bin 256)
//   mel = p0 W0 + p1 W1 + p2 w256, out = ln(max(mel, 1e-10)) * 10/ln(10), (S, 8, 32) raw dB.
// The window and the (b, d) twiddle are folded into the stage-1 bases B_b
// (ops/melspec.py::factored_dft_bases).
//
// What bounds it: the function is kernel 1's (chip_smoke.py::mel_work), 8.08 GFLOP at
// S = 4096 against 67 TFLOP/s of fp32: operations, 0.1206 ms. Run as it is here it is
// one GEMM of 8 S rows (stream, frame), K = 512 in (branch, tap) order and N = 2 x the
// live stage-1 columns (Re, Im), with the butterfly and the mel projection fused:
//   * only the stage-1 columns that feed a live bin (mel_program.h: kFactoredCol0 ..,
//     from ops/melspec_cuda.py::factored_columns): 2..121 at the default range, where
//     no bin of the c = 1 half and not bin 256 is live, so only X = E + O is formed. D,
//     F and p1 are formed only with kFactoredHalf1, p2 only with kFactoredNyquist. The
//     columns are padded to whole kFactoredColTile-column warp tiles (120 stay 120);
//   * one block per 8 streams, all 8 frames: 64 rows. Each window is staged once as
//     four fp32 branch planes (branch b = samples b::4, 408 positions), [position]
//     [stream] with 4 floats of padding after every 8 positions, so frame j's branch-b
//     operand starts 340 j floats into plane b and the 8 frames of a warp read 8
//     distinct bank quads (eight streams take 55.5 KB);
//   * the basis of the live columns (ops/melspec_cuda.py::_kernel_basis, fp32, zero
//     past the live count) streams in K slices of 32 rows (16 where two stages of 32 do
//     not fit) with cp.async, double buffered behind one barrier per slice; each slice
//     feeds the block's 64 rows;
//   * a warp is 8 frames x 4 column pairs; a thread holds 8 streams x 2 columns (Re,
//     Im). Per K step it does 32 FMAs from three 16-byte shared loads (two window reads,
//     broadcast to the warp's 4 column pairs, one basis read, broadcast to its 8 frames);
//   * the branch loop is outermost, in the order 0, 2, 1, 3, each branch summed into a
//     fresh tile, so the butterfly keeps the body's fp32 order: E = Z0 + Z2 (and D = Z0 -
//     Z2 with the c = 1 half) goes to shared memory that only its own thread touches,
//     then O = Z1 + Z3 and F = Z1 - Z3 are formed in registers and E comes back one
//     stream at a time. Two sets of 32 accumulators are live at once, which keeps a
//     thread within the 128 registers that 16 warps a block leave it (three sets
//     spilled there): 15 warps (120 columns) in one pass at the default range. With
//     the c = 1 half the saved E and D of 16 warps do not fit beside the rest, so 8
//     warps take the 128 columns in two passes;
//   * the epilogue of each pass forms the power in registers, writes the (64 rows x
//     columns) power tile and reads the mel weights of those columns, staged with the
//     first basis slice, and warp w projects rows w, w + warps, ... onto the 32 bands
//     (one band per lane), summing over the passes in registers; then p2 w256 and the
//     log. Only the (64, 32) dB tile leaves the chip.
// Any S >= 1: streams past the end of the last block read zeros and are not written.
// Measured with tools/mel_times.py on an NVIDIA H100 80GB HBM3 at 700.00 W: 0.2420 ms at
// S = 4096 (127 registers, no spills), 49.8% of the bound, against 0.7101 ms in the same
// call for the design it replaced (one block per 16 streams per frame over all 257 bins,
// the basis read from global memory by every block); a thread tile of 8 streams x 4
// columns (8 warps, 183 registers) took 0.2447 ms.
namespace factored {

constexpr int kRadix = 4;
constexpr int kSub = kNfft / kRadix;                     // taps per branch, and stage-1 columns
constexpr int kBranchLen = kSpan / kRadix;               // positions per stream in a branch plane
constexpr int kGroup = 8;                                // positions between two pads
constexpr int kGroupFloats = kGroup * kStreams + 4;      // 8 positions of the 8 streams, then 4 floats
constexpr int kPlane = kBranchLen / kGroup * kGroupFloats;   // floats of one branch plane
constexpr int kFrameFloats = kHop / kRadix / kGroup * kGroupFloats;   // a frame further into a plane
constexpr int kColTile = kFactoredColTile;               // columns per warp: 4 lanes x 2 columns
constexpr int kColsPad = (kFactoredCols + kColTile - 1) / kColTile * kColTile;
constexpr int kHalves = kFactoredHalf1 ? 2 : 1;          // the power of bins d, and of 128 + d
constexpr int kMaxWarps = 16;                            // 128 registers a thread: 2 sets of 32 accumulators
constexpr int kTileWarps = kColsPad / kColTile;
constexpr int kSaved = kHalves * kStreams * 4;           // floats a thread keeps in shared memory: E (and D)
constexpr int kMaxSmem = 227 * 1024;
// Shared memory, in floats, of a block that takes the columns in `passes` passes with
// K slices of `slice_k` rows: window planes, the threads' saved E (and D), the power
// tile, the mel weights ([pass][half][column][mel], then bin 256's row), p2 per row,
// and two basis stages.
constexpr int smem_floats(int passes, int slice_k) {
    return kRadix * kPlane + kSaved * 32 * (kTileWarps / passes) +
           kRows * (kHalves * kColsPad / passes + 4) + (kHalves * kColsPad + 1) * kMels + kRows +
           2 * slice_k * 2 * kColsPad / passes;
}
constexpr bool fits(int passes) {
    return kTileWarps % passes == 0 && kTileWarps / passes <= kMaxWarps &&
           smem_floats(passes, 16) * static_cast<int>(sizeof(float)) <= kMaxSmem;
}
constexpr int kPasses = fits(1) ? 1 : fits(2) ? 2 : 4;   // the fewest passes whose block fits an SM
constexpr int kWarps = kTileWarps / kPasses;
constexpr int kThreads = 32 * kWarps;
constexpr int kPassCols = kWarps * kColTile;             // columns of one pass
constexpr int kSliceRow = 2 * kPassCols;                 // floats of a staged basis row: (Re, Im) per column
constexpr int kPowStride = kHalves * kPassCols + 4;
constexpr int kMelRows = kHalves * kColsPad;             // then bin 256's row
constexpr int kRowsPerWarp = (kRows + kWarps - 1) / kWarps;
constexpr int kSavedOffset = kRadix * kPlane;
constexpr int kPowOffset = kSavedOffset + kSaved * kThreads;
constexpr int kMelOffset = kPowOffset + kRows * kPowStride;
constexpr int kNyqOffset = kMelOffset + (kMelRows + 1) * kMels;
constexpr int kStageOffset = kNyqOffset + kRows;
constexpr int kSliceK = smem_floats(kPasses, 32) * static_cast<int>(sizeof(float)) <= kMaxSmem ? 32 : 16;
constexpr int kSlicesPerBranch = kSub / kSliceK;
constexpr int kStagesPerPass = kRadix * kSlicesPerBranch;
constexpr int kStages = kPasses * kStagesPerPass;
constexpr int kSliceFloats = kSliceK * kSliceRow;
constexpr size_t kSmemBytes = smem_floats(kPasses, kSliceK) * sizeof(float);

static_assert(kBranchLen % kGroup == 0 && (kHop / kRadix) % kGroup == 0 && kSliceK % kGroup == 0,
              "frames and K slices start on a pad group");
static_assert(kGroupFloats % 4 == 0 && (kFrameFloats / 4) % 2 == 1,
              "16-byte window reads; the 8 frames of a warp start in distinct bank quads");
static_assert(kColTile == 8 && kGroupsPerWarp * kFrames == 32, "a warp is 8 frames x 4 column pairs");
static_assert(fits(kPasses) && kStageOffset + 2 * kSliceK * kSliceRow == smem_floats(kPasses, kSliceK),
              "whole passes of whole warps; the regions add up");
static_assert(kFactoredCol0 + kFactoredCols <= kSub && kColsPad <= kSub, "live stage-1 columns");
static_assert(!kFactoredNyquist || kFactoredCol0 == 0, "bin 256 is the butterfly of column 0, which must be computed");
static_assert(kSub % kSliceK == 0 && kSliceRow % 4 == 0 && kPowStride % 4 == 0 && kPlane % 4 == 0 &&
              kPowOffset % 4 == 0 && kMelOffset % 4 == 0 && kStageOffset % 4 == 0, "16-byte aligned regions");
static_assert(kSmemBytes <= kMaxSmem && kThreads <= 1024, "the block fits an SM");

// Starts the copy of stage i, K slice i % kSlicesPerBranch of the pass's v-th branch
// (v = (i / kSlicesPerBranch) % 4; branches in the order 0, 2, 1, 3), the columns of
// pass i / kStagesPerPass, into dst ([row][kSliceRow]), committed as one cp.async
// group with whatever this thread issued before.
__device__ __forceinline__ void load_stage(float* dst, const float* __restrict__ basis, int i) {
    constexpr int kChunks = kSliceRow / 4;
    const int pass = i / kStagesPerPass;
    const int v = (i - pass * kStagesPerPass) / kSlicesPerBranch;
    const int k0 = kSub * ((v & 1) * 2 + (v >> 1)) + kSliceK * (i % kSlicesPerBranch);
    const float* src = basis + static_cast<size_t>(k0) * (2 * kColsPad) + kSliceRow * pass;
    for (int c = threadIdx.x; c < kSliceK * kChunks; c += kThreads) {
        const int row = c / kChunks;
        const int chunk = c - row * kChunks;
        cp_async16(dst + row * kSliceRow + 4 * chunk, src + row * (2 * kColsPad) + 4 * chunk);
    }
    cp_async_commit();
}

// the thread's tile of one branch's product: the window from `a` (the thread's frame
// in the branch's plane), the basis from the branch's kSlicesPerBranch stages, the
// first of them `stage` (arrive(i) waits for stage i and returns the thread's column
// pair in it)
template <typename Arrive>
__device__ __forceinline__ void branch_product(float (&acc)[kStreams][4], const float* a, Arrive& arrive,
                                               int stage) {
#pragma unroll
    for (int s = 0; s < kStreams; ++s) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            acc[s][q] = 0.0f;
        }
    }
#pragma unroll 1
    for (int sl = 0; sl < kSlicesPerBranch; ++sl) {
        const float* b = arrive(stage + sl);
        const float* as = a + kSliceK / kGroup * kGroupFloats * sl;
#pragma unroll
        for (int kk = 0; kk < kSliceK; ++kk) {
            const float* ak = as + kk / kGroup * kGroupFloats + kk % kGroup * kStreams;
            const float4 a0 = *reinterpret_cast<const float4*>(ak);
            const float4 a1 = *reinterpret_cast<const float4*>(ak + 4);
            const float4 w = *reinterpret_cast<const float4*>(b + kSliceRow * kk);
            const float x[kStreams] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
            for (int s = 0; s < kStreams; ++s) {
                acc[s][0] = fmaf(w.x, x[s], acc[s][0]);
                acc[s][1] = fmaf(w.y, x[s], acc[s][1]);
                acc[s][2] = fmaf(w.z, x[s], acc[s][2]);
                acc[s][3] = fmaf(w.w, x[s], acc[s][3]);
            }
        }
    }
}

__device__ __forceinline__ float norm2(float re, float im) {
    return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

__global__ void __launch_bounds__(kThreads, 1)
melspec_frames_factored_kernel(const float* __restrict__ windows,   // (S, kWindow)
                               const float* __restrict__ basis,     // (kNfft, 2 kColsPad): (Re, Im) per live column
                               const float* __restrict__ melw,      // (kMelRows + 1, kMels)
                               float* __restrict__ out,             // (S, kFrames, kMels)
                               int n_streams) {
    extern __shared__ __align__(16) float smem[];
    float* win = smem;                               // [branch][position (+pad)][stream]
    float4* saved = reinterpret_cast<float4*>(smem + kSavedOffset);   // [half][stream][thread]: E, then D
    float* power = smem + kPowOffset;                // [row][half * kPassCols + column]
    float* mel_w = smem + kMelOffset;                // [pass][half][column][mel], then bin 256's row
    float* nyquist = smem + kNyqOffset;              // p2 per row
    float* stage = smem + kStageOffset;              // two basis stages
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int f = lane & 7;                          // the thread's frame
    const int g = lane >> 3;                         // its columns: 8 warp + 2 g, + 1 of each pass
    const int s0 = blockIdx.x * kStreams;
    const int n_valid = min(kStreams, n_streams - s0);

    // the mel weights and basis stage 0 arrive as the first cp.async group
    for (int c = tid; c < (kMelRows + 1) * (kMels / 4); c += kThreads) {
        const int row = c / (kMels / 4);
        const int half = row / kColsPad;
        const int col = row - half * kColsPad;
        const int pass = col / kPassCols;
        const int at = row < kMelRows ? (pass * kHalves + half) * kPassCols + col - pass * kPassCols : kMelRows;
        cp_async16(mel_w + at * kMels + 4 * (c - row * (kMels / 4)), melw + 4 * c);
    }
    load_stage(stage, basis, 0);

    // Unit u of stream s, samples 4 u .. 4 u + 3, is position u of the four branch
    // planes. Lanes take 8 streams x 4 units, so that a warp's stores are 32
    // consecutive floats; a thread loads a batch of units before it stores them.
    constexpr int kUnits = kStreams * kBranchLen;
    constexpr int kBatch = 4;
    for (int v0 = 0; v0 < kUnits; v0 += kBatch * kThreads) {
        float x[kBatch][kRadix];
#pragma unroll
        for (int v = 0; v < kBatch; ++v) {
            const int i = v0 + v * kThreads + tid;
            const int s = i % kStreams;
#pragma unroll
            for (int b = 0; b < kRadix; ++b) {
                x[v][b] = 0.0f;
            }
            if (i < kUnits && s < n_valid) {
                const float* src = windows + static_cast<size_t>(s0 + s) * kWindow + kRadix * (i / kStreams);
#pragma unroll
                for (int b = 0; b < kRadix; ++b) {
                    x[v][b] = src[b];
                }
            }
        }
#pragma unroll
        for (int v = 0; v < kBatch; ++v) {
            const int i = v0 + v * kThreads + tid;
            const int u = i / kStreams;
            if (i < kUnits) {
                const int at = u / kGroup * kGroupFloats + u % kGroup * kStreams + i % kStreams;
#pragma unroll
                for (int b = 0; b < kRadix; ++b) {
                    win[b * kPlane + at] = x[v][b];
                }
            }
        }
    }

    // stage i is in, and every warp is done with stage i - 1, whose buffer now takes
    // stage i + 1; returns the thread's column pair in stage i
    const int b_lane = 2 * kColTile * warp + 4 * g;
    auto arrive = [&](int i) {
        cp_async_wait<0>();
        __syncthreads();
        if (i + 1 < kStages) {
            load_stage(stage + ((i + 1) & 1) * kSliceFloats, basis, i + 1);
        }
        return stage + (i & 1) * kSliceFloats + b_lane;
    };

    const float* a_lane = win + kFrameFloats * f;
    float mel[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
        mel[i] = 0.0f;
    }
#pragma unroll 1
    for (int pass = 0; pass < kPasses; ++pass) {
        const int first = kStagesPerPass * pass;
        float z[kStreams][4];                        // Z0, then Z1 and O
        float t[kStreams][4];                        // Z2, then Z3 and F
        branch_product(z, a_lane, arrive, first);
        branch_product(t, a_lane + 2 * kPlane, arrive, first + kSlicesPerBranch);
#pragma unroll
        for (int s = 0; s < kStreams; ++s) {
            const float* z0 = z[s];
            const float* z2 = t[s];
            saved[s * kThreads + tid] = make_float4(z0[0] + z2[0], z0[1] + z2[1], z0[2] + z2[2], z0[3] + z2[3]);
            if constexpr (kFactoredHalf1) {
                saved[(kStreams + s) * kThreads + tid] =
                    make_float4(z0[0] - z2[0], z0[1] - z2[1], z0[2] - z2[2], z0[3] - z2[3]);
            }
        }
        branch_product(z, a_lane + kPlane, arrive, first + 2 * kSlicesPerBranch);
        branch_product(t, a_lane + 3 * kPlane, arrive, first + 3 * kSlicesPerBranch);
#pragma unroll
        for (int s = 0; s < kStreams; ++s) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float z1 = z[s][q];
                const float z3 = t[s][q];
                z[s][q] = z1 + z3;
                t[s][q] = z1 - z3;
            }
        }

        // The power of the thread's 8 streams x 2 columns: row 8 s + f of the tile.
        const int col = kColTile * warp + 2 * g;
#pragma unroll
        for (int s = 0; s < kStreams; ++s) {
            const float4 e = saved[s * kThreads + tid];
            const float* o = z[s];
            float* p = power + (kFrames * s + f) * kPowStride + col;
            *reinterpret_cast<float2*>(p) = make_float2(norm2(e.x + o[0], e.y + o[1]), norm2(e.z + o[2], e.w + o[3]));
            if constexpr (kFactoredHalf1) {
                const float4 d = saved[(kStreams + s) * kThreads + tid];
                const float* fo = t[s];
                *reinterpret_cast<float2*>(p + kPassCols) =
                    make_float2(norm2(d.x + fo[1], d.y - fo[0]), norm2(d.z + fo[3], d.w - fo[2]));
            }
            if constexpr (kFactoredNyquist) {
                // column 0 is the first column of lanes g == 0 in warp 0 of pass 0
                if (pass == 0 && col == 0) {
                    nyquist[kFrames * s + f] = norm2(e.x - o[0], e.y - o[1]);
                }
            }
        }
        __syncthreads();                             // the power tile is written

        // Warp w projects rows w, w + kWarps, ... onto band `lane`.
        const float* w_pass = mel_w + pass * kHalves * kPassCols * kMels + lane;
#pragma unroll 2
        for (int k = 0; k < kHalves * kPassCols; k += 4) {
            const float w0 = w_pass[(k + 0) * kMels];
            const float w1 = w_pass[(k + 1) * kMels];
            const float w2 = w_pass[(k + 2) * kMels];
            const float w3 = w_pass[(k + 3) * kMels];
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i) {
                const int r = warp + kWarps * i;
                if (kRows % kWarps == 0 || r < kRows) {
                    const float4 p = *reinterpret_cast<const float4*>(power + r * kPowStride + k);
                    mel[i] = fmaf(w0, p.x, mel[i]);
                    mel[i] = fmaf(w1, p.y, mel[i]);
                    mel[i] = fmaf(w2, p.z, mel[i]);
                    mel[i] = fmaf(w3, p.w, mel[i]);
                }
            }
        }
        // the next pass writes the power tile only after its K loop's barriers
    }

    // Row r = 8 s + f of the block is out[s0 + s, f]; bin 256's fp32 product comes
    // last, as the body adds p2 * mel_last after its two dots.
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
        if ((kRows % kWarps == 0 || r < kRows) && r / kFrames < n_valid) {
            float v = mel[i];
            if constexpr (kFactoredNyquist) {
                v = __fadd_rn(v, __fmul_rn(nyquist[r], mel_w[kMelRows * kMels + lane]));
            }
            out[(static_cast<size_t>(s0) * kFrames + r) * kMels + lane] = logf(fmaxf(v, kAmin)) * kDbPerLn;
        }
    }
}

}  // namespace factored

// Kernels 1 and 2 need more than 48 KB of dynamic shared memory, which a
// kernel must opt in to once per device: a costly runtime call, so it is made
// on the first launch on each device only.
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

int launch_factored(const float* windows, const float* basis, const float* melw, float* out, int n_streams,
                    void* stream) {
    if (n_streams <= 0) {
        return 0;
    }
    static std::atomic<unsigned long long> allowed{0};
    const cudaError_t err = allow_smem(factored::melspec_frames_factored_kernel, factored::kSmemBytes, &allowed);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int grid = (n_streams + kStreams - 1) / kStreams;
    factored::melspec_frames_factored_kernel<<<grid, factored::kThreads, factored::kSmemBytes,
                                               static_cast<cudaStream_t>(stream)>>>(windows, basis, melw, out,
                                                                                    n_streams);
    return static_cast<int>(cudaGetLastError());
}

int launch_direct(const float* windows, const float* basis, const float* melw, float* out, int n_streams,
                  void* stream) {
    if (n_streams <= 0) {
        return 0;
    }
    static std::atomic<unsigned long long> allowed{0};
    const cudaError_t err = allow_smem(melspec_frames_kernel, kSmemBytes, &allowed);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int grid = (n_streams + kStreams - 1) / kStreams;
    melspec_frames_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
        windows, basis, melw, out, n_streams);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: launch on `stream` and return cudaGetLastError() (0 = the
// launch was accepted). Pointers are device pointers to contiguous float32.
extern "C" int owwt_melspec_frames(const float* windows, const float* basis, const float* melw, float* out,
                                   int n_streams, void* stream) {
    return launch_direct(windows, basis, melw, out, n_streams, stream);
}

extern "C" int owwt_melspec_frames_factored(const float* windows, const float* basis, const float* melw,
                                            float* out, int n_streams, void* stream) {
    return launch_factored(windows, basis, melw, out, n_streams, stream);
}
