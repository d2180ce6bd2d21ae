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

// Kernel 2: the same output by the radix-4 factored DFT. Replaces the TPU kernel
// openwakeword_tpu/ops/melspec_pallas.py::_make_factored_kernel
// (melspectrogram_pallas, dft="factored"). Decimating n = 4a + b splits each
// 512-point frame into four 128-point branches b (samples 160j + 4a + b, read
// from the staged frame with stride 4, no deinterleave in memory):
//   Z_b[d]   = sum_a x[4a + b] * B_b[a, d]   (window and twiddle folded into B)
//   X[d]     = Z0 + Z1 + Z2 + Z3                    bins 0..127
//   X[128+d] = (Z0 - Z2) - i (Z1 - Z3)              bins 128..255
//   X[256]   = (Z0 + Z2) - (Z1 + Z3) at d = 0
// 4 x 128 x 128 complex MACs per frame against a direct DFT's 512 x 257:
// half the FMAs, but over all 257 bins (kernel 1 prunes to the live ones).
// Thread 4d + b owns Z_b[d] for the 16 streams of the tile; its basis is read
// as (a, d, b)-ordered float2, so a warp's basis loads are one contiguous
// 256-byte line. The four branches of a bin sit in neighbouring lanes, so the
// butterfly is two rounds of warp shuffles that write the power straight to
// shared memory. The mel projection is split as in
// the TPU kernel: bins [0, 128), [128, 256), then the k = 256 row.
constexpr int kTileS = 16;                           // streams per block
constexpr int kRadix = 4;
constexpr int kSub = kNfft / kRadix;                 // 128 samples per branch, 128 bins
constexpr int kFactoredThreads = kRadix * kSub;      // 512

static_assert(kTileS * kMels == kFactoredThreads, "one thread per (stream, mel) output");
static_assert(kNfft % kRadix == 0 && kTileS % 4 == 0, "radix-4 branches; frames read as float4 over streams");
static_assert(kFreqs <= kNfft, "the power reuses the frame buffer");

__global__ void __launch_bounds__(kFactoredThreads)
melspec_frames_factored_kernel(const float* __restrict__ windows,
                               const float2* __restrict__ basis,   // (128 a, 128 d, 4 b) of (Re, Im)
                               const float* __restrict__ melw,     // (257, 32)
                               float* __restrict__ out,            // (S, 8, 32)
                               int n_streams) {
    __shared__ __align__(16) float smem[kNfft * kTileS];
    const int s0 = blockIdx.x * kTileS;
    const int frame = blockIdx.y;
    const int tid = threadIdx.x;
    const int n_valid = min(kTileS, n_streams - s0);

    for (int i = tid; i < kTileS * kNfft; i += kFactoredThreads) {
        const int s = i / kNfft;
        const int n = i - s * kNfft;
        float v = 0.0f;
        if (s < n_valid) {
            v = windows[static_cast<size_t>(s0 + s) * kWindow + kHop * frame + n];
        }
        smem[n * kTileS + s] = v;
    }
    __syncthreads();

    const int b = tid % kRadix;
    const int d = tid / kRadix;
    float re[kTileS];
    float im[kTileS];
#pragma unroll
    for (int s = 0; s < kTileS; ++s) {
        re[s] = 0.0f;
        im[s] = 0.0f;
    }
#pragma unroll 4
    for (int a = 0; a < kSub; ++a) {
        const float2 w = basis[a * kFactoredThreads + tid];
        const float4* x4 = reinterpret_cast<const float4*>(smem + (kRadix * a + b) * kTileS);
#pragma unroll
        for (int q = 0; q < kTileS / 4; ++q) {
            const float4 x = x4[q];
            re[4 * q + 0] = fmaf(w.x, x.x, re[4 * q + 0]);
            im[4 * q + 0] = fmaf(w.y, x.x, im[4 * q + 0]);
            re[4 * q + 1] = fmaf(w.x, x.y, re[4 * q + 1]);
            im[4 * q + 1] = fmaf(w.y, x.y, im[4 * q + 1]);
            re[4 * q + 2] = fmaf(w.x, x.z, re[4 * q + 2]);
            im[4 * q + 2] = fmaf(w.y, x.z, im[4 * q + 2]);
            re[4 * q + 3] = fmaf(w.x, x.w, re[4 * q + 3]);
            im[4 * q + 3] = fmaf(w.y, x.w, im[4 * q + 3]);
        }
    }

    __syncthreads();                                // all frame reads are done

    // Butterfly, straight into the power buffer [s][k] that reuses the frame
    // buffer. Round 1 pairs b with b ^ 2: lanes 0, 1 form E = Z0 + Z2 and
    // O = Z1 + Z3, lanes 2, 3 form D = Z0 - Z2 and F = Z1 - Z3. Round 2 pairs
    // b with b ^ 1: lane 0 takes O beside E and writes bin d (and, for d = 0,
    // bin 256), lane 2 takes F beside D and writes bin 128 + d.
    float* power = smem;
#pragma unroll
    for (int s = 0; s < kTileS; ++s) {
        const float o_re = __shfl_xor_sync(0xffffffffu, re[s], 2);
        const float o_im = __shfl_xor_sync(0xffffffffu, im[s], 2);
        const float e_re = b < 2 ? re[s] + o_re : o_re - re[s];
        const float e_im = b < 2 ? im[s] + o_im : o_im - im[s];
        const float f_re = __shfl_xor_sync(0xffffffffu, e_re, 1);
        const float f_im = __shfl_xor_sync(0xffffffffu, e_im, 1);
        if (b == 0) {
            const float sr = e_re + f_re;
            const float si = e_im + f_im;
            power[s * kFreqs + d] = sr * sr + si * si;
            if (d == 0) {
                const float dr = e_re - f_re;
                const float di = e_im - f_im;
                power[s * kFreqs + 2 * kSub] = dr * dr + di * di;
            }
        } else if (b == 2) {
            const float cr = e_re + f_im;
            const float ci = e_im - f_re;
            power[s * kFreqs + kSub + d] = cr * cr + ci * ci;
        }
    }
    __syncthreads();

    const int s = tid / kMels;
    const int m = tid - s * kMels;
    if (s < n_valid) {
        const float* p = power + s * kFreqs;
        float lo = 0.0f;
        float hi = 0.0f;
        for (int f = 0; f < kSub; ++f) {
            lo = fmaf(melw[f * kMels + m], p[f], lo);
            hi = fmaf(melw[(kSub + f) * kMels + m], p[kSub + f], hi);
        }
        const float mel = (lo + hi) + p[2 * kSub] * melw[2 * kSub * kMels + m];
        out[(static_cast<size_t>(s0 + s) * kFrames + frame) * kMels + m] =
            logf(fmaxf(mel, kAmin)) * kDbPerLn;
    }
}

// Kernel 1 needs more than 48 KB of dynamic shared memory, which a kernel
// must opt in to once per device: a driver call, so it is made on the first
// launch on each device only.
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

int launch_factored(const float* windows, const float* basis, const float* melw, float* out, int n_streams,
                    void* stream) {
    if (n_streams <= 0) {
        return 0;
    }
    const dim3 grid((n_streams + kTileS - 1) / kTileS, kFrames);
    melspec_frames_factored_kernel<<<grid, kFactoredThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        windows, reinterpret_cast<const float2*>(basis), melw, out, n_streams);
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
