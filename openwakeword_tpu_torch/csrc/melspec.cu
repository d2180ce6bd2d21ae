// Streaming mel frontend for Hopper (sm_90a), fp32 on the CUDA cores: kernel 1
// (direct DFT) and, further down, kernel 2 (radix-4 factored DFT).
//
// Kernel 1 replaces the TPU kernel openwakeword_tpu/ops/melspec_pallas.py::_make_kernel
// (melspectrogram_pallas, dft="direct"): for each stream, the 8 new 512-sample
// frames (hop 160) of a 1760-sample window -> windowed cos/sin DFT -> power
// re^2 + im^2 over 257 bins -> (257, 32) Slaney mel projection ->
// 10*log10(max(mel, 1e-10)), written as ln(.) * 10/ln(10) like the TPU kernel.
// Input (S, 1760) f32, output (S, 8, 32) f32 raw dB. The top_db clamp and the
// /10+2 affine stay outside (they need the engine's first-frame mask).
//
// What bounds it: 8 frames x 512 samples x 257 bins x 2 (cos, sin) FMAs, about
// 4.2 MFLOP per stream per step, against 7 KB of input, so the kernel is
// compute-bound (~600 FLOP per byte of input). The design spends the FMAs on
// the CUDA cores in full fp32 (the engine's "highest"/"high" tiers) and keeps
// every intermediate on chip:
//   * one block per (tile of 16 streams, frame); the tile's frames are staged
//     in shared memory transposed to [n][stream], so one broadcast 16-byte
//     shared load feeds 4 streams;
//   * thread k < 257 owns DFT bin k and accumulates cos and sin for all 16
//     streams in registers, reading the interleaved (512, 257) cos/-sin basis
//     as one float2 per sample from global memory (1 MB, L2-resident); each
//     basis load is reused 16 times, once per stream of the tile;
//   * the power (16 x 257) overwrites the staged frames in shared memory, and
//     the mel projection and log run from there; only the (16, 32) dB tile
//     leaves the chip.
// No tensor cores, no bin skipping: faster designs are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 1760;
constexpr int kFrames = 8;
constexpr int kNfft = 512;
constexpr int kFreqs = 257;
constexpr int kMels = 32;
constexpr int kHop = 160;
constexpr int kTileS = 16;
constexpr int kThreads = 288;                       // 9 warps; threads 0..256 own one bin each
constexpr float kAmin = 1e-10f;
constexpr float kDbPerLn = 4.342944819032518f;      // 10 / ln(10)

static_assert(kTileS % 4 == 0, "frames are read as float4 over streams");
static_assert(kTileS * kFreqs <= kTileS * kNfft, "power reuses the frame buffer");
static_assert(kThreads >= kFreqs, "one thread per DFT bin");

__global__ void __launch_bounds__(kThreads)
melspec_frames_kernel(const float* __restrict__ windows,
                      const float2* __restrict__ basis,    // (512, 257) of (cos, -sin)
                      const float* __restrict__ melw,      // (257, 32)
                      float* __restrict__ out,             // (S, 8, 32)
                      int n_streams) {
    __shared__ __align__(16) float smem[kNfft * kTileS];
    const int s0 = blockIdx.x * kTileS;
    const int frame = blockIdx.y;
    const int tid = threadIdx.x;
    const int n_valid = min(kTileS, n_streams - s0);

    // Stage frame `frame` of every stream of the tile as [n][s]; streams past
    // the end read as zeros and are never written back.
    for (int i = tid; i < kTileS * kNfft; i += kThreads) {
        const int s = i / kNfft;
        const int n = i - s * kNfft;
        float v = 0.0f;
        if (s < n_valid) {
            v = windows[static_cast<size_t>(s0 + s) * kWindow + kHop * frame + n];
        }
        smem[n * kTileS + s] = v;
    }
    __syncthreads();

    const int k = tid;
    float re[kTileS];
    float im[kTileS];
#pragma unroll
    for (int s = 0; s < kTileS; ++s) {
        re[s] = 0.0f;
        im[s] = 0.0f;
    }
    if (k < kFreqs) {
#pragma unroll 4
        for (int n = 0; n < kNfft; ++n) {
            const float2 b = basis[n * kFreqs + k];
            const float4* x4 = reinterpret_cast<const float4*>(smem + n * kTileS);
#pragma unroll
            for (int q = 0; q < kTileS / 4; ++q) {
                const float4 x = x4[q];
                re[4 * q + 0] = fmaf(x.x, b.x, re[4 * q + 0]);
                im[4 * q + 0] = fmaf(x.x, b.y, im[4 * q + 0]);
                re[4 * q + 1] = fmaf(x.y, b.x, re[4 * q + 1]);
                im[4 * q + 1] = fmaf(x.y, b.y, im[4 * q + 1]);
                re[4 * q + 2] = fmaf(x.z, b.x, re[4 * q + 2]);
                im[4 * q + 2] = fmaf(x.z, b.y, im[4 * q + 2]);
                re[4 * q + 3] = fmaf(x.w, b.x, re[4 * q + 3]);
                im[4 * q + 3] = fmaf(x.w, b.y, im[4 * q + 3]);
            }
        }
    }
    __syncthreads();                                // all frame reads are done

    float* power = smem;                            // reused as [s][k]
    if (k < kFreqs) {
#pragma unroll
        for (int s = 0; s < kTileS; ++s) {
            power[s * kFreqs + k] = re[s] * re[s] + im[s] * im[s];
        }
    }
    __syncthreads();

    for (int o = tid; o < kTileS * kMels; o += kThreads) {
        const int s = o / kMels;
        const int m = o - s * kMels;
        if (s >= n_valid) {
            continue;
        }
        const float* p = power + s * kFreqs;
        float acc = 0.0f;
        for (int f = 0; f < kFreqs; ++f) {
            acc = fmaf(p[f], melw[f * kMels + m], acc);
        }
        out[(static_cast<size_t>(s0 + s) * kFrames + frame) * kMels + m] =
            logf(fmaxf(acc, kAmin)) * kDbPerLn;
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
// 4 x 128 x 128 complex MACs per frame against K1's 512 x 257: half the FMAs.
// Thread 4d + b owns Z_b[d] for the 16 streams of the tile; its basis is read
// as (a, d, b)-ordered float2, so a warp's basis loads are one contiguous
// 256-byte line. The four branches of a bin sit in neighbouring lanes, so the
// butterfly is two rounds of warp shuffles that write the power straight to
// shared memory. The mel projection is split as in
// the TPU kernel: bins [0, 128), [128, 256), then the k = 256 row.
constexpr int kRadix = 4;
constexpr int kSub = kNfft / kRadix;                 // 128 samples per branch, 128 bins
constexpr int kFactoredThreads = kRadix * kSub;      // 512

static_assert(kTileS * kMels == kFactoredThreads, "one thread per (stream, mel) output");

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
            re[4 * q + 0] = fmaf(x.x, w.x, re[4 * q + 0]);
            im[4 * q + 0] = fmaf(x.x, w.y, im[4 * q + 0]);
            re[4 * q + 1] = fmaf(x.y, w.x, re[4 * q + 1]);
            im[4 * q + 1] = fmaf(x.y, w.y, im[4 * q + 1]);
            re[4 * q + 2] = fmaf(x.z, w.x, re[4 * q + 2]);
            im[4 * q + 2] = fmaf(x.z, w.y, im[4 * q + 2]);
            re[4 * q + 3] = fmaf(x.w, w.x, re[4 * q + 3]);
            im[4 * q + 3] = fmaf(x.w, w.y, im[4 * q + 3]);
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
            lo = fmaf(p[f], melw[f * kMels + m], lo);
            hi = fmaf(p[kSub + f], melw[(kSub + f) * kMels + m], hi);
        }
        const float mel = (lo + hi) + p[2 * kSub] * melw[2 * kSub * kMels + m];
        out[(static_cast<size_t>(s0 + s) * kFrames + frame) * kMels + m] =
            logf(fmaxf(mel, kAmin)) * kDbPerLn;
    }
}

}  // namespace

extern "C" int owwt_melspec_frames_factored(const float* windows, const float* basis,
                                            const float* melw, float* out,
                                            int n_streams, void* stream) {
    if (n_streams <= 0) {
        return 0;
    }
    const dim3 grid((n_streams + kTileS - 1) / kTileS, kFrames);
    melspec_frames_factored_kernel<<<grid, kFactoredThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        windows, reinterpret_cast<const float2*>(basis), melw, out, n_streams);
    return static_cast<int>(cudaGetLastError());
}

// C entry point: launches on `stream` and returns cudaGetLastError() (0 = the
// launch was accepted). Pointers are device pointers to contiguous float32.
extern "C" int owwt_melspec_frames(const float* windows, const float* basis,
                                   const float* melw, float* out,
                                   int n_streams, void* stream) {
    if (n_streams <= 0) {
        return 0;
    }
    const dim3 grid((n_streams + kTileS - 1) / kTileS, kFrames);
    melspec_frames_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        windows, reinterpret_cast<const float2*>(basis), melw, out, n_streams);
    return static_cast<int>(cudaGetLastError());
}
