// Kernel 1's bf16 variants on Hopper's tensor cores: K1-1pass and K1-3pass.
//
// They replace the TPU kernel openwakeword_tpu/ops/melspec_pallas.py::_make_kernel
// (melspectrogram_pallas, dft="direct") at precision None/DEFAULT (1-pass) and at
// Precision.HIGH (3-pass): kernel 1's function (csrc/melspec.cu), (S, 1760) f32
// windows -> the 8 frames' windowed DFT over the live bins -> power -> mel
// projection -> 10*log10(max(mel, 1e-10)) as ln(.) * 10/ln(10), (S, 8, 32) raw dB,
// with each product taken as the TPU body takes it:
//   * 1-pass: both operands rounded to bf16 (round-to-nearest-even), fp32 sums;
//   * 3-pass: each operand x split into bf16 halves, hi = bf16(x) and
//     lo = bf16(x - hi) (melspec_pallas.py::_bf16_split), the product taken as
//     hi*hi + hi*lo + lo*hi with fp32 sums, lo*lo dropped.
// The kernel rounds or splits the window samples as it stages them and the power
// before the mel projection, in registers; the host rounds or splits the basis and
// the mel weights once (ops/melspec_cuda.py::_device_consts) into bf16 planes in
// this kernel's layout. Each pass is a bf16 x bf16 product with fp32 sums, which is
// what mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 computes, so both products, the
// DFT and the mel projection, run on the tensor cores.
//
// What bounds it: at S = 4096 the DFT is 8.6 GFLOP of MMA work per pass (rows
// 8 S, K = 512, N = 2 x 128 padded live bins), 9 us per pass at the dense bf16
// rate, against 27 MB of windows, 8 us at the HBM rate. The design is one GEMM
// with a fused epilogue, as kernel 1:
//   * a block takes 16 streams (128 rows) and all the live bins; 8 warps, each
//     64 rows (4 m16 tiles: the 8 frames of 2 streams each) x 32 bins (4 groups
//     of 8 bins, a cos and a -sin n8 tile each): 128 fp32 accumulators a thread.
//     A live range of more than 4 bin warps (128 bins) takes 8 streams a
//     block, so that the block keeps 8 warps or fewer and 255 registers a
//     thread (16 streams at 256 bins spilled 11 KB a thread at 128 registers);
//   * A comes straight from the staged window: each stream's 1632 samples are
//     staged once in shared memory as bf16 (hi, and lo for 3-pass), with 8 bf16
//     of padding after every 160 samples. ldmatrix takes one row address per
//     lane, so the frames' 3.2x overlap costs nothing; the 8 frame rows of one
//     8x8 matrix start 168 bf16 (84 words) apart and hit distinct bank quads; a
//     16-sample K step never straddles a pad (160 % 16 == 0). A thread issues
//     its window loads in batches before their stores, so that enough bytes
//     are in flight while the block waits for its window;
//   * B comes from K slices of the (N, K) basis (64 samples for 1-pass, 32 for
//     3-pass, as deep as two stages fit beside the window), streamed in with
//     cp.async and double buffered behind one barrier per slice, each staged
//     row padded by 16 bytes so that the 8 rows of an ldmatrix hit distinct
//     bank quads. The host orders the columns per 8-bin group as [cos of the
//     8 bins | -sin of the same 8], so one ldmatrix.x4 gives both n8 tiles'
//     fragments, and the two accumulator tiles hold re and im of the same
//     (row, bin) in the same registers;
//   * the epilogue forms the power in registers, where the m16n8 accumulators
//     of two 8-bin groups are the m16k16 A fragment of the mel projection,
//     rounded or split to bf16 pairs; B is the (32 mels x bins) weight tile,
//     loaded into shared memory with the first K slice, or, where that leaves
//     the K slices shallower (3-pass at the full band, 254 live bins: 16 deep
//     against 32), after the K loop into the region the window and the basis
//     stages free (mel_late). Each warp's partial
//     mel tile (its 32 bins) goes to shared memory, and the block adds the
//     partials of its 4 bin warps in a fixed order, takes the log and writes
//     the (128, 32) dB tile with 16-byte stores.
// The 3-pass product sums each 16-sample K step's three passes into a fresh
// tile, lo*hi and hi*lo first, and adds that tile to the accumulators with
// FADD. The tensor cores' own fp32 sums round a step's terms against the
// largest of them: taken in place, against a running sum of up to 512 terms,
// they can part the result from the 3-pass function by nearly as much as the
// dropped lo*lo terms part that function from fp32, which would leave little
// room above chip_smoke.py's THREE_PASS_CLOSER (an in-place variant is not
// kept, so that margin is not measured). The 1-pass product, whose bf16
// rounding dwarfs that, accumulates in place.
// Any S >= 1: streams past the end of the last block read zeros and are not
// written.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mel_program.h"
#include "mma_bf16.cuh"
#include "smem.cuh"

namespace {

constexpr float kAmin = 1e-10f;
constexpr float kDbPerLn = 4.342944819032518f;        // 10 / ln(10)

constexpr int kBins = (kLiveBinsPad + kMmaBinTile - 1) / kMmaBinTile * kMmaBinTile;   // whole warp tiles
constexpr int kCols = 2 * kBins;                      // basis rows (N): [cos | -sin] per 8-bin group
constexpr int kGroups = kMmaBinTile / 8;              // a warp's 8-bin groups
constexpr int kBinWarps = kBins / kMmaBinTile;
constexpr int kMTiles = 4;                            // a warp's m16 tiles: 8 streams x 8 frames
// Row groups of 8 streams: two (16 streams a block) while the block stays at
// 8 warps or fewer, where __launch_bounds__ leaves a thread 255 registers for
// its 128 accumulators; one (8 streams) past 4 bin warps (more than 128 padded
// bins), where two would cap a thread below 255 registers (128 at 256 bins)
constexpr int kMaxWarps = 8;
constexpr int kRowGroups = 2 * kBinWarps <= kMaxWarps ? 2 : 1;
constexpr int kStreams = kRowGroups * 2 * kMTiles;    // 16 streams per block at the default range
constexpr int kRows = kStreams * kFrames;             // 128 GEMM rows per block
constexpr int kWarps = kRowGroups * kBinWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kSpan = (kFrames - 1) * kHop + kNfft;   // the window samples the frames read
constexpr int kPad = 8;                               // bf16 of padding after every kHop samples
constexpr int kStreamStride = (kSpan + kPad * ((kSpan - 1) / kHop) + 7) / 8 * 8;
constexpr int kPlane = kStreams * kStreamStride;      // one staged window plane (bf16)
constexpr int kMelStride = kBins + 8;                 // bf16 per staged mel-weight row
constexpr int kMelPlane = kMels * kMelStride;
constexpr int kPartStride = kMels + 8;                // floats per row of a partial mel tile
constexpr int kPartBytes = 4 * kBinWarps * kRows * kPartStride;
constexpr int kMaxSmem = 227 * 1024;

// Shared memory of a block with `planes` bf16 planes (2 for 3-pass) and basis
// K slices of `slice_k`: the window and two basis stages (rows padded by 8
// bf16) during the K loop, then the partial mel tiles in their place. The mel
// weights go after both regions, loaded with the first K slice ("early"), or
// after the partial tiles, loaded once the K loop has freed the window and the
// basis stages ("late").
constexpr int loop_bytes(int planes, int slice_k) {
    return 2 * planes * (kPlane + 2 * kCols * (slice_k + 8));
}
constexpr int max_bytes(int a, int b) {
    return a > b ? a : b;
}
constexpr int mel_offset(int planes, int slice_k, bool late) {
    return late ? kPartBytes : max_bytes(loop_bytes(planes, slice_k), kPartBytes);
}
constexpr int block_bytes(int planes, int slice_k, bool late) {
    return max_bytes(loop_bytes(planes, slice_k), mel_offset(planes, slice_k, late) + 2 * planes * kMelPlane);
}
constexpr bool fits(int planes, int slice_k, bool late) {
    return block_bytes(planes, slice_k, late) <= kMaxSmem;
}

// basis K per cp.async stage: the deepest of 64, 32 and 16 whose two stages
// fit beside the window with the mel weights loaded early or late; early where
// both fit at that depth. 64 early for 1-pass and 32 early for 3-pass at the
// default range; at the full band (254 live bins, 8 streams a block) 64 early
// for 1-pass and 32 late for 3-pass, where early fits only at 16
constexpr int slice_k(int planes) {
    return fits(planes, 64, false) || fits(planes, 64, true) ? 64
         : fits(planes, 32, false) || fits(planes, 32, true) ? 32 : 16;
}
constexpr bool mel_late(int planes) {
    return !fits(planes, slice_k(planes), false);
}

static_assert(kFrames == 8, "an 8x8 matrix of A is the 8 frames of one stream");
static_assert(kMmaBinTile == 32 && kMTiles == 4, "a warp: 4 m16 tiles x 4 groups of 8 bins");
static_assert(kMels % 16 == 0, "the mel projection takes 16 mels per ldmatrix");
static_assert(kHop % 16 == 0 && kNfft % 64 == 0, "a K step never straddles a pad; whole K slices");
static_assert((kHop + kPad) % 16 == 8 && kMelStride % 16 == 8, "the 8 rows of an ldmatrix start in distinct bank quads");
static_assert(kSpan % 2 == 0 && kHop % 2 == 0, "the window is staged in pairs");
static_assert(kLiveBins <= kBins && kLiveBin0 + kLiveBins <= kNfft / 2 + 1, "live bins inside the spectrum");
static_assert(kThreads <= 1024, "one block");

template <int ARITH>
struct Smem {
    static constexpr int kPlanes = ARITH == kThreePass ? 2 : 1;   // hi, and lo for 3-pass
    static constexpr int kSliceK = slice_k(kPlanes);
    static constexpr bool kMelLate = mel_late(kPlanes);
    static constexpr int kSlices = kNfft / kSliceK;
    static constexpr int kSliceStride = kSliceK + 8;              // bf16 per staged basis row
    static constexpr int kSlicePlane = kCols * kSliceStride;
    static constexpr int kStage = kPlanes * kSlicePlane;           // bf16 of one basis stage
    static constexpr int kMelOffset = mel_offset(kPlanes, kSliceK, kMelLate);
    static constexpr int kBytes = block_bytes(kPlanes, kSliceK, kMelLate);
    static_assert(kSliceStride % 16 == 8, "the 8 rows of an ldmatrix start in distinct bank quads");
    static_assert(kPlane % 8 == 0 && kSlicePlane % 8 == 0 && kMelPlane % 8 == 0 && kMelOffset % 16 == 0,
                  "16-byte aligned regions");
    static_assert(kBytes <= kMaxSmem, "the block's shared memory fits an SM");
};

// Starts the copy of K slice `slice` of each basis plane into `dst`
// ([plane][col][kSliceStride]), committed as one cp.async group with whatever
// this thread issued before.
template <int ARITH>
__device__ __forceinline__ void load_slice(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ basis, int slice) {
    using L = Smem<ARITH>;
    constexpr int kChunks = L::kSliceK / 8;             // 16-byte chunks per row
    for (int c = threadIdx.x; c < L::kPlanes * kCols * kChunks; c += kThreads) {
        const int row = c / kChunks;                    // plane * kCols + col
        const int chunk = c - row * kChunks;
        cp_async16(dst + row * L::kSliceStride + 8 * chunk,
                   basis + static_cast<size_t>(row) * kNfft + L::kSliceK * slice + 8 * chunk);
    }
    cp_async_commit();
}

// Starts the copy of the (planes, kMels, kBins) mel weights into `dst`
// ([plane][mel][kMelStride]); the caller commits it.
template <int ARITH>
__device__ __forceinline__ void load_mel(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ melw) {
    constexpr int kMelChunks = kBins / 8;               // 16-byte chunks per row
    for (int c = threadIdx.x; c < Smem<ARITH>::kPlanes * kMels * kMelChunks; c += kThreads) {
        const int row = c / kMelChunks;
        const int chunk = c - row * kMelChunks;
        cp_async16(dst + row * kMelStride + 8 * chunk, melw + row * kBins + 8 * chunk);
    }
}

template <int ARITH>
__global__ void __launch_bounds__(kThreads, 1)
melspec_frames_mma_kernel(const float* __restrict__ windows,          // (S, kWindow)
                          const __nv_bfloat16* __restrict__ basis,    // (planes, kCols, kNfft)
                          const __nv_bfloat16* __restrict__ melw,     // (planes, kMels, kBins)
                          float* __restrict__ out,                    // (S, kFrames, kMels)
                          int n_streams) {
    using L = Smem<ARITH>;
    constexpr bool kSplit = ARITH == kThreePass;
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem);     // [plane][stream][sample + pads]
    __nv_bfloat16* stage = win + L::kPlanes * kPlane;                  // [buffer][plane][col][k]
    __nv_bfloat16* mel_w = reinterpret_cast<__nv_bfloat16*>(smem + L::kMelOffset);   // [plane][mel][bin]
    float* part = reinterpret_cast<float*>(smem);                      // then: [bin warp][row][mel]
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int rg = warp / kBinWarps;                   // rows: streams 8 rg .. 8 rg + 7 of the block
    const int bw = warp - rg * kBinWarps;              // bins: kMmaBinTile bw .. of the padded range
    const int s0 = blockIdx.x * kStreams;
    const int n_valid = min(kStreams, n_streams - s0);

    // the mel weights (when early) and basis slice 0 arrive as the first cp.async group
    if constexpr (!L::kMelLate) {
        load_mel<ARITH>(mel_w, melw);
    }
    load_slice<ARITH>(stage, basis, 0);

    // Sample n of stream s sits at s * kStreamStride + n + kPad * (n / kHop).
    // A thread stages sample pairs tid + kThreads * u; it issues a batch's
    // loads before its stores, so that enough bytes are in flight to feed
    // the SM from HBM while the block waits for its window.
    constexpr int kPairs = kSpan / 2;
    constexpr int kPairsPerThread = (kStreams * kPairs + kThreads - 1) / kThreads;
    constexpr int kBatches = (kPairsPerThread + 15) / 16;
    constexpr int kBatch = (kPairsPerThread + kBatches - 1) / kBatches;      // at most 16 pairs in flight
    for (int u0 = 0; u0 < kPairsPerThread; u0 += kBatch) {
        float x[kBatch];
        float y[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = tid + kThreads * (u0 + u);
            const int s = i / kPairs;
            x[u] = 0.0f;
            y[u] = 0.0f;
            if (s < n_valid) {
                const float* src = windows + static_cast<size_t>(s0 + s) * kWindow + 2 * (i - s * kPairs);
                x[u] = src[0];
                y[u] = src[1];
            }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = tid + kThreads * (u0 + u);
            const int s = i / kPairs;
            const int n = 2 * (i - s * kPairs);
            if (s < kStreams) {
                unsigned hi;
                unsigned lo;
                pair_operand<ARITH>(hi, lo, x[u], y[u]);
                const int at = s * kStreamStride + n + kPad * (n / kHop);
                *reinterpret_cast<unsigned*>(win + at) = hi;
                if constexpr (kSplit) {
                    *reinterpret_cast<unsigned*>(win + kPlane + at) = lo;
                }
            }
        }
    }

    // ldmatrix row addresses: for A, lane l gives frame l % 8 of stream
    // (l / 8) % 2 of an m16 tile at K offset 8 (l / 16); for B, column l % 8 of
    // the cos (l < 16) or -sin half of a group at K offset 8 ((l / 8) % 2)
    const __nv_bfloat16* a_lane = win + (8 * rg + ((lane >> 3) & 1)) * kStreamStride + (kHop + kPad) * (lane & 7) +
                                  8 * (lane >> 4);
    const int b_lane = (2 * kMmaBinTile * bw + (lane & 7) + 8 * (lane >> 4)) * L::kSliceStride + 8 * ((lane >> 3) & 1);

    float acc[kMTiles][2 * kGroups][4];
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
        for (int j = 0; j < 2 * kGroups; ++j) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                acc[mi][j][q] = 0.0f;
            }
        }
    }
    for (int j = 0; j < L::kSlices; ++j) {
        cp_async_wait<0>();
        // slice j (and, first, the window) is in, and every warp is done with
        // slice j - 1, whose buffer now takes slice j + 1
        __syncthreads();
        if (j + 1 < L::kSlices) {
            load_slice<ARITH>(stage + ((j + 1) & 1) * L::kStage, basis, j + 1);
        }
        const __nv_bfloat16* b = stage + (j & 1) * L::kStage + b_lane;
#pragma unroll
        for (int kk = 0; kk < L::kSliceK / 16; ++kk) {
            const int k0 = L::kSliceK * j + 16 * kk;
            const __nv_bfloat16* a = a_lane + k0 + kPad * (k0 / kHop);
            unsigned a_hi[kMTiles][4];
            unsigned a_lo[kMTiles][4];
#pragma unroll
            for (int mi = 0; mi < kMTiles; ++mi) {
                ldmatrix_x4(a_hi[mi], a + 2 * mi * kStreamStride);
                if constexpr (kSplit) {
                    ldmatrix_x4(a_lo[mi], a + kPlane + 2 * mi * kStreamStride);
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
    __syncthreads();                                   // the window and the basis are read
    if constexpr (L::kMelLate) {
        load_mel<ARITH>(mel_w, melw);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
    }

    // The mel projection of the warp's 32 bins, one m16 tile at a time: the
    // accumulators of groups 2 kb and 2 kb + 1 (bins 16 kb ..) give the A
    // fragment (rows g and g + 8, bins 2 t, 2 t + 1 and 8 more), so the power
    // never leaves the registers. The partial mel tile goes where the window was.
    const __nv_bfloat16* w_lane = mel_w + ((lane & 7) + 8 * (lane >> 4)) * kMelStride + kMmaBinTile * bw +
                                  8 * ((lane >> 3) & 1);
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi) {
        float mel[kMels / 8][4];
#pragma unroll
        for (int nt = 0; nt < kMels / 8; ++nt) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                mel[nt][q] = 0.0f;
            }
        }
#pragma unroll
        for (int kb = 0; kb < kGroups / 2; ++kb) {
            float p[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const float re = acc[mi][4 * kb + 2 * (q / 4)][q % 4];
                const float im = acc[mi][4 * kb + 2 * (q / 4) + 1][q % 4];
                p[q] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
            }
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
                ldmatrix_x4(w_hi, w_lane + 16 * h * kMelStride + 16 * kb);
                if constexpr (kSplit) {
                    ldmatrix_x4(w_lo, w_lane + kMelPlane + 16 * h * kMelStride + 16 * kb);
                }
                product<ARITH>(mel[2 * h], p_hi, p_lo, w_hi, w_lo);
                product<ARITH>(mel[2 * h + 1], p_hi, p_lo, w_hi + 2, w_lo + 2);
            }
        }
        float* dst = part + (bw * kRows + 64 * rg + 16 * mi + g) * kPartStride + 2 * t;
#pragma unroll
        for (int nt = 0; nt < kMels / 8; ++nt) {
            *reinterpret_cast<float2*>(dst + 8 * nt) = make_float2(mel[nt][0], mel[nt][1]);
            *reinterpret_cast<float2*>(dst + 8 * kPartStride + 8 * nt) = make_float2(mel[nt][2], mel[nt][3]);
        }
    }
    __syncthreads();

    // Row r = 8 s + f of the block is out[s0 + s, f]: the block's valid rows are
    // one contiguous run of the output.
    float* dst = out + static_cast<size_t>(s0) * kFrames * kMels;
    for (int i = 4 * tid; i < n_valid * kFrames * kMels; i += 4 * kThreads) {
        const int r = i / kMels;
        const float* src = part + r * kPartStride + (i - r * kMels);
        float4 v = *reinterpret_cast<const float4*>(src);
#pragma unroll
        for (int w = 1; w < kBinWarps; ++w) {
            const float4 u = *reinterpret_cast<const float4*>(src + w * kRows * kPartStride);
            v.x += u.x;
            v.y += u.y;
            v.z += u.z;
            v.w += u.w;
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
    const cudaError_t err = allow_smem(melspec_frames_mma_kernel<ARITH>, Smem<ARITH>::kBytes, &allowed);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int grid = (n_streams + kStreams - 1) / kStreams;
    melspec_frames_mma_kernel<ARITH><<<grid, kThreads, Smem<ARITH>::kBytes, static_cast<cudaStream_t>(stream)>>>(
        windows, basis, melw, out, n_streams);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: launch on `stream` and return cudaGetLastError() (0 = the
// launch was accepted). `windows` and `out` are contiguous float32 device
// tensors; `basis` and `melw` the bf16 planes of ops/melspec_cuda.py::_device_consts,
// rounded (1-pass) or split into a hi plane and a lo plane (3-pass).
extern "C" int owwt_melspec_frames_1pass(const float* windows, const __nv_bfloat16* basis,
                                         const __nv_bfloat16* melw, float* out, int n_streams, void* stream) {
    return launch<kOnePass>(windows, basis, melw, out, n_streams, stream);
}

extern "C" int owwt_melspec_frames_3pass(const float* windows, const __nv_bfloat16* basis,
                                         const __nv_bfloat16* melw, float* out, int n_streams, void* stream) {
    return launch<kThreePass>(windows, basis, melw, out, n_streams, stream);
}
