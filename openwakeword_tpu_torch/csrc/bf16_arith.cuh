// The three arithmetics of the TPU kernels' bodies, as the port's kernels
// take them (one template argument, ops/bf16.py on the host): fp32
// (Precision.HIGHEST); 1-pass bf16 (None/DEFAULT: each operand rounded to
// bf16, round-to-nearest-even, the product exact in fp32, the sum fp32); and
// 3-pass bf16 (Precision.HIGH: each operand x split into bf16 halves, hi =
// bf16(x) and lo = bf16(x - hi), both round-to-nearest-even, the product
// x * w taken as hi*hi + hi*lo + lo*hi with fp32 sums, lo*lo dropped; see
// melspec_pallas.py::_bf16_split and cnn_pallas.py::_dot).
//
// A 3-pass operand travels as one 32-bit word, hi's bf16 bits above lo's
// (ops/bf16.py::pack_split on the host), carried in a float's bits, so it
// moves through the same loads, cp.async copies and shared memory as an fp32
// value; a mask (hi) and a shift (lo) unpack it. w_hi + w_lo is exact in
// fp32 (its bits span at most 24 places), so a 3-pass product takes two
// FFMAs, fma(x_hi, w_hi + w_lo, fma(x_lo, w_hi, acc)), whose exact products
// are the three terms; only the rounding of the sums differs from three
// separate passes.

#pragma once

#include <cuda_bf16.h>

namespace {

enum Arith { kFp32 = 0, kOnePass = 1, kThreePass = 2 };

// v as an operand of the variant: as it is, rounded to bf16, or split into
// its word.
template <int ARITH>
__device__ __forceinline__ float operand(float v) {
    if constexpr (ARITH == kOnePass) {
        return __bfloat162float(__float2bfloat16_rn(v));
    } else if constexpr (ARITH == kThreePass) {
        const __nv_bfloat16 hi = __float2bfloat16_rn(v);
        const __nv_bfloat16 lo = __float2bfloat16_rn(v - __bfloat162float(hi));
        return __uint_as_float((static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16) |
                               static_cast<unsigned>(__bfloat16_as_ushort(lo)));
    } else {
        return v;
    }
}

__device__ __forceinline__ float split_hi(float word) {
    return __uint_as_float(__float_as_uint(word) & 0xffff0000u);
}

__device__ __forceinline__ float split_lo(float word) {
    return __uint_as_float(__float_as_uint(word) << 16);
}

// acc + x * w for operands x (an activation) and w (a weight) of the variant.
template <int ARITH>
__device__ __forceinline__ float mac(float x, float w, float acc) {
    if constexpr (ARITH == kThreePass) {
        const float w_hi = split_hi(w);
        return fmaf(split_hi(x), w_hi + split_lo(w), fmaf(split_lo(x), w_hi, acc));
    } else {
        return fmaf(w, x, acc);
    }
}

}  // namespace
