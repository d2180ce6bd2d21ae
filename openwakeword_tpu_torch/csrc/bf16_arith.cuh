// The three arithmetics of the TPU kernels' bodies, as the port's kernels
// take them (one template argument, ops/bf16.py on the host): fp32
// (Precision.HIGHEST); 1-pass bf16 (None/DEFAULT: each operand rounded to
// bf16, round-to-nearest-even, the product exact in fp32, the sum fp32); and
// 3-pass bf16 (Precision.HIGH: each operand x split into bf16 halves, hi =
// bf16(x) and lo = bf16(x - hi), both round-to-nearest-even, the product
// x * w taken as hi*hi + hi*lo + lo*hi with fp32 sums, lo*lo dropped; see
// melspec_pallas.py::_bf16_split and cnn_pallas.py::_dot).
//
// The FFMA kernels (cnn_step.cuh) take fp32 and 1-pass operands as floats
// (operand); the tensor-core kernels (mma_bf16.cuh) take 1-pass and
// 3-pass operands as bf16 pairs.

#pragma once

#include <cuda_bf16.h>

namespace {

enum Arith { kFp32 = 0, kOnePass = 1, kThreePass = 2 };

// v as an FFMA operand of the variant: as it is, or rounded to bf16.
template <int ARITH>
__device__ __forceinline__ float operand(float v) {
    static_assert(ARITH != kThreePass, "3-pass operands are bf16 pairs (mma_bf16.cuh)");
    if constexpr (ARITH == kOnePass) {
        return __bfloat162float(__float2bfloat16_rn(v));
    } else {
        return v;
    }
}

}  // namespace
