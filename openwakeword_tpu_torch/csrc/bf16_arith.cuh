// The three arithmetics of the TPU kernels' bodies, as the port's kernels
// take them (one template argument, ops/bf16.py on the host): fp32
// (Precision.HIGHEST); 1-pass bf16 (None/DEFAULT: each operand rounded to
// bf16, round-to-nearest-even, the product exact in fp32, the sum fp32); and
// 3-pass bf16 (Precision.HIGH: each operand x split into bf16 halves, hi =
// bf16(x) and lo = bf16(x - hi), both round-to-nearest-even, the product
// x * w taken as hi*hi + hi*lo + lo*hi with fp32 sums, lo*lo dropped; see
// melspec_pallas.py::_bf16_split and cnn_pallas.py::_dot).
//
// The tensor-core kernels (mma_bf16.cuh) take 1-pass and 3-pass operands as
// bf16 pairs; the FFMA kernels (csrc/melspec.cu, cnn_step.cuh) are fp32 only.

#pragma once

#include <cuda_bf16.h>

namespace {

enum Arith { kFp32 = 0, kOnePass = 1, kThreePass = 2 };

}  // namespace
