// Warp-level tensor-core helpers of the bf16 variants on the tensor cores
// (csrc/melspec_mma.cu, K1-1pass / K1-3pass; csrc/melspec_factored_mma.cu,
// K2-1pass / K2-3pass; csrc/cnn_step_mma.cuh, K3-high / K4-high): ldmatrix,
// one mma.sync.m16n8k16 bf16 tile with fp32 sums, an fp32 pair as the
// variant's bf16 operand, and a product in the variant's arithmetic
// (bf16_arith.cuh).

#pragma once

#include <cuda_bf16.h>

#include "bf16_arith.cuh"
#include "smem.cuh"

namespace {

// Four 8x8 bf16 matrices, row i of matrix m at the address lane 8m + i passes.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
}

// The same, each matrix transposed: lane l receives elements (2 (l % 4), l / 4)
// and (2 (l % 4) + 1, l / 4) of the rows that lanes 8m .. 8m + 7 address.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const __nv_bfloat16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
}

// Two 8x8 bf16 matrices, row i of matrix m at the address lane 8m + i passes
// (lanes 16-31 pass addresses that are not read).
__device__ __forceinline__ void ldmatrix_x2(unsigned* r, const __nv_bfloat16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p))
                 : "memory");
}

// d = a b + c for one m16n8k16 tile: A row-major and B column-major bf16, fp32 C and D.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], const unsigned* b,
                                         const float (&c)[4]) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
                 : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]), "f"(c[1]),
                   "f"(c[2]), "f"(c[3]));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
    return *reinterpret_cast<const unsigned*>(&v);
}

// (x, y) as the variant's bf16 pair operand, x in the low half: rounded (hi), and
// for 3-pass the residual bf16(x - hi) (lo).
template <int ARITH>
__device__ __forceinline__ void pair_operand(unsigned& hi, unsigned& lo, float x, float y) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    hi = bits(h);
    if constexpr (ARITH == kThreePass) {
        const float2 f = __bfloat1622float2(h);
        lo = bits(__floats2bfloat162_rn(x - f.x, y - f.y));
    }
}

// acc += a b in the variant's arithmetic: one pass on rounded operands, summed in
// the accumulators; or the passes lo*hi, hi*lo, hi*hi of split operands, summed
// into a fresh tile that FADD adds to the accumulators.
template <int ARITH>
__device__ __forceinline__ void product(float (&acc)[4], const unsigned (&a_hi)[4], const unsigned (&a_lo)[4],
                                        const unsigned* b_hi, const unsigned* b_lo) {
    if constexpr (ARITH == kThreePass) {
        const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float t[4];
        mma_bf16(t, a_lo, b_hi, zero);
        mma_bf16(t, a_hi, b_lo, t);
        mma_bf16(t, a_hi, b_hi, t);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            acc[q] += t[q];
        }
    } else {
        mma_bf16(acc, a_hi, b_hi, acc);
    }
}

}  // namespace
