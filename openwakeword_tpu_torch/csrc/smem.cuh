// Shared-memory helpers of the port's kernels (csrc/melspec.cu,
// csrc/melspec_mma.cu, csrc/melspec_factored_mma.cu and csrc/cnn_step.cuh):
// cp.async copies from global into shared memory and their groups, and the
// opt-in to more than 48 KB of dynamic shared memory.

#pragma once

#include <atomic>
#include <cstddef>

#include <cuda_runtime.h>

namespace {

// A shared-memory pointer as the 32-bit address that PTX takes.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, cached in L2 only (cp.async.cg).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// cp.async with zero-fill, cached in L1 and L2 (cp.async.ca): `src_bytes` of
// `src` land in shared memory, the rest of the 16 or 4 bytes are zeros
// (src_bytes = 0 reads nothing).
__device__ __forceinline__ void cp_async16_fill(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async4_fill(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A kernel above 48 KB of dynamic shared memory must opt in, once per device
// and instantiation: a costly runtime call, so it is made on the first launch
// on each device only. `allowed` is the caller's own (one per kernel), bit d
// set once device d is done.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, std::atomic<unsigned long long>* allowed) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) {
        return err;
    }
    const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
    if (bit != 0 && (allowed->load(std::memory_order_acquire) & bit) != 0) {
        return cudaSuccess;
    }
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err == cudaSuccess) {
        allowed->fetch_or(bit, std::memory_order_acq_rel);
    }
    return err;
}

}  // namespace
