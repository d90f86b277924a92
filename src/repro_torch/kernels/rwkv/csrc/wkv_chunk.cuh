// The pieces of the chunked wkv form that the forward (wkv.cu) and the
// backward (wkv_bwd.cu) share: float32 from the stored dtypes, 16-byte
// cp.async copies into shared memory, and TF32 products with every
// float32 operand split in two TF32 parts (hi·hi + hi·lo + lo·hi: about
// 2^-22 of each product). Included, never compiled on its own; every
// definition has internal linkage, so each .cu keeps its own copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ float lo_bf16(uint32_t x) {
    return __uint_as_float(x << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t x) {
    return __uint_as_float(x & 0xffff0000u);
}

// 16 bytes from global to shared memory; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's latest cp.async groups are in
// flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x as TF32 hi + lo, each a float with the low 13 bits clear. Rounded to
// nearest, ties away from zero, as cvt.rna.tf32.f32 does for a finite x
// (which takes 4 instructions to the 2 here: the values are never
// infinite).
__device__ __forceinline__ float tf32(float x) {
    return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}
__device__ __forceinline__ float2 split(float x) {
    const float hi = tf32(x);
    return make_float2(hi, tf32(x - hi));
}

// d += a·b over one m16n8k8 TF32 tile, float32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    float b0, float b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
          "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

}  // namespace
