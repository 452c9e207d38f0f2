// Warp-level tensor-core and copy helpers shared by the kernels that tile
// with mma.sync (flash_decode.cuh, ssd.cu, gemm_rows.cu): shared-memory addresses,
// cp.async, the m16n8k16 bf16 product with f32 accumulation, ldmatrix,
// and the bf16 hi + lo split of an f32 operand.
//
// Fragment layouts of m16n8k16 (row.col), thread (g = lane / 4,
// t = lane % 4):
//   A (16 x 16, row-major): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//                           a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8):             b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]
//   C/D (16 x 8, f32):      d0, d1 = D[g][2t, 2t+1], d2, d3 = D[g+8][2t, 2t+1]
// So a D tile's registers, rounded to bf16 in pairs, are the A fragment of
// a following product over the same rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
// 16 bytes, or 16 zero bytes where !valid (src is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // wait until at most the newest N groups are in flight
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// the same for a count known only at run time (more than 7 waits for 7)
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
    switch (n) {
        case 0: cp_async_wait<0>(); break;
        case 1: cp_async_wait<1>(); break;
        case 2: cp_async_wait<2>(); break;
        case 3: cp_async_wait<3>(); break;
        case 4: cp_async_wait<4>(); break;
        case 5: cp_async_wait<5>(); break;
        case 6: cp_async_wait<6>(); break;
        default: cp_async_wait<7>(); break;
    }
}

// d += a * b on the tensor cores: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed, from the rows that lanes 8i..8i+7
// address (matrix i): thread (g, t) receives rows 2t, 2t+1 of column g
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
// two of them, from the rows that lanes 0..15 address
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
// four 8x8 bf16 matrices as they are: thread (g, t) receives row g,
// columns 2t, 2t+1 of each
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
    return *reinterpret_cast<uint32_t*>(&v);
}

// two f32 values as bf16 hi (rounded) and lo (the rounding of the rest):
// hi + lo carries ~16 bits of each value, relative error ~2^-17
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 f = __bfloat1622float2(h);
    hi = pack_bf16(h);
    lo = pack_bf16(__floats2bfloat162_rn(a - f.x, b - f.y));
}
