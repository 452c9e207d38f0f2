// The last launch of the SSM backward kernels (selective_scan_bwd.cu,
// ssd_bwd.cu): the per-block f32 partials of dB, dC, dA and dD added in one
// fixed order, with no atomics, so the same partials give the same bits on
// every run. dB and dC are rounded to bf16, dA and dD stay f32.
//
// A Layout says where the terms of each output element lie: element i of
// n, split as (i / inner, i % inner), adds
//   p[(i / inner) * outer + i % inner + j * sj + k * sk]
// over j < J, and over k < K inside each j, into one f32 sum in that order.
// The long run of terms goes in k, whose loop is unrolled so that a
// thread has several loads in flight.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

struct Layout {
    size_t n, inner, outer, sj, sk;
    int J, K;
};

__device__ __forceinline__ size_t layout_base(const Layout& q, size_t i) {
    if (q.inner >= q.n) return i;
    if (q.n <= UINT32_MAX) {  // 32-bit division where the indices fit
        const uint32_t u = (uint32_t)i, in = (uint32_t)q.inner;
        return (size_t)(u / in) * q.outer + u % in;
    }
    return (i / q.inner) * q.outer + i % q.inner;
}

// element i of two sums of one layout (dB and dC), in one pass
__device__ __forceinline__ float2 layout_sum2(const Layout& q,
                                              const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              size_t i) {
    const size_t o = layout_base(q, i);
    float sa = 0.f, sb = 0.f;
    for (int j = 0; j < q.J; ++j) {
        const float* pa = a + o + j * q.sj;
        const float* pb = b + o + j * q.sj;
#pragma unroll 4
        for (int k = 0; k < q.K; ++k) {
            sa += pa[k * q.sk];
            sb += pb[k * q.sk];
        }
    }
    return make_float2(sa, sb);
}

__device__ __forceinline__ float layout_sum(const Layout& q,
                                            const float* __restrict__ p,
                                            size_t i) {
    const float* t = p + layout_base(q, i);
    float s = 0.f;
    for (int j = 0; j < q.J; ++j)
#pragma unroll 4
        for (int k = 0; k < q.K; ++k) s += t[j * q.sj + k * q.sk];
    return s;
}

// dB, dC (bc.n elements each, bf16, from pB, pC), then dA (a.n, f32, from
// pA), then dD (d.n, f32, from pD)
__global__ void fixed_sum_kernel(Layout bc, Layout a, Layout d,
                                 const float* __restrict__ pB,
                                 const float* __restrict__ pC,
                                 const float* __restrict__ pA,
                                 const float* __restrict__ pD,
                                 __nv_bfloat16* __restrict__ dB,
                                 __nv_bfloat16* __restrict__ dC,
                                 float* __restrict__ dA,
                                 float* __restrict__ dD) {
    const size_t total = bc.n + a.n + d.n;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += (size_t)gridDim.x * blockDim.x) {
        if (i < bc.n) {
            const float2 s = layout_sum2(bc, pB, pC, i);
            dB[i] = __float2bfloat16(s.x);
            dC[i] = __float2bfloat16(s.y);
        } else if (i < bc.n + a.n) {
            dA[i - bc.n] = layout_sum(a, pA, i - bc.n);
        } else {
            dD[i - bc.n - a.n] = layout_sum(d, pD, i - bc.n - a.n);
        }
    }
}

// One launch of fixed_sum_kernel on `st`: 264 blocks of 256 threads (two
// an SM of the H100's 132) striding over the elements
static inline void launch_fixed_sum(const Layout& bc, const Layout& a,
                                    const Layout& d, const void* pB,
                                    const void* pC, const void* pA,
                                    const void* pD, void* dB, void* dC,
                                    void* dA, void* dD, cudaStream_t st) {
    fixed_sum_kernel<<<264, 256, 0, st>>>(
        bc, a, d, (const float*)pB, (const float*)pC, (const float*)pA,
        (const float*)pD, (__nv_bfloat16*)dB, (__nv_bfloat16*)dC,
        (float*)dA, (float*)dD);
}
