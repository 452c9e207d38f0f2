// Flash-decode attention for Hopper (sm_90a): one query token per lane
// against that lane's cached keys and values. Shared by the paged kernel
// (paged_decode_attention.cu: keys reached through a page table) and the
// dense one (decode_attention.cu: keys contiguous per lane); a Layout type
// says where key t of lane b lives, nothing else differs.
//
// What bounds it on this card: bytes. Each lane reads len_b keys and values
// of K*D bf16 once; the arithmetic is 4*G*D FLOP per key and kv head, far
// below the ~295 FLOP/byte the H100 needs before compute binds. The bound
// is sum_b len_b * K * D * 2 (K and V) * 2 bytes over 3.35 TB/s.
//
// Design:
// - Grid (B, K): one block per (lane, kv head). The block finds its own key
//   rows (no host-side gather) and holds the G = H/K query heads of its kv
//   head in shared memory, in f32, pre-scaled by 1/sqrt(D) as the TPU
//   kernels do.
// - Each of the block's 16 warps takes every 16th tile of 32 keys of the
//   lane (row stride K*D in the cache) and runs its own f32 online softmax
//   over its tiles. In a tile, each thread scores one key against all G
//   heads (its K row read as 16-byte vectors, q read from shared memory as
//   a broadcast), the warp reduces the tile's max and sum once per head,
//   and then the threads split D to accumulate the tile's
//   probability-weighted V rows, each row one coalesced load. Keys at or
//   past the lane's length (capped at the cache's capacity) are never read,
//   so stale bytes past it cannot reach the output.
// - The 16 partial states (m, l and a D-wide accumulator per query head)
//   are merged in shared memory, in warp order. Warp w always takes the
//   same tiles and the merge order is fixed, a lane's keys are never split
//   across blocks and nothing is reduced with atomics: a lane's result is
//   bitwise independent of B and of the other lanes, and two runs give the
//   same bits. A lane of length 0 writes zeros.
// - Known slowness: at 8 lanes x 8 kv heads the grid is 64 blocks on 132
//   SMs, and the longest lane sets the time; K and V loads are not
//   overlapped with the arithmetic of the tile before them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
#define WARPS 16
#define THREADS (WARPS * 32)
#define TILE 32    // keys per warp tile: one per thread
#define VBATCH 8   // V rows loaded together in the accumulation loop

template <int EPL>  // elements of D per thread when threads split D
struct Row {
    float v[EPL];
};

template <int EPL>
__device__ __forceinline__ Row<EPL> load_row(const __nv_bfloat16* p) {
    Row<EPL> r;
    if constexpr (EPL == 4) {
        const uint2 raw = *reinterpret_cast<const uint2*>(p);
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        r.v[0] = a.x; r.v[1] = a.y; r.v[2] = b.x; r.v[3] = b.y;
    } else {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
        r.v[0] = a.x; r.v[1] = a.y;
    }
    return r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// Layout: a trivially copyable kernel argument with
//   __device__ Lane lane(int b) const  -- the rows of lane b, where
//   __device__ size_t Lane::row(int t) const gives key t's row index in the
//   cache (element offset row * K * D), and
//   int cap  -- the most keys a lane can hold (lengths are clamped to it).
template <int EPL, int MAXG, class Layout>  // D = 32 * EPL; MAXG >= G = H / K
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(
    const __nv_bfloat16* __restrict__ q,        // (B, H, D)
    const __nv_bfloat16* __restrict__ k_cache,  // rows of (K, D)
    const __nv_bfloat16* __restrict__ v_cache,  // rows of (K, D)
    const int32_t* __restrict__ lengths,        // (B,)
    __nv_bfloat16* __restrict__ out,            // (B, H, D)
    Layout layout, int H, int K, float scale) {
    constexpr int D = 32 * EPL;
    const int b = blockIdx.x;
    const int kh = blockIdx.y;
    const int G = H / K;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;

    extern __shared__ __align__(16) float smem[];
    float* qs = smem;                                  // (MAXG, D)
    float* pw = qs + MAXG * D + warp * TILE * MAXG;    // this warp's (TILE, MAXG)
    float* sacc = qs + MAXG * D + WARPS * TILE * MAXG; // (WARPS, G, D)
    __shared__ float sm[WARPS][MAXG];
    __shared__ float sl[WARPS][MAXG];

    const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)kh * G) * D;
    for (int i = threadIdx.x; i < G * D; i += THREADS)
        qs[i] = __bfloat162float(qb[i]) * scale;
    __syncthreads();

    float m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
        m[g] = NEG_INF;
        l[g] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
    }

    const int len = max(0, min(lengths[b], layout.cap));
    const auto rows = layout.lane(b);
    const size_t row = (size_t)K * D;  // elements between two keys' rows
    const size_t head = (size_t)kh * D;
    for (int t0 = warp * TILE; t0 < len; t0 += WARPS * TILE) {
        // scores: this thread's key against every query head
        const int t = t0 + lane;
        const bool valid = t < len;
        float s[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
        if (valid) {
            const __nv_bfloat16* kr = k_cache + rows.row(t) * row + head;
#pragma unroll 4
            for (int c = 0; c < D; c += 8) {
                const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
                const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
                float kf[8];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float2 f = __bfloat1622float2(h2[i]);
                    kf[2 * i] = f.x;
                    kf[2 * i + 1] = f.y;
                }
#pragma unroll
                for (int g = 0; g < MAXG; ++g) {
                    if (g >= G) break;
                    const float4 qa = *reinterpret_cast<const float4*>(qs + g * D + c);
                    const float4 qc = *reinterpret_cast<const float4*>(qs + g * D + c + 4);
                    float a = s[g];
                    a = fmaf(qa.x, kf[0], a); a = fmaf(qa.y, kf[1], a);
                    a = fmaf(qa.z, kf[2], a); a = fmaf(qa.w, kf[3], a);
                    a = fmaf(qc.x, kf[4], a); a = fmaf(qc.y, kf[5], a);
                    a = fmaf(qc.z, kf[6], a); a = fmaf(qc.w, kf[7], a);
                    s[g] = a;
                }
            }
        }
        // online softmax over the tile, per head
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
            if (g >= G) break;
            const float sg = valid ? s[g] : NEG_INF;
            const float m_new = fmaxf(m[g], warp_max(sg));
            const float alpha = expf(m[g] - m_new);
            const float p = valid ? expf(sg - m_new) : 0.f;
            l[g] = l[g] * alpha + warp_sum(p);
            m[g] = m_new;
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
            pw[lane * MAXG + g] = p;
        }
        __syncwarp();
        // acc += sum over the tile's keys of p_j * V_j, threads split D
        const int n = min(TILE, len - t0);
        for (int j0 = 0; j0 < n; j0 += VBATCH) {
            Row<EPL> vr[VBATCH];
#pragma unroll
            for (int u = 0; u < VBATCH; ++u) {
                if (j0 + u < n)
                    vr[u] = load_row<EPL>(v_cache + rows.row(t0 + j0 + u) * row
                                          + head + lane * EPL);
            }
#pragma unroll
            for (int u = 0; u < VBATCH; ++u) {
                if (j0 + u >= n) break;
                const float* pj = pw + (j0 + u) * MAXG;
#pragma unroll
                for (int g = 0; g < MAXG; ++g) {
                    if (g >= G) break;
#pragma unroll
                    for (int e = 0; e < EPL; ++e)
                        acc[g][e] = fmaf(pj[g], vr[u].v[e], acc[g][e]);
                }
            }
        }
        __syncwarp();  // the next tile rewrites pw
    }

    // merge the warps' partial states in warp order
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        if (lane == 0) {
            sm[warp][g] = m[g];
            sl[warp][g] = l[g];
        }
#pragma unroll
        for (int e = 0; e < EPL; ++e)
            sacc[((size_t)warp * G + g) * D + lane * EPL + e] = acc[g][e];
    }
    __syncthreads();
    __nv_bfloat16* ob = out + ((size_t)b * H + (size_t)kh * G) * D;
    for (int i = threadIdx.x; i < G * D; i += THREADS) {
        const int g = i / D;
        float mx = NEG_INF;
        for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm[w][g]);
        float lt = 0.f, o = 0.f;
        for (int w = 0; w < WARPS; ++w) {
            const float c = expf(sm[w][g] - mx);
            lt = fmaf(sl[w][g], c, lt);
            o = fmaf(sacc[((size_t)w * G + g) * D + (i - g * D)], c, o);
        }
        ob[i] = __float2bfloat16(o / fmaxf(lt, 1e-30f));
    }
}

template <int EPL, int MAXG, class Layout>
static int launch_decode(const void* q, const void* k_cache,
                         const void* v_cache, const void* lengths, void* out,
                         Layout layout, int B, int H, int K, float scale,
                         cudaStream_t stream) {
    const size_t smem = (size_t)(MAXG * 32 * EPL + WARPS * TILE * MAXG
                                 + WARPS * (H / K) * 32 * EPL) * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            flash_decode_kernel<EPL, MAXG, Layout>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid(B, K);
    flash_decode_kernel<EPL, MAXG, Layout><<<grid, THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache,
        (const __nv_bfloat16*)v_cache, (const int32_t*)lengths,
        (__nv_bfloat16*)out, layout, H, K, scale);
    return (int)cudaGetLastError();
}

// D must be 64 or 128 and H/K at most 8 (the wrappers check both).
template <class Layout>
static int flash_decode(const void* q, const void* k_cache,
                        const void* v_cache, const void* lengths, void* out,
                        Layout layout, int B, int H, int K, int D,
                        float scale, cudaStream_t stream) {
    if (K <= 0 || H % K || H / K > 8) return (int)cudaErrorInvalidValue;
    const bool small_g = H / K <= 4;
    if (D == 128)
        return small_g
            ? launch_decode<4, 4>(q, k_cache, v_cache, lengths, out, layout,
                                  B, H, K, scale, stream)
            : launch_decode<4, 8>(q, k_cache, v_cache, lengths, out, layout,
                                  B, H, K, scale, stream);
    if (D == 64)
        return small_g
            ? launch_decode<2, 4>(q, k_cache, v_cache, lengths, out, layout,
                                  B, H, K, scale, stream)
            : launch_decode<2, 8>(q, k_cache, v_cache, lengths, out, layout,
                                  B, H, K, scale, stream);
    return (int)cudaErrorInvalidValue;
}
