// Token-choice top-k routing for Hopper (sm_90a): the router of every MoE
// layer (granite-moe-1b-a400m, deepseek-moe-16b), on every path.
//
// Replaces no TPU kernel: the JAX package routes in XLA
// (repro/models/moe.py:209-213). It replaces the composite of a cuBLAS f32
// product, a softmax and a top-k on the card, because cuBLAS picks its
// kernel from the row count: a token's logits, and so near ties between
// experts, would change between an 8-row decode step and a 40-row verify,
// and greedy speculation would no longer equal plain decode.
//
// Computes, per token t of x (T, d) bf16 with router (d, E) f32: the f32
// logits l[e] = sum_i x[t, i] * router[i, e], p = softmax(l), the k most
// probable experts best first (a tie goes to the lower expert id, as
// lax.top_k breaks it), and their probabilities renormalised by
// max(sum, 1e-9). Writes weights (T, k) f32 and ids (T, k) int32.
//
// The contract: a token's outputs depend only on that token's row and the
// router, at any T. One block works on one token, and every order of
// summation is fixed by (d, E): thread g * E + e sums x[i] * router[i, e]
// over i = g, g + G, ... (G = THREADS / E groups) in i order, the G
// partials of an expert are added in g order, and one warp takes the
// softmax and the top-k over the E logits with a fixed shuffle tree.
//
// What bounds it on this card: bytes. The router is read once for all
// tokens (d E 4 bytes, 512 KB at deepseek's 2048 x 64) and x once; 2 T d E
// operations are far below the f32 rate. The simple form here reads the
// router once per token from L2 (a token's block streams it with 512
// threads, 256-byte runs a group), so at the decode step's 8 tokens it
// runs on 8 SMs: a later design would split d across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define THREADS 512             // a token's block
#define MAX_E 256               // experts: 8 a lane of the ranking warp
#define PER_LANE (MAX_E / 32)
#define MAX_K 16
#define MAX_D 8192              // x's row as f32 in shared memory: 32 KB

// (v, e) becomes (v2, e2) where that is the better expert: the higher
// probability, the lower id on a tie
__device__ __forceinline__ void better(float& v, int& e, float v2, int e2) {
    if (v2 > v || (v2 == v && e2 < e)) {
        v = v2;
        e = e2;
    }
}

__global__ void __launch_bounds__(THREADS) moe_route_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ router,
    float* __restrict__ weights, int* __restrict__ ids, int d, int E,
    int k) {
    extern __shared__ float xs[];        // the token's row, as f32
    __shared__ float part[THREADS];      // part[g * E + e]
    __shared__ float w_sel[MAX_K];
    __shared__ int id_sel[MAX_K];
    const int tok = blockIdx.x, t = threadIdx.x;
    const int G = THREADS / E;
    const __nv_bfloat16* xr = x + (size_t)tok * d;
    for (int i = t; i < d; i += THREADS) xs[i] = __bfloat162float(xr[i]);
    __syncthreads();
    if (t < G * E) {
        const int e = t % E, g = t / E;
        float acc = 0.f;
#pragma unroll 4
        for (int i = g; i < d; i += G)
            acc = fmaf(xs[i], router[(size_t)i * E + e], acc);
        part[t] = acc;
    }
    __syncthreads();
    if (t >= 32) return;

    // the ranking warp: lane t holds experts t, t + 32, ...
    float p[PER_LANE];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
        const int e = t + 32 * j;
        float l = -CUDART_INF_F;
        if (e < E) {
            l = part[e];
            for (int g = 1; g < G; ++g) l += part[g * E + e];
        }
        p[j] = l;
        m = fmaxf(m, l);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
        p[j] = t + 32 * j < E ? expf(p[j] - m) : 0.f;
        s += p[j];
    }
    // the butterfly leaves the same sum in every lane
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) p[j] = p[j] / s;

    // top-k: k rounds of a warp argmax over the experts not yet taken
    unsigned taken = 0;   // bit j: this lane's expert t + 32 j is taken
    for (int r = 0; r < k; ++r) {
        float v = -1.f;   // probabilities are >= 0: -1 loses to any
        int best = 1 << 30;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j)
            if (t + 32 * j < E && !((taken >> j) & 1u))
                better(v, best, p[j], t + 32 * j);
#pragma unroll
        for (int o = 16; o; o >>= 1) {
            const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
            const int e2 = __shfl_xor_sync(0xffffffffu, best, o);
            better(v, best, v2, e2);
        }
        if ((best & 31) == t) taken |= 1u << (best >> 5);
        if (t == 0) {
            w_sel[r] = v;
            id_sel[r] = best;
        }
    }
    if (t == 0) {
        float sum = 0.f;
        for (int r = 0; r < k; ++r) sum += w_sel[r];
        const float den = fmaxf(sum, 1e-9f);
        for (int r = 0; r < k; ++r) {
            weights[(size_t)tok * k + r] = w_sel[r] / den;
            ids[(size_t)tok * k + r] = id_sel[r];
        }
    }
}

// x (T, d) bf16, router (d, E) f32, weights (T, k) f32 and ids (T, k)
// int32, all contiguous; d at most MAX_D, E at most MAX_E, k at most
// min(E, MAX_K) (the wrapper checks). Returns cudaGetLastError() after the
// launch.
extern "C" int moe_route_fwd(const void* x, const void* router, void* weights,
                             void* ids, int T, int d, int E, int k,
                             void* stream) {
    if (T <= 0 || d <= 0 || d > MAX_D || E < 1 || E > MAX_E || k < 1
        || k > MAX_K || k > E)
        return (int)cudaErrorInvalidValue;
    moe_route_kernel<<<T, THREADS, d * sizeof(float), (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (const float*)router, (float*)weights,
        (int*)ids, d, E, k);
    return (int)cudaGetLastError();
}
