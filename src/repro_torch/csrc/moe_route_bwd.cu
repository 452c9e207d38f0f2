// The backward of token-choice top-k routing for Hopper (sm_90a): the
// router's gradient in every MoE layer of a training step (granite-moe-1b-
// a400m, deepseek-moe-16b).
//
// Replaces no TPU kernel: the JAX package routes in XLA and differentiates
// that (repro/models/moe.py:209-218). It is the backward of the port's
// router kernel (csrc/moe_route.cu), which keeps the softmax p for it.
//
// Computes, per token t, from the forward's probabilities p (T, E) f32, its
// picks ids (T, k) int32 and renormalised weights w (T, k) f32, the
// weights' gradient dw (T, k) f32 and, where dprobs is not null, the
// probabilities' own gradient (the aux loss's) dprobs (T, E) f32:
// - the renormalisation's backward through max(s, 1e-9), s the sum of the
//   k picked probabilities: ds_j = (dw_j - [s > 1e-9] sum_i dw_i w_i) / den;
// - those k gradients scattered into their experts' columns, added to
//   dprobs (the ids of a token are distinct: one add a column at most);
// - the softmax's backward: dl = p * (dp - sum_e p_e dp_e).
// Writes d_logits (T, E) f32. The products that take d_logits to x's and
// the router's gradients are the caller's (f32 matmuls, as XLA's einsum).
//
// What bounds it on this card: bytes (p, dprobs and d_logits, 12 T E
// bytes, and 12 T k for the picks: 1.6 MB at granite's T 4096, E 32, k 8),
// latency in practice: the bytes take ~0.5 us, an empty launch ~5 us.
//
// Design: one warp a token, as the forward's ranking stage; lane j < k
// holds pick j, lane l holds experts l, l + 32, ... (NQ of them, a template
// parameter by E). Each sum over the picks or the experts is a butterfly
// of shuffles, which leaves the same value in every lane; the scatter is k
// shuffles of (id, ds) from the pick's lane. No atomics, no shared memory:
// a token's d_logits depend on its own row alone, in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 8        // tokens a block
#define MAX_E 256      // experts: 8 a lane
#define MAX_K 16       // picks: one a lane

template <int NQ>
__global__ void __launch_bounds__(WARPS * 32) moe_route_bwd_kernel(
    const float* __restrict__ probs, const int* __restrict__ ids,
    const float* __restrict__ weights, const float* __restrict__ dw,
    const float* __restrict__ dprobs, float* __restrict__ dlogits, int T,
    int E, int k) {
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (t >= T) return;
    const float* p_row = probs + (size_t)t * E;

    // lane j < k: pick j's expert, probability, weight and gradient
    int id = 0;
    float top = 0.f, wj = 0.f, gj = 0.f;
    if (lane < k) {
        id = ids[(size_t)t * k + lane];
        top = p_row[id];
        wj = weights[(size_t)t * k + lane];
        gj = dw[(size_t)t * k + lane];
    }
    float s = top, c = gj * wj;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        c += __shfl_xor_sync(0xffffffffu, c, o);
    }
    const float den = fmaxf(s, 1e-9f);
    const float ds = (gj - (s > 1e-9f ? c : 0.f)) / den;

    float p[NQ], dp[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        const int ex = lane + 32 * q;
        p[q] = ex < E ? p_row[ex] : 0.f;
        dp[q] = dprobs != nullptr && ex < E ? dprobs[(size_t)t * E + ex] : 0.f;
    }
    for (int j = 0; j < k; ++j) {
        const int idj = __shfl_sync(0xffffffffu, id, j);
        const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int q = 0; q < NQ; ++q)
            if (lane + 32 * q == idj) dp[q] += dj;
    }
    float dot = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) dot = fmaf(p[q], dp[q], dot);
#pragma unroll
    for (int o = 16; o; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        const int ex = lane + 32 * q;
        if (ex < E) dlogits[(size_t)t * E + ex] = p[q] * (dp[q] - dot);
    }
}

template <int NQ>
static int launch(const void* probs, const void* ids, const void* weights,
                  const void* dw, const void* dprobs, void* dlogits, int T,
                  int E, int k, cudaStream_t stream) {
    const dim3 grid((T + WARPS - 1) / WARPS);
    moe_route_bwd_kernel<NQ><<<grid, WARPS * 32, 0, stream>>>(
        (const float*)probs, (const int*)ids, (const float*)weights,
        (const float*)dw, (const float*)dprobs, (float*)dlogits, T, E, k);
    return (int)cudaGetLastError();
}

// probs (T, E) f32, ids (T, k) int32 (distinct in a row, each below E),
// weights and dw (T, k) f32, dprobs (T, E) f32 or null, dlogits (T, E) f32,
// all contiguous; E at most MAX_E, k at most min(E, MAX_K). One launch;
// returns its cudaError_t.
extern "C" int moe_route_bwd(const void* probs, const void* ids,
                             const void* weights, const void* dw,
                             const void* dprobs, void* dlogits, int T, int E,
                             int k, void* stream) {
    if (T <= 0 || E < 1 || E > MAX_E || k < 1 || k > MAX_K || k > E)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (E <= 32)
        return launch<1>(probs, ids, weights, dw, dprobs, dlogits, T, E, k, st);
    if (E <= 64)
        return launch<2>(probs, ids, weights, dw, dprobs, dlogits, T, E, k, st);
    if (E <= 128)
        return launch<4>(probs, ids, weights, dw, dprobs, dlogits, T, E, k, st);
    return launch<8>(probs, ids, weights, dw, dprobs, dlogits, T, E, k, st);
}
