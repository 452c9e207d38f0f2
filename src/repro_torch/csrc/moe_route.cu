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
// max(sum, 1e-9). Writes weights (T, k) f32 and ids (T, k) int32, and,
// where probs is not null (training: the router's backward and its aux loss
// read them), the softmax p (T, E) f32 as the ranking warp holds it; a
// null probs (serving) stores nothing more, so weights and ids keep their
// bits either way.
//
// What bounds it on this card: bytes in principle (the router's d E 4
// bytes, 512 KB at deepseek's 2048 x 64, and x once; 2 T d E operations
// are far below the f32 rate), latency in practice: at a decode step's 8
// tokens the bytes take 0.2 us, an empty launch ~5 us. The design keeps the
// chain after the launch short.
//
// Design: a token tile is split over the d axis across the C blocks of a
// thread block cluster (C <= 8, a portable cluster), one launch a call.
// - Block r of a cluster owns rows [r S, r S + S) of the router (its
//   slice; the last may be shorter). Thread j E + e of its THREADS owns
//   expert e over run j of the slice: rows [j L, j L + L) (the last runs
//   may be shorter or empty). It keeps U router rows in flight in
//   registers (the first U issued before x is staged) and folds x[t, i]
//   * router[i, e] for the tile's TT tokens in i order with fmaf, x read
//   as f32 from shared memory (broadcast, four tokens a load).
// - The J run partials of (t, e) are added in run order into the block's
//   partial logit, which is stored through distributed shared memory into
//   the block that ranks token t (block t % C, a slot for each rank); after
//   one cluster barrier, that block's warp t / C adds the C partials of
//   each expert in rank order from its own shared memory, takes the
//   softmax with a fixed shuffle tree and the top-k by k warp argmaxes
//   (redux.sync over the probabilities' bits, then over the ids). That
//   warp runs alone on its SM by then, so its instruction count is its
//   time: a lane holds NQ = ceil(E / 32) experts, a template parameter.
// - C, S, J and L come from kernels/moe_route.py::plan(d, E), never from
//   T; the tile TT (8 or 16 tokens, by T) changes which tokens share a
//   block, never a token's arithmetic. So a token's outputs depend only on
//   its row and the router, at any T (the contract the kernel exists for).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define THREADS 512             // a block: J E of them work
#define MAX_E 256               // experts: 8 a lane of the ranking warp
#define MAX_K 16
#define MAX_D 8192
#define MAX_C 8                 // blocks of a cluster (portable)
#define U 16                    // router rows a thread has in flight
#define MAX_S (MAX_D / MAX_C)   // rows of a slice
// x's tile [S][16] + the runs' partials [J E <= THREADS][16] + the
// gathered partials [C][ceil(16 / C)][E] <= [16 + MAX_C][E], f32
#define MAX_SMEM ((MAX_S * 16 + THREADS * 16 + (16 + MAX_C) * MAX_E) * 4)

// router rows [i0, i0 + U) of column e, those below i_hi (row i of the
// slice is rows[i * E])
__device__ __forceinline__ void load_rows(float* r, const float* rows, int i0,
                                          int i_hi, int E) {
#pragma unroll
    for (int u = 0; u < U; ++u)
        r[u] = i0 + u < i_hi ? __ldg(rows + (size_t)(i0 + u) * E) : 0.f;
}

template <int TT, int NQ>
__global__ void __launch_bounds__(THREADS, 2) moe_route_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ router,
    float* __restrict__ weights, int* __restrict__ ids,
    float* __restrict__ probs, int T, int d, int E, int k, int S, int J,
    int L) {
    extern __shared__ __align__(16) float sm[];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int TPB = (TT + C - 1) / C;  // tokens a block ranks: rank, rank + C..
    const int tid = threadIdx.x;
    const int t0 = blockIdx.y * TT;
    const int s0 = rank * S;
    const int sl = min(S, d - s0);     // this block's slice
    float* xs = sm;                    // [S][TT]: x's tile as f32
    float* part = xs + S * TT;         // [J][TT][E]: the runs' partials
    float* gat = part + J * TT * E;    // [C][TPB][E]: the blocks' partials

    const int j = tid / E, e = tid - j * E;
    const bool worker = j < J;
    const int i_lo = j * L, i_hi = min(i_lo + L, sl);
    const float* rows = router + (size_t)s0 * E + e;

    float r[U];
    if (worker) load_rows(r, rows, i_lo, i_hi, E);

    // x's tile, columns of the slice, transposed: xs[i][t] (thread q takes
    // t = q % TT, i = q / TT: its store is word q of the tile)
    for (int q = tid; q < TT * S; q += THREADS) {
        const int t = q % TT, i = q / TT;
        float v = 0.f;
        if (t0 + t < T && i < sl)
            v = __bfloat162float(x[(size_t)(t0 + t) * d + s0 + i]);
        xs[q] = v;
    }
    __syncthreads();

    float acc[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = 0.f;
    if (worker) {
        for (int i0 = i_lo; i0 < i_hi; i0 += U) {
            if (i0 != i_lo) load_rows(r, rows, i0, i_hi, E);
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (i0 + u < i_hi) {
                    const float4* xv =
                        reinterpret_cast<const float4*>(xs + (i0 + u) * TT);
#pragma unroll
                    for (int q = 0; q < TT / 4; ++q) {
                        const float4 a = xv[q];
                        acc[4 * q] = fmaf(a.x, r[u], acc[4 * q]);
                        acc[4 * q + 1] = fmaf(a.y, r[u], acc[4 * q + 1]);
                        acc[4 * q + 2] = fmaf(a.z, r[u], acc[4 * q + 2]);
                        acc[4 * q + 3] = fmaf(a.w, r[u], acc[4 * q + 3]);
                    }
                }
            }
        }
#pragma unroll
        for (int t = 0; t < TT; ++t) part[(j * TT + t) * E + e] = acc[t];
    }
    __syncthreads();
    // the runs' partials in run order, stored into the shared memory of
    // the block that ranks token t (block t % C, its slot for this rank)
    for (int idx = tid; idx < TT * E; idx += THREADS) {
        const int t = idx / E, e2 = idx - t * E;
        float v = part[t * E + e2];
#pragma unroll 8
        for (int jj = 1; jj < J; ++jj) v += part[(jj * TT + t) * E + e2];
        cluster.map_shared_rank(gat, t % C)[(rank * TPB + t / C) * E + e2] = v;
    }
    cluster.sync();   // every block's partials arrived where they are ranked

    // the ranking warp of token t = rank + C w: lane l holds experts l,
    // l + 32, ... (NQ of them); the C blocks' partials added in rank order
    const int lane = tid & 31, w = tid >> 5;
    const int t = rank + C * w;
    if (w >= TPB || t >= TT || t0 + t >= T) return;
    float p[NQ];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        const int ex = lane + 32 * q;
        p[q] = -CUDART_INF_F;
        if (ex < E) {
            float pr[MAX_C];
#pragma unroll
            for (int rr = 0; rr < MAX_C; ++rr)
                if (rr < C) pr[rr] = gat[(rr * TPB + w) * E + ex];
            float l = pr[0];
#pragma unroll
            for (int rr = 1; rr < MAX_C; ++rr)
                if (rr < C) l += pr[rr];
            p[q] = l;
            m = fmaxf(m, l);
        }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        p[q] = lane + 32 * q < E ? expf(p[q] - m) : 0.f;
        s += p[q];
    }
    // the butterfly leaves the same sum in every lane
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
#pragma unroll
    for (int q = 0; q < NQ; ++q) p[q] = p[q] / s;
    if (probs) {
#pragma unroll
        for (int q = 0; q < NQ; ++q)
            if (lane + 32 * q < E)
                probs[(size_t)(t0 + t) * E + lane + 32 * q] = p[q];
    }

    // top-k: k rounds of a warp argmax over the experts not yet taken (the
    // highest probability, the lowest id on a tie). Probabilities are >= 0,
    // so their bits order as unsigned integers: the warp's largest by
    // redux.sync, then the lowest id among the lanes that hold it.
    unsigned taken = 0;   // bit q: this lane's expert lane + 32 q is taken
    float sum = 0.f;      // the picks' sum in round order, in every lane
    float mine_w = 0.f;   // lane rd keeps round rd's pick
    int mine_id = 0;
    for (int rd = 0; rd < k; ++rd) {
        unsigned key = 0, id = 0xffffffffu;   // no expert left: loses
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            const unsigned bits = __float_as_uint(p[q]);
            if (lane + 32 * q < E && !((taken >> q) & 1u)
                && (id == 0xffffffffu || bits > key)) {
                key = bits;
                id = lane + 32 * q;
            }
        }
        const unsigned top = __reduce_max_sync(0xffffffffu, key);
        const unsigned best =
            __reduce_min_sync(0xffffffffu, key == top ? id : 0xffffffffu);
        if ((best & 31) == (unsigned)lane) taken |= 1u << (best >> 5);
        const float v = __uint_as_float(top);
        sum += v;
        if (lane == rd) {
            mine_w = v;
            mine_id = (int)best;
        }
    }
    const float den = fmaxf(sum, 1e-9f);
    if (lane < k) {
        weights[(size_t)(t0 + t) * k + lane] = mine_w / den;
        ids[(size_t)(t0 + t) * k + lane] = mine_id;
    }
}

template <int TT, int NQ>
static int launch(const void* x, const void* router, void* weights, void* ids,
                  void* probs, int T, int d, int E, int k, int C, int S,
                  int J, int L, cudaStream_t stream) {
    static bool attr_set = false;   // once per instance: it costs host time
    if (!attr_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            moe_route_kernel<TT, NQ>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
        if (err != cudaSuccess) return (int)err;
        attr_set = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, (T + TT - 1) / TT, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    const int tpb = (TT + C - 1) / C;
    cfg.dynamicSmemBytes =
        ((size_t)S * TT + (size_t)J * TT * E + (size_t)C * tpb * E)
        * sizeof(float);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, moe_route_kernel<TT, NQ>, (const __nv_bfloat16*)x,
        (const float*)router, (float*)weights, (int*)ids, (float*)probs, T, d,
        E, k, S, J, L);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// the ranking warp's experts a lane (NQ) by E, then the token tile by T
template <int TT>
static int launch_nq(const void* x, const void* router, void* weights,
                     void* ids, void* probs, int T, int d, int E, int k,
                     int C, int S, int J, int L, cudaStream_t st) {
    if (E <= 32)
        return launch<TT, 1>(x, router, weights, ids, probs, T, d, E, k, C, S,
                             J, L, st);
    if (E <= 64)
        return launch<TT, 2>(x, router, weights, ids, probs, T, d, E, k, C, S,
                             J, L, st);
    if (E <= 128)
        return launch<TT, 4>(x, router, weights, ids, probs, T, d, E, k, C, S,
                             J, L, st);
    return launch<TT, 8>(x, router, weights, ids, probs, T, d, E, k, C, S, J,
                         L, st);
}

// x (T, d) bf16, router (d, E) f32, weights (T, k) f32 and ids (T, k)
// int32, probs (T, E) f32 or null, all contiguous; d at most MAX_D, E at
// most MAX_E, k at most min(E, MAX_K); (C, S, J, L) the plan of (d, E) (the wrapper's
// kernels/moe_route.py::plan): C blocks a cluster, slices of S rows, J
// runs of L rows a slice. One launch; returns its cudaError_t.
extern "C" int moe_route_fwd(const void* x, const void* router, void* weights,
                             void* ids, void* probs, int T, int d, int E,
                             int k, int C, int S, int J, int L,
                             void* stream) {
    if (T <= 0 || d <= 0 || d > MAX_D || E < 1 || E > MAX_E || k < 1
        || k > MAX_K || k > E || C < 1 || C > MAX_C || S < 1
        || S > MAX_S || (long)C * S < d || (long)(C - 1) * S >= d
        || J < 1 || J * E > THREADS || L < 1 || (long)J * L < S)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (T <= 64)
        return launch_nq<8>(x, router, weights, ids, probs, T, d, E, k, C, S,
                            J, L, st);
    return launch_nq<16>(x, router, weights, ids, probs, T, d, E, k, C, S, J,
                         L, st);
}
