// The backward of token-choice top-k routing for Hopper (sm_90a): the
// router's gradients in every MoE layer of a training step (granite-moe-1b-
// a400m, deepseek-moe-16b), dx and d_router, as one unit.
//
// Replaces no TPU kernel: the JAX package routes in XLA and differentiates
// that (repro/models/moe.py:209-218). It is the backward of the port of the
// router (csrc/moe_route.cu), which keeps the softmax p for it.
//
// From x (T, d) bf16, the router R (d, E) f32, the forward's probabilities
// p (T, E) f32, its picks ids (T, k) int32 and renormalised weights w (T,
// k) f32, the weights' gradient dw (T, k) f32 and, where dprobs is not
// null, the probabilities' own gradient (the aux loss's) dprobs (T, E) f32:
// (a) d_logits (T, E) f32, per token:
//   - the renormalisation's backward through max(s, 1e-9), s the sum of the
//     k picked probabilities: ds_j = (dw_j - [s > 1e-9] sum_i dw_i w_i) / den;
//   - those k gradients scattered into their experts' columns, added to
//     dprobs (the ids of a token are distinct: one add a column at most);
//   - the softmax's backward: dl = p * (dp - sum_e p_e dp_e);
// (b) the two products of the f32 einsum's backward, to f32 accuracy:
//   dx = d_logits R^T, rounded once to bf16, and d_router = x^T d_logits.
//
// What bounds it on this card: at granite's training shape (T 4096, d 1024,
// E 32) the products are 4 T d E = 0.54 GFLOP, 0.0080 ms on the f32 units
// (67 TFLOP/s); the bytes (x read and dx written in bf16, p, dprobs, the
// picks, R and d_router) ~18.5 MB, 0.0055 ms; at deepseek's (d 2048, E 64)
// 2.15 GFLOP, 0.032 ms, against ~37 MB, 0.011 ms. On the f32 units the
// operations bound it; on the tensor cores, with the f32 operands split
// into bf16 parts (three products each), the bytes do. In practice the
// latency of each block's chain of copies, products and sums does: the
// work a block gets is small (at granite 16 tiles of 128 tokens by 32
// columns, 2 an SM). The first design (d_logits, then two cuBLAS f32
// products, an f32 copy of all of x and a cast of an f32 dx: six launches,
// two transient (T, d) f32 tensors) takes 0.052 / 0.121 ms of device time
// at the two shapes.
//
// Design: two launches, the second a programmatic dependent of the first.
// - (a) moe_route_bwd_kernel: one warp a token; lane j < k holds pick j,
//   lane l holds experts l, l + 32, ... (NQ of them, a template parameter by
//   E). Each sum over the picks or the experts is a butterfly of shuffles,
//   which leaves the same value in every lane; the scatter is k shuffles of
//   (id, ds) from the pick's lane. It writes d_logits as three bf16 parts,
//   hi + mid + lo (~24 bits of each value), in rows of EP + 8 (EP: E
//   rounded up to 32, 64, 128 or 256; zero past E), 3 x 0.98 MB at granite,
//   which stay in L2; and d_logits itself in f32 only where asked (checks).
// - (b) moe_route_grads_kernel: a slice of S = 8 CG columns of d (32 at
//   granite, 64 at deepseek: 32 slices) has RANKS = 8 blocks, rank r taking
//   the token tiles r, r + 8, ... of TT = 4096 / EP tokens: 256 blocks, two
//   an SM, one wave. A tile comes into a two-stage ring: x[tile, slice] by
//   one 2-D TMA box (zeros past T and past d; rows of 16 CG bytes in the
//   swizzle of that width) and the three parts' rows by three bulk copies,
//   all completing on the stage's mbarrier, issued by lane 0 of warps 4-7
//   once the stage is free (cp.async for x, each thread its 16-byte
//   pieces, held every tile back by ~0.45 us). R's slice sits in shared
//   memory as bf16 hi + lo. R and the first tile's x come while (a) runs;
//   (b) waits for (a) (griddepcontrol.wait) only before it copies the
//   parts. Both products run on the tensor cores (mma.sync m16n8k16, bf16
//   in, f32 accumulators; operands by ldmatrix, rows padded or swizzled so
//   that its eight rows fall on distinct banks), under the f32 contract:
//   * dx = d_logits R^T: 16 tokens by 8 columns, K 16 experts; A the parts
//     hi and mid, B R's hi and lo: three products (hi hi, hi lo, mid hi),
//     rounded once to bf16 and staged through shared memory into 16-byte
//     stores; warp w one 16-token step and a group of column groups;
//   * d_router^T += d_logits^T x: 16 experts by 8 columns, K 16 tokens; A
//     the three parts (ldmatrix.trans), B x (exact in bf16), three
//     products; warp w the expert tiles w % M2 (+ M2), every column group,
//     and the 16-token steps of token group w / M2 (GW groups); the
//     accumulators stay in registers across the tiles.
//   At the end the GW groups' partials are added in group order through
//   shared memory into the block's partial in device memory; the slice's
//   last block to arrive (an integer counter, as ssd.cu's) adds the 8
//   ranks' partials in rank order and writes each element once. No atomics
//   on values, no f32 copy of x or dx: every sum has one fixed order, fixed
//   by (d, E) (the wrapper's kernels/moe_route.py::grads_plan), so two
//   calls give the same bits. Variants and a timeline of the designs tried
//   (tools/route_bwd_variants.py, tools/route_bwd_timeline.py): a block a
//   slice of 8 columns over every token on the f32 units read all of
//   d_logits in every block (64 MB of L2 reads at granite; 0.044 ms);
//   clusters of 4 splitting the tokens, f32 d_logits split in every block,
//   ran in two waves (0.048 ms); 4 ranks, one block an SM, 0.022 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <string.h>

#include "mma.cuh"
#include "tma.cuh"

#define WARPS 8        // tokens a block of (a)
#define MAX_E 256      // experts: 8 a lane
#define MAX_K 16       // picks: one a lane
#define THREADS 256    // a block of (b)
#define TILE_FLOATS 4096  // TT x EP: the d_logits a tile of (b) holds
#define RANKS 8        // blocks of (b) a slice: they take the tiles in turn

// E rounded up to 32, 64, 128 or 256 (the experts of a lane's stride in
// (a), the width of d_logits' parts); a part's row holds EP + 8 bf16 (the
// pad keeps ldmatrix's rows on distinct banks)
__host__ __device__ constexpr int padded_e(int E) {
    return E <= 32 ? 32 : E <= 64 ? 64 : E <= 128 ? 128 : 256;
}

template <int NQ>
__global__ void __launch_bounds__(WARPS * 32) moe_route_bwd_kernel(
    const float* __restrict__ probs, const int* __restrict__ ids,
    const float* __restrict__ weights, const float* __restrict__ dw,
    const float* __restrict__ dprobs, float* __restrict__ dlogits,
    __nv_bfloat16* __restrict__ parts, int T, int E, int k) {
    // (b) may start its launch now: it waits for this grid's end before it
    // reads d_logits' parts
    asm volatile("griddepcontrol.launch_dependents;");
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
    // d_logits as f32 where asked, and as its three bf16 parts (hi, mid, lo:
    // ~24 bits, the rest below 2^-24 of each value) in rows of PB, zero
    // past E
    constexpr int PB = 32 * NQ + 8;
    const size_t plane = (size_t)T * PB;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        const int ex = lane + 32 * q;
        const float v = ex < E ? p[q] * (dp[q] - dot) : 0.f;
        if (dlogits != nullptr && ex < E) dlogits[(size_t)t * E + ex] = v;
        const __nv_bfloat16 h = __float2bfloat16_rn(v);
        const float r = v - __bfloat162float(h);
        const __nv_bfloat16 m = __float2bfloat16_rn(r);
        __nv_bfloat16* out = parts + (size_t)t * PB + ex;
        out[0] = h;
        out[plane] = m;
        out[2 * plane] = __float2bfloat16_rn(r - __bfloat162float(m));
    }
    if (lane < 8) {
        const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
        __nv_bfloat16* out = parts + (size_t)t * PB + 32 * NQ + lane;
        out[0] = z;
        out[plane] = z;
        out[2 * plane] = z;
    }
}

// one contiguous run of global memory into shared memory, completing on
// `bar` (bytes and both addresses multiples of 16)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// (b): see the design note. Block (rank blockIdx.x, slice blockIdx.y) of
// CG column groups of 8; dx and drouter may each be null (that gradient is
// not wanted); part (slices x RANKS x S x E f32) and counters (slices,
// zero, left zero) serve d_router's sum over the ranks.
template <int EP>
__global__ void __launch_bounds__(THREADS, 2) moe_route_grads_kernel(
    const __grid_constant__ CUtensorMap xmap,  // x (T, d) bf16, S x TT boxes
    const float* __restrict__ router,
    const __nv_bfloat16* __restrict__ parts, __nv_bfloat16* __restrict__ dx,
    float* __restrict__ drouter, float* __restrict__ part,
    unsigned int* __restrict__ counters, int T, int d, int E, int CG) {
    constexpr int TT = TILE_FLOATS / EP;     // tokens a tile
    constexpr int PB = EP + 8;               // a row of d_logits' parts
    constexpr int RB = EP + 8;               // a row of R's parts (bf16)
    constexpr int MAXCG = EP == 256 ? 4 : 8; // column groups a block, at most
    constexpr int M2 = EP / 16 < 8 ? EP / 16 : 8;  // warps a token group
    constexpr int GW = 8 / M2;               // token groups of d_router
    constexpr int MPW = EP / 16 / M2;        // expert tiles a warp
    constexpr int MT = TT / 16;              // 16-token steps a tile
    constexpr int DS = 8 * 8 + 8;            // a staging row of dx (bf16)
    extern __shared__ unsigned char smem_raw[];
    __shared__ __align__(8) uint64_t full[2];
    __shared__ unsigned int last;
    const int rank = blockIdx.x;
    const int S = 8 * CG;
    const int c0 = blockIdx.y * S;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    // x's 2 stages first (TT x S each, as the TMA writes them: rows of 16 CG
    // bytes in the swizzle of that width, so 1024-byte aligned), then 2
    // stages of d_logits' three parts (TT x PB each), R's hi and lo (S x RB
    // each), the warps' staging rows of dx (16 x DS each)
    unsigned char* smem =
        smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* ring = xs + 2 * TT * S;
    __nv_bfloat16* rhi = ring + 2 * 3 * TT * PB;
    __nv_bfloat16* rlo = rhi + S * RB;
    // a warp's staging rows for dx: 16 rows of up to 64 columns
    __nv_bfloat16* stage = rlo + S * RB + warp * 16 * DS;
    const size_t plane = (size_t)T * PB;

    // a phase's arrivals: one for each part's copy, one for x's
    const int arrivals = 3 + (drouter != nullptr);
    if (tid == 0) {
        mbar_init(&full[0], arrivals);
        mbar_init(&full[1], arrivals);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // R's slice as bf16 hi + lo, zero past E and past d: every load of a
    // thread issued before the first is used (float4s where E allows)
    {
        // S RB = S (EP + 8) <= 8 x 1024 + 8 x 64 elements, 4 a float4
        constexpr int NV = (8 * 1024 + 8 * 64 + 4 * THREADS - 1)
                           / (4 * THREADS);
        const int n4 = S * RB / 4;
        float4 v[NV];
#pragma unroll
        for (int u = 0; u < NV; ++u) {
            const int i = 4 * (tid + u * THREADS);
            const int c = c0 + i / RB, e = i % RB;
            if (i >= 4 * n4 || c >= d) {
                v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
            } else if (E % 4 == 0) {
                v[u] = e < E ? __ldg(reinterpret_cast<const float4*>(
                                   router + (size_t)c * E + e))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
            } else {
                const float* r = router + (size_t)c * E;
                v[u] = make_float4(e < E ? r[e] : 0.f,
                                   e + 1 < E ? r[e + 1] : 0.f,
                                   e + 2 < E ? r[e + 2] : 0.f,
                                   e + 3 < E ? r[e + 3] : 0.f);
            }
        }
#pragma unroll
        for (int u = 0; u < NV; ++u) {
            const int i = 4 * (tid + u * THREADS);
            if (i >= 4 * n4) break;
            const float f[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const __nv_bfloat16 h = __float2bfloat16_rn(f[q]);
                rhi[i + q] = h;
                rlo[i + q] = __float2bfloat16_rn(f[q] - __bfloat162float(h));
            }
        }
    }

    // this rank's tiles: rank, rank + RANKS, ...; a tile's rows past T are
    // zero (x's by the TMA's fill, which also zeroes columns past d; the
    // parts' by stores: the bulk copy takes only the rows that exist); a
    // stage's copies are issued by lane 0 of warps 4 (x) and 5-7 (the parts)
    const int ntiles = (T + TT - 1) / TT;
    auto load_x = [&](int tile, int st) {
        if (drouter == nullptr || tid != 4 * 32) return;
        mbar_expect_tx(&full[st], TT * S * 2);
        tma_load_2d(xs + st * TT * S, &xmap, &full[st], c0, tile * TT);
    };
    auto load_parts = [&](int tile, int st) {
        const int rows = min(TT, T - tile * TT);
        __nv_bfloat16* dst = ring + st * 3 * TT * PB;
        for (int i = rows * PB + tid; i < TT * PB; i += THREADS) {
            dst[i] = __float2bfloat16_rn(0.f);
            dst[TT * PB + i] = __float2bfloat16_rn(0.f);
            dst[2 * TT * PB + i] = __float2bfloat16_rn(0.f);
        }
        if (lane == 0 && warp >= 5) {
            const int q = warp - 5;
            const uint32_t bytes = rows * PB * 2;
            mbar_expect_tx(&full[st], bytes);
            bulk_load(dst + q * TT * PB,
                      parts + q * plane + (size_t)tile * TT * PB, bytes,
                      &full[st]);
        }
    };
    __syncthreads();   // the barriers are initialised
    if (rank < ntiles) load_x(rank, 0);
    asm volatile("griddepcontrol.wait;" ::: "memory");
    if (rank < ntiles) load_parts(rank, 0);

    // d_router: warp w owns expert tiles w % M2 + M2 i (16 experts each)
    // and token group w / M2, over all of the block's column groups
    const int gw = warp / M2;
    float acc2[MPW][MAXCG][4];
#pragma unroll
    for (int m = 0; m < MPW; ++m)
#pragma unroll
        for (int j = 0; j < MAXCG; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc2[m][j][q] = 0.f;
    // dx: (16-token step, group of column groups) items, at least one a
    // warp where the block has the column groups for it
    const int NJ = min(CG, max(1, 8 / MT)), JPI = CG / NJ;
    // ldmatrix's row a lane: x4 over (rows 0-7, 8-15) x (columns 0-7, 8-15)
    const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
    const int tr = (lane & 7) + (lane >> 4) * 8, tc = ((lane >> 3) & 1) * 8;

    int it = 0;
    for (int tile = rank; tile < ntiles; tile += RANKS, ++it) {
        const int st = it & 1;
        mbar_wait(&full[st], (it >> 1) & 1);
        __syncthreads();
        // the next tile's copies into the other stage, freed at the end of
        // the last tile
        if (tile + RANKS < ntiles) {
            load_x(tile + RANKS, st ^ 1);
            load_parts(tile + RANKS, st ^ 1);
        }
        const __nv_bfloat16* hi = ring + st * 3 * TT * PB;
        const __nv_bfloat16* mid = hi + TT * PB;
        const __nv_bfloat16* lo = mid + TT * PB;
        const unsigned char* xt =
            reinterpret_cast<const unsigned char*>(xs + st * TT * S);

        // dx = dl R^T: 16 tokens by 8 columns an mma, K 16 experts; A the
        // parts hi and mid, B R's hi and lo: hi hi, hi lo, mid hi
        if (dx != nullptr) {
            for (int item = warp; item < MT * NJ; item += THREADS / 32) {
                const int mt = item % MT, j0 = item / MT * JPI;
                float acc1[MAXCG][4];
#pragma unroll
                for (int j = 0; j < MAXCG; ++j)
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc1[j][q] = 0.f;
                for (int ks = 0; ks < EP / 16; ++ks) {
                    uint32_t ah[4], am[4];
                    const int o = (16 * mt + lr) * PB + 16 * ks + lc;
                    ldsm_x4(ah, hi + o);
                    ldsm_x4(am, mid + o);
                    uint32_t b[MAXCG][4];
#pragma unroll
                    for (int jj = 0; jj < MAXCG; ++jj) {
                        if (jj >= JPI) break;
                        const int row = 8 * (j0 + jj) + (lane & 7);
                        const int col = 16 * ks + ((lane >> 3) & 1) * 8;
                        ldsm_x4(b[jj], (lane >> 4 ? rlo : rhi) + row * RB
                                       + col);
                    }
#pragma unroll
                    for (int jj = 0; jj < MAXCG; ++jj) {
                        if (jj >= JPI) break;
                        mma16816(acc1[jj], ah[0], ah[1], ah[2], ah[3],
                                 b[jj][0], b[jj][1]);
                    }
#pragma unroll
                    for (int jj = 0; jj < MAXCG; ++jj) {
                        if (jj >= JPI) break;
                        mma16816(acc1[jj], ah[0], ah[1], ah[2], ah[3],
                                 b[jj][2], b[jj][3]);
                    }
#pragma unroll
                    for (int jj = 0; jj < MAXCG; ++jj) {
                        if (jj >= JPI) break;
                        mma16816(acc1[jj], am[0], am[1], am[2], am[3],
                                 b[jj][0], b[jj][1]);
                    }
                }
                // the 16 x 8 JPI bf16 results through the warp's staging
                // rows, then 16 bytes a lane to dx
#pragma unroll
                for (int jj = 0; jj < MAXCG; ++jj) {
                    if (jj >= JPI) break;
                    uint32_t* o = reinterpret_cast<uint32_t*>(
                        stage + g * DS + 8 * jj + 2 * t4);
                    o[0] = pack_bf16(__floats2bfloat162_rn(acc1[jj][0],
                                                           acc1[jj][1]));
                    o[4 * DS] = pack_bf16(__floats2bfloat162_rn(acc1[jj][2],
                                                                acc1[jj][3]));
                }
                __syncwarp();
                for (int ci = lane; ci < 16 * JPI; ci += 32) {
                    const int r = ci / JPI, q = ci % JPI;
                    const int t = tile * TT + 16 * mt + r;
                    const int c = c0 + 8 * (j0 + q);
                    if (t < T && c < d)
                        *reinterpret_cast<uint4*>(dx + (size_t)t * d + c) =
                            *reinterpret_cast<const uint4*>(stage + r * DS
                                                            + 8 * q);
                }
                __syncwarp();
            }
        }
        // d_router^T += dl^T x: 16 experts by 8 columns an mma, K 16 tokens;
        // A the three parts (ldmatrix.trans of their rows), B x (exact in
        // bf16); token group gw takes the tile's steps gw, gw + GW, ...
        if (drouter != nullptr) {
            for (int ks = gw; ks < MT; ks += GW) {
                uint32_t bx[MAXCG][2];
#pragma unroll
                for (int j = 0; j < MAXCG; ++j) {
                    if (j >= CG) break;
                    // row 16 ks + (lane & 15), chunk j, in the swizzle
                    const uint32_t o = (16 * ks + (lane & 15)) * 16 * CG
                                       + 16 * j;
                    ldsm_x2_trans(bx[j],
                                  xt + (o ^ (((o >> 7) & (CG - 1)) << 4)));
                }
#pragma unroll
                for (int m = 0; m < MPW; ++m) {
                    const int o = (16 * ks + tr) * PB
                                  + 16 * (warp % M2 + M2 * m) + tc;
                    uint32_t a[3][4];
                    ldsm_x4_trans(a[0], hi + o);
                    ldsm_x4_trans(a[1], mid + o);
                    ldsm_x4_trans(a[2], lo + o);
#pragma unroll
                    for (int q = 0; q < 3; ++q)
#pragma unroll
                        for (int j = 0; j < MAXCG; ++j) {
                            if (j >= CG) break;
                            mma16816(acc2[m][j], a[q][0], a[q][1], a[q][2],
                                     a[q][3], bx[j][0], bx[j][1]);
                        }
                }
            }
        }
        __syncthreads();   // the stage is free for the tile after next
    }
    if (drouter == nullptr) return;

    // the GW token groups' partials, added in group order (the ring is
    // free now), to this block's partial in device memory; the slice's
    // last block to arrive adds the RANKS partials in rank order
    float* red = reinterpret_cast<float*>(smem);   // GW x S x EP
#pragma unroll
    for (int m = 0; m < MPW; ++m) {
        const int e = 16 * (warp % M2 + M2 * m) + g;
#pragma unroll
        for (int j = 0; j < MAXCG; ++j) {
            if (j >= CG) break;
            float* r = red + ((size_t)gw * S + 8 * j + 2 * t4) * EP + e;
            r[0] = acc2[m][j][0];
            r[EP] = acc2[m][j][1];
            r[8] = acc2[m][j][2];
            r[EP + 8] = acc2[m][j][3];
        }
    }
    __syncthreads();
    const int n = S * E;
    float* mine = part + ((size_t)blockIdx.y * RANKS + rank) * n;
    for (int i = tid; i < n; i += THREADS) {
        const int c = i / E, e = i % E;
        float v = red[c * EP + e];
        for (int q = 1; q < GW; ++q) v += red[(q * S + c) * EP + e];
        __stcg(mine + i, v);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0)
        last = atomicAdd(&counters[blockIdx.y], 1u) == RANKS - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // a thread's elements of every rank loaded before the first add
    const float* all = part + (size_t)blockIdx.y * RANKS * n;
    const int nd = min(n, (d - c0) * E);    // the slice's columns below d
    for (int i0 = 0; i0 < nd; i0 += 4 * THREADS) {
        float v[RANKS][4];
#pragma unroll
        for (int q = 0; q < RANKS; ++q)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int i = i0 + tid + u * THREADS;
                v[q][u] = i < nd ? __ldcg(all + q * n + i) : 0.f;
            }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int i = i0 + tid + u * THREADS;
            if (i >= nd) break;
            float sum = v[0][u];
#pragma unroll
            for (int q = 1; q < RANKS; ++q) sum += v[q][u];
            drouter[(size_t)c0 * E + i] = sum;
        }
    }
    if (tid == 0) counters[blockIdx.y] = 0u;
}

template <int EP>
static int launch_grads(const void* x, const void* router, const void* pts,
                        void* dx, void* drouter, void* part, void* counters,
                        int T, int d, int E, int CG, cudaStream_t stream) {
    constexpr int TT = TILE_FLOATS / EP;
    const int S = 8 * CG;
    const size_t smem = 1024   // room to align x's stages
                        + ((size_t)2 * TT * S + (size_t)2 * 3 * TT * (EP + 8)
                           + (size_t)2 * S * (EP + 8)
                           + (size_t)THREADS / 32 * 16 * 72)
                          * sizeof(__nv_bfloat16);
    // x's tensor map: boxes of S columns by TT rows, in the swizzle of S's
    // 16 CG bytes (none at 16); rows past T and columns past d read zero
    CUtensorMap xmap;
    memset(&xmap, 0, sizeof(xmap));
    if (drouter != nullptr) {
        const EncodeTiled enc = encoder();
        if (!enc) return (int)cudaErrorNotSupported;
        const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)T};
        const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
        const cuuint32_t box[2] = {(cuuint32_t)S, (cuuint32_t)TT};
        const cuuint32_t unit[2] = {1, 1};
        const CUtensorMapSwizzle sw =
            CG == 1 ? CU_TENSOR_MAP_SWIZZLE_NONE
            : CG == 2 ? CU_TENSOR_MAP_SWIZZLE_32B
            : CG == 4 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
        if (enc(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
            return (int)cudaErrorInvalidValue;
    }
    static bool attr_set = false;
    if (!attr_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            moe_route_grads_kernel<EP>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
        if (err != cudaSuccess) return (int)err;
        attr_set = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(RANKS, (d + S - 1) / S, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, moe_route_grads_kernel<EP>, xmap,
        (const float*)router, (const __nv_bfloat16*)pts, (__nv_bfloat16*)dx,
        (float*)drouter, (float*)part, (unsigned int*)counters, T, d, E, CG);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <int NQ>
static int launch_dlogits(const void* probs, const void* ids,
                          const void* weights, const void* dw,
                          const void* dprobs, void* dlogits, void* pts, int T,
                          int E, int k, cudaStream_t stream) {
    const dim3 grid((T + WARPS - 1) / WARPS);
    moe_route_bwd_kernel<NQ><<<grid, WARPS * 32, 0, stream>>>(
        (const float*)probs, (const int*)ids, (const float*)weights,
        (const float*)dw, (const float*)dprobs, (float*)dlogits,
        (__nv_bfloat16*)pts, T, E, k);
    return (int)cudaGetLastError();
}

// x (T, d) bf16 and router (d, E) f32 (either may be null when neither dx
// nor drouter is wanted), probs (T, E) f32, ids (T, k) int32 (distinct in a
// row, each below E), weights and dw (T, k) f32, dprobs (T, E) f32 or null,
// dlogits (T, E) f32 or null, parts (3, T, EP + 8) bf16 scratch (EP: E
// rounded up to 32, 64, 128 or 256), dx (T, d) bf16 or null, drouter (d, E)
// f32 or null, part (ceil(d / 8 CG) x RANKS x 8 CG x E) f32 scratch,
// counters (ceil(d / 8 CG)) zero, all contiguous, x, parts and dx 16-byte
// aligned; E at most MAX_E, k at most min(E, MAX_K), d a multiple of 8;
// CG the column groups of 8 a block of (b) (the wrapper's grads_plan): a
// power of two, at most 8 and 1024 / EP. Launches (a), then (b) unless dx
// and drouter are both null; returns the first cudaError_t that is not
// cudaSuccess.
extern "C" int moe_route_bwd(const void* x, const void* router,
                             const void* probs, const void* ids,
                             const void* weights, const void* dw,
                             const void* dprobs, void* dlogits, void* parts,
                             void* dx, void* drouter, void* part,
                             void* counters, int T, int d, int E, int k,
                             int CG, void* stream) {
    const int EP = padded_e(E);
    const bool grads = dx != nullptr || drouter != nullptr;
    if (T <= 0 || E < 1 || E > MAX_E || k < 1 || k > MAX_K || k > E
        || (grads && (d < 8 || d % 8 != 0 || CG < 1 || CG * EP > 1024
                      || CG > 8 || (CG & (CG - 1)) != 0)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    int err;
    if (EP == 32)
        err = launch_dlogits<1>(probs, ids, weights, dw, dprobs, dlogits,
                                parts, T, E, k, st);
    else if (EP == 64)
        err = launch_dlogits<2>(probs, ids, weights, dw, dprobs, dlogits,
                                parts, T, E, k, st);
    else if (EP == 128)
        err = launch_dlogits<4>(probs, ids, weights, dw, dprobs, dlogits,
                                parts, T, E, k, st);
    else
        err = launch_dlogits<8>(probs, ids, weights, dw, dprobs, dlogits,
                                parts, T, E, k, st);
    if (err != 0 || !grads) return err;
    if (EP == 32)
        return launch_grads<32>(x, router, parts, dx, drouter, part, counters,
                                T, d, E, CG, st);
    if (EP == 64)
        return launch_grads<64>(x, router, parts, dx, drouter, part, counters,
                                T, d, E, CG, st);
    if (EP == 128)
        return launch_grads<128>(x, router, parts, dx, drouter, part,
                                 counters, T, d, E, CG, st);
    return launch_grads<256>(x, router, parts, dx, drouter, part, counters, T,
                             d, E, CG, st);
}
