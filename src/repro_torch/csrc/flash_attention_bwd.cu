// The backward of causal (or non-causal) GQA flash attention for Hopper
// (sm_90a): the gradient of the training loss's attention.
//
// Replaces: nothing on the TPU. repro/kernels/flash_attention.py
// (flash_attention) has no backward kernel; the JAX package differentiates
// the XLA form of the op (repro/kernels/ops.py:100-118) for training. The
// port's forward is a hand-written kernel (flash_attention.cu), which
// autograd cannot see into, so the backward is one too.
//
// Computes, from q (B, Sq, H, D), k, v (B, Sk, K, D), the forward's output
// o and its gradient dO (B, Sq, H, D), all bf16, and the forward's lse
// (B, H, Sq) f32 (the log-sum-exp of each query row's scaled scores):
//   delta_i = sum_d dO_i * O_i                       (f32)
//   P_ij    = exp(S_ij * scale - lse_i)              (recomputed, f32)
//   dV_j    = sum_i P_ij dO_i
//   dS_ij   = P_ij (dO_i . V_j - delta_i)
//   dK_j    = scale * sum_i dS_ij Q_i,  dQ_i = scale * sum_j dS_ij K_j
// with kv head h / (H/K): a kv head's dK and dV sum over its H/K query
// heads. Masked pairs (key past Sk, query past Sq, key above the causal
// diagonal at q_offset) have P = 0.
//
// What bounds it on this card: operations. The function needs five
// products of D-deep dot products per attended (query, key) pair (S, dP,
// dV, dK, dQ), 2 * D FLOP each, against one read of q, k, v, o, dO and one
// write of dq, dk, dv: well above the H100's ~295 FLOP a byte at S 2048.
// The bound is 10 * D * H * B * (attended pairs) FLOP over 989 TFLOP/s
// (bf16 tensor cores). This kernel does 14 * D a pair, since it computes S
// and dP twice (once for dK/dV, once for dQ); that is part of its gap to
// the bound.
//
// Design (FlashAttention-2's backward, simple first: mma.sync, cp.async,
// no TMA or wgmma yet):
// - Three launches. (1) delta: a warp per (batch, query, head) row, its D
//   products summed in a fixed order. (2) dK/dV: a block per (batch, kv
//   head, 64-key tile), 4 warps of 16 keys; it walks its group's query
//   heads in order, and for each the 32-query steps from the first one that
//   reaches the tile (causal: steps wholly above the diagonal skipped),
//   recomputing S^T = K Q^T, P^T, dP^T = V dO^T and dS^T in registers and
//   accumulating dV += P^T dO and dK += dS^T Q in f32 registers. (3) dQ: a
//   block per (batch, head, 64-query tile), 4 warps of 16 queries, walking
//   the 32-key steps up to the diagonal (heaviest tiles first) and
//   accumulating dQ += dS K. Nothing is shared between blocks, and every
//   sum runs in an order fixed by the shapes: no floating-point atomics,
//   so a backward gives the same bits on every run (the trainer's
//   bit-exact restore rests on it), and dQ needs no f32 scratch.
// - The walked operand (Q and dO, or K and V) comes in 32-row steps
//   through a two-stage cp.async ring, so step t+1 loads while step t is
//   computed; the owned 64-row tiles are loaded once. Shared rows are
//   padded by 16 bytes, so the ldmatrix loads of 8 rows hit 8 distinct
//   bank groups.
// - Products are mma.sync m16n8k16 (bf16 in, f32 sums): P and dS are
//   rounded to bf16 as the A operands of their products straight from the
//   accumulator registers (the C layout of one product is the A layout of
//   the next, mma.cuh); the B operands come by ldmatrix, transposed where
//   the product needs the other major order.
// - Outputs in bf16 (the inputs' type): dk = scale * dK, dv, dq = scale *
//   dQ, converted once from the f32 sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

#define OWN 64          // rows a block owns: keys (dK/dV) or queries (dQ)
#define STEP 32         // rows of the walked operand a step
#define THREADS 128     // 4 warps of 16 owned rows
#define LOG2E 1.4426950408889634f

typedef __nv_bfloat16 bf16;

// R rows of D bf16 from `src` (row r at src + r * stride) into a shared
// tile of leading dim D + 8, rows at or past S zero-filled (not read)
template <int D, int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t stride, int row0, int S) {
    constexpr int CH = D / 8;
    for (int c = threadIdx.x; c < R * CH; c += THREADS) {
        const int r = c / CH;
        const int col = (c - r * CH) * 8;
        const bool ok = row0 + r < S;
        const bf16* g = src + (size_t)(ok ? row0 + r : 0) * stride + col;
        cp_async16_zfill(dst + r * (D + 8) + col, g, ok);
    }
}

// A fragment (16 x 16) of a row-major shared tile: rows r0.., cols c0..
__device__ __forceinline__ void ld_a(uint32_t* a, const bf16* t, int ld,
                                     int r0, int c0, int lane) {
    const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = c0 + (lane >> 4) * 8;
    ldsm_x4(a, t + r * ld + c);
}

// B fragments of two 8-column tiles (n0, n0 + 8) at k-step k0, where the
// product's B[k][n] is the shared tile's element (n, k): b[0..1] for n0,
// b[2..3] for n0 + 8
__device__ __forceinline__ void ld_b_nk(uint32_t* b, const bf16* t, int ld,
                                        int n0, int k0, int lane) {
    const int r = n0 + (lane & 7) + (lane >> 4) * 8;
    const int c = k0 + ((lane >> 3) & 1) * 8;
    ldsm_x4(b, t + r * ld + c);
}

// the same where B[k][n] is the shared tile's element (k, n): transposed
__device__ __forceinline__ void ld_b_kn(uint32_t* b, const bf16* t, int ld,
                                        int k0, int n0, int lane) {
    const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = n0 + (lane >> 4) * 8;
    ldsm_x4_trans(b, t + r * ld + c);
}

// the A fragment of k-step kk from f32 accumulator tiles (8 columns each)
// c[2kk] and c[2kk + 1], rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*c)[4],
                                         int kk) {
    a[0] = pack_bf16(__floats2bfloat162_rn(c[2 * kk][0], c[2 * kk][1]));
    a[1] = pack_bf16(__floats2bfloat162_rn(c[2 * kk][2], c[2 * kk][3]));
    a[2] = pack_bf16(__floats2bfloat162_rn(c[2 * kk + 1][0], c[2 * kk + 1][1]));
    a[3] = pack_bf16(__floats2bfloat162_rn(c[2 * kk + 1][2], c[2 * kk + 1][3]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// (1) delta (B, H, Sq) = rowsum(dO * O) in f32: a warp per row of the
// (B, Sq, H) row-major layout
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    float* __restrict__ delta, int rows, int Sq, int H, int D) {
    const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (r >= rows) return;
    const bf16* orow = o + (size_t)r * D;
    const bf16* drow = dout + (size_t)r * D;
    float acc = 0.f;
    for (int c = 2 * lane; c < D; c += 64) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(orow + c));
        const float2 g = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(drow + c));
        acc = fmaf(a.x, g.x, acc);
        acc = fmaf(a.y, g.y, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
        const int h = r % H;
        const int i = (r / H) % Sq;
        const int b = r / (H * Sq);
        delta[((size_t)b * H + h) * Sq + i] = acc;
    }
}

template <int D>
struct Tiles {
    static constexpr int LD = D + 8;                    // padded row
    static constexpr int OWN_ELEMS = OWN * LD;
    static constexpr int STEP_ELEMS = STEP * LD;
    static constexpr int BYTES = 2 * (2 * OWN_ELEMS + 4 * STEP_ELEMS)
                                 + 4 * 2 * STEP * 4;    // + lse, delta
};

// (2) dK, dV: a block per (64-key tile, batch * K + kv head)
template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
    int K, int causal, int q_offset, float scale, float scale_log2) {
    constexpr int LD = Tiles<D>::LD;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* ks = reinterpret_cast<bf16*>(smem);
    bf16* vs = ks + Tiles<D>::OWN_ELEMS;
    bf16* qs = vs + Tiles<D>::OWN_ELEMS;          // [2][STEP][LD]
    bf16* dos = qs + 2 * Tiles<D>::STEP_ELEMS;    // [2][STEP][LD]
    float* lse_s = reinterpret_cast<float*>(dos + 2 * Tiles<D>::STEP_ELEMS);
    float* del_s = lse_s + 2 * STEP;

    const int k0 = blockIdx.x * OWN;
    const int b = blockIdx.y / K;
    const int kh = blockIdx.y - b * K;
    const int G = H / K;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const size_t kv_stride = (size_t)K * D, q_stride = (size_t)H * D;

    load_rows<D, OWN>(ks, k + (size_t)b * Sk * kv_stride + (size_t)kh * D,
                      kv_stride, k0, Sk);
    load_rows<D, OWN>(vs, v + (size_t)b * Sk * kv_stride + (size_t)kh * D,
                      kv_stride, k0, Sk);
    cp_async_commit();

    // query steps of each head that reach this key tile
    const int first = causal ? max(0, k0 - q_offset) / STEP : 0;
    const int per_head = max(0, (Sq + STEP - 1) / STEP - first);
    const int n_iter = G * per_head;

    auto issue = [&](int it) {
        const int hh = kh * G + it / per_head;
        const int q0 = (first + it % per_head) * STEP;
        const int st = it & 1;
        const size_t base = (size_t)b * Sq * q_stride + (size_t)hh * D;
        load_rows<D, STEP>(qs + st * Tiles<D>::STEP_ELEMS, q + base,
                           q_stride, q0, Sq);
        load_rows<D, STEP>(dos + st * Tiles<D>::STEP_ELEMS, dout + base,
                           q_stride, q0, Sq);
        if (threadIdx.x < STEP) {
            const int i = q0 + threadIdx.x;
            const size_t at = ((size_t)b * H + hh) * Sq + i;
            lse_s[st * STEP + threadIdx.x] = i < Sq ? lse[at] * LOG2E : 0.f;
            del_s[st * STEP + threadIdx.x] = i < Sq ? delta[at] : 0.f;
        }
    };

    float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

    if (n_iter > 0) issue(0);
    cp_async_commit();
    const int key_a = k0 + warp * 16 + g;  // this thread's key rows: a, a + 8
    for (int it = 0; it < n_iter; ++it) {
        if (it + 1 < n_iter) issue(it + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const int st = it & 1;
        const bf16* qt = qs + st * Tiles<D>::STEP_ELEMS;
        const bf16* dot = dos + st * Tiles<D>::STEP_ELEMS;
        const float* ls = lse_s + st * STEP;
        const float* ds = del_s + st * STEP;
        const int q0 = (first + it % per_head) * STEP;

        // S^T (16 keys x 32 queries) = K_w Q^T, dP^T = V_w dO^T
        float s[4][4], dp[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4], av[4], bq[4], bd[4];
            ld_a(a, ks, LD, warp * 16, kk * 16, lane);
            ld_a(av, vs, LD, warp * 16, kk * 16, lane);
#pragma unroll
            for (int n2 = 0; n2 < 2; ++n2) {
                ld_b_nk(bq, qt, LD, n2 * 16, kk * 16, lane);
                ld_b_nk(bd, dot, LD, n2 * 16, kk * 16, lane);
                mma16816(s[2 * n2], a[0], a[1], a[2], a[3], bq[0], bq[1]);
                mma16816(s[2 * n2 + 1], a[0], a[1], a[2], a[3], bq[2], bq[3]);
                mma16816(dp[2 * n2], av[0], av[1], av[2], av[3], bd[0], bd[1]);
                mma16816(dp[2 * n2 + 1], av[0], av[1], av[2], av[3], bd[2],
                         bd[3]);
            }
        }
        // P^T and dS^T = P^T (dP^T - delta), masked pairs 0
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = key_a + (e >> 1) * 8;
                const int qi = 8 * j + 2 * t + (e & 1);
                const int query = q0 + qi;
                const bool ok = key < Sk && query < Sq
                                && (!causal || key <= q_offset + query);
                const float p = ok ? exp2f(s[j][e] * scale_log2 - ls[qi])
                                   : 0.f;
                s[j][e] = p;
                dp[j][e] = p * (dp[j][e] - ds[qi]);
            }
        // dV += P^T dO, dK += dS^T Q (k-steps over the 32 queries)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
            uint32_t pa[4], sa[4];
            acc_to_a(pa, s, kk);
            acc_to_a(sa, dp, kk);
#pragma unroll
            for (int n0 = 0; n0 < D / 16; ++n0) {
                uint32_t bd[4], bq[4];
                ld_b_kn(bd, dot, LD, kk * 16, n0 * 16, lane);
                ld_b_kn(bq, qt, LD, kk * 16, n0 * 16, lane);
                mma16816(dva[2 * n0], pa[0], pa[1], pa[2], pa[3], bd[0], bd[1]);
                mma16816(dva[2 * n0 + 1], pa[0], pa[1], pa[2], pa[3], bd[2],
                         bd[3]);
                mma16816(dka[2 * n0], sa[0], sa[1], sa[2], sa[3], bq[0], bq[1]);
                mma16816(dka[2 * n0 + 1], sa[0], sa[1], sa[2], sa[3], bq[2],
                         bq[3]);
            }
        }
        __syncthreads();  // stage st is free for step it + 2
    }
    cp_async_wait<0>();

    bf16* dkb = dk + (size_t)b * Sk * kv_stride + (size_t)kh * D;
    bf16* dvb = dv + (size_t)b * Sk * kv_stride + (size_t)kh * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t;
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
            const int key = key_a + hlf * 8;
            if (key < Sk) {
                *reinterpret_cast<__nv_bfloat162*>(
                    dkb + (size_t)key * kv_stride + col) =
                    __floats2bfloat162_rn(dka[j][2 * hlf] * scale,
                                          dka[j][2 * hlf + 1] * scale);
                *reinterpret_cast<__nv_bfloat162*>(
                    dvb + (size_t)key * kv_stride + col) =
                    __floats2bfloat162_rn(dva[j][2 * hlf], dva[j][2 * hlf + 1]);
            }
        }
    }
}

// (3) dQ: a block per (64-query tile, batch * H + head)
template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Sk, int H, int K, int causal,
    int q_offset, float scale, float scale_log2) {
    constexpr int LD = Tiles<D>::LD;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* qs = reinterpret_cast<bf16*>(smem);
    bf16* dos = qs + Tiles<D>::OWN_ELEMS;
    bf16* ks = dos + Tiles<D>::OWN_ELEMS;         // [2][STEP][LD]
    bf16* vs = ks + 2 * Tiles<D>::STEP_ELEMS;     // [2][STEP][LD]

    // causal: the tiles with the most keys first
    const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    const int q0 = tile * OWN;
    const int b = blockIdx.y / H;
    const int h = blockIdx.y - b * H;
    const int kh = h / (H / K);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const size_t kv_stride = (size_t)K * D, q_stride = (size_t)H * D;
    const size_t qbase = (size_t)b * Sq * q_stride + (size_t)h * D;
    const size_t kvbase = (size_t)b * Sk * kv_stride + (size_t)kh * D;

    load_rows<D, OWN>(qs, q + qbase, q_stride, q0, Sq);
    load_rows<D, OWN>(dos, dout + qbase, q_stride, q0, Sq);
    cp_async_commit();

    const int row_a = q0 + warp * 16 + g;  // this thread's query rows: a, a + 8
    float lse2[2], del[2];
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
        const int i = row_a + hlf * 8;
        const size_t at = ((size_t)b * H + h) * Sq + i;
        lse2[hlf] = i < Sq ? lse[at] * LOG2E : 0.f;
        del[hlf] = i < Sq ? delta[at] : 0.f;
    }
    const int last = min(q0 + OWN, Sq) - 1;
    const int kend = causal ? min(Sk, q_offset + last + 1) : Sk;
    const int n_iter = kend > 0 ? (kend + STEP - 1) / STEP : 0;

    auto issue = [&](int it) {
        const int st = it & 1;
        load_rows<D, STEP>(ks + st * Tiles<D>::STEP_ELEMS, k + kvbase,
                           kv_stride, it * STEP, Sk);
        load_rows<D, STEP>(vs + st * Tiles<D>::STEP_ELEMS, v + kvbase,
                           kv_stride, it * STEP, Sk);
    };

    float dqa[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

    if (n_iter > 0) issue(0);
    cp_async_commit();
    for (int it = 0; it < n_iter; ++it) {
        if (it + 1 < n_iter) issue(it + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const int st = it & 1;
        const bf16* kt = ks + st * Tiles<D>::STEP_ELEMS;
        const bf16* vt = vs + st * Tiles<D>::STEP_ELEMS;
        const int kt0 = it * STEP;

        // S (16 queries x 32 keys) = Q_w K^T, dP = dO_w V^T
        float s[4][4], dp[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4], ad[4], bk[4], bv[4];
            ld_a(a, qs, LD, warp * 16, kk * 16, lane);
            ld_a(ad, dos, LD, warp * 16, kk * 16, lane);
#pragma unroll
            for (int n2 = 0; n2 < 2; ++n2) {
                ld_b_nk(bk, kt, LD, n2 * 16, kk * 16, lane);
                ld_b_nk(bv, vt, LD, n2 * 16, kk * 16, lane);
                mma16816(s[2 * n2], a[0], a[1], a[2], a[3], bk[0], bk[1]);
                mma16816(s[2 * n2 + 1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
                mma16816(dp[2 * n2], ad[0], ad[1], ad[2], ad[3], bv[0], bv[1]);
                mma16816(dp[2 * n2 + 1], ad[0], ad[1], ad[2], ad[3], bv[2],
                         bv[3]);
            }
        }
        // dS = P (dP - delta), masked pairs 0
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int hlf = e >> 1;
                const int query = row_a + hlf * 8;
                const int key = kt0 + 8 * j + 2 * t + (e & 1);
                const bool ok = key < Sk && query < Sq
                                && (!causal || key <= q_offset + query);
                const float p = ok ? exp2f(s[j][e] * scale_log2 - lse2[hlf])
                                   : 0.f;
                dp[j][e] = p * (dp[j][e] - del[hlf]);
            }
        // dQ += dS K (k-steps over the 32 keys)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
            uint32_t sa[4];
            acc_to_a(sa, dp, kk);
#pragma unroll
            for (int n0 = 0; n0 < D / 16; ++n0) {
                uint32_t bk[4];
                ld_b_kn(bk, kt, LD, kk * 16, n0 * 16, lane);
                mma16816(dqa[2 * n0], sa[0], sa[1], sa[2], sa[3], bk[0], bk[1]);
                mma16816(dqa[2 * n0 + 1], sa[0], sa[1], sa[2], sa[3], bk[2],
                         bk[3]);
            }
        }
        __syncthreads();  // stage st is free for step it + 2
    }
    cp_async_wait<0>();

    bf16* dqb = dq + qbase;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t;
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
            const int i = row_a + hlf * 8;
            if (i < Sq)
                *reinterpret_cast<__nv_bfloat162*>(
                    dqb + (size_t)i * q_stride + col) =
                    __floats2bfloat162_rn(dqa[j][2 * hlf] * scale,
                                          dqa[j][2 * hlf + 1] * scale);
        }
    }
}

template <int D>
static int launch(const bf16* q, const bf16* k, const bf16* v,
                  const bf16* o, const bf16* dout, const float* lse,
                  float* delta, bf16* dq, bf16* dk, bf16* dv, int B, int Sq,
                  int Sk, int H, int K, int causal, int q_offset, float scale,
                  cudaStream_t stream) {
    const int rows = B * Sq * H;
    flash_bwd_delta_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
        o, dout, delta, rows, Sq, H, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int smem = Tiles<D>::BYTES;
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    const float scale_log2 = scale * LOG2E;
    flash_bwd_dkdv_kernel<D><<<dim3((Sk + OWN - 1) / OWN, B * K), THREADS,
                               smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, K, causal, q_offset,
        scale, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_kernel<D><<<dim3((Sq + OWN - 1) / OWN, B * H), THREADS,
                             smem, stream>>>(
        q, k, v, dout, lse, delta, dq, Sq, Sk, H, K, causal, q_offset, scale,
        scale_log2);
    return (int)cudaGetLastError();
}

// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, K, D); all bf16 and
// contiguous; lse and the scratch delta (B, H, Sq) f32. D must be 64 or 128
// and K must divide H (the wrapper checks both, and pads narrower heads).
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int K, int D, int causal,
    int q_offset, float scale, void* stream) {
    if (K <= 0 || H % K || B <= 0 || Sq <= 0 || Sk <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (D == 128)
        return launch<128>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                           (const bf16*)o, (const bf16*)dout,
                           (const float*)lse, (float*)delta, (bf16*)dq,
                           (bf16*)dk, (bf16*)dv, B, Sq, Sk, H, K, causal,
                           q_offset, scale, st);
    if (D == 64)
        return launch<64>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                          (const bf16*)o, (const bf16*)dout,
                          (const float*)lse, (float*)delta, (bf16*)dq,
                          (bf16*)dk, (bf16*)dv, B, Sq, Sk, H, K, causal,
                          q_offset, scale, st);
    return (int)cudaErrorInvalidValue;
}
