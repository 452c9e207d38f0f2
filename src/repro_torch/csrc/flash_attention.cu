// Causal (or non-causal) GQA flash attention for Hopper (sm_90a): the
// chunked-prefill attention over the gathered context pages, and the dense
// engine's whole-prompt prefill.
//
// Replaces: repro/kernels/flash_attention.py, flash_attention (_flash_kernel,
// the TPU kernel whose grid carries online-softmax statistics across
// sequential key blocks in VMEM scratch).
//
// What bounds it on this card: operations. At the prefill chunk's shapes
// (Sq = 256 queries, D = 128) every key tile loaded is used by 64 queries,
// so the work is 4*D FLOP per (query, head, attended key) against
// 2*D*2 bytes per key and kv head: well above the H100's ~295 FLOP/byte.
// The bound is 4*D*H*sum_q keys_attended FLOP over 989 TFLOP/s (bf16 tensor
// cores).
//
// Design (FlashAttention-3's shape, without its intra-warpgroup overlap):
// - Grid (B*H, ceil(Sq/64)), heaviest query tiles first. A block is one
//   consumer warpgroup (4 warps) that owns 64 query rows of head h, plus one
//   producer warp; it reads kv head h / (H/K): GQA without expanding K/V.
//   One consumer warpgroup (not two) because the prefill chunk has
//   B*H*ceil(256/64) = 128 query tiles at qwen3-8b's and zamba2's shapes:
//   with 64 rows a block that is one block per SM on 132 SMs, with 128 rows
//   it would be 64 blocks and half the card idle. At 80 KB of shared memory
//   (D = 128) two blocks fit on an SM, so a whole 2048-token prefill (1,024
//   tiles) overlaps one block's softmax with the other's products.
// - Loads: the producer warp's first lane issues TMA loads
//   (cp.async.bulk.tensor, 4-D maps over (D, heads, S, B) with the 128-byte
//   swizzle that the wgmma descriptors read) of Q once and of each 64-key K
//   and V tile into a 2-stage ring, tracked by mbarriers (K and V each
//   their own "full" barrier, one "empty" barrier per stage that the 128
//   consumer threads arrive on). So tile t+1 lands while tile t is
//   computed, and S = Q K^T starts before V has landed. Rows past Sq or Sk
//   are zero-filled by the TMA unit; tiles entirely above the causal
//   diagonal are never loaded.
// - Compute: S = Q K^T is wgmma m64n64k16 with both operands in shared
//   memory (K-major); P is converted in registers to bf16 and is the
//   register A operand of O += P V (wgmma m64nDk16), whose B operand is the
//   row-major (keys, D) V tile read through the transpose flag (MN-major):
//   no transpose copy. The accumulator layout of S is the A-operand layout
//   of P, so P never leaves the registers.
// - State in registers: O (64 x D f32: D/2 registers a thread), the row
//   maxima m and the row sums l. A row is owned by the 4 threads of a quad;
//   its max is reduced by two shuffles per tile, its sum once at the end.
//   Nothing of S, P or O goes through shared memory.
// - Masking: only a tile that crosses Sk or the causal diagonal of the
//   block's first row tests positions; keys at kpos >= Sk, and at
//   kpos > qpos when causal, are masked. q_offset, Sq and Sk are runtime.
// - Numerics (unchanged since the first port): f32 scores, scaled by
//   1/sqrt(D) after the f32-accumulated dot (folded with log2(e) into one
//   multiply, the exponentials are exp2); f32 online softmax; the
//   probabilities rounded to bf16 for the P V product, and the row sum l
//   adds the rounded values, so the weights that are normalized are the
//   weights that were used; l clamped at 1e-30.
// - Training: with a non-null `lse` the epilogue also writes each query
//   row's log-sum-exp of the scaled scores, (m + log2 l) * ln 2, f32
//   (B, H, Sq), which the backward kernel (flash_attention_bwd.cu)
//   recomputes P from. With a null `lse` nothing else changes: the serving
//   path's outputs are the same bits.
// - Not done: the producer keeps its registers (no setmaxnreg), and one
//   warpgroup does not overlap its softmax with its own next Q K^T.

#include <cuda_bf16.h>

#include "flash_wgmma.cuh"  // the wgmma shapes, the tensor map; TMA

#define NEG_INF (-1e30f)
#define BQ 64              // query rows of a block: one consumer warpgroup
#define BK 64              // keys of a tile
#define STAGES 2           // K/V ring depth
#define CONSUMERS 128      // the consumer warpgroup's threads
#define THREADS (CONSUMERS + 32)  // and one producer warp
static_assert(BQ == 64 && BK == 64, "tiles are 64 rows: one wgmma M, 8 swizzle atoms");

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// shared-memory plan (bytes from a 1024-byte aligned base): Q, then the K
// ring, then the V ring, each tile stored as D/64 column blocks of
// (rows x 128 bytes) in the 128-byte swizzle, then the mbarriers
template <int D>
struct Plan {
    static constexpr int Q_BYTES = BQ * D * 2;
    static constexpr int KV_BYTES = BK * D * 2;
    static constexpr int K_OFF = Q_BYTES;
    static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
    static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
    static constexpr int BYTES = BAR_OFF + (1 + 3 * STAGES) * 8;
};

template <int D>  // 64 or 128
__global__ void __launch_bounds__(THREADS, 2) flash_attention_kernel(
    const __grid_constant__ CUtensorMap tq,  // (B, Sq, H, D) bf16
    const __grid_constant__ CUtensorMap tk,  // (B, Sk, K, D) bf16
    const __grid_constant__ CUtensorMap tv,  // (B, Sk, K, D) bf16
    __nv_bfloat16* __restrict__ out,         // (B, Sq, H, D) bf16
    float* __restrict__ lse,                 // (B, H, Sq) f32, or null
    int Sq, int Sk, int H, int K, int causal, int q_offset,
    float scale_log2) {
    using P = Plan<D>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + P::K_OFF);
    __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + P::V_OFF);
    uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + P::BAR_OFF);
    uint64_t* k_full = q_full + 1;
    uint64_t* v_full = k_full + STAGES;
    uint64_t* empty = v_full + STAGES;

    const int b = blockIdx.x / H;
    const int h = blockIdx.x - b * H;
    const int kh = h / (H / K);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    // keys this block can attend: up to the last real row's position
    const int last_row = min(q0 + BQ, Sq) - 1;
    const int kend = causal ? min(Sk, q_offset + last_row + 1) : Sk;
    const int n_tiles = kend > 0 ? (kend + BK - 1) / BK : 0;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&k_full[s], 1);
            mbar_init(&v_full[s], 1);
            mbar_init(&empty[s], CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= CONSUMERS) {  // the producer warp
        if (threadIdx.x == CONSUMERS) {
            mbar_expect_tx(q_full, P::Q_BYTES);
            for (int c = 0; c < D / 64; ++c)
                tma_load_4d(qs + c * BQ * 64, &tq, q_full, c * 64, h, q0, b);
            for (int t = 0; t < n_tiles; ++t) {
                const int s = t % STAGES;
                // the stage's previous tile released (passes at once on a
                // stage's first use)
                mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
                __nv_bfloat16* kt = ks + s * BK * D;
                __nv_bfloat16* vt = vs + s * BK * D;
                mbar_expect_tx(&k_full[s], P::KV_BYTES);
                for (int c = 0; c < D / 64; ++c)
                    tma_load_4d(kt + c * BK * 64, &tk, &k_full[s], c * 64, kh,
                                t * BK, b);
                mbar_expect_tx(&v_full[s], P::KV_BYTES);
                for (int c = 0; c < D / 64; ++c)
                    tma_load_4d(vt + c * BK * 64, &tv, &v_full[s], c * 64, kh,
                                t * BK, b);
            }
        }
        return;
    }

    // the consumer warpgroup: thread (warp w, lane) holds rows r0 and r0 + 8
    // of the tile, columns cq and cq + 1 of every 8-column block
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int r0 = warp * 16 + (lane >> 2);
    const int cq = 2 * (lane & 3);
    const int qpos0 = q_offset + q0 + r0;
    const int qpos1 = qpos0 + 8;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const uint32_t phase = (t / STAGES) & 1;
        const __nv_bfloat16* kt = ks + s * BK * D;
        const __nv_bfloat16* vt = vs + s * BK * D;

        // S = Q K^T (64 x BK, f32)
        float sc[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
        mbar_wait(&k_full[s], phase);
        fence_regs<BK / 2>(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const int off = (kk / 4) * 64 * 64 + (kk % 4) * 16;
            wgmma_ss_n64(sc, sw128_desc(qs + off, 16, 1024),
                         sw128_desc(kt + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<BK / 2>(sc);

        // mask (edge tiles only), scale into the log2 domain, row maxima
        const int k0 = t * BK;
        const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q_offset + q0);
        float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float x0 = sc[4 * j + e] * scale_log2;
                float x1 = sc[4 * j + 2 + e] * scale_log2;
                if (edge) {
                    const int kpos = k0 + 8 * j + cq + e;
                    if (kpos >= Sk || (causal && kpos > qpos0)) x0 = NEG_INF;
                    if (kpos >= Sk || (causal && kpos > qpos1)) x1 = NEG_INF;
                }
                sc[4 * j + e] = x0;
                sc[4 * j + 2 + e] = x1;
                mx0 = fmaxf(mx0, x0);
                mx1 = fmaxf(mx1, x1);
            }
        }
        const float mn0 = fmaxf(m0, quad_max(mx0));
        const float mn1 = fmaxf(m1, quad_max(mx1));
        const float a0 = exp2f(m0 - mn0);
        const float a1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;

        // P = exp2(S - m) rounded to bf16, straight into the A fragments of
        // P V; l adds the rounded values (this thread's columns only)
        uint32_t pa[BK / 16][4];
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
            const __nv_bfloat162 p0 = __floats2bfloat162_rn(
                exp2f(sc[4 * j] - mn0), exp2f(sc[4 * j + 1] - mn0));
            const __nv_bfloat162 p1 = __floats2bfloat162_rn(
                exp2f(sc[4 * j + 2] - mn1), exp2f(sc[4 * j + 3] - mn1));
            const float2 f0 = __bfloat1622float2(p0);
            const float2 f1 = __bfloat1622float2(p1);
            s0 += f0.x + f0.y;
            s1 += f1.x + f1.y;
            pa[j / 2][(j % 2) * 2] = bf162_bits(p0);
            pa[j / 2][(j % 2) * 2 + 1] = bf162_bits(p1);
        }
        l0 = l0 * a0 + s0;
        l1 = l1 * a1 + s1;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
            o[4 * j] *= a0;
            o[4 * j + 1] *= a0;
            o[4 * j + 2] *= a1;
            o[4 * j + 3] *= a1;
        }

        // O += P V
        mbar_wait(&v_full[s], phase);
        fence_regs<D / 2>(o);
        fence_regs<BK / 4>(&pa[0][0]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t dv = sw128_desc(vt + kk * 16 * 64, BK * 128, 1024);
            if constexpr (D == 128)
                wgmma_rs_n128(o, pa[kk], dv);
            else
                wgmma_rs_n64(o, pa[kk], dv);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<D / 2>(o);
        mbar_arrive(&empty[s]);  // this thread is done with the stage
    }

    const float lv0 = fmaxf(quad_sum(l0), 1e-30f);
    const float lv1 = fmaxf(quad_sum(l1), 1e-30f);
    const size_t q_row = (size_t)H * D;
    __nv_bfloat16* ob = out + (size_t)b * Sq * q_row + (size_t)h * D;
    const int row0 = q0 + r0;
    const int row1 = row0 + 8;
    if (lse != nullptr && (lane & 3) == 0) {
        float* lb = lse + ((size_t)b * H + h) * Sq;
        if (row0 < Sq) lb[row0] = (m0 + log2f(lv0)) * 0.6931471805599453f;
        if (row1 < Sq) lb[row1] = (m1 + log2f(lv1)) * 0.6931471805599453f;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + cq;
        if (row0 < Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + row0 * q_row + col) =
                __floats2bfloat162_rn(o[4 * j] / lv0, o[4 * j + 1] / lv0);
        if (row1 < Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + row1 * q_row + col) =
                __floats2bfloat162_rn(o[4 * j + 2] / lv1, o[4 * j + 3] / lv1);
    }
}

// ---------------------------------------------------------------------------
// host side: TMA maps and the launch
// ---------------------------------------------------------------------------

template <int D>
static int launch(const void* q, const void* k, const void* v, void* out,
                  float* lse, int B, int Sq, int Sk, int H, int K, int causal,
                  int q_offset, float scale, cudaStream_t stream) {
    CUtensorMap tq, tk, tv;
    int e = make_map(&tq, q, B, Sq, H, D, BQ);
    if (!e) e = make_map(&tk, k, B, Sk, K, D, BK);
    if (!e) e = make_map(&tv, v, B, Sk, K, D, BK);
    if (e) return e;
    const int smem = Plan<D>::BYTES + 1024;  // + slack to align the base
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(B * H, (Sq + BQ - 1) / BQ);
    flash_attention_kernel<D><<<grid, THREADS, smem, stream>>>(
        tq, tk, tv, (__nv_bfloat16*)out, lse, Sq, Sk, H, K, causal,
        q_offset, scale * 1.4426950408889634f);
    return (int)cudaGetLastError();
}

// D must be 64 or 128 and K must divide H (the wrapper checks both). `lse`
// (B, H, Sq) f32 is written when it is not null.
extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int Sq, int Sk, int H, int K, int D, int causal, int q_offset,
    float scale, void* stream) {
    if (K <= 0 || H % K) return (int)cudaErrorInvalidValue;
    if (Sk == 0) {  // nothing to attend: zeros, as acc / max(l, 1e-30) gives
        if (lse) {
            const int e = (int)cudaMemsetAsync(lse, 0, (size_t)B * H * Sq * 4,
                                               (cudaStream_t)stream);
            if (e) return e;
        }
        return (int)cudaMemsetAsync(out, 0, (size_t)B * Sq * H * D * 2,
                                    (cudaStream_t)stream);
    }
    if (D == 128)
        return launch<128>(q, k, v, out, (float*)lse, B, Sq, Sk, H, K, causal,
                           q_offset, scale, (cudaStream_t)stream);
    if (D == 64)
        return launch<64>(q, k, v, out, (float*)lse, B, Sq, Sk, H, K, causal,
                          q_offset, scale, (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}
