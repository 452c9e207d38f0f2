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
// - Not done: the producer keeps its registers (no setmaxnreg), and one
//   warpgroup does not overlap its softmax with its own next Q K^T.

#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
#define BQ 64              // query rows of a block: one consumer warpgroup
#define BK 64              // keys of a tile
#define STAGES 2           // K/V ring depth
#define CONSUMERS 128      // the consumer warpgroup's threads
#define THREADS (CONSUMERS + 32)  // and one producer warp
static_assert(BQ == 64 && BK == 64, "tiles are 64 rows: one wgmma M, 8 swizzle atoms");

// ---------------------------------------------------------------------------
// PTX helpers: shared-memory addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`; a
// wait of more than ~10 s (a broken protocol, not a slow load) traps, so
// the launch fails instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    long long start = 0;
    while (true) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
        if (done) return;
        if (!start) start = clock64();
        else if (clock64() - start > 20000000000LL) __trap();
    }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// a wgmma shared-memory descriptor for a tile in the 128-byte swizzle
// (1024-byte aligned atoms of 8 rows x 128 bytes); offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
    uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
    d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
    d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
    d |= 1ull << 62;  // layout: 128-byte swizzle
    return d;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving register reads or writes across a wgmma
// boundary (the products run asynchronously on these registers)
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// D(64 x 64) (+)= A(64 x 16, shared) * B(64 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 64) += A(64 x 16, registers) * B(16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64 x 128) += A(64 x 16, registers) * B(16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
    return *reinterpret_cast<uint32_t*>(&v);
}

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

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA
// runtime's entry-point query, so nothing links -lcuda
static EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                    cudaEnableDefault, &found) == cudaSuccess
            && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// (B, S, heads, D) bf16 as a 4-D map (D, heads, S, B): a box is 64 columns
// (128 bytes, 128-byte swizzle) of one head at `rows` positions of one
// batch; positions past S read as zeros
static int make_map(CUtensorMap* map, const void* base, int B, int S,
                    int heads, int D, int rows) {
    const EncodeTiled enc = encoder();
    if (!enc) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                                (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                   (cuuint64_t)heads * D * 2,
                                   (cuuint64_t)S * heads * D * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                           const_cast<void*>(base), dims, strides, box, unit,
                           CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int Sq, int Sk, int H, int K, int causal,
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
        tq, tk, tv, (__nv_bfloat16*)out, Sq, Sk, H, K, causal, q_offset,
        scale * 1.4426950408889634f);
    return (int)cudaGetLastError();
}

// D must be 64 or 128 and K must divide H (the wrapper checks both).
extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* out,
    int B, int Sq, int Sk, int H, int K, int D, int causal, int q_offset,
    float scale, void* stream) {
    if (K <= 0 || H % K) return (int)cudaErrorInvalidValue;
    if (Sk == 0)  // nothing to attend: zeros, as acc / max(l, 1e-30) gives
        return (int)cudaMemsetAsync(out, 0, (size_t)B * Sq * H * D * 2,
                                    (cudaStream_t)stream);
    if (D == 128)
        return launch<128>(q, k, v, out, B, Sq, Sk, H, K, causal, q_offset,
                           scale, (cudaStream_t)stream);
    if (D == 64)
        return launch<64>(q, k, v, out, B, Sq, Sk, H, K, causal, q_offset,
                          scale, (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}
