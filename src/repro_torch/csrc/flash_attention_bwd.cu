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
// (bf16 tensor cores). This kernel executes 14 * D a pair: S and dP are
// computed twice, once for dK/dV and once for dQ, because dQ sums over
// keys and dK/dV over queries, and neither sum may cross blocks without
// atomics (below). Beside the products, each pair costs two exponentials
// (one a kernel) on the SFU. What holds it back on the card is latency,
// not a unit's rate: a warpgroup's step is a chain (wait for the stage;
// the S and dP products; the exponentials; the dV and dK, or dQ,
// products), and two warpgroups an SM overlap each other's chains only in
// part (tools/flash_bwd_phases.py times each link).
//
// Design (FlashAttention-3's warp-specialised shape; in the dK/dV kernel
// S and dP are computed transposed, keys as the product's rows, so that
// P^T and dS^T are register A operands like the forward's P):
// - Two launches. (1) dQ: a block per (batch, head, 128-query tile), the
//   last query tiles (the most keys) first; it also forms delta, which
//   it needs and writes for (2). (2) dK/dV: a block per (batch, kv head,
//   128-key tile), key tiles in order (the first attend the most queries:
//   heaviest first).
// - A block is two consumer warpgroups, each owning 64 rows (queries or
//   keys), and a producer warpgroup (setmaxnreg: 40 registers a thread,
//   the consumers 232) of which one warp works. The owned tiles (Q and dO,
//   or K and V) are loaded once by TMA; the walked operand streams in
//   64-row steps (K and V, or Q and dO of each query head of the group in
//   turn) through a ring of 4 (D 128) or 6 (D 64) stages, tracked by
//   mbarriers ("full": the TMA bytes, and in (2) the 32 producer lanes
//   that copy the step's lse and delta into the stage; "empty": the 256
//   consumer threads). Every TMA box is 64 columns (128 bytes) in the
//   128-byte swizzle, zero-filled past Sq or Sk; steps wholly above the
//   causal diagonal of the block are never loaded.
// - Products are wgmma (64-row M, bf16 in, f32 sums). S = Q K^T and dP =
//   dO V^T, or S^T = K Q^T and dP^T = V dO^T (64 x 64), read both
//   operands from shared memory, K-major. P (P^T) and dS = P (dP - delta)
//   are rounded to bf16 in registers, where the accumulator layout of one
//   product is the A-operand layout of the next; dQ += dS K, dV += P^T dO
//   and dK += dS^T Q take A from registers and read B (the stage's K, or
//   its dO and Q) through the transpose flag (MN-major), as the forward
//   reads V: no ldmatrix, no transposed copy.
// - Overlap: in (1) a step's dQ product runs under the next step's S, dP
//   and exponentials (two sets of dS fragments, the loop unrolled by
//   two); in (2) a warpgroup waits for its products before its
//   exponentials, the other warpgroup's products running meanwhile. (The
//   deferred form in (2) does not fit D 128's registers; at D 64 ptxas
//   serialised its wgmma, C7518, and it ran slower on the H100.)
// - Registers: a (2) consumer at D 128 holds dK and dV (64 x 128 f32: 64
//   registers a thread each) and S^T and dP^T (32 each), 192 of its 232;
//   P^T and dS^T are formed together after one wait, so no f32 P outlives
//   its element. (1) holds dQ, S, dP and two sets of dS: 160 at D 128.
// - Masking: only a step that crosses Sq, Sk or the causal diagonal tests
//   positions. A warpgroup whose 64 rows are wholly past Sk (or Sq) skips
//   every product but still waits for and releases each stage, so the
//   ring's phases stay in step; a step wholly above one warpgroup's
//   diagonal (the other's first) is computed and masked to zero.
// - Deterministic: every output element, and every delta, is written by
//   exactly one warpgroup, and every sum runs in an order fixed by the
//   shapes (key steps in order; query heads of the group in order, then
//   steps in order; within a product, wgmma's k16 slices in order; delta's
//   columns by a fixed shuffle tree). There are no floating-point atomics,
//   so a backward gives the same bits on every run (the trainer's
//   bit-exact restore rests on it), and dQ needs no f32 scratch.
// - Outputs in bf16 (the inputs' type): dk = scale * dK, dv, dq = scale *
//   dQ, converted once from the f32 sums and stored from registers.

#include <cuda_bf16.h>

#include "flash_wgmma.cuh"  // the wgmma shapes, the tensor map; TMA

#define OWN 64                  // rows a consumer warpgroup owns
#define STEP 64                 // rows of the walked operand a step
#define WGS 2                   // consumer warpgroups a block
#define CONSUMERS (128 * WGS)
#define THREADS (CONSUMERS + 128)  // and one producer warpgroup
#define PRODUCER_REGS 40        // setmaxnreg: 40 + 2 x 232 of an SMSP's 512
#define CONSUMER_REGS 232
#define LOG2E 1.4426950408889634f

typedef __nv_bfloat16 bf16;

// shared-memory plan (bytes from a 1024-byte aligned base): the owned
// tiles (WGS of each), then the ring of walked tiles, each tile stored as
// D / 64 column blocks of (64 rows x 128 bytes), then (dK/dV) the ring's
// lse and delta rows, then the mbarriers (owned, full[STAGES],
// empty[STAGES])
template <int D, bool KV>
struct Plan {
    static constexpr int STAGES = D == 64 ? 6 : 4;
    static constexpr int TILE = 64 * D * 2;  // bytes of a 64-row tile
    static constexpr int OWN_A = 0;          // K (dK/dV) or Q (dQ)
    static constexpr int OWN_B = WGS * TILE;  // V or dO
    static constexpr int RING_A = 2 * WGS * TILE;  // Q or K
    static constexpr int RING_B = RING_A + STAGES * TILE;  // dO or V
    static constexpr int LSE = RING_B + STAGES * TILE;
    static constexpr int DEL = LSE + (KV ? STAGES * STEP * 4 : 0);
    static constexpr int BAR = DEL + (KV ? STAGES * STEP * 4 : 0);
    static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8;
    static constexpr int SMEM = BYTES + 1024;  // + slack to align the base
};
static_assert(OWN == 64 && STEP == 64, "tiles are 64 rows: one wgmma M");

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// the descriptor of k16 slice kk of a K-major 64-row tile
__device__ __forceinline__ uint64_t kmajor(const bf16* tile, int kk) {
    return sw128_desc(tile + (kk / 4) * 64 * 64 + (kk % 4) * 16, 16, 1024);
}

// the descriptor of rows 16 kk .. 16 kk + 15 of a 64-row tile read
// MN-major (its D columns are the product's N)
__device__ __forceinline__ uint64_t mnmajor(const bf16* tile, int kk) {
    return sw128_desc(tile + kk * 16 * 64, 64 * 128, 1024);
}

// acc = A(64 x D, shared, K-major) * B(64 rows x D, shared, K-major)^T: a
// 64 x 64 product over D, issued and committed as one group
template <int D>
__device__ __forceinline__ void product_ss(float* acc, const bf16* a,
                                           const bf16* b) {
    fence_regs<32>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(acc, kmajor(a, kk), kmajor(b, kk), kk > 0);
    wgmma_commit();
}

// acc (64 x D) += A(64 x 64, registers) * B(64 rows x D, shared, MN-major)
template <int D>
__device__ __forceinline__ void product_rs(float* acc, const uint32_t (*a)[4],
                                           const bf16* b) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        if constexpr (D == 128)
            wgmma_rs_n128(acc, a[kk], mnmajor(b, kk));
        else
            wgmma_rs_n64(acc, a[kk], mnmajor(b, kk));
    }
}

// the two 64-row tiles at rows r0 .. r0 + 63 of the maps at head `head`,
// batch `batch` into a and b, completing on `bar`
template <int D>
__device__ __forceinline__ void load_pair(bf16* a, bf16* b,
                                          const CUtensorMap* ma,
                                          const CUtensorMap* mb,
                                          uint64_t* bar, int head, int r0,
                                          int batch) {
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(a + c * 64 * 64, ma, bar, c * 64, head, r0, batch);
        tma_load_4d(b + c * 64 * 64, mb, bar, c * 64, head, r0, batch);
    }
}

// the pair of the accumulator layout (columns 8 j + cq, + 1 of row r0 for
// e 0, of row r0 + 8 for e 1) rounded to bf16, into A fragment slot j of a
// 64-deep register operand
__device__ __forceinline__ void put_a(uint32_t (*a)[4], int j, int e,
                                      float x, float y) {
    a[j / 2][(j % 2) * 2 + e] = bf162_bits(__floats2bfloat162_rn(x, y));
}

// 2^x on the SFU, subnormal results flushed to zero (a probability below
// 2^-126 adds nothing a bf16 product keeps); exp2f's subnormal path cost
// three more instructions an exponential
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// dK, dV (the second launch): a block per (batch * K + kv head, 128-key
// tile)
template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_kernel(
    const __grid_constant__ CUtensorMap tq,   // (B, Sq, H, D)
    const __grid_constant__ CUtensorMap tk,   // (B, Sk, K, D)
    const __grid_constant__ CUtensorMap tv,   // (B, Sk, K, D)
    const __grid_constant__ CUtensorMap tdo,  // (B, Sq, H, D)
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
    int K, int causal, int q_offset, float scale, float scale_log2) {
    using P = Plan<D, true>;
    constexpr int STAGES = P::STAGES;
    constexpr int T = 64 * D;  // elements of a tile
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    bf16* ks = reinterpret_cast<bf16*>(smem + P::OWN_A);
    bf16* vs = reinterpret_cast<bf16*>(smem + P::OWN_B);
    bf16* qs = reinterpret_cast<bf16*>(smem + P::RING_A);
    bf16* dos = reinterpret_cast<bf16*>(smem + P::RING_B);
    float* lse_s = reinterpret_cast<float*>(smem + P::LSE);
    float* del_s = reinterpret_cast<float*>(smem + P::DEL);
    uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + P::BAR);
    uint64_t* full = own_full + 1;
    uint64_t* empty = full + STAGES;

    const int b = blockIdx.x / K;
    const int kh = blockIdx.x - b * K;
    const int G = H / K;
    const int k0 = blockIdx.y * WGS * OWN;
    // query steps of each head that reach the block's first key
    const int first = causal ? max(0, k0 - q_offset) / STEP : 0;
    const int per_head = max(0, (Sq + STEP - 1) / STEP - first);
    const int n_iter = G * per_head;
    const int own = min(WGS, (Sk - k0 + OWN - 1) / OWN);  // warpgroups with keys

    if (threadIdx.x == 0) {
        mbar_init(own_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1 + 32);
            mbar_init(&empty[s], CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: one warp
        setmaxnreg_dec<PRODUCER_REGS>();
        const int lane = threadIdx.x & 31;
        if (threadIdx.x >= CONSUMERS + 32 || n_iter == 0) return;
        if (lane == 0) {
            mbar_expect_tx(own_full, own * 2 * T * 2);
            for (int w = 0; w < own; ++w)
                load_pair<D>(ks + w * T, vs + w * T, &tk, &tv, own_full, kh,
                             k0 + w * OWN, b);
        }
        for (int it = 0; it < n_iter; ++it) {
            const int s = it % STAGES;
            const int hh = kh * G + it / per_head;
            const int q0 = (first + it % per_head) * STEP;
            // the stage's previous step released (passes at once on a
            // stage's first use)
            mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            if (lane == 0) {
                mbar_expect_tx(&full[s], 2 * T * 2);
                load_pair<D>(qs + s * T, dos + s * T, &tq, &tdo, &full[s], hh,
                             q0, b);
            }
            const size_t row = ((size_t)b * H + hh) * Sq;
            for (int i = lane; i < STEP; i += 32) {
                const int qi = q0 + i;
                lse_s[s * STEP + i] = qi < Sq ? lse[row + qi] * LOG2E : 0.f;
                del_s[s * STEP + i] = qi < Sq ? delta[row + qi] : 0.f;
            }
            mbar_arrive(&full[s]);
        }
        return;
    }

    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x >> 7;
    if (wg >= own) {  // no keys: release each stage as it fills
        for (int it = 0; it < n_iter; ++it) {
            mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
            mbar_arrive(&empty[it % STAGES]);
        }
        return;
    }

    // a consumer warpgroup: thread (warp, lane) holds key rows r0 and r0 + 8
    // of its 64, query columns cq and cq + 1 of every 8-column block
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int r0 = warp * 16 + (lane >> 2);
    const int cq = 2 * (lane & 3);
    const int kw0 = k0 + wg * OWN;  // this warpgroup's first key
    const int key0 = kw0 + r0;
    const int key1 = key0 + 8;
    const bf16* kt = ks + wg * T;
    const bf16* vt = vs + wg * T;

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    if (n_iter > 0) mbar_wait(own_full, 0);
    for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const int q0 = (first + it % per_head) * STEP;
        const bf16* qt = qs + s * T;
        const bf16* dot = dos + s * T;
        const float* ls = lse_s + s * STEP;
        const float* ds = del_s + s * STEP;
        // a step that crosses Sk, Sq or the diagonal tests positions (one
        // wholly above the diagonal, for the second warpgroup, gives 0)
        const bool edge = kw0 + OWN > Sk || q0 + STEP > Sq
                          || (causal && kw0 + OWN - 1 > q_offset + q0);
        mbar_wait(&full[s], (it / STAGES) & 1);

        // S^T = K Q^T, dP^T = V dO^T (64 keys x 64 queries, f32)
        float st[STEP / 2], dpt[STEP / 2];
        product_ss<D>(st, kt, qt);
        product_ss<D>(dpt, vt, dot);
        // this thread's queries' lse * log2 e, read while the products run
        float2 l[STEP / 8];
#pragma unroll
        for (int j = 0; j < STEP / 8; ++j)
            l[j] = *reinterpret_cast<const float2*>(ls + 8 * j + cq);
        wgmma_wait<0>();
        fence_regs<STEP / 2>(st);
        fence_regs<STEP / 2>(dpt);

        // P^T = exp2(S^T scale log2 e - lse log2 e), masked pairs 0, and
        // dS^T = P^T (dP^T - delta), rounded to bf16 into the A fragments
        // of dV += P^T dO and dK += dS^T Q
        uint32_t pa[STEP / 16][4], sa[STEP / 16][4];
#pragma unroll
        for (int j = 0; j < STEP / 8; ++j) {
            const float2 dl = *reinterpret_cast<const float2*>(ds + 8 * j + cq);
            float p[4], d[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = ex2(st[4 * j + e] * scale_log2
                              - ((e & 1) ? l[j].y : l[j].x));
                if (edge) {
                    const int key = e < 2 ? key0 : key1;
                    const int query = q0 + 8 * j + cq + (e & 1);
                    if (key >= Sk || query >= Sq
                        || (causal && key > q_offset + query))
                        x = 0.f;
                }
                p[e] = x;
                d[e] = x * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x));
            }
            put_a(pa, j, 0, p[0], p[1]);
            put_a(pa, j, 1, p[2], p[3]);
            put_a(sa, j, 0, d[0], d[1]);
            put_a(sa, j, 1, d[2], d[3]);
        }

        // dV += P^T dO, dK += dS^T Q (k over the step's 64 queries)
        fence_regs<D / 2>(dva);
        fence_regs<D / 2>(dka);
        fence_regs<STEP / 4>(&pa[0][0]);
        fence_regs<STEP / 4>(&sa[0][0]);
        wgmma_fence();
        product_rs<D>(dva, pa, dot);
        product_rs<D>(dka, sa, qt);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(dva);
        fence_regs<D / 2>(dka);
        fence_regs<STEP / 4>(&pa[0][0]);  // read by the products until done
        fence_regs<STEP / 4>(&sa[0][0]);
        mbar_arrive(&empty[s]);  // this thread is done with the stage
    }

    const size_t kv_row = (size_t)K * D;
    bf16* dkb = dk + (size_t)b * Sk * kv_row + (size_t)kh * D;
    bf16* dvb = dv + (size_t)b * Sk * kv_row + (size_t)kh * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + cq;
        if (key0 < Sk) {
            *reinterpret_cast<__nv_bfloat162*>(dkb + key0 * kv_row + col) =
                __floats2bfloat162_rn(dka[4 * j] * scale, dka[4 * j + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(dvb + key0 * kv_row + col) =
                __floats2bfloat162_rn(dva[4 * j], dva[4 * j + 1]);
        }
        if (key1 < Sk) {
            *reinterpret_cast<__nv_bfloat162*>(dkb + key1 * kv_row + col) =
                __floats2bfloat162_rn(dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
            *reinterpret_cast<__nv_bfloat162*>(dvb + key1 * kv_row + col) =
                __floats2bfloat162_rn(dva[4 * j + 2], dva[4 * j + 3]);
        }
    }
}

// dQ and delta (the first launch): a block per (batch * H + head,
// 128-query tile)
template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tq,   // (B, Sq, H, D)
    const __grid_constant__ CUtensorMap tk,   // (B, Sk, K, D)
    const __grid_constant__ CUtensorMap tv,   // (B, Sk, K, D)
    const __grid_constant__ CUtensorMap tdo,  // (B, Sq, H, D)
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Sk, int H, int K, int causal,
    int q_offset, float scale, float scale_log2) {
    using P = Plan<D, false>;
    constexpr int STAGES = P::STAGES;
    constexpr int T = 64 * D;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    bf16* qs = reinterpret_cast<bf16*>(smem + P::OWN_A);
    bf16* dos = reinterpret_cast<bf16*>(smem + P::OWN_B);
    bf16* ks = reinterpret_cast<bf16*>(smem + P::RING_A);
    bf16* vs = reinterpret_cast<bf16*>(smem + P::RING_B);
    uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + P::BAR);
    uint64_t* full = own_full + 1;
    uint64_t* empty = full + STAGES;

    const int b = blockIdx.x / H;
    const int h = blockIdx.x - b * H;
    const int kh = h / (H / K);
    // causal: the query tiles with the most keys first
    const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
    const int q0 = tile * WGS * OWN;
    // keys the block attends: up to its last real row's position
    const int last = min(q0 + WGS * OWN, Sq) - 1;
    const int kend = causal ? min(Sk, q_offset + last + 1) : Sk;
    const int n_iter = (kend + STEP - 1) / STEP;
    const int own = min(WGS, (Sq - q0 + OWN - 1) / OWN);  // warpgroups with queries

    if (threadIdx.x == 0) {
        mbar_init(own_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: one thread
        setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x == CONSUMERS) {
            mbar_expect_tx(own_full, own * 2 * T * 2);
            for (int w = 0; w < own; ++w)
                load_pair<D>(qs + w * T, dos + w * T, &tq, &tdo, own_full, h,
                             q0 + w * OWN, b);
            for (int it = 0; it < n_iter; ++it) {
                const int s = it % STAGES;
                mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
                mbar_expect_tx(&full[s], 2 * T * 2);
                load_pair<D>(ks + s * T, vs + s * T, &tk, &tv, &full[s], kh,
                             it * STEP, b);
            }
        }
        return;
    }

    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x >> 7;
    if (wg >= own) {  // no queries: release each stage as it fills
        for (int it = 0; it < n_iter; ++it) {
            mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
            mbar_arrive(&empty[it % STAGES]);
        }
        return;
    }

    // a consumer warpgroup: thread (warp, lane) holds query rows r0 and
    // r0 + 8 of its 64, key columns cq and cq + 1 of every 8-column block
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int r0 = warp * 16 + (lane >> 2);
    const int cq = 2 * (lane & 3);
    const int qw0 = q0 + wg * OWN;  // this warpgroup's first query
    const int row0 = qw0 + r0;
    const int row1 = row0 + 8;
    const bf16* qt = qs + wg * T;
    const bf16* dot = dos + wg * T;
    // lse * log2 e and delta = rowsum(dO * O) of this thread's two rows;
    // the four threads of a quad each sum a quarter of a row's columns,
    // added by a fixed shuffle tree, and the first writes delta for the
    // dK/dV kernel
    float lse2[2], del[2];
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
        const int i = row0 + hlf * 8;
        const size_t at = ((size_t)b * H + h) * Sq + i;
        float acc = 0.f;
        if (i < Sq) {
            const size_t row = ((size_t)b * Sq + i) * H * D + (size_t)h * D
                               + (lane & 3) * (D / 4);
#pragma unroll
            for (int c = 0; c < D / 4; c += 8) {
                const uint4 x = *reinterpret_cast<const uint4*>(o + row + c);
                const uint4 y = *reinterpret_cast<const uint4*>(dout + row + c);
                const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
                const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const float2 u = __bfloat1622float2(x2[k]);
                    const float2 w = __bfloat1622float2(y2[k]);
                    acc = fmaf(u.x, w.x, acc);
                    acc = fmaf(u.y, w.y, acc);
                }
            }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        del[hlf] = acc;
        if (i < Sq && (lane & 3) == 0) delta[at] = acc;
        lse2[hlf] = i < Sq ? lse[at] * LOG2E : 0.f;
    }

    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    fence_regs<D / 2>(dqa);
    // dS in bf16, the A operand of dQ's product: two sets, a step's and
    // the one before it (wgmma reads registers while it runs)
    uint32_t sa[2][STEP / 16][4];

    // dQ += dS K over the 64 keys of stage s_
    auto product = [&](uint32_t (*sa_)[4], int s_) {
        fence_regs<D / 2>(dqa);
        wgmma_fence();
        product_rs<D>(dqa, sa_, ks + s_ * T);
        wgmma_commit();
    };
    auto retire = [&](uint32_t (*sa_)[4], int s_) {
        fence_regs<D / 2>(dqa);
        fence_regs<STEP / 4>(&sa_[0][0]);
        mbar_arrive(&empty[s_]);  // this thread is done with the stage
    };
    // one step: S and dP, the last step's product behind them, dS into sc
    auto step = [&](int it, uint32_t (*sc)[4], uint32_t (*sp)[4]) {
        const int s = it % STAGES;
        const int kt0 = it * STEP;
        // a step that crosses Sk, Sq or the diagonal tests positions (one
        // wholly above the diagonal, for the first warpgroup, gives 0)
        const bool edge = kt0 + STEP > Sk || qw0 + OWN > Sq
                          || (causal && kt0 + STEP - 1 > q_offset + qw0);
        mbar_wait(&full[s], (it / STAGES) & 1);
        // S = Q K^T, then P in place; dP = dO V^T (64 queries x 64 keys)
        float pr[STEP / 2], dp[STEP / 2];
        product_ss<D>(pr, qt, ks + s * T);
        product_ss<D>(dp, dot, vs + s * T);
        if (it > 0) {
            product(sp, (it - 1) % STAGES);
            wgmma_wait<2>();
        } else {
            wgmma_wait<1>();
        }
        fence_regs<STEP / 2>(pr);

        // P = exp2(S scale log2 e - lse log2 e), masked pairs 0, while dP
        // runs
#pragma unroll
        for (int j = 0; j < STEP / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int hlf = e >> 1;
                float x = ex2(pr[4 * j + e] * scale_log2 - lse2[hlf]);
                if (edge) {
                    const int query = row0 + hlf * 8;
                    const int key = kt0 + 8 * j + cq + (e & 1);
                    if (key >= Sk || query >= Sq
                        || (causal && key > q_offset + query))
                        x = 0.f;
                }
                pr[4 * j + e] = x;
            }
        }
        // dS = P (dP - delta), rounded into the A fragments of dQ += dS K
        if (it > 0)
            wgmma_wait<1>();
        else
            wgmma_wait<0>();
        fence_regs<STEP / 2>(dp);
#pragma unroll
        for (int j = 0; j < STEP / 8; ++j) {
            put_a(sc, j, 0, pr[4 * j] * (dp[4 * j] - del[0]),
                  pr[4 * j + 1] * (dp[4 * j + 1] - del[0]));
            put_a(sc, j, 1, pr[4 * j + 2] * (dp[4 * j + 2] - del[1]),
                  pr[4 * j + 3] * (dp[4 * j + 3] - del[1]));
        }
        if (it > 0) {
            wgmma_wait<0>();
            retire(sp, (it - 1) % STAGES);
        }
    };

    mbar_wait(own_full, 0);
    for (int it = 0; it < n_iter; it += 2) {
        step(it, sa[0], sa[1]);
        if (it + 1 < n_iter) step(it + 1, sa[1], sa[0]);
    }
    {  // the last step's product
        const int s = (n_iter - 1) % STAGES;
        if ((n_iter - 1) & 1) {
            product(sa[1], s);
            wgmma_wait<0>();
            retire(sa[1], s);
        } else {
            product(sa[0], s);
            wgmma_wait<0>();
            retire(sa[0], s);
        }
    }

    const size_t q_row = (size_t)H * D;
    bf16* dqb = dq + (size_t)b * Sq * q_row + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + cq;
        if (row0 < Sq)
            *reinterpret_cast<__nv_bfloat162*>(dqb + row0 * q_row + col) =
                __floats2bfloat162_rn(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);
        if (row1 < Sq)
            *reinterpret_cast<__nv_bfloat162*>(dqb + row1 * q_row + col) =
                __floats2bfloat162_rn(dqa[4 * j + 2] * scale, dqa[4 * j + 3] * scale);
    }
}

template <int D>
static int launch(const bf16* q, const bf16* k, const bf16* v,
                  const bf16* o, const bf16* dout, const float* lse,
                  float* delta, bf16* dq, bf16* dk, bf16* dv, int B, int Sq,
                  int Sk, int H, int K, int causal, int q_offset, float scale,
                  cudaStream_t stream) {
    CUtensorMap tq, tk, tv, tdo;
    int e = make_map(&tq, q, B, Sq, H, D, 64);
    if (!e) e = make_map(&tdo, dout, B, Sq, H, D, 64);
    if (!e) e = make_map(&tk, k, B, Sk, K, D, 64);
    if (!e) e = make_map(&tv, v, B, Sk, K, D, 64);
    if (e) return e;
    constexpr int KV_SMEM = Plan<D, true>::SMEM;
    constexpr int Q_SMEM = Plan<D, false>::SMEM;
    constexpr int BLOCK_ROWS = WGS * OWN;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        KV_SMEM);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            flash_bwd_dq_kernel<D>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, Q_SMEM);
    if (err != cudaSuccess) return (int)err;

    const float scale_log2 = scale * LOG2E;
    // dQ first: it writes delta, which dK/dV reads
    const dim3 q_grid(B * H, (Sq + BLOCK_ROWS - 1) / BLOCK_ROWS);
    flash_bwd_dq_kernel<D><<<q_grid, THREADS, Q_SMEM, stream>>>(
        tq, tk, tv, tdo, o, dout, lse, delta, dq, Sq, Sk, H, K, causal,
        q_offset, scale, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 kv_grid(B * K, (Sk + BLOCK_ROWS - 1) / BLOCK_ROWS);
    flash_bwd_dkdv_kernel<D><<<kv_grid, THREADS, KV_SMEM, stream>>>(
        tq, tk, tv, tdo, lse, delta, dk, dv, Sq, Sk, H, K, causal, q_offset,
        scale, scale_log2);
    return (int)cudaGetLastError();
}

// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, K, D); all bf16,
// contiguous and 16-byte aligned; lse and the scratch delta (B, H, Sq) f32.
// D must be 64 or 128 and K must divide H (the wrapper checks both, and
// pads narrower heads).
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
