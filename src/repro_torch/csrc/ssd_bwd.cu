// Backward of the Mamba2 SSD for Hopper (sm_90a): the gradients of ssd.cu's
// y and hT, for training the hybrid family (zamba2-1.2b).
//
// Replaces: no TPU kernel. repro/kernels/ssd.py, ssd (_ssd_kernel) is
// forward only; the JAX package differentiates the XLA form of the SSD
// (repro/kernels/ops.py:534-585). This is the backward of the port of that
// kernel.
//
// The forward, per batch row b, head h and chunk (l the inclusive cumsum of
// dt A within it, L its last value, H the state entering it, G = C B^T,
// E_ij = exp(l_i - l_j) for j <= i, M = G E dt_j):
//   y_i = sum_j M_ij x_j + exp(l_i) C_i H^T + D x_i
//   H'  = exp(L) H + sum_j w_j x_j B_j^T,   w_j = exp(L - l_j) dt_j.
// Its transposes, from dy (bf16) and dhT (f32 or null):
//   (a) the state's gradient, chunks in reverse: dH_c = exp(L_c) dH_{c+1}
//       + sum_i exp(l_i) dy_i^T C_i (dH_{chunks} = dhT; dh0 = dH_0);
//   (b) per chunk and head, with dHn = dH_{c+1} the exiting state's
//       gradient and dM_ij = dy_i . x_j, dG = dM E dt_j, R = dM M:
//       dx_j = sum_i M_ij dy_i + w_j dHn B_j + D dy_j
//       dB_j = sum_i dG_ij C_i + w_j dHn^T x_j     (summed over heads)
//       dC_i = sum_j dG_ij B_j + q_i, q_i = exp(l_i) dy_i H  (over heads)
//       ddt_j = sum_i dM_ij G_ij E_ij + (x_j . dHn B_j) exp(L - l_j)
//               + A sum_{k >= j} dl_k
//       dl_i = sum_j R_ij - sum_k R_ki + C_i . q_i - (x_i . dHn B_i) w_i
//              (+ dL at the last step: exp(L) dHn . H + sum_j (x_j . dHn
//              B_j) w_j)
//       dA = sum dt_k sum_{k' >= k} dl_k',  dD = sum dy . x.
//
// What bounds it on this card: at zamba2's training shape (B 2, S 2048, Hs
// 64, P 64, N 64, chunk 256) the algorithm's work is ~26 GFLOP a call (per
// head four products on the causal triangle, 64 deep, and four (c, P, N)
// products with the states; C B^T once for all heads): 0.026 ms at the
// bf16 tensor-core peak; it reads x, dy, dt, B, C and the forward's scratch
// (~87 MB) and writes dx, ddt, dB, dC, dA, dD, dh0 (~36 MB): 0.037 ms, so
// bytes bound it. The first design ran every product on the f32 units (0.39
// ms at their 67 TFLOP/s), walked the causal triangle twice (G and dM formed
// in both walks, whole tiles on the diagonal), walked the chunks of a head
// serially in one block, and wrote per-head f32 partials of dB and dC
// (~268 MB with their second read): 3.31 ms on the H100 (PERF.md section 6,
// row 6b).
//
// Design: three launches.
// - (a) ssd_bwd_state_kernel, grid (chunks, Hs, B), 8 warps: the forward's
//   phase (a) + (b) split, transposed. Each block forms its chunk's local
//   part sum_i (exp(l_i) dy_i)^T C_i on the tensor cores (64-step tiles,
//   exp(l) dy split into bf16 hi + lo, warp w: 16 rows of p, half of n),
//   the chunk's dy and C rows staged with cp.async; the head's block that
//   arrives last (an integer counter, as ssd.cu's) walks the chunks in
//   reverse, dH_c = exp(L_c) dH_{c+1} + local_c, elementwise, writing each
//   chunk's dHn over its local part and dh0 at the end.
// - (b) ssd_bwd_kernel, grid (chunks, head groups of HG = 4, B), 8 warps,
//   launched as a programmatic dependent of (a): it stages B and C of the
//   chunk once, and x and dy of its first head, while (a) runs, and waits
//   for (a) (griddepcontrol.wait) only before it reads dHn. Per head, one
//   walk of the causal triangle by key tile J, query tiles I >= J inside.
//   Warp w owns rows j 16 (w % 4) .. of the key tile and the half w / 4 of
//   the query tile's 64 columns i. Per tile pair, on the tensor cores
//   (mma.sync m16n8k16, bf16 in, f32 out): G^T = B_J C_I^T and dM^T =
//   x_J dy_I^T once (two bf16 operands each); the decay, the mask and the
//   products M^T, dG^T, R elementwise on their accumulators; then dx_J +=
//   M^T dy_I and dB_J += dG^T C_I with M^T, dG^T split into bf16 hi + lo
//   as the A fragments straight from those accumulators. dG^T goes to
//   shared memory as hi + lo; after one barrier each warp forms its 16
//   rows i x half of n of dC_I += dG B_J (A by ldmatrix.trans), skipping
//   key steps above the diagonal; at the diagonal the same warps add the
//   carried state's read q_I = exp(l_i) dy_I H (H as hi + lo). Warps whose
//   rows j lie wholly above the diagonal skip the pair. The exiting state's
//   terms (w_j dHn B_j into dx, w_j x_j dHn into dB) start each key tile,
//   half the warps each. The two column halves' dx and dB partials are
//   added in half order through shared memory at the end of a key tile.
// - Sums over heads: the block's heads add dB and dC in head order into
//   one f32 partial per head group (B, Hs / 4, S, N), read and written by
//   the thread that owns the element (the first head stores), so the
//   partials are a quarter of per-head ones; the next head's x and dy
//   tiles are copied (cp.async) as soon as the walk is past them. dl and
//   ddt's parts are kept per row in shared memory, each written by one
//   owner, and summed per row in a fixed order; the reverse cumsum of dl is
//   one warp's (8 rows a lane, then the lanes to the right by a fixed
//   shuffle scan).
// - (c) fixed_sum_kernel (fixed_sum.cuh): dB and dC add their head groups'
//   partials in group order and round to bf16; dA and dD per (batch row,
//   head, chunk), added in batch-row then chunk order.
// - f32 contract as the forward's (ssd.cu): bf16 x bf16 products exact
//   with f32 sums (G, dM); every f32 operand split into hi + lo (~16 bits
//   each): M, dG, exp(l) dy, H and dHn.
// - No floating-point atomics: every sum has one order, fixed by the
//   shapes, so the same inputs give the same bits on every run.
// - Ragged tail: rows past the chunk's real steps are zeros in every staged
//   operand, and masked out of the decays; nothing of them is stored. P
//   and N multiples of 8 up to 64 (columns past them zeros), chunk up to
//   256.
// - The decays of the triangle come from the fast exponential (ex2.approx
//   of x log2 e, relative error ~1e-5 at |x| 100); the group partials' old
//   values are all loaded before any is stored (interleaved, each load
//   waits on the store before it).
// - Measured on the H100 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
//   section 6, row 6b): 0.599 ms a call (state pass 0.049, products 0.531,
//   sums 0.019) against the first design's 3.314 timed beside it
//   (tools/ssm_bwd_digest.py). Left out one at a time
//   (tools/ssm_bwd_variants.py): the dC phase 0.140 ms, the dx and dB
//   products 0.084, the exiting state's terms 0.062, G and dM 0.043; with no
//   product at all the products launch still takes 0.20 ms (staging, the
//   decays and masks, the barriers, the sums), at one block of 8 warps an
//   SM (215 KB of shared memory, 233 registers a thread).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_sum.cuh"
#include "mma.cuh"

#define THREADS 256   // 8 warps in both kernels
#define TT 64         // rows (steps) of a tile
#define LD 72         // bf16 row of a staged tile: 64 + 8
#define MAXW 64       // the most P and N
#define MAXC 256      // the most steps of a chunk
#define HG 4          // heads of a products block

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float2 ld_f2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the sum over the 4 lanes of a quad (equal g), the same in each
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ void zero4(float (*a)[4], int n) {
    for (int i = 0; i < n; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

// rows [r0, r1) of the chunk of a (rows, width) bf16 matrix into a (rows,
// LD) tile by cp.async, 16 bytes a copy; rows at or past nt and columns
// past width zeros. `src` points at row 0 of the chunk's batch row plus the
// head's offset; a row is `stride` elements.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           size_t stride, int width,
                                           int nt, int r0, int r1) {
    for (int idx = threadIdx.x + r0 * 8; idx < r1 * 8; idx += THREADS) {
        const int r = idx >> 3;
        const int cc = (idx & 7) * 8;
        const bool ok = r < nt && cc < width;
        cp_async16_zfill(dst + r * LD + cc,
                         ok ? src + (size_t)r * stride + cc : src, ok);
    }
}

// ---------------------------------------------------------------------------
// (a) the chunks' local parts in parallel, then the state's gradient passed
//     over the chunks in reverse by the head's last block
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 2) ssd_bwd_state_kernel(
    const bf16* __restrict__ dy,      // (B, S, Hs, P)
    const bf16* __restrict__ C,       // (B, S, N)
    const float* __restrict__ lbuf,   // (B, Hs, chunks * c)
    const float* __restrict__ decay,  // (B, Hs, chunks): L
    const float* __restrict__ dhT,    // (B, Hs, P, N) or null
    float* __restrict__ dHn,          // (B, Hs, chunks, P, N)
    float* __restrict__ dh0,          // (B, Hs, P, N)
    unsigned int* __restrict__ counters,  // (B * Hs), zero between launches
    int S, int Hs, int P, int N, int c) {
    const int ck = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int n_chunks = gridDim.x;
    const int t0 = ck * c, nt = min(c, S - t0);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3, m = lane >> 3;
    const int CT = (c + TT - 1) / TT * TT;
    // the products launch may start now: it stages its inputs while this
    // grid runs, and waits for its completion before it reads dHn
    asm volatile("griddepcontrol.launch_dependents;");

    extern __shared__ __align__(16) unsigned char smem[];
    bf16* ys = reinterpret_cast<bf16*>(smem);  // (CT, LD) dy rows of the head
    bf16* cs = ys + CT * LD;                   // (CT, LD) C rows
    bf16* yh = cs + CT * LD;                   // (TT, LD) a tile's e dy, hi
    bf16* yl = yh + TT * LD;                   // (TT, LD) e dy, lo
    float* es = reinterpret_cast<float*>(yl + TT * LD);  // (CT,) exp(l)
    __shared__ int last;

    const size_t row0 = (size_t)b * S + t0;
    const size_t head = (size_t)b * Hs + h;
    stage_rows(ys, dy + row0 * Hs * P + (size_t)h * P, (size_t)Hs * P, P, nt,
               0, CT);
    stage_rows(cs, C + row0 * N, N, N, nt, 0, CT);
    cp_async_commit();
    const float* lrow = lbuf + (head * n_chunks + ck) * c;
    for (int r = tid; r < CT; r += THREADS) es[r] = r < nt ? expf(lrow[r]) : 0.f;
    cp_async_wait<0>();
    __syncthreads();

    // local = (e dy)^T C: M = p (warp w: rows 16 (w % 4)..), N = n (the
    // half w / 4), K = steps; both operands from row-major (step, *) tiles
    // through ldmatrix.trans, as the forward's S_c
    const int wp = 16 * (warp & 3);
    const int nh = warp >> 2;
    float acc[MAXW / 16][4];
    zero4(acc, MAXW / 16);
    for (int k0 = 0; k0 < nt; k0 += TT) {
#pragma unroll
        for (int q = 0; q < TT * 8 / THREADS; ++q) {
            const int idx = tid + q * THREADS;
            const int r = idx >> 3;
            const int cc = (idx & 7) * 8;
            const float e = es[k0 + r];
            const uint4 raw = *reinterpret_cast<const uint4*>(ys + (k0 + r) * LD + cc);
            const bf16* v = reinterpret_cast<const bf16*>(&raw);
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
                split_bf16(__bfloat162float(v[2 * u]) * e,
                           __bfloat162float(v[2 * u + 1]) * e, hi[u], lo[u]);
            *reinterpret_cast<uint4*>(yh + r * LD + cc) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
            *reinterpret_cast<uint4*>(yl + r * LD + cc) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
        __syncthreads();
        if (wp < P && 32 * nh < N) {
#pragma unroll
            for (int ks = 0; ks < TT / 16; ++ks) {
                uint32_t ah[4], al[4];
                const int ar = 16 * ks + 8 * (m >> 1) + (lane & 7);
                const int ac = wp + 8 * (m & 1);
                ldsm_x4_trans(ah, yh + ar * LD + ac);
                ldsm_x4_trans(al, yl + ar * LD + ac);
                const bf16* crow = cs + (k0 + 16 * ks + 8 * (m & 1) + (lane & 7)) * LD
                                   + 32 * nh + 8 * (m >> 1);
#pragma unroll
                for (int dp = 0; dp < 2; ++dp) {
                    if (32 * nh + 16 * dp < N) {
                        uint32_t bfr[4];
                        ldsm_x4_trans(bfr, crow + 16 * dp);
                        mma16816(acc[2 * dp], ah[0], ah[1], ah[2], ah[3], bfr[0], bfr[1]);
                        mma16816(acc[2 * dp], al[0], al[1], al[2], al[3], bfr[0], bfr[1]);
                        mma16816(acc[2 * dp + 1], ah[0], ah[1], ah[2], ah[3], bfr[2], bfr[3]);
                        mma16816(acc[2 * dp + 1], al[0], al[1], al[2], al[3], bfr[2], bfr[3]);
                    }
                }
            }
        }
        __syncthreads();  // yh, yl are rewritten next
    }
    float* loc = dHn + (head * n_chunks + ck) * P * N;
#pragma unroll
    for (int j = 0; j < MAXW / 16; ++j) {
        const int n = 32 * nh + 8 * j + 2 * t;
        const int p0 = wp + g;
        if (n < N) {
            if (p0 < P)
                *reinterpret_cast<float2*>(loc + (size_t)p0 * N + n) =
                    make_float2(acc[j][0], acc[j][1]);
            if (p0 + 8 < P)
                *reinterpret_cast<float2*>(loc + (size_t)(p0 + 8) * N + n) =
                    make_float2(acc[j][2], acc[j][3]);
        }
    }

    // the head's last block to finish passes the gradient in reverse
    __threadfence();
    __syncthreads();
    if (tid == 0)
        last = atomicAdd(&counters[head], 1u) == (unsigned int)(n_chunks - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    constexpr int PV = MAXW * MAXW / 4 / THREADS;  // float4s a thread
    const int PN = P * N;
    float* st = dHn + head * n_chunks * PN;
    float4 H[PV];
#pragma unroll
    for (int q = 0; q < PV; ++q) {
        const int e = 4 * (tid + q * THREADS);
        H[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < PN && dhT) H[q] = *reinterpret_cast<const float4*>(dhT + head * PN + e);
    }
    for (int k = n_chunks - 1; k >= 0; --k) {
        const float f = expf(__ldcg(decay + head * n_chunks + k));
        float4 sv[PV];
#pragma unroll
        for (int q = 0; q < PV; ++q) {
            const int e = 4 * (tid + q * THREADS);
            if (e < PN) sv[q] = __ldcg(reinterpret_cast<const float4*>(st + k * PN + e));
        }
#pragma unroll
        for (int q = 0; q < PV; ++q) {
            const int e = 4 * (tid + q * THREADS);
            if (e < PN) {
                // the exiting state's gradient of chunk k, over its local part
                __stcg(reinterpret_cast<float4*>(st + k * PN + e), H[q]);
                H[q].x = fmaf(f, H[q].x, sv[q].x);
                H[q].y = fmaf(f, H[q].y, sv[q].y);
                H[q].z = fmaf(f, H[q].z, sv[q].z);
                H[q].w = fmaf(f, H[q].w, sv[q].w);
            }
        }
    }
#pragma unroll
    for (int q = 0; q < PV; ++q) {
        const int e = 4 * (tid + q * THREADS);
        if (e < PN) *reinterpret_cast<float4*>(dh0 + head * PN + e) = H[q];
    }
    if (tid == 0) counters[head] = 0u;
}

// ---------------------------------------------------------------------------
// (b) per (chunk, head group, batch row): the transposed products
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_kernel(
    const bf16* __restrict__ x,       // (B, S, Hs, P)
    const bf16* __restrict__ dt,      // (B, S, Hs)
    const float* __restrict__ A,      // (Hs,)
    const bf16* __restrict__ Bm,      // (B, S, N)
    const bf16* __restrict__ C,       // (B, S, N)
    const float* __restrict__ D,      // (Hs,)
    const bf16* __restrict__ dy,      // (B, S, Hs, P)
    const float* __restrict__ lbuf,   // (B, Hs, chunks * c)
    const float* __restrict__ states, // (B, Hs, chunks, P, N): H entering
    const float* __restrict__ decay,  // (B, Hs, chunks): L
    const float* __restrict__ dHn,    // (B, Hs, chunks, P, N), from (a)
    bf16* __restrict__ dx,            // (B, S, Hs, P)
    bf16* __restrict__ ddt,           // (B, S, Hs)
    float* __restrict__ pB,           // (B, groups, S, N): dB of a group
    float* __restrict__ pC,           // (B, groups, S, N): dC of a group
    float* __restrict__ pA,           // (B, Hs, chunks): dA of a chunk
    float* __restrict__ pD,           // (B, Hs, chunks): dD of a chunk
    int S, int Hs, int P, int N, int c) {
    const int ck = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
    const int n_chunks = gridDim.x, groups = gridDim.y;
    const int t0 = ck * c, nt = min(c, S - t0);
    const int nq = (nt + TT - 1) / TT;
    const int CT = (c + TT - 1) / TT * TT;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3, m = lane >> 3, lr = lane & 7;
    const int r = warp & 3;    // rows 16 r .. of a 64-row tile
    const int hf = warp >> 2;  // the half of the other index: 32 hf ..
    const size_t row0 = (size_t)b * S + t0;
    const size_t xstr = (size_t)Hs * P;

    extern __shared__ __align__(16) unsigned char smem[];
    bf16* bs = reinterpret_cast<bf16*>(smem);  // (CT, LD) B rows of the chunk
    bf16* cs = bs + CT * LD;                   // (CT, LD) C rows
    bf16* xs = cs + CT * LD;                   // (CT, LD) x rows of the head
    bf16* ys = xs + CT * LD;                   // (CT, LD) dy rows of the head
    bf16* hh = ys + CT * LD;                   // (TT, LD) H (p, n), hi
    bf16* hl = hh + TT * LD;                   // H, lo
    bf16* nhi = hl + TT * LD;                  // dHn (p, n), hi
    bf16* nlo = nhi + TT * LD;                 // dHn, lo
    bf16* gh = nlo + TT * LD;                  // (TT, LD) dG^T (j, i), hi
    bf16* gl = gh + TT * LD;                   // dG^T, lo
    float* ls = reinterpret_cast<float*>(gl + TT * LD);  // (CT,) l
    float* dts = ls + CT;       // (CT,) dt
    float* rowR = dts + CT;     // (CT,) sum_j R_ij, over the key tiles in order
    float* colR = rowR + CT;    // (2, CT) sum_i R_ij, a column half each
    float* colD = colR + 2 * CT;  // (2, CT) sum_i dM G E
    float* qd = colD + 2 * CT;  // (2, CT) C_i . q_i, an n half each
    float* wdw = qd + 2 * CT;   // (CT,) w_j (x_j . dHn B_j)
    float* ddS = wdw + CT;      // (CT,) exp(L - l_j) (x_j . dHn B_j)
    float* red = ddS + CT;      // (8, 32) a warp's column sums of R
    float* red2 = red + 8 * 32; // (8, 2) warps' sums for dL and dD
    float* comb = reinterpret_cast<float*>(gh);  // (32, 128) a half's partials

    // B and C of the chunk and x, dy of the first head in flight; the
    // group's heads: grp * HG .. (a ragged last group has fewer)
    const int h0 = grp * HG;
    const int nheads = min(HG, Hs - h0);
    stage_rows(bs, Bm + row0 * N, N, N, nt, 0, nq * TT);
    stage_rows(cs, C + row0 * N, N, N, nt, 0, nq * TT);
    stage_rows(xs, x + row0 * xstr + (size_t)h0 * P, xstr, P, nt, 0, nq * TT);
    stage_rows(ys, dy + row0 * xstr + (size_t)h0 * P, xstr, P, nt, 0, nq * TT);
    cp_async_commit();

    for (int hi_ = 0; hi_ < nheads; ++hi_) {
        const int h = h0 + hi_;
        const size_t head = (size_t)b * Hs + h;
        const float L = decay[head * n_chunks + ck];
        const float Ah = A[h], Dh = D[h];
        const float* lrow = lbuf + (head * n_chunks + ck) * c;
        if (hi_) __syncthreads();  // the last head's rows are read
        for (int i = tid; i < CT; i += THREADS) {
            const bool ok = i < nt;
            ls[i] = ok ? lrow[i] : 0.f;
            dts[i] = ok ? __bfloat162float(dt[(row0 + i) * Hs + h]) : 0.f;
            rowR[i] = wdw[i] = ddS[i] = 0.f;
            colR[i] = colR[CT + i] = colD[i] = colD[CT + i] = 0.f;
            qd[i] = qd[CT + i] = 0.f;
        }
        // dHn is the state launch's: wait for it (once; a no-op without a
        // programmatic launch)
        if (hi_ == 0) asm volatile("griddepcontrol.wait;" ::: "memory");
        // H and dHn as bf16 hi + lo (rows p, columns n; zeros past P, N);
        // this thread's part of dHn . H
        float hd = 0.f;
        {
            const float* Hc = states + (head * n_chunks + ck) * P * N;
            const float* dHc = dHn + (head * n_chunks + ck) * P * N;
#pragma unroll
            for (int q = 0; q < MAXW * MAXW / 4 / THREADS; ++q) {
                const int e = 4 * (tid + q * THREADS);
                const int p = e >> 6, n = e & 63;
                float4 hv = make_float4(0.f, 0.f, 0.f, 0.f), dv = hv;
                if (p < P && n < N) {
                    hv = *reinterpret_cast<const float4*>(Hc + p * N + n);
                    dv = __ldcg(reinterpret_cast<const float4*>(dHc + p * N + n));
                }
                hd = fmaf(hv.x, dv.x, hd);
                hd = fmaf(hv.y, dv.y, hd);
                hd = fmaf(hv.z, dv.z, hd);
                hd = fmaf(hv.w, dv.w, hd);
                uint2 a, a2;
                split_bf16(hv.x, hv.y, a.x, a2.x);
                split_bf16(hv.z, hv.w, a.y, a2.y);
                *reinterpret_cast<uint2*>(hh + p * LD + n) = a;
                *reinterpret_cast<uint2*>(hl + p * LD + n) = a2;
                split_bf16(dv.x, dv.y, a.x, a2.x);
                split_bf16(dv.z, dv.w, a.y, a2.y);
                *reinterpret_cast<uint2*>(nhi + p * LD + n) = a;
                *reinterpret_cast<uint2*>(nlo + p * LD + n) = a2;
            }
        }
        cp_async_wait<0>();
        __syncthreads();

        float dsum = 0.f;  // dy . x over this thread's positions
        for (int J = 0; J < nq; ++J) {
            const int jr = J * TT + 16 * r + g;  // this thread's rows j: jr, jr + 8
            // the key rows' A fragments: B_J (k = n) and x_J (k = p)
            uint32_t ba[MAXW / 16][4], xa[MAXW / 16][4];
#pragma unroll
            for (int kk = 0; kk < MAXW / 16; ++kk) {
                const int o = jr * LD + 16 * kk + 2 * t;
                if (16 * kk < N) {
                    ba[kk][0] = ld_u32(bs + o);
                    ba[kk][1] = ld_u32(bs + o + 8 * LD);
                    ba[kk][2] = ld_u32(bs + o + 8);
                    ba[kk][3] = ld_u32(bs + o + 8 * LD + 8);
                }
                if (16 * kk < P) {
                    xa[kk][0] = ld_u32(xs + o);
                    xa[kk][1] = ld_u32(xs + o + 8 * LD);
                    xa[kk][2] = ld_u32(xs + o + 8);
                    xa[kk][3] = ld_u32(xs + o + 8 * LD + 8);
                }
            }
            const float lj0 = ls[jr], lj1 = ls[jr + 8];
            const float dj0 = dts[jr], dj1 = dts[jr + 8];
            float dxa[MAXW / 8][4], dba[MAXW / 8][4];
            zero4(dxa, MAXW / 8);
            zero4(dba, MAXW / 8);

            // the exiting state's terms: half 0 v = B_j dHn^T (dx += w v +
            // D dy, and x_j . v), half 1 s = x_j dHn (dB += w s)
            {
                const float dec0 = jr < nt ? expf(L - lj0) : 0.f;
                const float dec1 = jr + 8 < nt ? expf(L - lj1) : 0.f;
                const float w0 = dec0 * dj0, w1 = dec1 * dj1;
                float sa[MAXW / 8][4];
                zero4(sa, MAXW / 8);
                if (hf == 0) {
#pragma unroll
                    for (int kk = 0; kk < MAXW / 16; ++kk) {
                        if (16 * kk >= N) continue;
#pragma unroll
                        for (int pb = 0; pb < MAXW / 8; ++pb) {
                            if (8 * pb >= P) continue;
                            const int o = (8 * pb + g) * LD + 16 * kk + 2 * t;
                            mma16816(sa[pb], ba[kk][0], ba[kk][1], ba[kk][2], ba[kk][3],
                                     ld_u32(nhi + o), ld_u32(nhi + o + 8));
                            mma16816(sa[pb], ba[kk][0], ba[kk][1], ba[kk][2], ba[kk][3],
                                     ld_u32(nlo + o), ld_u32(nlo + o + 8));
                        }
                    }
                    float dw0 = 0.f, dw1 = 0.f;
#pragma unroll
                    for (int pb = 0; pb < MAXW / 8; ++pb) {
                        const int p = 8 * pb + 2 * t;
                        if (p >= P) continue;
                        const float2 x0 = ld_f2(xs + jr * LD + p), x1 = ld_f2(xs + (jr + 8) * LD + p);
                        const float2 y0 = ld_f2(ys + jr * LD + p), y1 = ld_f2(ys + (jr + 8) * LD + p);
                        dw0 = fmaf(x0.x, sa[pb][0], dw0);
                        dw0 = fmaf(x0.y, sa[pb][1], dw0);
                        dw1 = fmaf(x1.x, sa[pb][2], dw1);
                        dw1 = fmaf(x1.y, sa[pb][3], dw1);
                        dsum = fmaf(y0.x, x0.x, dsum);
                        dsum = fmaf(y0.y, x0.y, dsum);
                        dsum = fmaf(y1.x, x1.x, dsum);
                        dsum = fmaf(y1.y, x1.y, dsum);
                        dxa[pb][0] = fmaf(w0, sa[pb][0], Dh * y0.x);
                        dxa[pb][1] = fmaf(w0, sa[pb][1], Dh * y0.y);
                        dxa[pb][2] = fmaf(w1, sa[pb][2], Dh * y1.x);
                        dxa[pb][3] = fmaf(w1, sa[pb][3], Dh * y1.y);
                    }
                    dw0 = quad_sum(dw0);
                    dw1 = quad_sum(dw1);
                    if (t == 0) {
                        if (jr < nt) {
                            wdw[jr] = dw0 * w0;
                            ddS[jr] = dw0 * dec0;
                        }
                        if (jr + 8 < nt) {
                            wdw[jr + 8] = dw1 * w1;
                            ddS[jr + 8] = dw1 * dec1;
                        }
                    }
                } else {
#pragma unroll
                    for (int ks = 0; ks < MAXW / 16; ++ks) {
                        if (16 * ks >= P) continue;
                        const int ro = (16 * ks + 8 * (m & 1) + lr) * LD + 8 * (m >> 1);
#pragma unroll
                        for (int dp = 0; dp < MAXW / 16; ++dp) {
                            if (16 * dp >= N) continue;
                            uint32_t f[4];
                            ldsm_x4_trans(f, nhi + ro + 16 * dp);
                            mma16816(sa[2 * dp], xa[ks][0], xa[ks][1], xa[ks][2], xa[ks][3], f[0], f[1]);
                            mma16816(sa[2 * dp + 1], xa[ks][0], xa[ks][1], xa[ks][2], xa[ks][3], f[2], f[3]);
                            ldsm_x4_trans(f, nlo + ro + 16 * dp);
                            mma16816(sa[2 * dp], xa[ks][0], xa[ks][1], xa[ks][2], xa[ks][3], f[0], f[1]);
                            mma16816(sa[2 * dp + 1], xa[ks][0], xa[ks][1], xa[ks][2], xa[ks][3], f[2], f[3]);
                        }
                    }
#pragma unroll
                    for (int nb = 0; nb < MAXW / 8; ++nb) {
                        dba[nb][0] = w0 * sa[nb][0];
                        dba[nb][1] = w0 * sa[nb][1];
                        dba[nb][2] = w1 * sa[nb][2];
                        dba[nb][3] = w1 * sa[nb][3];
                    }
                }
            }

            // the query tiles from the diagonal down
            float cd0 = 0.f, cd1 = 0.f, cl0 = 0.f, cl1 = 0.f;
            for (int I = J; I < nq; ++I) {
                const bool diag = I == J;
                const int ic = I * TT + 32 * hf;  // this warp's first column i
                if (!(diag && hf == 0 && r >= 2)) {
                    // G^T = B_J C_I^T and dM^T = x_J dy_I^T: rows j, columns
                    // i (this warp's 32)
                    float ga[4][4], sa[4][4];
                    zero4(ga, 4);
                    zero4(sa, 4);
#pragma unroll
                    for (int kk = 0; kk < MAXW / 16; ++kk) {
#pragma unroll
                        for (int nb = 0; nb < 4; ++nb) {
                            const int o = (ic + 8 * nb + g) * LD + 16 * kk + 2 * t;
                            if (16 * kk < N)
                                mma16816(ga[nb], ba[kk][0], ba[kk][1], ba[kk][2], ba[kk][3],
                                         ld_u32(cs + o), ld_u32(cs + o + 8));
                            if (16 * kk < P)
                                mma16816(sa[nb], xa[kk][0], xa[kk][1], xa[kk][2], xa[kk][3],
                                         ld_u32(ys + o), ld_u32(ys + o + 8));
                        }
                    }
                    // the decay and the mask; M^T, dG^T and R
                    float rs[4][2];
#pragma unroll
                    for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int i = ic + 8 * nb + 2 * t + e;
                            const float li = ls[i];
                            const bool ok0 = i < nt && i >= jr;
                            const bool ok1 = i < nt && i >= jr + 8;
                            const float E0 = ok0 ? __expf(li - lj0) : 0.f;
                            const float E1 = ok1 ? __expf(li - lj1) : 0.f;
                            const float gE0 = ga[nb][e] * E0, gE1 = ga[nb][2 + e] * E1;
                            const float M0 = gE0 * dj0, M1 = gE1 * dj1;
                            const float R0 = sa[nb][e] * M0, R1 = sa[nb][2 + e] * M1;
                            cd0 = fmaf(sa[nb][e], gE0, cd0);
                            cd1 = fmaf(sa[nb][2 + e], gE1, cd1);
                            cl0 += R0;
                            cl1 += R1;
                            rs[nb][e] = R0 + R1;
                            ga[nb][e] = M0;
                            ga[nb][2 + e] = M1;
                            sa[nb][e] = sa[nb][e] * E0 * dj0;
                            sa[nb][2 + e] = sa[nb][2 + e] * E1 * dj1;
                        }
                    }
                    // dx_J += M^T dy_I and dB_J += dG^T C_I, M^T and dG^T as
                    // bf16 hi + lo A fragments (k = i: two 16-column steps);
                    // dG^T to shared memory for dC
#pragma unroll
                    for (int ks = 0; ks < 2; ++ks) {
                        uint32_t mh[4], ml[4], dh[4], dl[4];
                        split_bf16(ga[2 * ks][0], ga[2 * ks][1], mh[0], ml[0]);
                        split_bf16(ga[2 * ks][2], ga[2 * ks][3], mh[1], ml[1]);
                        split_bf16(ga[2 * ks + 1][0], ga[2 * ks + 1][1], mh[2], ml[2]);
                        split_bf16(ga[2 * ks + 1][2], ga[2 * ks + 1][3], mh[3], ml[3]);
                        split_bf16(sa[2 * ks][0], sa[2 * ks][1], dh[0], dl[0]);
                        split_bf16(sa[2 * ks][2], sa[2 * ks][3], dh[1], dl[1]);
                        split_bf16(sa[2 * ks + 1][0], sa[2 * ks + 1][1], dh[2], dl[2]);
                        split_bf16(sa[2 * ks + 1][2], sa[2 * ks + 1][3], dh[3], dl[3]);
                        const int go = (16 * r + g) * LD + 32 * hf + 16 * ks + 2 * t;
                        *reinterpret_cast<uint32_t*>(gh + go) = dh[0];
                        *reinterpret_cast<uint32_t*>(gh + go + 8 * LD) = dh[1];
                        *reinterpret_cast<uint32_t*>(gh + go + 8) = dh[2];
                        *reinterpret_cast<uint32_t*>(gh + go + 8 * LD + 8) = dh[3];
                        *reinterpret_cast<uint32_t*>(gl + go) = dl[0];
                        *reinterpret_cast<uint32_t*>(gl + go + 8 * LD) = dl[1];
                        *reinterpret_cast<uint32_t*>(gl + go + 8) = dl[2];
                        *reinterpret_cast<uint32_t*>(gl + go + 8 * LD + 8) = dl[3];
                        // rows i of this step (k), columns p / n, transposed
                        const int ro = (ic + 16 * ks + 8 * (m & 1) + lr) * LD + 8 * (m >> 1);
#pragma unroll
                        for (int dp = 0; dp < MAXW / 16; ++dp) {
                            uint32_t f[4];
                            if (16 * dp < P) {
                                ldsm_x4_trans(f, ys + ro + 16 * dp);
                                mma16816(dxa[2 * dp], mh[0], mh[1], mh[2], mh[3], f[0], f[1]);
                                mma16816(dxa[2 * dp], ml[0], ml[1], ml[2], ml[3], f[0], f[1]);
                                mma16816(dxa[2 * dp + 1], mh[0], mh[1], mh[2], mh[3], f[2], f[3]);
                                mma16816(dxa[2 * dp + 1], ml[0], ml[1], ml[2], ml[3], f[2], f[3]);
                            }
                            if (16 * dp < N) {
                                ldsm_x4_trans(f, cs + ro + 16 * dp);
                                mma16816(dba[2 * dp], dh[0], dh[1], dh[2], dh[3], f[0], f[1]);
                                mma16816(dba[2 * dp], dl[0], dl[1], dl[2], dl[3], f[0], f[1]);
                                mma16816(dba[2 * dp + 1], dh[0], dh[1], dh[2], dh[3], f[2], f[3]);
                                mma16816(dba[2 * dp + 1], dl[0], dl[1], dl[2], dl[3], f[2], f[3]);
                            }
                        }
                    }
                    // R's sums over this warp's 16 rows j, per column i:
                    // rows g and g + 8, then the lanes of equal t in g order
#pragma unroll
                    for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            float v = rs[nb][e];
                            v += __shfl_xor_sync(0xffffffffu, v, 4);
                            v += __shfl_xor_sync(0xffffffffu, v, 8);
                            v += __shfl_xor_sync(0xffffffffu, v, 16);
                            if (g == 0) red[warp * 32 + 8 * nb + 2 * t + e] = v;
                        }
                    }
                } else if (g == 0) {
                    // rows wholly above the diagonal: no terms
#pragma unroll
                    for (int nb = 0; nb < 4; ++nb) {
                        red[warp * 32 + 8 * nb + 2 * t] = 0.f;
                        red[warp * 32 + 8 * nb + 2 * t + 1] = 0.f;
                    }
                }
                __syncthreads();  // dG^T and the column sums are written

                // rows i of the query tile (16 r .., n half hf): dC_I +=
                // dG B_J (key steps above the diagonal skipped), and at the
                // diagonal the carried state's read q = exp(l_i) dy_I H
                const int ir = I * TT + 16 * r + g;
                if (32 * hf < N) {
                    float* pc = pC + ((size_t)(b * groups + grp) * S + t0) * N;
                    const bool first = hi_ == 0 && J == 0;
                    float2 old[4][2];
#pragma unroll
                    for (int nb = 0; nb < 4; ++nb) {
                        const int n = 32 * hf + 8 * nb + 2 * t;
                        old[nb][0] = old[nb][1] = make_float2(0.f, 0.f);
                        if (!first && n < N) {
                            if (ir < nt) old[nb][0] = __ldcg(reinterpret_cast<const float2*>(pc + (size_t)ir * N + n));
                            if (ir + 8 < nt) old[nb][1] = __ldcg(reinterpret_cast<const float2*>(pc + (size_t)(ir + 8) * N + n));
                        }
                    }
                    float dca[4][4];
                    zero4(dca, 4);
#pragma unroll
                    for (int ks = 0; ks < 4; ++ks) {
                        if (diag && ks > r) continue;
                        uint32_t ah[4], al[4];
                        const int ao = (16 * ks + 8 * (m >> 1) + lr) * LD + 16 * r + 8 * (m & 1);
                        ldsm_x4_trans(ah, gh + ao);
                        ldsm_x4_trans(al, gl + ao);
                        const bf16* brow = bs + (J * TT + 16 * ks + 8 * (m & 1) + lr) * LD
                                           + 32 * hf + 8 * (m >> 1);
#pragma unroll
                        for (int dp = 0; dp < 2; ++dp) {
                            if (32 * hf + 16 * dp >= N) continue;
                            uint32_t f[4];
                            ldsm_x4_trans(f, brow + 16 * dp);
                            mma16816(dca[2 * dp], ah[0], ah[1], ah[2], ah[3], f[0], f[1]);
                            mma16816(dca[2 * dp], al[0], al[1], al[2], al[3], f[0], f[1]);
                            mma16816(dca[2 * dp + 1], ah[0], ah[1], ah[2], ah[3], f[2], f[3]);
                            mma16816(dca[2 * dp + 1], al[0], al[1], al[2], al[3], f[2], f[3]);
                        }
                    }
                    if (diag) {
                        float qa[4][4];
                        zero4(qa, 4);
#pragma unroll
                        for (int kk = 0; kk < MAXW / 16; ++kk) {
                            if (16 * kk >= P) continue;
                            const int o = ir * LD + 16 * kk + 2 * t;
                            const uint32_t a0 = ld_u32(ys + o), a1 = ld_u32(ys + o + 8 * LD),
                                           a2 = ld_u32(ys + o + 8), a3 = ld_u32(ys + o + 8 * LD + 8);
                            const int ho = (16 * kk + 8 * (m & 1) + lr) * LD + 32 * hf + 8 * (m >> 1);
#pragma unroll
                            for (int dp = 0; dp < 2; ++dp) {
                                if (32 * hf + 16 * dp >= N) continue;
                                uint32_t f[4];
                                ldsm_x4_trans(f, hh + ho + 16 * dp);
                                mma16816(qa[2 * dp], a0, a1, a2, a3, f[0], f[1]);
                                mma16816(qa[2 * dp + 1], a0, a1, a2, a3, f[2], f[3]);
                                ldsm_x4_trans(f, hl + ho + 16 * dp);
                                mma16816(qa[2 * dp], a0, a1, a2, a3, f[0], f[1]);
                                mma16816(qa[2 * dp + 1], a0, a1, a2, a3, f[2], f[3]);
                            }
                        }
                        const float e0 = ir < nt ? expf(ls[ir]) : 0.f;
                        const float e1 = ir + 8 < nt ? expf(ls[ir + 8]) : 0.f;
                        float c0 = 0.f, c1 = 0.f;
#pragma unroll
                        for (int nb = 0; nb < 4; ++nb) {
                            const int n = 32 * hf + 8 * nb + 2 * t;
                            if (n >= N) continue;
                            const float2 cv0 = ld_f2(cs + ir * LD + n), cv1 = ld_f2(cs + (ir + 8) * LD + n);
                            const float q0 = qa[nb][0] * e0, q1 = qa[nb][1] * e0;
                            const float q2 = qa[nb][2] * e1, q3 = qa[nb][3] * e1;
                            c0 = fmaf(cv0.x, q0, c0);
                            c0 = fmaf(cv0.y, q1, c0);
                            c1 = fmaf(cv1.x, q2, c1);
                            c1 = fmaf(cv1.y, q3, c1);
                            dca[nb][0] += q0;
                            dca[nb][1] += q1;
                            dca[nb][2] += q2;
                            dca[nb][3] += q3;
                        }
                        c0 = quad_sum(c0);
                        c1 = quad_sum(c1);
                        if (t == 0) {
                            qd[hf * CT + ir] = c0;
                            qd[hf * CT + ir + 8] = c1;
                        }
                    }
#pragma unroll
                    for (int nb = 0; nb < 4; ++nb) {
                        const int n = 32 * hf + 8 * nb + 2 * t;
                        if (n >= N) continue;
                        if (ir < nt)
                            __stcg(reinterpret_cast<float2*>(pc + (size_t)ir * N + n),
                                   make_float2(old[nb][0].x + dca[nb][0], old[nb][0].y + dca[nb][1]));
                        if (ir + 8 < nt)
                            __stcg(reinterpret_cast<float2*>(pc + (size_t)(ir + 8) * N + n),
                                   make_float2(old[nb][1].x + dca[nb][2], old[nb][1].y + dca[nb][3]));
                    }
                }
                // R's row sums: column i adds its half's four row slabs in order
                if (tid < TT) {
                    const int half = tid >> 5, col = tid & 31;
                    float s = 0.f;
#pragma unroll
                    for (int rr = 0; rr < 4; ++rr) s += red[(4 * half + rr) * 32 + col];
                    rowR[I * TT + tid] += s;
                }
                __syncthreads();  // dG^T and the column sums are read
            }

            // this warp's sums over its columns i, per row j
            cd0 = quad_sum(cd0);
            cd1 = quad_sum(cd1);
            cl0 = quad_sum(cl0);
            cl1 = quad_sum(cl1);
            if (t == 0) {
                colD[hf * CT + jr] = cd0;
                colD[hf * CT + jr + 8] = cd1;
                colR[hf * CT + jr] = cl0;
                colR[hf * CT + jr + 8] = cl1;
            }
            // dx and dB of the key rows: half 0's partial, then half 1's
            const int ct = tid & 127;
            if (hf) {
#pragma unroll
                for (int k = 0; k < 32; ++k) comb[k * 128 + ct] = dxa[k >> 2][k & 3];
            }
            __syncthreads();
            if (!hf) {
#pragma unroll
                for (int k = 0; k < 32; ++k) dxa[k >> 2][k & 3] += comb[k * 128 + ct];
#pragma unroll
                for (int pb = 0; pb < MAXW / 8; ++pb) {
                    const int p = 8 * pb + 2 * t;
                    if (p >= P) continue;
                    if (jr < nt)
                        *reinterpret_cast<__nv_bfloat162*>(dx + (row0 + jr) * xstr + (size_t)h * P + p) =
                            __floats2bfloat162_rn(dxa[pb][0], dxa[pb][1]);
                    if (jr + 8 < nt)
                        *reinterpret_cast<__nv_bfloat162*>(dx + (row0 + jr + 8) * xstr + (size_t)h * P + p) =
                            __floats2bfloat162_rn(dxa[pb][2], dxa[pb][3]);
                }
            }
            __syncthreads();
            if (hf) {
#pragma unroll
                for (int k = 0; k < 32; ++k) comb[k * 128 + ct] = dba[k >> 2][k & 3];
            }
            __syncthreads();
            if (!hf) {
                float* pb_ = pB + ((size_t)(b * groups + grp) * S + t0) * N;
                // the earlier heads' sums, every load in flight before any
                // store (the first head stores alone)
                float2 old[MAXW / 8][2];
#pragma unroll
                for (int nb = 0; nb < MAXW / 8; ++nb) {
                    const int n = 8 * nb + 2 * t;
                    old[nb][0] = old[nb][1] = make_float2(0.f, 0.f);
                    if (hi_ && n < N) {
                        if (jr < nt) old[nb][0] = __ldcg(reinterpret_cast<const float2*>(pb_ + (size_t)jr * N + n));
                        if (jr + 8 < nt) old[nb][1] = __ldcg(reinterpret_cast<const float2*>(pb_ + (size_t)(jr + 8) * N + n));
                    }
                }
#pragma unroll
                for (int nb = 0; nb < MAXW / 8; ++nb) {
                    const int n = 8 * nb + 2 * t;
                    if (n >= N) continue;
                    const float s0 = dba[nb][0] + comb[(4 * nb) * 128 + ct];
                    const float s1 = dba[nb][1] + comb[(4 * nb + 1) * 128 + ct];
                    const float s2 = dba[nb][2] + comb[(4 * nb + 2) * 128 + ct];
                    const float s3 = dba[nb][3] + comb[(4 * nb + 3) * 128 + ct];
                    if (jr < nt)
                        __stcg(reinterpret_cast<float2*>(pb_ + (size_t)jr * N + n),
                               make_float2(old[nb][0].x + s0, old[nb][0].y + s1));
                    if (jr + 8 < nt)
                        __stcg(reinterpret_cast<float2*>(pb_ + (size_t)(jr + 8) * N + n),
                               make_float2(old[nb][1].x + s2, old[nb][1].y + s3));
                }
            }
            __syncthreads();  // comb (gh, gl) and the key tile are read
            // the next head's x and dy rows of this key tile: no later step
            // of this head reads them
            if (hi_ + 1 < nheads) {
                stage_rows(xs, x + row0 * xstr + (size_t)(h + 1) * P, xstr, P, nt,
                           J * TT, (J + 1) * TT);
                stage_rows(ys, dy + row0 * xstr + (size_t)(h + 1) * P, xstr, P, nt,
                           J * TT, (J + 1) * TT);
                cp_async_commit();
            }
        }

        // per row: dl and ddt's parts in a fixed order; dL at the last
        // step; l's reverse cumsum by one warp (8 rows a lane, then the
        // lanes to the right); dA and dD of the chunk
        hd = warp_sum(hd);
        dsum = warp_sum(dsum);
        if (lane == 0) {
            red2[2 * warp] = hd;
            red2[2 * warp + 1] = dsum;
        }
        __syncthreads();
        if (warp == 0) {
            float hdt = 0.f, dsm = 0.f;
#pragma unroll
            for (int w = 0; w < THREADS / 32; ++w) {
                hdt += red2[2 * w];
                dsm += red2[2 * w + 1];
            }
            const int k0 = 8 * lane;
            float dlv[8], ddv[8], wpart = 0.f;
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int k = k0 + u;
                dlv[u] = ddv[u] = 0.f;
                if (k < CT) {
                    dlv[u] = rowR[k] - colR[k] - colR[CT + k] + qd[k] + qd[CT + k] - wdw[k];
                    ddv[u] = colD[k] + colD[CT + k] + ddS[k];
                    wpart += wdw[k];
                }
            }
            const float wsum = warp_sum(wpart);
            const float dL = expf(L) * hdt + wsum;
#pragma unroll
            for (int u = 0; u < 8; ++u)
                if (k0 + u == nt - 1) dlv[u] += dL;
            float run = 0.f;
#pragma unroll
            for (int u = 7; u >= 0; --u) {
                run += dlv[u];
                dlv[u] = run;
            }
            float v = run;  // the sum over lanes lane .. 31
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const float nv = __shfl_down_sync(0xffffffffu, v, o);
                if (lane + o < 32) v += nv;
            }
            float right = __shfl_down_sync(0xffffffffu, v, 1);
            if (lane == 31) right = 0.f;
            float da = 0.f;
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int k = k0 + u;
                if (k < nt) {
                    const float rc = dlv[u] + right;
                    ddt[(row0 + k) * Hs + h] = __float2bfloat16(fmaf(Ah, rc, ddv[u]));
                    da = fmaf(rc, dts[k], da);
                }
            }
            da = warp_sum(da);
            if (lane == 0) {
                pA[head * n_chunks + ck] = da;
                pD[head * n_chunks + ck] = dsm;
            }
        }
    }
}

static int set_smem(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Shapes as ssd.cu's; lbuf, states and decay the forward's scratch of the
// same call (states holding each chunk's entering state); dhT null for a
// zero gradient of hT. Scratch: dHn (B, Hs, chunks, P, N), pB, pC (B,
// ceil(Hs / 4), S, N), pA, pD (B, Hs, chunks), all f32; counters B * Hs
// unsigned ints that are zero (left zero). Outputs: dx (B, S, Hs, P), ddt
// (B, S, Hs), dB, dC (B, S, N) bf16; dA, dD (Hs,), dh0 (B, Hs, P, N) f32.
// Three launches; returns cudaGetLastError() after them.
extern "C" int ssd_bwd_bf16(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* C, const void* D, const void* dy, const void* dhT,
    const void* lbuf, const void* states, const void* decay, void* dHn,
    void* dx, void* ddt, void* dA, void* dB, void* dC, void* dD, void* dh0,
    void* pB, void* pC, void* pA, void* pD, void* counters, int B, int S,
    int Hs, int P, int N, int chunk, void* stream) {
    if (P % 8 || P > MAXW || N % 8 || N > MAXW || chunk < 1 || chunk > MAXC
        || S < 1)
        return (int)cudaErrorInvalidValue;
    const int c = chunk, n_chunks = (S + c - 1) / c;
    const int groups = (Hs + HG - 1) / HG;
    const int ct = (c + TT - 1) / TT * TT;
    const size_t smem_a = (2 * ct + 2 * TT) * LD * 2 + ct * 4;
    const size_t smem_b = (4 * ct + 6 * TT) * LD * 2 + (11 * ct + 8 * 32 + 16) * 4;
    int e = set_smem((const void*)ssd_bwd_state_kernel, smem_a);
    if (!e) e = set_smem((const void*)ssd_bwd_kernel, smem_b);
    if (e) return e;
    cudaStream_t st = (cudaStream_t)stream;
    ssd_bwd_state_kernel<<<dim3(n_chunks, Hs, B), THREADS, smem_a, st>>>(
        (const bf16*)dy, (const bf16*)C, (const float*)lbuf,
        (const float*)decay, (const float*)dhT, (float*)dHn, (float*)dh0,
        (unsigned int*)counters, S, Hs, P, N, c);
    if ((e = (int)cudaGetLastError())) return e;
    // (b) by programmatic dependent launch: its blocks may start once every
    // block of (a) runs, and stage their inputs meanwhile
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_chunks, groups, B);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem_b;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = (int)cudaLaunchKernelEx(
        &cfg, ssd_bwd_kernel, (const bf16*)x, (const bf16*)dt,
        (const float*)A, (const bf16*)Bm, (const bf16*)C, (const float*)D,
        (const bf16*)dy, (const float*)lbuf, (const float*)states,
        (const float*)decay, (const float*)dHn, (bf16*)dx, (bf16*)ddt,
        (float*)pB, (float*)pC, (float*)pA, (float*)pD, S, Hs, P, N, c);
    if (e) return e;
    if ((e = (int)cudaGetLastError())) return e;
    // (c) dB, dC: element (b, e) adds its head groups' partials; dA, dD:
    // head h adds (b, h, k) over b, then k
    const size_t row = (size_t)S * N, nc = n_chunks;
    const Layout bc{B * row, row, groups * row, 0, row, 1, groups};
    const Layout ad{(size_t)Hs, 1, nc, Hs * nc, 1, B, n_chunks};
    launch_fixed_sum(bc, ad, ad, pB, pC, pA, pD, dB, dC, dA, dD, st);
    return (int)cudaGetLastError();
}
