// Backward of the Mamba1 selective scan for Hopper (sm_90a): the gradients
// of selective_scan.cu's y and hT, for training the SSM family
// (falcon-mamba-7b).
//
// Replaces: no TPU kernel. repro/kernels/selective_scan.py, selective_scan
// (_scan_kernel) is forward only; the JAX package differentiates the XLA
// form of the scan (repro/kernels/ops.py:434-485). This is the backward of
// the port of that kernel.
//
// Computes, for the forward h_t = a_t h_{t-1} + b_t (a_t = exp(dt_t A),
// b_t = dt_t x_t B_t), y_t = h_t . C_t + D x_t, from dy (bf16) and dhT (f32
// or null), the adjoint of the state walked back from dhT,
//   g_t = dy_t C_t + u_{t+1},  u_t = a_t g_t   (u_S = dhT),
// and from it, per step t, channel d and state n:
//   dC_t[n]  = sum_d dy_t[d] h_t[d, n]     dB_t[n] = sum_d g_t dt_t x_t[d]
//   dx_t[d]  = dt_t s1 + D dy_t            ddt_t[d] = x_t s1 + sum_n w A
//   dA[d, n] = sum_{b,t} w dt_t            dD[d] = sum_{b,t} dy_t x_t
//   dh0 = u_0,  with s1 = sum_n g_t B_t[n] and w = g_t a_t h_{t-1}.
//
// What bounds it on this card: operations, as the forward. At
// falcon-mamba's training shape (B 2, S 2048, Di 8192, N 16) it reads x,
// dt and dy (201 MB, bf16) and the saved states (8 MB) and writes dx and
// ddt (134 MB): ~344 MB, 0.103 ms at 3.35 TB/s. It needs S Di N = 537 M
// exponentials (the replay's a_t), 0.128 ms on the special-function units
// at 16 an SM a clock (it evaluates ~604 M: the lanes' decay products
// twice), and ~25 further instructions per step and state. Measured on
// the H100: 1.60 ms (PERF.md section 6, row 5b).
//
// Design (a simple kernel: right first; its speed is later work):
// - Block: one batch row and CT = 64 channels, walked as 4 groups of 16,
//   one channel a half-warp (lane g owns steps 16g .. 16g+15 of a 256-step
//   tile, as in the forward). Tiles are walked in reverse. Per tile, B and
//   C are staged as f32 (N, 256) rows, each group's x, dt and dy as f32
//   (16, 256) rows; a padded column (t + t / 16) keeps a half-warp's reads
//   of its 16 lanes' steps on 16 banks, the other half on the other 16.
// - Per state n, each half-warp replays the forward from the state saved
//   at the tile's entry (the forward's hsave) with the forward's own
//   operations (ex2.approx of dt A log2 e, the lanes' maps h -> P h + Q
//   composed by the same 4-round shuffle scan, then h = a h + b), so the
//   states it recomputes are the forward's bits; then the adjoint is
//   scanned the other way: each lane folds its 16 steps, last first, into
//   u -> P u + R (u = a (e + u), e = dy C), a 4-round shuffle scan composes
//   the lanes to its right, the composite applied to the carry from the
//   next tile is the lane's incoming u, and the lane walks its steps
//   backwards forming g_t and the sums above. Lane 0's last u is the carry
//   into the tile before; after tile 0 it is dh0.
// - Sums over channels (dB, dC) without atomics: per state n, each
//   half-warp writes its 256 steps' terms to its own row, and after a
//   barrier thread t adds the 16 rows of step t in row order into the
//   tile's (N, 256) sums (groups in order); the block writes them as one
//   partial per block, and a second launch adds the blocks' partials in
//   block order and rounds to bf16. dA and dD: a 16-lane shuffle tree per
//   (channel, n), tiles in order, then the second launch adds the batch
//   rows in order. So the same inputs give the same bits on every run.
// - Ragged tail and channels past Di: zeros, as in the forward (dt = 0 is
//   an identity step: a = 1, b = 0, and it has dy = 0); nothing of them is
//   stored.
// - Shared memory: (4 N + 80) rows of 272 floats and 5 (64, N) tables:
//   177 KB at N = 16 (one block an SM). State sizes 4, 8 and 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_sum.cuh"

#define THREADS 256
#define TT 256               // steps of a tile: 16 lanes x 16
#define GC 16                // channels of a group: one a half-warp
#define GROUPS 4             // groups of a block
#define CT (GC * GROUPS)     // channels of a block
#define RS 272               // row stride of a (row, TT) tile: TT + TT / 16
#define LOG2E 1.4426950408889634f

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float ex2(float x) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

// the column of step t in a padded row
__device__ __forceinline__ int col(int t) { return t + (t >> 4); }

template <int N>
struct Smem {
    static constexpr int rows = 4 * N + 3 * GC + 2 * 16;
    static constexpr size_t bytes =
        ((size_t)rows * RS + 5 * (size_t)CT * N + 2 * CT) * 4;
};

template <int N>
__global__ void __launch_bounds__(THREADS, 1) scan_bwd_kernel(
    const bf16* __restrict__ x,      // (B, S, Di)
    const bf16* __restrict__ dt,     // (B, S, Di)
    const float* __restrict__ A,     // (Di, N)
    const bf16* __restrict__ Bm,     // (B, S, N)
    const bf16* __restrict__ C,      // (B, S, N)
    const float* __restrict__ D,     // (Di,)
    const float* __restrict__ hsave, // (B, tiles, Di, N): state entering a tile
    const bf16* __restrict__ dy,     // (B, S, Di)
    const float* __restrict__ dhT,   // (B, Di, N) or null
    bf16* __restrict__ dx,           // (B, S, Di)
    bf16* __restrict__ ddt,          // (B, S, Di)
    float* __restrict__ dh0,         // (B, Di, N)
    float* __restrict__ pB,          // (blocks, B, S, N): partial dB
    float* __restrict__ pC,          // (blocks, B, S, N): partial dC
    float* __restrict__ pA,          // (B, Di, N): dA of a batch row
    float* __restrict__ pD,          // (B, Di): dD of a batch row
    int S, int Di) {
    extern __shared__ __align__(16) float sm[];
    float* Bt = sm;                 // (N, RS) B of the tile
    float* Ct = Bt + N * RS;        // (N, RS) C
    float* accB = Ct + N * RS;      // (N, RS) the tile's dB over the block
    float* accC = accB + N * RS;    // (N, RS) dC
    float* xs = accC + N * RS;      // (GC, RS) x of the group; then dx
    float* dts = xs + GC * RS;      // (GC, RS) dt; then ddt
    float* dys = dts + GC * RS;     // (GC, RS) dy
    float* redB = dys + GC * RS;    // (16, RS) a half-warp's dB terms a row
    float* redC = redB + 16 * RS;   // (16, RS) dC terms
    float* As = redC + 16 * RS;     // (CT, N) A log2 e
    float* Ar = As + CT * N;        // (CT, N) A
    float* hs = Ar + CT * N;        // (CT, N) the state entering the tile
    float* us = hs + CT * N;        // (CT, N) the adjoint's carry
    float* dAs = us + CT * N;       // (CT, N) dA
    float* Ds = dAs + CT * N;       // (CT,) D
    float* dDs = Ds + CT;           // (CT,) dD

    const int b = blockIdx.y;
    const int c0 = blockIdx.x * CT;
    const int B = gridDim.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int half = 2 * warp + (lane >> 4);  // the half-warp: its channel
    const int g = lane & 15;                  // steps 16g .. 16g+15
    const unsigned FULL = 0xffffffffu;
    const int ntiles = (S + TT - 1) / TT;

    for (int i = tid; i < CT * N; i += THREADS) {
        const bool live = c0 + i / N < Di;
        const float a = live ? A[(size_t)c0 * N + i] : 0.f;
        As[i] = a * LOG2E;   // as the forward forms it
        Ar[i] = a;
        us[i] = live && dhT ? dhT[((size_t)b * Di + c0) * N + i] : 0.f;
        dAs[i] = 0.f;
    }
    for (int c = tid; c < CT; c += THREADS) {
        Ds[c] = c0 + c < Di ? D[c0 + c] : 0.f;
        dDs[c] = 0.f;
    }

    for (int k = ntiles - 1; k >= 0; --k) {
        const int t0 = k * TT, nt = min(TT, S - t0);
        __syncthreads();  // the last tile's sums are out
        for (int i = tid; i < N * TT; i += THREADS) {
            const int t = i / N, n = i % N, o = n * RS + col(t);
            const bool ok = t < nt;
            const size_t off = ((size_t)b * S + t0 + t) * N + n;
            Bt[o] = ok ? __bfloat162float(Bm[off]) : 0.f;
            Ct[o] = ok ? __bfloat162float(C[off]) : 0.f;
            accB[o] = 0.f;
            accC[o] = 0.f;
        }
        for (int i = tid; i < CT * N; i += THREADS)
            hs[i] = c0 + i / N < Di
                ? hsave[(((size_t)b * ntiles + k) * Di + c0) * N + i] : 0.f;

        for (int gr = 0; gr < GROUPS; ++gr) {
            const int gc0 = c0 + gr * GC;
            if (gc0 >= Di) break;  // the same for every thread
            __syncthreads();  // the last group's dx and ddt are out
            for (int i = tid; i < GC * TT; i += THREADS) {
                const int t = i / GC, c = i % GC, o = c * RS + col(t);
                const bool ok = t < nt && gc0 + c < Di;
                const size_t off = ((size_t)b * S + t0 + t) * Di + gc0 + c;
                xs[o] = ok ? __bfloat162float(x[off]) : 0.f;
                dts[o] = ok ? __bfloat162float(dt[off]) : 0.f;
                dys[o] = ok ? __bfloat162float(dy[off]) : 0.f;
            }
            __syncthreads();

            const int cc = gr * GC + half;  // the channel within the block
            const int row = half * RS + col(16 * g);
            float dtv[16], dxv[16], dyv[16], s1[16], s2[16], sdt = 0.f;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                dtv[j] = dts[row + j];
                dxv[j] = dtv[j] * xs[row + j];
                dyv[j] = dys[row + j];
                s1[j] = s2[j] = 0.f;
                sdt += dtv[j];
            }
#pragma unroll 1
            for (int n = 0; n < N; ++n) {
                const float a2 = As[cc * N + n], ar = Ar[cc * N + n];
                const float carry = hs[cc * N + n], ucarry = us[cc * N + n];
                const int bc = n * RS + col(16 * g);
                float av[16], hv[16];
#pragma unroll
                for (int j = 0; j < 16; ++j) {
                    av[j] = ex2(dtv[j] * a2);
                    hv[j] = dxv[j] * Bt[bc + j];  // b_t, then h_t
                }
                // the forward's replay: the lane's map, the lanes composed
                float P = ex2(sdt * a2), Q = hv[0];
#pragma unroll
                for (int j = 1; j < 16; ++j) Q = fmaf(av[j], Q, hv[j]);
#pragma unroll
                for (int o = 1; o < 16; o <<= 1) {
                    const float Pp = __shfl_up_sync(FULL, P, o, 16);
                    const float Qp = __shfl_up_sync(FULL, Q, o, 16);
                    const float Qn = fmaf(P, Qp, Q), Pn = P * Pp;
                    Q = g >= o ? Qn : Q;
                    P = g >= o ? Pn : P;
                }
                float h = __shfl_up_sync(FULL, fmaf(P, carry, Q), 1, 16);
                if (g == 0) h = carry;
                const float h_in = h;
#pragma unroll
                for (int j = 0; j < 16; ++j) {
                    h = fmaf(av[j], h, hv[j]);
                    hv[j] = h;
                }
                // the adjoint: the lane's steps, last first, as u -> Pu u + R
                float Pu = ex2(sdt * a2), R = 0.f;
#pragma unroll
                for (int j = 15; j >= 0; --j)
                    R = av[j] * fmaf(dyv[j], Ct[bc + j], R);
                // lanes g .. 15 composed (inclusive, from the right)
#pragma unroll
                for (int o = 1; o < 16; o <<= 1) {
                    const float Pp = __shfl_down_sync(FULL, Pu, o, 16);
                    const float Rp = __shfl_down_sync(FULL, R, o, 16);
                    const float Rn = fmaf(Pu, Rp, R), Pn = Pu * Pp;
                    R = g + o < 16 ? Rn : R;
                    Pu = g + o < 16 ? Pn : Pu;
                }
                // the u entering lane g from its right: lanes g+1 .. 15 on
                // the next tile's carry
                float u = __shfl_down_sync(FULL, fmaf(Pu, ucarry, R), 1, 16);
                if (g == 15) u = ucarry;
                float dAl = 0.f;
#pragma unroll
                for (int j = 15; j >= 0; --j) {
                    const float gt = fmaf(dyv[j], Ct[bc + j], u);
                    const float hp = j ? hv[j - 1] : h_in;
                    const float w = gt * av[j] * hp;
                    redB[row + j] = gt * dxv[j];
                    redC[row + j] = dyv[j] * hv[j];
                    s1[j] = fmaf(gt, Bt[bc + j], s1[j]);
                    s2[j] = fmaf(w, ar, s2[j]);
                    dAl = fmaf(w, dtv[j], dAl);
                    u = av[j] * gt;
                }
#pragma unroll
                for (int o = 8; o; o >>= 1)
                    dAl += __shfl_xor_sync(FULL, dAl, o, 16);
                if (g == 0) {
                    us[cc * N + n] = u;
                    dAs[cc * N + n] += dAl;
                }
                __syncthreads();  // every half-warp's row is written
                {
                    const int o = col(tid);
                    float sb = 0.f, sc = 0.f;
#pragma unroll
                    for (int r = 0; r < 16; ++r) {
                        sb += redB[r * RS + o];
                        sc += redC[r * RS + o];
                    }
                    accB[n * RS + o] += sb;
                    accC[n * RS + o] += sc;
                }
                __syncthreads();  // the rows are read
            }
            // the channel's dx and ddt over its x and dt rows; dD
            const float dc = Ds[cc];
            float dd = 0.f;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const float xv = xs[row + j];
                dd = fmaf(dyv[j], xv, dd);
                xs[row + j] = fmaf(dtv[j], s1[j], dc * dyv[j]);
                dts[row + j] = fmaf(xv, s1[j], s2[j]);
            }
#pragma unroll
            for (int o = 8; o; o >>= 1) dd += __shfl_xor_sync(FULL, dd, o, 16);
            if (g == 0) dDs[cc] += dd;
            __syncthreads();
            for (int i = tid; i < GC * TT; i += THREADS) {
                const int t = i / GC, c = i % GC, o = c * RS + col(t);
                if (t < nt && gc0 + c < Di) {
                    const size_t off = ((size_t)b * S + t0 + t) * Di + gc0 + c;
                    dx[off] = __float2bfloat16(xs[o]);
                    ddt[off] = __float2bfloat16(dts[o]);
                }
            }
        }
        __syncthreads();  // the tile's sums are complete
        for (int i = tid; i < N * nt; i += THREADS) {
            const int t = i / N, n = i % N, o = n * RS + col(t);
            const size_t off = (((size_t)blockIdx.x * B + b) * S + t0 + t) * N + n;
            pB[off] = accB[o];
            pC[off] = accC[o];
        }
    }
    __syncthreads();
    for (int i = tid; i < CT * N; i += THREADS) {
        if (c0 + i / N < Di) {
            dh0[((size_t)b * Di + c0) * N + i] = us[i];
            pA[((size_t)b * Di + c0) * N + i] = dAs[i];
        }
    }
    for (int c = tid; c < CT; c += THREADS)
        if (c0 + c < Di) pD[(size_t)b * Di + c0 + c] = dDs[c];
}

template <int N>
static int launch(const void* x, const void* dt, const void* A,
                  const void* Bm, const void* C, const void* D,
                  const void* hsave, const void* dy, const void* dhT,
                  void* dx, void* ddt, void* dh0, void* pB, void* pC,
                  void* pA, void* pD, int B, int S, int Di,
                  cudaStream_t st) {
    const size_t bytes = Smem<N>::bytes;
    static bool ready = false;  // the shared-memory limit, set once
    if (!ready) {
        const cudaError_t err = cudaFuncSetAttribute(
            scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)bytes);
        if (err != cudaSuccess) return (int)err;
        ready = true;
    }
    dim3 grid((Di + CT - 1) / CT, B);
    scan_bwd_kernel<N><<<grid, THREADS, bytes, st>>>(
        (const bf16*)x, (const bf16*)dt, (const float*)A, (const bf16*)Bm,
        (const bf16*)C, (const float*)D, (const float*)hsave,
        (const bf16*)dy, (const float*)dhT, (bf16*)dx, (bf16*)ddt,
        (float*)dh0, (float*)pB, (float*)pC, (float*)pA, (float*)pD, S, Di);
    return (int)cudaGetLastError();
}

// Shapes as selective_scan.cu's; hsave (B, ceil(S / 256), Di, N) from the
// forward; dhT null for a zero gradient of hT. Scratch: pB, pC
// (ceil(Di / 64), B, S, N) f32, pA (B, Di, N), pD (B, Di). Outputs: dx,
// ddt (B, S, Di) bf16, dA (Di, N) f32, dB, dC (B, S, N) bf16, dD (Di,) f32,
// dh0 (B, Di, N) f32. Two launches; returns cudaGetLastError() after them,
// cudaErrorInvalidValue for a state size other than 4, 8 or 16.
extern "C" int selective_scan_bwd_bf16(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* C, const void* D, const void* hsave, const void* dy,
    const void* dhT, void* dx, void* ddt, void* dA, void* dB, void* dC,
    void* dD, void* dh0, void* pB, void* pC, void* pA, void* pD, int B,
    int S, int Di, int N, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    int e;
    switch (N) {
        case 4: e = launch<4>(x, dt, A, Bm, C, D, hsave, dy, dhT, dx, ddt, dh0, pB, pC, pA, pD, B, S, Di, st); break;
        case 8: e = launch<8>(x, dt, A, Bm, C, D, hsave, dy, dhT, dx, ddt, dh0, pB, pC, pA, pD, B, S, Di, st); break;
        case 16: e = launch<16>(x, dt, A, Bm, C, D, hsave, dy, dhT, dx, ddt, dh0, pB, pC, pA, pD, B, S, Di, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (e) return e;
    // dB and dC: the blocks' partials added in block order, rounded to
    // bf16; dA and dD: the batch rows added in order
    const int blocks = (Di + CT - 1) / CT;
    const size_t nbc = (size_t)B * S * N, na = (size_t)Di * N;
    const Layout bc{nbc, nbc, 0, 0, nbc, 1, blocks};
    const Layout a{na, na, 0, 0, na, 1, B};
    const Layout d{(size_t)Di, (size_t)Di, 0, 0, (size_t)Di, 1, B};
    launch_fixed_sum(bc, a, d, pB, pC, pA, pD, dB, dC, dA, dD, st);
    return (int)cudaGetLastError();
}
