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
// at 16 an SM a clock, and ~20 further instructions per step and state:
// the replay (2), the adjoint's fold (2), the walk (8), the shuffle scans
// (~3.5), the sums over channels of dB and dC (~4). The first design took
// 1.59 ms on the H100 (PERF.md section 6, row 5b): two block-wide barriers
// per state per 16 channels, B and C read as scalars four times a step,
// every dB and dC term through shared memory one scalar at a time, and
// scalar staging with nothing in flight during the compute.
//
// Design:
// - Block: one batch row and CT = 64 channels in four passes of PC = 16,
//   8 warps: a half-warp per channel of the pass (lane g owns steps 16g ..
//   16g+15 of a 256-step tile, as in the forward). Tiles are walked in
//   reverse. A pass's x, dt and dy rows (256, 16) bf16 are loaded 16 bytes
//   a thread into registers while the pass before finishes, then
//   transposed into the forward's channel-major swizzled layout; each lane
//   keeps its channel's 16 dt, dt x and dy in registers. B and C of the
//   tile are f32 (N, 256) tiles in the forward's layout, read as float4s.
// - Two states at a time, interleaved: their chains are independent and
//   share the channel's inputs. Per state each half-warp replays the
//   forward from the state saved at the tile's entry (the forward's hsave)
//   with the forward's own operations (ex2.approx of dt A log2 e, the
//   lanes' maps h -> P h + Q composed by the same 4-round shuffle scan,
//   then h = a h + b), so the states it recomputes are the forward's bits;
//   then the adjoint is scanned the other way: each lane folds its 16
//   steps, last first, into u -> P u + R (u = a (e + u), e = dy C; P the
//   forward's exp2 of the lane's dt sum, formed once for both scans), a
//   4-round shuffle scan composes the lanes to its right, the composite
//   applied to the carry from the next tile is the lane's incoming u, and
//   the lane walks its steps backwards forming g_t and the sums above (u =
//   a g formed once for w and the carry). Lane 0's last u is the carry
//   into the tile before; after tile 0 it is dh0.
// - Sums over channels (dB, dC) without atomics, one barrier pair per two
//   states: each lane stores its 16 steps' terms of both states as float4s
//   into its channel's rows (a swizzled layout in which those stores and
//   the column reads below are free of bank conflicts); after a barrier
//   thread t adds the pass's 16 rows in channel order for step t (both
//   states and arrays) into the tile's f32 sums in shared memory (passes
//   in order); after the last pass thread t writes step t's sums to the
//   block's f32 partial (blocks, B, S, N), 16 bytes a store. A second
//   launch (fixed_sum.cuh) adds the blocks' partials in block order and
//   rounds to bf16. dA and dD: a 16-lane shuffle tree per (channel, n),
//   tiles in order, then the second launch adds the batch rows in order. Every
//   sum has the first design's order, so the outputs keep its bits.
// - dx and ddt are rounded to bf16 over x and dt in the channel-major
//   tiles and written out 16 bytes a thread, channels contiguous.
// - What it does not do: a lane keeps ~112 live values for one channel
//   (dt, dt x, dy, s1, s2 and a state's a, h), so 16 warps an SM (128
//   registers a thread) spill; and adding two channels' dB and dC terms in
//   registers before the shared-memory pass needs 48 more inputs and 32
//   more sums a lane, which spill at 8 warps. Both were built and ran
//   slower; PERF.md section 6 has the readings.
// - Ragged tail and channels past Di: zeros, as in the forward (dt = 0 is
//   an identity step: a = 1, b = 0, and it has dy = 0); nothing of them is
//   stored. A Di that is not a multiple of 8, or an x, dt, dy, dx or ddt
//   off 16 bytes, takes a scalar staging path with the same arithmetic.
// - Shared memory: 169 KB at N = 16 (one block an SM, 255 registers a
//   thread). State sizes 4, 8 and 16 (N even: states go in pairs).
// - Staging goes through registers, not cp.async: the loads of the next
//   pass are in flight during this one either way, and cp.async would
//   need a 24 KB landing buffer for the same transpose.
// - Measured on the H100 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
//   section 6, row 5b): 1.174 ms a call (tiles 1.133, sums 0.041) against
//   the first design's 1.602 timed beside it, its outputs bitwise the
//   first design's (tools/ssm_bwd_digest.py): 1.36x. It misses both the
//   2x over the first design and the 0.6 ms that were asked of it. Left
//   out (tools/ssm_bwd_variants.py): the channel sums 0.18 ms, the state
//   loop's barriers 0.07; the recurrences alone
//   (no dB, dC terms, no sums, no barriers) take 0.83 ms: at 8 warps an
//   SM the lanes' dependent chains (the folds, the two shuffle scans, the
//   walk) leave the issue slots mostly idle.
// - What a faster design must cut, counted per step, channel and state
//   (537 M of them): ~24 issued instructions (~0.45 ms at the card's FP32
//   issue rate) and ~32 bytes of shared-memory traffic (B and C read
//   twice each, a dB and a dC term stored and read back; ~0.6 ms at 128
//   bytes a clock an SM). Every layout tried crosses lanes for one of the
//   two sums (over states: dx, ddt; over channels: dB, dC). Making the
//   other sum lane-local takes more live values a lane, and 16 warps an
//   SM then spill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_sum.cuh"
#include "mma.cuh"

#define TT 256               // steps of a tile: 16 lanes x 16
#define THREADS 256          // 8 warps: 16 half-warps
#define PC 16                // channels of a pass: one a half-warp
#define CT 64                // channels of a block
#define PASSES (CT / PC)     // passes of a block
#define NS (TT + 4)          // row stride of a B or C tile
#define PF (TT * PC / 8 / THREADS)  // 16-byte loads of an array a thread
#define LOG2E 1.4426950408889634f
static_assert(THREADS == TT && PC == THREADS / 16, "tile shape");

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float ex2(float x) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

// channel-major (PC, TT) bf16 tile as the forward's: step t of channel c,
// its 16-byte chunk XOR-swizzled by c / 8
__device__ __forceinline__ int cm(int c, int t) {
    return c * TT + 8 * ((t >> 3) ^ (c >> 3)) + (t & 7);
}

// (N, TT) f32 tile of B or C as the forward's: the steps 16g + 4q .. 16g +
// 4q + 3 of lane g at 64q + 4g
__device__ __forceinline__ int nm(int n, int t) {
    return n * NS + ((t & 15) >> 2) * 64 + (t >> 4) * 4 + (t & 3);
}

// step t = 16g + 4q + e in a row of 256 floats (a channel's dB or dC
// terms of a state): at 64q + 4(g ^ 2q) + e, so a
// lane's float4 q is a quarter-warp's contiguous 128 bytes, and 32
// consecutive steps lie on 32 banks
__device__ __forceinline__ int rp(int t) {
    const int q = (t >> 2) & 3;
    return 64 * q + 4 * ((t >> 4) ^ (2 * q)) + (t & 3);
}

__device__ __forceinline__ void unpack8(uint4 v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
}

// B and C rows [t0, t0 + nt) of batch row b as bf16 pairs, neighbouring
// threads on neighbouring words (zeros past S)
template <int N>
__device__ __forceinline__ void load_bc(uint32_t* bw, uint32_t* cw,
                                        const bf16* Bm, const bf16* C, int b,
                                        int S, int t0, int nt) {
    const size_t base = ((size_t)b * S + t0) * N / 2;
    const uint32_t* b32 = reinterpret_cast<const uint32_t*>(Bm) + base;
    const uint32_t* c32 = reinterpret_cast<const uint32_t*>(C) + base;
#pragma unroll
    for (int j = 0; j < TT * N / 2 / THREADS; ++j) {
        const int w = threadIdx.x + THREADS * j;
        const bool ok = 2 * w / N < nt;
        bw[j] = ok ? b32[w] : 0u;
        cw[j] = ok ? c32[w] : 0u;
    }
}

template <int N>
__device__ __forceinline__ void store_bc(const uint32_t* bw,
                                         const uint32_t* cw, float* BT,
                                         float* CTs) {
#pragma unroll
    for (int j = 0; j < TT * N / 2 / THREADS; ++j) {
        const int e = 2 * (threadIdx.x + THREADS * j);
        const int t = e / N, n = e % N;
        BT[nm(n, t)] = __uint_as_float(bw[j] << 16);
        BT[nm(n + 1, t)] = __uint_as_float(bw[j] & 0xffff0000u);
        CTs[nm(n, t)] = __uint_as_float(cw[j] << 16);
        CTs[nm(n + 1, t)] = __uint_as_float(cw[j] & 0xffff0000u);
    }
}

// x, dt and dy rows [t0, t0 + nt) of channels [c0, c0 + PC), 16 bytes a
// load into registers (PF of each array a thread); past S or Di, zeros
__device__ __forceinline__ void load_pass(uint4 (*v)[PF], const bf16* x,
                                          const bf16* dt, const bf16* dy,
                                          int b, int S, int Di, int c0,
                                          int t0, int nt) {
    const bf16* src[3] = {x, dt, dy};
#pragma unroll
    for (int f = 0; f < PF; ++f) {
        const int i = threadIdx.x + f * THREADS;
        const int r = i / (PC / 8), ch = i % (PC / 8);
        const bool ok = r < nt && c0 + 8 * ch < Di;
        const size_t off = ((size_t)b * S + t0 + r) * Di + c0 + 8 * ch;
#pragma unroll
        for (int a = 0; a < 3; ++a)
            v[a][f] = ok ? *reinterpret_cast<const uint4*>(src[a] + off)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
}

template <int N>
struct Smem {
    static constexpr size_t bytes =
        3 * (size_t)PC * TT * 2               // x, dt, dy channel-major
        + 2 * (size_t)N * NS * 4              // B, C
        + 4 * (size_t)PC * TT * 4             // dB, dC terms of two states
        + 2 * (size_t)N * TT * 4              // the tile's dB, dC sums
        + 4 * (size_t)CT * N * 4 + 2 * CT * 4;  // per (channel, n); per channel
};

template <int N, bool VEC>
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
    extern __shared__ __align__(16) unsigned char smem[];
    // bf16 tiles held as their 16-bit patterns
    uint16_t* xT = reinterpret_cast<uint16_t*>(smem);  // cm: x, then dx
    uint16_t* dtT = xT + PC * TT;                      // cm: dt, then ddt
    uint16_t* dyT = dtT + PC * TT;                     // cm: dy
    float* BT = reinterpret_cast<float*>(dyT + PC * TT);  // nm
    float* CTs = BT + N * NS;                          // nm
    float* red = CTs + N * NS;   // (2 states, 2, PC, TT) dB, dC terms
    float* acc = red + 4 * PC * TT;  // (2, N, TT) the tile's dB, dC sums
    float* Ar = acc + 2 * N * TT;  // (CT, N) A
    float* hs = Ar + CT * N;     // (CT, N) the state entering the tile
    float* us = hs + CT * N;     // (CT, N) the adjoint's carry
    float* dAs = us + CT * N;    // (CT, N) dA
    float* Ds = dAs + CT * N;    // (CT,) D
    float* dDs = Ds + CT;        // (CT,) dD
    const uint16_t* xs16 = reinterpret_cast<const uint16_t*>(x);
    const uint16_t* dts16 = reinterpret_cast<const uint16_t*>(dt);
    const uint16_t* dys16 = reinterpret_cast<const uint16_t*>(dy);

    const int b = blockIdx.y;
    const int c0 = blockIdx.x * CT;
    const int B = gridDim.y;
    const int tid = threadIdx.x, lane = tid & 31;
    const int hw = tid >> 4;   // the half-warp: channel hw of the pass
    const int g = lane & 15;   // steps 16g .. 16g+15
    const unsigned FULL = 0xffffffffu;
    const int ntiles = (S + TT - 1) / TT;
    // this thread's float4 of a lane row (rp) at quarter q: 64q + 4(g ^ 2q)
    auto lo = [&](int q) { return 64 * q + 4 * (g ^ (2 * q)); };

    for (int i = tid; i < CT * N; i += THREADS) {
        const bool live = c0 + i / N < Di;
        Ar[i] = live ? A[(size_t)c0 * N + i] : 0.f;
        us[i] = live && dhT ? dhT[((size_t)b * Di + c0) * N + i] : 0.f;
        dAs[i] = 0.f;
    }
    for (int c = tid; c < CT; c += THREADS) {
        Ds[c] = c0 + c < Di ? D[c0 + c] : 0.f;
        dDs[c] = 0.f;
    }
    uint32_t bw[TT * N / 2 / THREADS], cw[TT * N / 2 / THREADS];
    uint4 pre[3][PF];  // the next pass's x, dt, dy (VEC)
    {
        const int t0 = (ntiles - 1) * TT;
        if (VEC) load_pass(pre, x, dt, dy, b, S, Di, c0, t0, S - t0);
        load_bc<N>(bw, cw, Bm, C, b, S, t0, S - t0);
    }

    for (int k = ntiles - 1; k >= 0; --k) {
        const int t0 = k * TT, nt = min(TT, S - t0);
        for (int pass = 0; pass < PASSES; ++pass) {
            const int pc0 = c0 + pass * PC;  // the pass's first channel
            // ---- stage: x, dt, dy channel-major; B, C and the tile's
            // entering states at its first pass ----
            __syncthreads();  // the last pass is out
            if (VEC) {
                uint16_t* dst[3] = {xT, dtT, dyT};
#pragma unroll
                for (int f = 0; f < PF; ++f) {
                    const int i = tid + f * THREADS;
                    const int r = i / (PC / 8), ch = i % (PC / 8);
#pragma unroll
                    for (int a = 0; a < 3; ++a) {
                        const uint32_t w[4] = {pre[a][f].x, pre[a][f].y, pre[a][f].z, pre[a][f].w};
#pragma unroll
                        for (int e = 0; e < 8; ++e)
                            dst[a][cm(8 * ch + e, r)] = (uint16_t)(w[e >> 1] >> (16 * (e & 1)));
                    }
                }
            } else {
                for (int i = tid; i < TT * PC; i += THREADS) {
                    const int r = i / PC, c = i % PC;
                    const bool ok = r < nt && pc0 + c < Di;
                    const size_t off = ((size_t)b * S + t0 + r) * Di + pc0 + c;
                    xT[cm(c, r)] = ok ? xs16[off] : (uint16_t)0;
                    dtT[cm(c, r)] = ok ? dts16[off] : (uint16_t)0;
                    dyT[cm(c, r)] = ok ? dys16[off] : (uint16_t)0;
                }
            }
            if (pass == 0) {
                store_bc<N>(bw, cw, BT, CTs);
                for (int i = tid; i < CT * N; i += THREADS)
                    hs[i] = c0 + i / N < Di
                        ? hsave[(((size_t)b * ntiles + k) * Di + c0) * N + i] : 0.f;
            }
            __syncthreads();

            // ---- the lane's channel: dt, dt x, dy of its 16 steps ----
            const int c = hw;                 // within the pass
            const int cc = pass * PC + hw;    // within the block
            float dtv[16], dxv[16], dyv[16], s1[16], s2[16], sdt = 0.f;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                float xf[8];
                unpack8(*reinterpret_cast<const uint4*>(xT + cm(c, 16 * g + 8 * hh)), xf);
                unpack8(*reinterpret_cast<const uint4*>(dtT + cm(c, 16 * g + 8 * hh)), dtv + 8 * hh);
                unpack8(*reinterpret_cast<const uint4*>(dyT + cm(c, 16 * g + 8 * hh)), dyv + 8 * hh);
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    dxv[8 * hh + j] = dtv[8 * hh + j] * xf[j];
                    s1[8 * hh + j] = s2[8 * hh + j] = 0.f;
                    sdt += dtv[8 * hh + j];
                }
            }

            // two states at a time, interleaved: their chains are
            // independent and share the channel's inputs
#pragma unroll 1
            for (int n0 = 0; n0 < N; n0 += 2) {
                float av[2][16], hv[2][16], ar[2], a2[2], carry[2], ucarry[2];
                float P[2], Q[2], Pu[2], R[2], h[2], h_in[2], u[2], dAl[2];
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                    const int n = n0 + s;
                    ar[s] = Ar[cc * N + n];
                    a2[s] = ar[s] * LOG2E;  // as the forward forms it
                    carry[s] = hs[cc * N + n];
                    ucarry[s] = us[cc * N + n];
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const float4 v = *reinterpret_cast<const float4*>(BT + n * NS + 64 * q + 4 * g);
                        const float bb[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int j = 4 * q + e;
                            av[s][j] = ex2(dtv[j] * a2[s]);
                            hv[s][j] = dxv[j] * bb[e];  // b_t, then h_t
                        }
                    }
                    // the forward's replay: the lane's map
                    P[s] = ex2(sdt * a2[s]);
                    Pu[s] = P[s];
                    Q[s] = hv[s][0];
#pragma unroll
                    for (int j = 1; j < 16; ++j) Q[s] = fmaf(av[s][j], Q[s], hv[s][j]);
                }
                // the lanes composed (inclusive Kogge-Stone), both states
#pragma unroll
                for (int o = 1; o < 16; o <<= 1) {
#pragma unroll
                    for (int s = 0; s < 2; ++s) {
                        const float Pp = __shfl_up_sync(FULL, P[s], o, 16);
                        const float Qp = __shfl_up_sync(FULL, Q[s], o, 16);
                        const float Qn = fmaf(P[s], Qp, Q[s]), Pn = P[s] * Pp;
                        Q[s] = g >= o ? Qn : Q[s];
                        P[s] = g >= o ? Pn : P[s];
                    }
                }
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                    h[s] = __shfl_up_sync(FULL, fmaf(P[s], carry[s], Q[s]), 1, 16);
                    if (g == 0) h[s] = carry[s];
                    h_in[s] = h[s];
#pragma unroll
                    for (int j = 0; j < 16; ++j) {
                        h[s] = fmaf(av[s][j], h[s], hv[s][j]);
                        hv[s][j] = h[s];
                    }
                    // the adjoint: the lane's steps, last first, as u -> Pu u + R
                    R[s] = 0.f;
#pragma unroll
                    for (int q = 3; q >= 0; --q) {
                        const float4 v = *reinterpret_cast<const float4*>(CTs + (n0 + s) * NS + 64 * q + 4 * g);
                        const float cv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                        for (int e = 3; e >= 0; --e) {
                            const int j = 4 * q + e;
                            R[s] = av[s][j] * fmaf(dyv[j], cv[e], R[s]);
                        }
                    }
                }
                // lanes g .. 15 composed (inclusive, from the right)
#pragma unroll
                for (int o = 1; o < 16; o <<= 1) {
#pragma unroll
                    for (int s = 0; s < 2; ++s) {
                        const float Pp = __shfl_down_sync(FULL, Pu[s], o, 16);
                        const float Rp = __shfl_down_sync(FULL, R[s], o, 16);
                        const float Rn = fmaf(Pu[s], Rp, R[s]), Pn = Pu[s] * Pp;
                        R[s] = g + o < 16 ? Rn : R[s];
                        Pu[s] = g + o < 16 ? Pn : Pu[s];
                    }
                }
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                    // the u entering lane g from its right: lanes g+1 .. 15
                    // on the next tile's carry
                    u[s] = __shfl_down_sync(FULL, fmaf(Pu[s], ucarry[s], R[s]), 1, 16);
                    if (g == 15) u[s] = ucarry[s];
                    dAl[s] = 0.f;
                    float* rb = red + ((2 * s) * PC + hw) * TT;
                    float* rc = red + ((2 * s + 1) * PC + hw) * TT;
#pragma unroll
                    for (int q = 3; q >= 0; --q) {
                        const float4 bv4 = *reinterpret_cast<const float4*>(BT + (n0 + s) * NS + 64 * q + 4 * g);
                        const float4 cv4 = *reinterpret_cast<const float4*>(CTs + (n0 + s) * NS + 64 * q + 4 * g);
                        const float bb[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
                        const float cv[4] = {cv4.x, cv4.y, cv4.z, cv4.w};
                        float tb[4], tc[4];
#pragma unroll
                        for (int e = 3; e >= 0; --e) {
                            const int j = 4 * q + e;
                            const float gt = fmaf(dyv[j], cv[e], u[s]);
                            const float hp = j ? hv[s][j - 1] : h_in[s];
                            const float ug = av[s][j] * gt;
                            const float w = ug * hp;
                            tb[e] = gt * dxv[j];
                            tc[e] = dyv[j] * hv[s][j];
                            s1[j] = fmaf(gt, bb[e], s1[j]);
                            s2[j] = fmaf(w, ar[s], s2[j]);
                            dAl[s] = fmaf(w, dtv[j], dAl[s]);
                            u[s] = ug;
                        }
                        *reinterpret_cast<float4*>(rb + lo(q)) = make_float4(tb[0], tb[1], tb[2], tb[3]);
                        *reinterpret_cast<float4*>(rc + lo(q)) = make_float4(tc[0], tc[1], tc[2], tc[3]);
                    }
                }
#pragma unroll
                for (int s = 0; s < 2; ++s) {
#pragma unroll
                    for (int o = 8; o; o >>= 1)
                        dAl[s] += __shfl_xor_sync(FULL, dAl[s], o, 16);
                    if (g == 0) {
                        us[cc * N + n0 + s] = u[s];
                        dAs[cc * N + n0 + s] += dAl[s];
                    }
                }
                __syncthreads();  // every channel's rows are written
                {
                    // thread tid: step tid of both states and arrays; the
                    // pass's channels in order, added to the tile's sums
                    // (passes in order)
                    const int o = rp(tid);
#pragma unroll
                    for (int s = 0; s < 2; ++s) {
                        float sb = 0.f, sc = 0.f;
#pragma unroll
                        for (int r = 0; r < PC; ++r) {
                            sb += red[((2 * s) * PC + r) * TT + o];
                            sc += red[((2 * s + 1) * PC + r) * TT + o];
                        }
                        float* ab = acc + (n0 + s) * TT + tid;
                        float* ac = acc + (N + n0 + s) * TT + tid;
                        *ab = pass ? *ab + sb : sb;
                        *ac = pass ? *ac + sc : sc;
                    }
                }
                __syncthreads();  // the rows are read
            }
            // the next pass's x, dt, dy (VEC) and the next tile's B and C
            // in flight
            if (VEC) {
                if (pass + 1 < PASSES)
                    load_pass(pre, x, dt, dy, b, S, Di, pc0 + PC, t0, nt);
                else if (k > 0)
                    load_pass(pre, x, dt, dy, b, S, Di, c0, t0 - TT, TT);
            }
            if (pass + 1 == PASSES && k > 0) load_bc<N>(bw, cw, Bm, C, b, S, t0 - TT, TT);
            // the channel's dx and ddt over its x and dt rows; dD
            const float dc = Ds[cc];
            float dd = 0.f;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                uint4* xrow = reinterpret_cast<uint4*>(xT + cm(c, 16 * g + 8 * hh));
                uint4* drow = reinterpret_cast<uint4*>(dtT + cm(c, 16 * g + 8 * hh));
                float xf[8];
                unpack8(*xrow, xf);
                uint32_t wx[4], wd[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int j = 8 * hh + 2 * i;
                    dd = fmaf(dyv[j], xf[2 * i], dd);
                    dd = fmaf(dyv[j + 1], xf[2 * i + 1], dd);
                    wx[i] = pack_bf16(__floats2bfloat162_rn(
                        fmaf(dtv[j], s1[j], dc * dyv[j]),
                        fmaf(dtv[j + 1], s1[j + 1], dc * dyv[j + 1])));
                    wd[i] = pack_bf16(__floats2bfloat162_rn(
                        fmaf(xf[2 * i], s1[j], s2[j]),
                        fmaf(xf[2 * i + 1], s1[j + 1], s2[j + 1])));
                }
                *xrow = make_uint4(wx[0], wx[1], wx[2], wx[3]);
                *drow = make_uint4(wd[0], wd[1], wd[2], wd[3]);
            }
#pragma unroll
            for (int o = 8; o; o >>= 1) dd += __shfl_xor_sync(FULL, dd, o, 16);
            if (g == 0) dDs[cc] += dd;
            __syncthreads();
            // ---- dx and ddt out, channels contiguous; after the last
            // pass, the tile's dB and dC sums into the block's partial ----
            if (VEC) {
                for (int i = tid; i < TT * PC / 8; i += THREADS) {
                    const int r = i / (PC / 8), ch = i % (PC / 8);
                    if (r >= nt || pc0 + 8 * ch >= Di) continue;
                    uint32_t w[2][4];
#pragma unroll
                    for (int i2 = 0; i2 < 4; ++i2) {
                        w[0][i2] = (uint32_t)xT[cm(8 * ch + 2 * i2, r)]
                                   | (uint32_t)xT[cm(8 * ch + 2 * i2 + 1, r)] << 16;
                        w[1][i2] = (uint32_t)dtT[cm(8 * ch + 2 * i2, r)]
                                   | (uint32_t)dtT[cm(8 * ch + 2 * i2 + 1, r)] << 16;
                    }
                    const size_t off = ((size_t)b * S + t0 + r) * Di + pc0 + 8 * ch;
                    *reinterpret_cast<uint4*>(dx + off) = make_uint4(w[0][0], w[0][1], w[0][2], w[0][3]);
                    *reinterpret_cast<uint4*>(ddt + off) = make_uint4(w[1][0], w[1][1], w[1][2], w[1][3]);
                }
            } else {
                for (int i = tid; i < TT * PC; i += THREADS) {
                    const int r = i / PC, c2 = i % PC;
                    if (r < nt && pc0 + c2 < Di) {
                        const size_t off = ((size_t)b * S + t0 + r) * Di + pc0 + c2;
                        reinterpret_cast<uint16_t*>(dx)[off] = xT[cm(c2, r)];
                        reinterpret_cast<uint16_t*>(ddt)[off] = dtT[cm(c2, r)];
                    }
                }
            }
            if (pass + 1 == PASSES && tid < nt) {
                // thread t: step t's N sums, 16 bytes a store
                const size_t o = (((size_t)blockIdx.x * B + b) * S + t0 + tid) * N;
#pragma unroll
                for (int n = 0; n < N; n += 4) {
                    *reinterpret_cast<float4*>(pB + o + n) = make_float4(
                        acc[n * TT + tid], acc[(n + 1) * TT + tid],
                        acc[(n + 2) * TT + tid], acc[(n + 3) * TT + tid]);
                    *reinterpret_cast<float4*>(pC + o + n) = make_float4(
                        acc[(N + n) * TT + tid], acc[(N + n + 1) * TT + tid],
                        acc[(N + n + 2) * TT + tid], acc[(N + n + 3) * TT + tid]);
                }
            }
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

template <int N, bool VEC>
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
            scan_bwd_kernel<N, VEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
        ready = true;
    }
    dim3 grid((Di + CT - 1) / CT, B);
    scan_bwd_kernel<N, VEC><<<grid, THREADS, bytes, st>>>(
        (const bf16*)x, (const bf16*)dt, (const float*)A, (const bf16*)Bm,
        (const bf16*)C, (const float*)D, (const float*)hsave,
        (const bf16*)dy, (const float*)dhT, (bf16*)dx, (bf16*)ddt,
        (float*)dh0, (float*)pB, (float*)pC, (float*)pA, (float*)pD, S, Di);
    return (int)cudaGetLastError();
}

template <int N>
static int launch_n(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* C, const void* D,
                    const void* hsave, const void* dy, const void* dhT,
                    void* dx, void* ddt, void* dh0, void* pB, void* pC,
                    void* pA, void* pD, int B, int S, int Di, int vec,
                    cudaStream_t st) {
    return vec ? launch<N, true>(x, dt, A, Bm, C, D, hsave, dy, dhT, dx, ddt, dh0, pB, pC, pA, pD, B, S, Di, st)
               : launch<N, false>(x, dt, A, Bm, C, D, hsave, dy, dhT, dx, ddt, dh0, pB, pC, pA, pD, B, S, Di, st);
}

// Shapes as selective_scan.cu's; hsave (B, ceil(S / 256), Di, N) from the
// forward; dhT null for a zero gradient of hT; vec: Di a multiple of 8 and
// x, dt, dy, dx, ddt 16-byte aligned (else the scalar staging path).
// Scratch: pB, pC (ceil(Di / 64), B, S, N) f32, pA (B, Di, N), pD (B, Di).
// Outputs: dx, ddt (B, S, Di) bf16, dA (Di, N) f32, dB, dC (B, S, N) bf16,
// dD (Di,) f32, dh0 (B, Di, N) f32. Two launches; returns
// cudaGetLastError() after them, cudaErrorInvalidValue for a state size
// other than 4, 8 or 16.
extern "C" int selective_scan_bwd_bf16(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* C, const void* D, const void* hsave, const void* dy,
    const void* dhT, void* dx, void* ddt, void* dA, void* dB, void* dC,
    void* dD, void* dh0, void* pB, void* pC, void* pA, void* pD, int B,
    int S, int Di, int N, int vec, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    int e;
    switch (N) {
        case 4: e = launch_n<4>(x, dt, A, Bm, C, D, hsave, dy, dhT, dx, ddt, dh0, pB, pC, pA, pD, B, S, Di, vec, st); break;
        case 8: e = launch_n<8>(x, dt, A, Bm, C, D, hsave, dy, dhT, dx, ddt, dh0, pB, pC, pA, pD, B, S, Di, vec, st); break;
        case 16: e = launch_n<16>(x, dt, A, Bm, C, D, hsave, dy, dhT, dx, ddt, dh0, pB, pC, pA, pD, B, S, Di, vec, st); break;
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
