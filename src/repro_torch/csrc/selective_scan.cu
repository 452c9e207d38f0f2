// Mamba1 selective scan for Hopper (sm_90a): the prefill recurrence of the
// SSM family (falcon-mamba-7b), as a time-parallel warp scan.
//
// Replaces: repro/kernels/selective_scan.py, selective_scan (_scan_kernel,
// the TPU kernel whose grid walks sequence chunks in order, carrying the
// (channels, N) state in VMEM scratch, with a log-depth associative scan
// inside each chunk).
//
// Computes, per batch row b, channel d and state n, from h = h0[b, d, n]:
//   h   = exp(dt[t, d] * A[d, n]) * h + (dt[t, d] * x[t, d]) * B[t, n]
//   y[t, d] = sum_n h * C[t, n] + D[d] * x[t, d]
// returning y (bf16) and the final state hT (f32). Everything is f32 inside,
// whatever the model's ssm_dtype (the TPU kernel ignores it too).
//
// What bounds it on this card: operations, on the special-function units.
// At falcon-mamba's prefill chunk (S = 256, Di = 8192, N = 16) the kernel
// reads x and dt (4 MB each, bf16), B and C (16 KB), A and h0 (0.5 MB
// each), and writes y (4 MB) and hT (0.5 MB): about 14 MB, 4.2 us at
// 3.35 TB/s. It evaluates S * Di * N = 33.5 M exponentials; an SM's
// special-function units retire 16 of them per clock, so at 1.98 GHz on
// 132 SMs they take 8 us, above the memory bound. Next comes the issue of
// the ~10 other instructions per step and state (the fold, the replay, y,
// the scan's shuffles).
//
// The first design gave each (channel, state group) to a thread that
// walked every step in order, in 64-step tiles loaded with 2-byte loads. A
// %globaltimer timeline of it at the chunk (tools/scan_timeline.py, PERF.md
// section 6) put 58 % of each block's time in that walk (three dependent
// shuffles and an exponential a step) and 37 % in staging that overlapped
// nothing; its accurate expf cost 7 % of the walk. This design:
// - Block: one batch row and CT = 32 contiguous channels, 8 warps. Steps go
//   in tiles of TT = 256 at fixed offsets from the call's start. Each
//   tile's x and dt rows, (256, 32) bf16, are staged with 16-byte cp.async
//   loads into a row-major buffer, then transposed into channel-major
//   shared memory (a 16-byte chunk XOR swizzle keeps both sides free of
//   bank conflicts); B and C are read as bf16 pairs, neighbouring threads
//   on neighbouring words, into registers ahead of use, and stored as f32
//   (N, 256) tiles laid out so that each 16-byte read of a half-warp is
//   contiguous. The next tile's copies are in flight while this tile is
//   computed.
// - Warp: 4 channels, two at a time, one per half-warp. Lane g of a half
//   owns steps 16g .. 16g+15 of the tile. Per state n it forms its 16
//   pairs (a, b) = (exp2(dt * A log2 e), dt x B) in registers, with
//   A log2 e formed once per (d, n): one ex2.approx per (t, d, n). It folds
//   them in step order into one map h -> P h + Q (P = exp2(A log2 e * the
//   lane's dt sum), one more exponential per 16 steps); a fixed 4-round
//   Kogge-Stone shuffle scan composes the 16 lanes' maps; the composite of
//   lanes 0..g-1 applied to the carried state is lane g's entering state;
//   the lane replays its 16 steps, h = a h + b, and adds h C[t, n] to its
//   16 y sums. Lane 15's last state is the carry into the next tile; after
//   the last tile it is hT. A half-warp per channel rather than a warp
//   (8 steps a lane, 5 rounds), because the scan then costs each step half
//   as many shuffles, and P from the dt sum rather than 15 products: the
//   state loop went from 206 instructions per two channels and state to
//   135, 8 % and then 2 % less time at the chunk (PERF.md section 6).
// - y = sum + D x is rounded to bf16 over x in the channel's own shared
//   row, then written out 16 bytes a thread with channels contiguous.
// - The same bits however a call is cut: the fold and the combine tree
//   depend only on a step's index within its tile, tiles start at multiples
//   of 256 from the call's start, and the state crosses a tile boundary
//   through the carried f32 value alone. So one call over S steps equals
//   chained calls cut at multiples of 256, bit for bit, and a batch row's
//   bits do not depend on the batch.
// - Ragged tail: the last tile's steps past S, and channels past Di, are
//   zero-filled: dt = 0 makes each an identity step (exp2(0) = 1, dt x B =
//   0, exact) and nothing of them is stored.
// - Shared memory: 101 KB at N = 16 (two blocks, 16 warps, an SM, the
//   register file full at ~126 registers a thread); 213 KB at N = 64 (one
//   block). A Di that is not a multiple of 8, or an x, dt or y off 16
//   bytes, takes a scalar staging path with the same arithmetic.
// - For training, the call may also save the f32 state entering each tile,
//   (B, tiles, Di, N), tile 0's being h0 (hsave; null when serving). It is
//   the carried value the next tile starts from, stored while the tile is
//   staged; no operation of the scan changes, so y and hT keep their bits.
//   selective_scan_bwd.cu replays each tile from it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)
#define TT 256               // steps of a tile: 16 lanes x 16
#define CT 32                // channels of a block
#define CPW (CT / WARPS)     // channels of a warp, taken two at a time
#define NS (TT + 4)          // row stride of a B or C tile: fewer conflicts
#define LOG2E 1.4426950408889634f
static_assert(TT == 16 * 16 && CT == 32 && CPW == 4, "tile shape");

__device__ __forceinline__ float ex2(float x) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

// 16 bytes from global, or zeros where src_bytes is 0
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// channel-major (CT, TT) bf16 tile: step t of channel c, its 16-byte chunk
// XOR-swizzled by c / 8 so a warp's transposing writes (8 steps x 4 chunks
// of channels) and its reads (one channel's 32 chunks) avoid conflicts
__device__ __forceinline__ int cm(int c, int t) {
    return c * TT + 8 * ((t >> 3) ^ (c >> 3)) + (t & 7);
}

// (N, TT) f32 tile of B or C, rows NS apart: the steps 16g + 4q .. 16g +
// 4q + 3 of lane group g at 64q + 4g, so each of a half-warp's four 16-byte
// reads is a contiguous 256 bytes
__device__ __forceinline__ int nm(int n, int t) {
    return n * NS + ((t & 15) >> 2) * 64 + (t >> 4) * 4 + (t & 3);
}

// B and C rows [t0, t0 + nt) of batch row b as bf16 pairs, N / 2 words a
// thread, neighbouring threads on neighbouring words (zeros past S)
template <int N>
__device__ __forceinline__ void load_bc(uint32_t* bw, uint32_t* cw,
                                        const __nv_bfloat16* Bm,
                                        const __nv_bfloat16* C, int b, int S,
                                        int t0, int nt) {
    const size_t base = ((size_t)b * S + t0) * N / 2;
    const uint32_t* b32 = reinterpret_cast<const uint32_t*>(Bm) + base;
    const uint32_t* c32 = reinterpret_cast<const uint32_t*>(C) + base;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
        const int w = threadIdx.x + THREADS * j;
        const bool ok = 2 * w / N < nt;
        bw[j] = ok ? b32[w] : 0u;
        cw[j] = ok ? c32[w] : 0u;
    }
}

// the words of load_bc into the f32 (N, TT) tiles
template <int N>
__device__ __forceinline__ void store_bc(const uint32_t* bw,
                                         const uint32_t* cw, float* BT,
                                         float* CTs) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
        const int e = 2 * (threadIdx.x + THREADS * j);
        const int t = e / N, n = e % N;
        BT[nm(n, t)] = __uint_as_float(bw[j] << 16);
        BT[nm(n + 1, t)] = __uint_as_float(bw[j] & 0xffff0000u);
        CTs[nm(n, t)] = __uint_as_float(cw[j] << 16);
        CTs[nm(n + 1, t)] = __uint_as_float(cw[j] & 0xffff0000u);
    }
}

__device__ __forceinline__ void unpack8(uint4 v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
}

template <int N>
struct Smem {
    static constexpr size_t cm_bytes = (size_t)CT * TT * 2;   // one bf16 tile
    static constexpr size_t nm_bytes = (size_t)N * NS * 4;    // one f32 tile
    static constexpr size_t bytes(bool vec) {
        return 2 * cm_bytes + 2 * nm_bytes + 2 * (size_t)CT * N * 4
               + CT * 4 + (vec ? 2 * cm_bytes : 0);
    }
};

// x and dt rows [t0, t0 + nt) of channels [c0, c0 + CT) into the row-major
// staging buffers, 16 bytes a copy; past S or Di, zeros
__device__ __forceinline__ void issue_tile(
    __nv_bfloat16* xr, __nv_bfloat16* dr, const __nv_bfloat16* x,
    const __nv_bfloat16* dt, int b, int S, int Di, int c0, int t0, int nt) {
    for (int i = threadIdx.x; i < TT * CT / 8; i += THREADS) {
        const int r = i >> 2, ch = i & 3;
        const bool ok = r < nt && c0 + 8 * ch < Di;
        const size_t off =
            ok ? ((size_t)b * S + t0 + r) * Di + c0 + 8 * ch : 0;
        cp_async16_zfill(xr + r * CT + 8 * ch, x + off, ok ? 16 : 0);
        cp_async16_zfill(dr + r * CT + 8 * ch, dt + off, ok ? 16 : 0);
    }
    cp_async_commit();
}

// two blocks an SM up to N = 16; above, shared memory allows one
template <int N, bool VEC>
__global__ void __launch_bounds__(THREADS, N <= 16 ? 2 : 1) selective_scan_kernel(
    const __nv_bfloat16* __restrict__ x,   // (B, S, Di)
    const __nv_bfloat16* __restrict__ dt,  // (B, S, Di)
    const float* __restrict__ A,           // (Di, N)
    const __nv_bfloat16* __restrict__ Bm,  // (B, S, N)
    const __nv_bfloat16* __restrict__ C,   // (B, S, N)
    const float* __restrict__ D,           // (Di,)
    const float* __restrict__ h0,          // (B, Di, N)
    __nv_bfloat16* __restrict__ y,         // (B, S, Di)
    float* __restrict__ hT,                // (B, Di, N)
    float* __restrict__ hsave,             // (B, tiles, Di, N) or null
    int S, int Di) {
    extern __shared__ __align__(16) unsigned char smem[];
    // bf16 tiles held as their 16-bit patterns
    uint16_t* xT = reinterpret_cast<uint16_t*>(smem);             // cm
    uint16_t* dtT = xT + CT * TT;                                 // cm
    float* BT = reinterpret_cast<float*>(dtT + CT * TT);          // nm
    float* CTs = BT + N * NS;                                     // nm
    float* As = CTs + N * NS;   // (CT, N): A log2 e
    float* hs = As + CT * N;    // (CT, N): the carried state
    float* Ds = hs + CT * N;    // (CT,)
    __nv_bfloat16* xr = reinterpret_cast<__nv_bfloat16*>(Ds + CT);  // (TT, CT)
    __nv_bfloat16* dr = xr + TT * CT;                                // (TT, CT)
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);
    const uint16_t* dts = reinterpret_cast<const uint16_t*>(dt);

    const int b = blockIdx.y;
    const int c0 = blockIdx.x * CT;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned FULL = 0xffffffffu;

    uint32_t bw[N / 2], cw[N / 2];  // the next tile's B and C, in flight
    if (VEC && S > 0) issue_tile(xr, dr, x, dt, b, S, Di, c0, 0, min(TT, S));
    if (S > 0) load_bc<N>(bw, cw, Bm, C, b, S, 0, min(TT, S));
    for (int i = tid; i < CT * N; i += THREADS) {
        const bool live = c0 + i / N < Di;
        As[i] = live ? A[(size_t)c0 * N + i] * LOG2E : 0.f;
        hs[i] = live ? h0[((size_t)b * Di + c0) * N + i] : 0.f;
    }
    for (int c = tid; c < CT; c += THREADS) Ds[c] = c0 + c < Di ? D[c0 + c] : 0.f;

    const int ntiles = (S + TT - 1) / TT;
    for (int k = 0; k < ntiles; ++k) {
        const int t0 = k * TT, nt = min(TT, S - t0);
        // ---- stage: x and dt channel-major, B and C as f32 ----
        if (VEC) {
            cp_async_wait<0>();
            __syncthreads();  // the copies landed; the last tile's y is out
            for (int i = tid; i < TT * CT / 8; i += THREADS) {
                const int r = i >> 2, ch = i & 3;
                const uint4 xv = reinterpret_cast<const uint4*>(xr)[i];
                const uint4 dv = reinterpret_cast<const uint4*>(dr)[i];
                const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
                const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const int sh = 16 * (e & 1);
                    xT[cm(8 * ch + e, r)] = (uint16_t)(xw[e >> 1] >> sh);
                    dtT[cm(8 * ch + e, r)] = (uint16_t)(dw[e >> 1] >> sh);
                }
            }
        } else {
            __syncthreads();  // the last tile's y is out
            for (int i = tid; i < TT * CT; i += THREADS) {
                const int r = i / CT, c = i % CT;
                const bool ok = r < nt && c0 + c < Di;
                const size_t off = ((size_t)b * S + t0 + r) * Di + c0 + c;
                xT[cm(c, r)] = ok ? xs[off] : (uint16_t)0;
                dtT[cm(c, r)] = ok ? dts[off] : (uint16_t)0;
            }
        }
        store_bc<N>(bw, cw, BT, CTs);
        // the state entering this tile (no thread writes hs until the
        // barrier below)
        if (hsave)
            for (int i = tid; i < CT * N; i += THREADS)
                if (c0 + i / N < Di)
                    hsave[(((size_t)b * ntiles + k) * Di + c0) * N + i] = hs[i];
        __syncthreads();
        if (VEC && k + 1 < ntiles)
            issue_tile(xr, dr, x, dt, b, S, Di, c0, t0 + TT,
                       min(TT, S - t0 - TT));

        // ---- scan: a half-warp per channel, two channels a warp ----
        const int g = lane & 15;     // steps 16g .. 16g+15 of the tile
#pragma unroll 1
        for (int p = 0; p < CPW; p += 2) {
            const int c = warp * CPW + p + (lane >> 4);
            float dtv[16], dxv[16], yv[16], sdt = 0.f;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                float xf[8];
                unpack8(*reinterpret_cast<const uint4*>(xT + cm(c, 16 * g + 8 * hh)), xf);
                unpack8(*reinterpret_cast<const uint4*>(dtT + cm(c, 16 * g + 8 * hh)),
                        dtv + 8 * hh);
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    dxv[8 * hh + j] = dtv[8 * hh + j] * xf[j];
                    yv[8 * hh + j] = 0.f;
                    sdt += dtv[8 * hh + j];
                }
            }
#pragma unroll 1
            for (int n = 0; n < N; ++n) {
                const float a2 = As[c * N + n];
                const float carry = hs[c * N + n];
                float av[16], bv[16];
#pragma unroll
                for (int q4 = 0; q4 < 4; ++q4) {
                    const float4 bq = *reinterpret_cast<const float4*>(
                        BT + n * NS + 64 * q4 + 4 * g);
                    const float bb[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int j = 4 * q4 + e;
                        av[j] = ex2(dtv[j] * a2);
                        bv[j] = dxv[j] * bb[e];
                    }
                }
                // the lane's 16 steps folded in order: h -> P h + Q, with
                // P = exp2(A log2 e * sum dt), the product of the 16 a's
                float P = ex2(sdt * a2), Q = bv[0];
#pragma unroll
                for (int j = 1; j < 16; ++j) Q = fmaf(av[j], Q, bv[j]);
                // lanes 0..g of the half composed (inclusive Kogge-Stone)
#pragma unroll
                for (int o = 1; o < 16; o <<= 1) {
                    const float Pp = __shfl_up_sync(FULL, P, o, 16);
                    const float Qp = __shfl_up_sync(FULL, Q, o, 16);
                    const float Qn = fmaf(P, Qp, Q), Pn = P * Pp;
                    Q = g >= o ? Qn : Q;
                    P = g >= o ? Pn : P;
                }
                // the state entering lane g: lanes 0..g-1 on the carry
                float h = __shfl_up_sync(FULL, fmaf(P, carry, Q), 1, 16);
                if (g == 0) h = carry;
#pragma unroll
                for (int q4 = 0; q4 < 4; ++q4) {
                    const float4 cq = *reinterpret_cast<const float4*>(
                        CTs + n * NS + 64 * q4 + 4 * g);
                    const float cc[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int j = 4 * q4 + e;
                        h = fmaf(av[j], h, bv[j]);
                        yv[j] = fmaf(h, cc[e], yv[j]);
                    }
                }
                if (g == 15) hs[c * N + n] = h;
            }
            // y = sum + D x, rounded to bf16 over x in the channel's row
            const float dc = Ds[c];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                uint4* row = reinterpret_cast<uint4*>(xT + cm(c, 16 * g + 8 * hh));
                float xf[8];
                unpack8(*row, xf);
                uint32_t w[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    w[i] = pack_bf16(__floats2bfloat162_rn(
                        fmaf(dc, xf[2 * i], yv[8 * hh + 2 * i]),
                        fmaf(dc, xf[2 * i + 1], yv[8 * hh + 2 * i + 1])));
                *row = make_uint4(w[0], w[1], w[2], w[3]);
            }
        }
        if (k + 1 < ntiles)
            load_bc<N>(bw, cw, Bm, C, b, S, t0 + TT, min(TT, S - t0 - TT));
        __syncthreads();

        // ---- y out, channels contiguous ----
        if (VEC) {
            for (int i = tid; i < TT * CT / 8; i += THREADS) {
                const int r = i >> 2, ch = i & 3;
                if (r >= nt || c0 + 8 * ch >= Di) continue;
                uint32_t w[4];
#pragma unroll
                for (int i2 = 0; i2 < 4; ++i2)
                    w[i2] = (uint32_t)xT[cm(8 * ch + 2 * i2, r)]
                            | (uint32_t)xT[cm(8 * ch + 2 * i2 + 1, r)] << 16;
                *reinterpret_cast<uint4*>(
                    y + ((size_t)b * S + t0 + r) * Di + c0 + 8 * ch) =
                    make_uint4(w[0], w[1], w[2], w[3]);
            }
        } else {
            for (int i = tid; i < TT * CT; i += THREADS) {
                const int r = i / CT, c = i % CT;
                if (r < nt && c0 + c < Di)
                    reinterpret_cast<uint16_t*>(y)[
                        ((size_t)b * S + t0 + r) * Di + c0 + c] = xT[cm(c, r)];
            }
        }
    }
    __syncthreads();
    for (int i = tid; i < CT * N; i += THREADS)
        if (c0 + i / N < Di) hT[((size_t)b * Di + c0) * N + i] = hs[i];
}

template <int N, bool VEC>
static int launch(const void* x, const void* dt, const void* A, const void* Bm,
                  const void* C, const void* D, const void* h0, void* y,
                  void* hT, void* hsave, int B, int S, int Di,
                  cudaStream_t stream) {
    const size_t bytes = Smem<N>::bytes(VEC);
    static bool ready = false;  // the shared-memory limit, set once
    if (!ready) {
        const cudaError_t err = cudaFuncSetAttribute(
            selective_scan_kernel<N, VEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
        ready = true;
    }
    dim3 grid((Di + CT - 1) / CT, B);
    selective_scan_kernel<N, VEC><<<grid, THREADS, bytes, stream>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)dt, (const float*)A,
        (const __nv_bfloat16*)Bm, (const __nv_bfloat16*)C, (const float*)D,
        (const float*)h0, (__nv_bfloat16*)y, (float*)hT, (float*)hsave, S,
        Di);
    return (int)cudaGetLastError();
}

template <int N>
static int launch_n(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* C, const void* D,
                    const void* h0, void* y, void* hT, void* hs, int B,
                    int S, int Di, int vec, cudaStream_t st) {
    return vec ? launch<N, true>(x, dt, A, Bm, C, D, h0, y, hT, hs, B, S, Di, st)
               : launch<N, false>(x, dt, A, Bm, C, D, h0, y, hT, hs, B, S, Di, st);
}

// vec: Di is a multiple of 8 and x, dt and y are 16-byte aligned (16-byte
// staging and stores); else the scalar path. hsave: null, or (B,
// ceil(S / 256), Di, N) f32 for the state entering each tile. Returns
// cudaGetLastError()
// after the launch; cudaErrorInvalidValue for a state size the kernel has
// no instance for.
extern "C" int selective_scan_bf16(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* C, const void* D, const void* h0, void* y, void* hT,
    void* hsave, int B, int S, int Di, int N, int vec, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (N) {
        case 4: return launch_n<4>(x, dt, A, Bm, C, D, h0, y, hT, hsave, B, S, Di, vec, st);
        case 8: return launch_n<8>(x, dt, A, Bm, C, D, h0, y, hT, hsave, B, S, Di, vec, st);
        case 16: return launch_n<16>(x, dt, A, Bm, C, D, h0, y, hT, hsave, B, S, Di, vec, st);
        case 32: return launch_n<32>(x, dt, A, Bm, C, D, h0, y, hT, hsave, B, S, Di, vec, st);
        case 64: return launch_n<64>(x, dt, A, Bm, C, D, h0, y, hT, hsave, B, S, Di, vec, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
