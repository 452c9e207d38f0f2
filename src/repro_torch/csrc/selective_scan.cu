// Mamba1 selective scan for Hopper (sm_90a): the prefill recurrence of the
// SSM family (falcon-mamba-7b).
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
// 132 SMs they take 8 us, above the memory bound. The FMAs (about 5 per
// state and step) are below both.
//
// Design:
// - The recurrence is sequential in t, so each (channel, state) pair is
//   walked in order by one thread; the TPU kernel's in-chunk associative
//   scan is a VMEM adaptation and is not carried over.
// - A channel's N states are split over LPC = min(N, 8) neighbouring lanes
//   of a warp (N / LPC states each, in registers), so Di = 8192 gives 512
//   blocks of 16 channels instead of 64 blocks of one channel per thread.
//   y's sum over n is a register sum plus log2(LPC) xor shuffles.
// - Timesteps go in tiles of TT = 64: the block stages x and dt for its
//   channels, and B and C (shared by every channel), in shared memory as
//   f32, walks the tile, collects y in shared memory and writes it out
//   with the channels contiguous. Channels past Di are zero-filled and
//   not stored; a ragged S is the last, shorter tile.
// - Simple first: no cp.async double buffering of the next tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define TT 64  // timesteps staged per tile

template <int N>
__global__ void __launch_bounds__(THREADS) selective_scan_kernel(
    const __nv_bfloat16* __restrict__ x,   // (B, S, Di)
    const __nv_bfloat16* __restrict__ dt,  // (B, S, Di)
    const float* __restrict__ A,           // (Di, N)
    const __nv_bfloat16* __restrict__ Bm,  // (B, S, N)
    const __nv_bfloat16* __restrict__ C,   // (B, S, N)
    const float* __restrict__ D,           // (Di,)
    const float* __restrict__ h0,          // (B, Di, N)
    __nv_bfloat16* __restrict__ y,         // (B, S, Di)
    float* __restrict__ hT,                // (B, Di, N)
    int S, int Di) {
    constexpr int LPC = N < 8 ? N : 8;   // lanes per channel
    constexpr int SPL = N / LPC;         // states per lane
    constexpr int CPB = THREADS / LPC;   // channels per block
    __shared__ float xs[TT][CPB];
    __shared__ float dts[TT][CPB];
    __shared__ float ys[TT][CPB];
    __shared__ float bs[TT][N];
    __shared__ float cs[TT][N];

    const int b = blockIdx.y;
    const int c0 = blockIdx.x * CPB;
    const int tid = threadIdx.x;
    const int lc = tid / LPC;   // this thread's channel within the block
    const int g = tid % LPC;    // its group of states: g*SPL .. g*SPL+SPL-1
    const int ch = c0 + lc;
    const bool live = ch < Di;

    float a[SPL], h[SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
        const int n = g * SPL + s;
        a[s] = live ? A[(size_t)ch * N + n] : 0.f;
        h[s] = live ? h0[((size_t)b * Di + ch) * N + n] : 0.f;
    }
    const float dskip = live ? D[ch] : 0.f;

    for (int t0 = 0; t0 < S; t0 += TT) {
        const int nt = min(TT, S - t0);
        __syncthreads();  // the previous tile's ys are written out
        for (int i = tid; i < TT * CPB; i += THREADS) {
            const int r = i / CPB;
            const int cc = i - r * CPB;
            float xv = 0.f, dv = 0.f;
            if (r < nt && c0 + cc < Di) {
                const size_t off = ((size_t)b * S + t0 + r) * Di + c0 + cc;
                xv = __bfloat162float(x[off]);
                dv = __bfloat162float(dt[off]);
            }
            xs[r][cc] = xv;
            dts[r][cc] = dv;
        }
        for (int i = tid; i < TT * N; i += THREADS) {
            const int r = i / N;
            const int n = i - r * N;
            float bv = 0.f, cv = 0.f;
            if (r < nt) {
                const size_t off = ((size_t)b * S + t0 + r) * N + n;
                bv = __bfloat162float(Bm[off]);
                cv = __bfloat162float(C[off]);
            }
            bs[r][n] = bv;
            cs[r][n] = cv;
        }
        __syncthreads();

        for (int r = 0; r < nt; ++r) {
            const float xv = xs[r][lc];
            const float dv = dts[r][lc];
            const float dx = dv * xv;
            float part = 0.f;
#pragma unroll
            for (int s = 0; s < SPL; ++s) {
                const int n = g * SPL + s;
                h[s] = expf(dv * a[s]) * h[s] + dx * bs[r][n];
                part += h[s] * cs[r][n];
            }
#pragma unroll
            for (int o = LPC / 2; o > 0; o >>= 1)
                part += __shfl_xor_sync(0xffffffffu, part, o);
            if (g == 0) ys[r][lc] = part + dskip * xv;
        }
        __syncthreads();

        for (int i = tid; i < nt * CPB; i += THREADS) {
            const int r = i / CPB;
            const int cc = i - r * CPB;
            if (c0 + cc < Di)
                y[((size_t)b * S + t0 + r) * Di + c0 + cc] =
                    __float2bfloat16(ys[r][cc]);
        }
    }
    if (live) {
#pragma unroll
        for (int s = 0; s < SPL; ++s)
            hT[((size_t)b * Di + ch) * N + g * SPL + s] = h[s];
    }
}

template <int N>
static int launch(const void* x, const void* dt, const void* A, const void* Bm,
                  const void* C, const void* D, const void* h0, void* y,
                  void* hT, int B, int S, int Di, cudaStream_t stream) {
    constexpr int LPC = N < 8 ? N : 8;
    constexpr int CPB = THREADS / LPC;
    dim3 grid((Di + CPB - 1) / CPB, B);
    selective_scan_kernel<N><<<grid, THREADS, 0, stream>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)dt, (const float*)A,
        (const __nv_bfloat16*)Bm, (const __nv_bfloat16*)C, (const float*)D,
        (const float*)h0, (__nv_bfloat16*)y, (float*)hT, S, Di);
    return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// state size the kernel has no instance for.
extern "C" int selective_scan_bf16(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* C, const void* D, const void* h0, void* y, void* hT,
    int B, int S, int Di, int N, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (N) {
        case 4: return launch<4>(x, dt, A, Bm, C, D, h0, y, hT, B, S, Di, st);
        case 8: return launch<8>(x, dt, A, Bm, C, D, h0, y, hT, B, S, Di, st);
        case 16: return launch<16>(x, dt, A, Bm, C, D, h0, y, hT, B, S, Di, st);
        case 32: return launch<32>(x, dt, A, Bm, C, D, h0, y, hT, B, S, Di, st);
        case 64: return launch<64>(x, dt, A, Bm, C, D, h0, y, hT, B, S, Di, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
