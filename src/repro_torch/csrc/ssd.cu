// Mamba2 SSD (state-space duality, chunked) for Hopper (sm_90a): the prefill
// recurrence of the hybrid family (zamba2-1.2b).
//
// Replaces: repro/kernels/ssd.py, ssd (_ssd_kernel, the TPU kernel whose
// grid walks sequence chunks in order per (batch, head), carrying the (P, N)
// state in VMEM scratch, with the in-chunk work as c x c matrix products).
//
// Computes, per batch row b and head h, chunk by chunk (c = min(chunk, S);
// a ragged tail behaves as zero-padded steps with dt = 0), with
// l = inclusive cumsum of dt * A[h] within the chunk and H the state
// entering it:
//   y[i, p] = sum_{j <= i} exp(l_i - l_j) (C_i . B_j) dt_j x[j, p]
//           + exp(l_i) sum_n C[i, n] H[p, n] + D[h] x[i, p]
//   H'[p, n] = exp(l_last) H[p, n] + sum_j exp(l_last - l_j) dt_j x[j, p] B[j, n]
// returning y (bf16) and the final state hT (f32), all arithmetic in f32.
//
// What bounds it on this card: operations. At zamba2's prefill chunk
// (S = c = 256, Hs = 64, P = 64, N = 64) the causal half of C B^T is
// 256*257/2 * 64 = 2.1 M FMA per head, the masked product with x as much
// again, the carried-state terms 2 * 256 * 64 * 64 = 2.1 M: about 6.3 M FMA
// = 12.6 MFLOP per head, 0.81 GFLOP per call, 12 us at the 67 TFLOP/s of f32
// outside the tensor cores; the call moves about 6 MB (x, y, B, C, h0, hT),
// 1.8 us at 3.35 TB/s.
//
// Design:
// - Grid (Hs * ceil(P / 32), B): a block owns one head and 32 of its P
//   columns, so zamba2's 64 heads fill 128 of the 132 SMs; the columns of
//   the state are independent, and the cost is C B^T computed twice per
//   head. A block walks its chunks in order and carries its (32, N) slice
//   of the state in shared memory.
// - Per chunk the block stages B, C and its x columns in shared memory (f32,
//   rows padded by one word so that the 2 x 2 register tiles below read
//   distinct banks), with dt, l, exp(l) and the state weights
//   exp(l_last - l_j) dt_j. l is a warp scan.
// - y is formed by 32-row query tiles. For each 32-key tile at or below the
//   diagonal the 256 threads compute the masked tile
//   M = (C B^T) * exp(l_i - l_j) * dt_j into shared memory (a 2 x 2 tile
//   each), then accumulate M x into their 2 x 2 tile of y. exp(l_i - l_j)
//   is formed from the difference, never as exp(l_i) * exp(-l_j): l is a
//   sum of negative terms, and exp(-l_j) overflows on long chunks. Tiles
//   above the diagonal are skipped; j > i inside the diagonal tile is
//   masked.
// - The state update follows the chunk's y (which reads the old state):
//   each thread owns 8 (p, n) entries.
// - Simple first: f32 FMAs, no tensor cores (wgmma), no staging overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define PB 32  // state columns (p) per block
#define TI 32  // query rows per tile
#define TJ 32  // keys per tile

__global__ void __launch_bounds__(THREADS) ssd_kernel(
    const __nv_bfloat16* __restrict__ x,   // (B, S, Hs, P)
    const __nv_bfloat16* __restrict__ dt,  // (B, S, Hs)
    const float* __restrict__ A,           // (Hs,)
    const __nv_bfloat16* __restrict__ Bm,  // (B, S, N)
    const __nv_bfloat16* __restrict__ C,   // (B, S, N)
    const float* __restrict__ D,           // (Hs,)
    const float* __restrict__ h0,          // (B, Hs, P, N)
    __nv_bfloat16* __restrict__ y,         // (B, S, Hs, P)
    float* __restrict__ hT,                // (B, Hs, P, N)
    int S, int Hs, int P, int N, int chunk) {
    const int n_pt = (P + PB - 1) / PB;
    const int h = blockIdx.x / n_pt;
    const int p0 = (blockIdx.x - h * n_pt) * PB;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int ty = tid >> 4;  // 0..15
    const int tx = tid & 15;  // 0..15
    const int c = chunk;
    const int CP = (c + TI - 1) / TI * TI;  // rows staged: c rounded up to tiles
    const int NL = N + 1;     // padded row of B, C and the state
    const int XL = PB + 1;    // padded row of x

    extern __shared__ __align__(16) float smem[];
    float* bs = smem;              // (CP, NL)
    float* cs = bs + CP * NL;      // (CP, NL)
    float* xs = cs + CP * NL;      // (CP, XL)
    float* dts = xs + CP * XL;     // (CP,)
    float* ls = dts + CP;          // (CP,) cumsum of dt * a
    float* els = ls + CP;          // (CP,) exp(l_i)
    float* ws = els + CP;          // (CP,) exp(l_last - l_j) * dt_j
    float* ms = ws + CP;           // (TI, TJ + 1) masked decay tile
    float* hs = ms + TI * (TJ + 1);  // (PB, NL) carried state

    const float a = A[h];
    const float dskip = D[h];
    const size_t hrow = (size_t)(b * Hs + h) * P;  // row of (p = 0) in h0/hT
    for (int i = tid; i < PB * N; i += THREADS) {
        const int p = i / N;
        const int n = i - p * N;
        hs[p * NL + n] = (p0 + p < P) ? h0[(hrow + p0 + p) * N + n] : 0.f;
    }

    for (int t0 = 0; t0 < S; t0 += c) {
        const int nt = min(c, S - t0);
        __syncthreads();  // the previous chunk's state update is done
        // rows past the chunk's real steps (nt) are zeros: dt = 0 steps
        for (int i = tid; i < CP * N; i += THREADS) {
            const int r = i / N;
            const int n = i - r * N;
            float bv = 0.f, cv = 0.f;
            if (r < nt) {
                const size_t off = ((size_t)b * S + t0 + r) * N + n;
                bv = __bfloat162float(Bm[off]);
                cv = __bfloat162float(C[off]);
            }
            bs[r * NL + n] = bv;
            cs[r * NL + n] = cv;
        }
        for (int i = tid; i < CP * PB; i += THREADS) {
            const int r = i / PB;
            const int p = i - r * PB;
            float xv = 0.f;
            if (r < nt && p0 + p < P)
                xv = __bfloat162float(
                    x[(((size_t)b * S + t0 + r) * Hs + h) * P + p0 + p]);
            xs[r * XL + p] = xv;
        }
        for (int r = tid; r < CP; r += THREADS)
            dts[r] = r < nt ? __bfloat162float(dt[((size_t)b * S + t0 + r) * Hs + h])
                            : 0.f;
        __syncthreads();

        // l = inclusive cumsum of dt * a over the chunk: warp 0, each lane
        // a run of consecutive steps, then a shuffle scan of the run sums
        if (tid < 32) {
            const int per = CP / 32;
            const int r0 = tid * per;
            const int r1 = r0 + per;
            float run = 0.f;
            for (int r = r0; r < r1; ++r) run += dts[r] * a;
            float incl = run;
            for (int o = 1; o < 32; o <<= 1) {
                const float v = __shfl_up_sync(0xffffffffu, incl, o);
                if (tid >= o) incl += v;
            }
            float acc = incl - run;
            for (int r = r0; r < r1; ++r) {
                acc += dts[r] * a;
                ls[r] = acc;
            }
        }
        __syncthreads();
        const float l_last = ls[CP - 1];  // = l[nt - 1]: pads add 0
        for (int r = tid; r < CP; r += THREADS) {
            els[r] = expf(ls[r]);
            ws[r] = expf(l_last - ls[r]) * dts[r];
        }
        __syncthreads();

        // y, by 32-row query tiles
        for (int i0 = 0; i0 < nt; i0 += TI) {
            float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
            for (int j0 = 0; j0 <= i0; j0 += TJ) {
                float g[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
                const float* c0r = cs + (i0 + 2 * ty) * NL;
                const float* b0r = bs + (j0 + 2 * tx) * NL;
                for (int n = 0; n < N; ++n) {
                    const float ca = c0r[n], cb = c0r[NL + n];
                    const float ba = b0r[n], bb = b0r[NL + n];
                    g[0][0] += ca * ba;
                    g[0][1] += ca * bb;
                    g[1][0] += cb * ba;
                    g[1][1] += cb * bb;
                }
#pragma unroll
                for (int u = 0; u < 2; ++u) {
#pragma unroll
                    for (int v = 0; v < 2; ++v) {
                        const int i = i0 + 2 * ty + u;
                        const int j = j0 + 2 * tx + v;
                        float m = 0.f;
                        if (j <= i && j < nt)
                            m = g[u][v] * expf(ls[i] - ls[j]) * dts[j];
                        ms[(2 * ty + u) * (TJ + 1) + 2 * tx + v] = m;
                    }
                }
                __syncthreads();
                const float* m0 = ms + (2 * ty) * (TJ + 1);
                for (int j = 0; j < TJ; ++j) {
                    const float ma = m0[j], mb = m0[TJ + 1 + j];
                    const float xa = xs[(j0 + j) * XL + 2 * tx];
                    const float xb = xs[(j0 + j) * XL + 2 * tx + 1];
                    acc[0][0] += ma * xa;
                    acc[0][1] += ma * xb;
                    acc[1][0] += mb * xa;
                    acc[1][1] += mb * xb;
                }
                __syncthreads();
            }
            // the carried state's contribution and the skip term
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int i = i0 + 2 * ty + u;
                const float* cr = cs + i * NL;
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                    const int p = 2 * tx + v;
                    const float* hr = hs + p * NL;
                    float inter = 0.f;
                    for (int n = 0; n < N; ++n) inter += cr[n] * hr[n];
                    const float out = acc[u][v] + els[i] * inter
                        + dskip * xs[i * XL + p];
                    if (i < nt && p0 + p < P)
                        y[(((size_t)b * S + t0 + i) * Hs + h) * P + p0 + p] =
                            __float2bfloat16(out);
                }
            }
        }
        __syncthreads();  // every read of the old state is done

        const float decay = expf(l_last);
        for (int e = tid; e < PB * N; e += THREADS) {
            const int p = e / N;
            const int n = e - p * N;
            float s = 0.f;
            for (int j = 0; j < nt; ++j)
                s += ws[j] * xs[j * XL + p] * bs[j * NL + n];
            hs[p * NL + n] = decay * hs[p * NL + n] + s;
        }
    }
    __syncthreads();
    for (int i = tid; i < PB * N; i += THREADS) {
        const int p = i / N;
        const int n = i - p * N;
        if (p0 + p < P) hT[(hrow + p0 + p) * N + n] = hs[p * NL + n];
    }
}

// Returns cudaGetLastError() after the launch (or the attribute call's
// error when the shared memory does not fit).
extern "C" int ssd_bf16(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* C, const void* D, const void* h0, void* y, void* hT,
    int B, int S, int Hs, int P, int N, int chunk, void* stream) {
    const size_t cp = (size_t)(chunk + TI - 1) / TI * TI;
    const size_t smem = sizeof(float) * (2 * cp * (N + 1) + cp * (PB + 1)
                                         + 4 * cp + TI * (TJ + 1)
                                         + (size_t)PB * (N + 1));
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid(Hs * ((P + PB - 1) / PB), B);
    ssd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)dt, (const float*)A,
        (const __nv_bfloat16*)Bm, (const __nv_bfloat16*)C, (const float*)D,
        (const float*)h0, (__nv_bfloat16*)y, (float*)hT, S, Hs, P, N, chunk);
    return (int)cudaGetLastError();
}
