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
// 64, P 64, N 64, chunk 256) the work is ~26 GFLOP a call (per head four
// products on the causal triangle, 64 deep, and four (c, P, N) products
// with the states; C B^T once for all heads): 0.026 ms at the bf16
// tensor-core peak, and it reads x, dy, dt, B, C and the forward's scratch
// (~87 MB) and writes dx, ddt, dB, dC, dA, dD, dh0 (~36 MB): 0.037 ms, so
// bytes bound it. This kernel runs the products on the f32 units (0.39 ms
// at their 67 TFLOP/s), recomputes G and dM in both of its passes and
// multiplies whole 64 x 64 tiles on the diagonal; measured on the H100:
// 3.36 ms (PERF.md section 6, row 6b). The per-head partials of dB and dC
// add ~67 MB each.
//
// Design (a simple kernel: right first; its speed is later work):
// - Three launches. (a) ssd_bwd_state_kernel, one block a (head, batch
//   row), walks the chunks in reverse, as the forward's phase (b) walks
//   them forward: it writes dHn of each chunk, then adds the chunk's local
//   part (64-row tiles of exp(l) dy and C staged in shared memory, a
//   thread's 16 elements of (P, N)), in chunk order, elementwise.
// - (b) ssd_bwd_kernel, one block a (chunk, head, batch row), reads the
//   forward's scratch (l, the entering states, the decays) and dHn, and
//   walks 64 x 64 tiles of the causal triangle twice: by query tile (rows
//   i: dC, the row part of dl), and by key tile (columns j: dx, dB, ddt,
//   the column part of dl), recomputing G and dM in each. Every product is
//   a 64 x 64 x 64 f32 multiply-add over shared memory, a thread holding a
//   4 x 4 tile of the result (rows ty + 16a, columns tx + 16b). Then the
//   reverse cumsum of dl, one thread, in step order.
// - (c) fixed_sum_kernel (fixed_sum.cuh): dB and dC are per-head partials
//   (B, Hs, S, N), added in head order and rounded to bf16; dA and dD per
//   (batch row, head, chunk), added in batch-row then chunk order.
// - No atomics: every sum has one order, so the same inputs give the same
//   bits on every run.
// - Ragged tail: rows past the chunk's real steps are zeros in every staged
//   operand (and l, dt); nothing of them is stored. P and N multiples of 8
//   up to 64 (columns past them zeros), chunk up to 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_sum.cuh"

#define THREADS 256
#define TT 64          // rows (steps) of a tile
#define LDF 65         // f32 row of a staged (64, 64) tile
#define MAXW 64        // the most P and N
#define MAXC 256       // the most steps of a chunk

typedef __nv_bfloat16 bf16;

// rows [r0, r0 + 64) of a (rows, width) bf16 matrix with row stride
// `stride` into an f32 (64, LDF) tile; rows at or past `nr`, and columns
// past `width`, zeros; `scale` (or null) multiplies row r by scale[r0 + r]
__device__ __forceinline__ void stage(float* dst, const bf16* src,
                                      size_t stride, int r0, int nr,
                                      int width, const float* scale) {
    for (int i = threadIdx.x; i < TT * MAXW; i += THREADS) {
        const int r = i / MAXW, c = i % MAXW;
        float v = 0.f;
        if (r0 + r < nr && c < width) {
            v = __bfloat162float(src[(size_t)(r0 + r) * stride + c]);
            if (scale) v *= scale[r0 + r];
        }
        dst[r * LDF + c] = v;
    }
}

// acc[a][b] += sum_k X[ty + 16a][k] Y[tx + 16b][k]   (X Y^T)
__device__ __forceinline__ void prod_nt(float acc[4][4], const float* X,
                                        const float* Y, int ty, int tx) {
#pragma unroll 4
    for (int k = 0; k < MAXW; ++k) {
        float xa[4], yb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xa[a] = X[(ty + 16 * a) * LDF + k];
#pragma unroll
        for (int b = 0; b < 4; ++b) yb[b] = Y[(tx + 16 * b) * LDF + k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xa[a], yb[b], acc[a][b]);
    }
}

// acc[a][b] += sum_k X[k][ty + 16a] Y[k][tx + 16b]   (X^T Y)
__device__ __forceinline__ void prod_tn(float acc[4][4], const float* X,
                                        const float* Y, int ty, int tx) {
#pragma unroll 4
    for (int k = 0; k < TT; ++k) {
        float xa[4], yb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xa[a] = X[k * LDF + ty + 16 * a];
#pragma unroll
        for (int b = 0; b < 4; ++b) yb[b] = Y[k * LDF + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xa[a], yb[b], acc[a][b]);
    }
}

// acc[a][b] += sum_k X[ty + 16a][k] Y[k][tx + 16b]   (X Y)
__device__ __forceinline__ void prod_nn(float acc[4][4], const float* X,
                                        const float* Y, int ty, int tx) {
#pragma unroll 4
    for (int k = 0; k < MAXW; ++k) {
        float xa[4], yb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xa[a] = X[(ty + 16 * a) * LDF + k];
#pragma unroll
        for (int b = 0; b < 4; ++b) yb[b] = Y[k * LDF + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xa[a], yb[b], acc[a][b]);
    }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
}

// the sum over the 16 threads of a row group (tx = 0..15, one half-warp)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
    for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, 16);
    return v;
}

// ---------------------------------------------------------------------------
// (a) the state's gradient, chunks in reverse
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) ssd_bwd_state_kernel(
    const bf16* __restrict__ dy,      // (B, S, Hs, P)
    const bf16* __restrict__ C,       // (B, S, N)
    const float* __restrict__ lbuf,   // (B, Hs, chunks * c)
    const float* __restrict__ decay,  // (B, Hs, chunks): L
    const float* __restrict__ dhT,    // (B, Hs, P, N) or null
    float* __restrict__ dHn,          // (B, Hs, chunks, P, N)
    float* __restrict__ dh0,          // (B, Hs, P, N)
    int S, int Hs, int P, int N, int c) {
    const int h = blockIdx.x, b = blockIdx.y;
    const int n_chunks = (S + c - 1) / c;
    const int tid = threadIdx.x;
    const int PN = P * N;
    const size_t head = (size_t)b * Hs + h;
    extern __shared__ __align__(16) float sm[];
    float* ys = sm;              // (64, LDF) exp(l_i) dy_i
    float* cs = ys + TT * LDF;   // (64, LDF) C_i
    float* el = cs + TT * LDF;   // (MAXC,) exp(l)

    constexpr int Q = MAXW * MAXW / THREADS;  // a thread's elements of (P, N)
    float cur[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int e = tid + q * THREADS;
        cur[q] = e < PN && dhT ? dhT[head * PN + e] : 0.f;
    }
    for (int ck = n_chunks - 1; ck >= 0; --ck) {
        const int t0 = ck * c, nt = min(c, S - t0);
        float* out = dHn + (head * n_chunks + ck) * PN;
        float loc[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int e = tid + q * THREADS;
            if (e < PN) out[e] = cur[q];
            loc[q] = 0.f;
        }
        __syncthreads();  // the last chunk's el is read
        const float* lrow = lbuf + (head * n_chunks + ck) * c;
        for (int i = tid; i < nt; i += THREADS) el[i] = expf(lrow[i]);
        for (int r0 = 0; r0 < nt; r0 += TT) {
            __syncthreads();  // el written; the last tile is read
            stage(ys, dy + (((size_t)b * S + t0) * Hs + h) * P,
                  (size_t)Hs * P, r0, nt, P, el);
            stage(cs, C + ((size_t)b * S + t0) * N, N, r0, nt, N, nullptr);
            __syncthreads();
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                const int e = tid + q * THREADS;
                if (e < PN) {
                    const int p = e / N, n = e - p * N;
                    float s = loc[q];
                    for (int r = 0; r < TT; ++r)
                        s = fmaf(ys[r * LDF + p], cs[r * LDF + n], s);
                    loc[q] = s;
                }
            }
        }
        const float f = expf(decay[head * n_chunks + ck]);
#pragma unroll
        for (int q = 0; q < Q; ++q) cur[q] = fmaf(f, cur[q], loc[q]);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int e = tid + q * THREADS;
        if (e < PN) dh0[head * PN + e] = cur[q];
    }
}

// ---------------------------------------------------------------------------
// (b) per (chunk, head, batch row): the transposed products
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
    const float* __restrict__ dHn,    // (B, Hs, chunks, P, N)
    bf16* __restrict__ dx,            // (B, S, Hs, P)
    bf16* __restrict__ ddt,           // (B, S, Hs)
    float* __restrict__ pB,           // (B, Hs, S, N): dB of a head
    float* __restrict__ pC,           // (B, Hs, S, N): dC of a head
    float* __restrict__ pA,           // (B, Hs, chunks): dA of a chunk
    float* __restrict__ pD,           // (B, Hs, chunks): dD of a chunk
    int S, int Hs, int P, int N, int c) {
    const int ck = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int n_chunks = gridDim.x;
    const int t0 = ck * c, nt = min(c, S - t0);
    const int nq = (nt + TT - 1) / TT;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const size_t head = (size_t)b * Hs + h;
    const size_t row0 = (size_t)b * S + t0;

    extern __shared__ __align__(16) float sm[];
    float* Ai = sm;                 // C rows of the query tile
    float* Yi = Ai + TT * LDF;      // dy rows of the query tile
    float* Aj = Yi + TT * LDF;      // B rows of the key tile
    float* Xj = Aj + TT * LDF;      // x rows of the key tile
    float* Gt = Xj + TT * LDF;      // a product tile (dG, or M)
    float* St = Gt + TT * LDF;      // a product tile (dG)
    float* Hm = St + TT * LDF;      // (P, N) H, then dHn
    float* ls = Hm + TT * LDF;      // (MAXC,) l
    float* dts = ls + MAXC;         // (MAXC,) dt
    float* dl = dts + MAXC;         // (MAXC,) l's gradient
    float* dd = dl + MAXC;          // (MAXC,) dt's gradient but through l
    float* wdw = dd + MAXC;         // (MAXC,) w_j (x_j . dHn B_j)
    float* red = wdw + MAXC;        // (16, 2, 64) column sums; (256,) sums

    const float* lrow = lbuf + (head * n_chunks + ck) * c;
    const float L = decay[head * n_chunks + ck];
    const float Ah = A[h], Dh = D[h];
    for (int i = tid; i < MAXC; i += THREADS) {
        const bool ok = i < nt;
        ls[i] = ok ? lrow[i] : 0.f;
        dts[i] = ok ? __bfloat162float(dt[(row0 + i) * Hs + h]) : 0.f;
        dl[i] = dd[i] = wdw[i] = 0.f;
    }
    // H entering the chunk as a (64, LDF) tile (rows p, columns n)
    auto stage_state = [&](const float* src) {
        for (int i = tid; i < TT * MAXW; i += THREADS) {
            const int p = i / MAXW, n = i % MAXW;
            Hm[p * LDF + n] = p < P && n < N ? src[p * N + n] : 0.f;
        }
    };
    const bf16* xh = x + row0 * Hs * P + (size_t)h * P;
    const bf16* yh = dy + row0 * Hs * P + (size_t)h * P;
    const bf16* bh = Bm + row0 * N;
    const bf16* ch = C + row0 * N;
    const size_t xs = (size_t)Hs * P;
    stage_state(states + (head * n_chunks + ck) * P * N);

    // the masked weights of a tile pair from the products G, S (dM):
    // rows i = I*64 + ty + 16a, columns j = J*64 + tx + 16b
    float g[4][4], s[4][4];

    // ---- by query tile: dC and the rows' part of dl ----
    for (int I = 0; I < nq; ++I) {
        __syncthreads();  // the last tile's operands are read
        stage(Ai, ch, N, I * TT, nt, N, nullptr);
        stage(Yi, yh, xs, I * TT, nt, P, nullptr);
        float dc[4][4], rl[4] = {0.f, 0.f, 0.f, 0.f};
        zero(dc);
        for (int J = 0; J <= I; ++J) {
            __syncthreads();  // Gt and the last key tile are read
            stage(Aj, bh, N, J * TT, nt, N, nullptr);
            stage(Xj, xh, xs, J * TT, nt, P, nullptr);
            __syncthreads();
            zero(g);
            zero(s);
            prod_nt(g, Ai, Aj, ty, tx);
            prod_nt(s, Yi, Xj, ty, tx);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int i = I * TT + ty + 16 * a;
#pragma unroll
                for (int bb = 0; bb < 4; ++bb) {
                    const int j = J * TT + tx + 16 * bb;
                    float dG = 0.f;
                    if (j <= i && i < nt) {
                        const float ew = expf(ls[i] - ls[j]) * dts[j];
                        dG = s[a][bb] * ew;
                        rl[a] = fmaf(dG, g[a][bb], rl[a]);  // R = dM M
                    }
                    Gt[(ty + 16 * a) * LDF + tx + 16 * bb] = dG;
                }
            }
            __syncthreads();
            prod_nn(dc, Gt, Aj, ty, tx);
        }
        // the carried state's read: q_i = exp(l_i) dy_i H, dC += q,
        // dl_i += C_i . q_i
        zero(g);
        prod_nn(g, Yi, Hm, ty, tx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const int r = ty + 16 * a, i = I * TT + r;
            const float e = i < nt ? expf(ls[i]) : 0.f;
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) {
                const float q = g[a][bb] * e;
                dc[a][bb] += q;
                rl[a] = fmaf(q, Ai[r * LDF + tx + 16 * bb], rl[a]);
            }
            const float tot = sum16(rl[a]);
            if (tx == 0 && i < nt) dl[i] += tot;
            if (i < nt)
#pragma unroll
                for (int bb = 0; bb < 4; ++bb) {
                    const int n = tx + 16 * bb;
                    if (n < N) pC[(head * S + t0 + i) * N + n] = dc[a][bb];
                }
        }
    }

    // ---- by key tile: dx, dB, ddt and the columns' part of dl ----
    __syncthreads();  // Hm (H) is read
    stage_state(dHn + (head * n_chunks + ck) * P * N);
    float dsum = 0.f;  // dy . x over the chunk's rows of this thread
    for (int J = 0; J < nq; ++J) {
        __syncthreads();
        stage(Aj, bh, N, J * TT, nt, N, nullptr);
        stage(Xj, xh, xs, J * TT, nt, P, nullptr);
        float dxa[4][4], dba[4][4], cd[4] = {0.f, 0.f, 0.f, 0.f},
              cl[4] = {0.f, 0.f, 0.f, 0.f};
        zero(dxa);
        zero(dba);
        for (int I = J; I < nq; ++I) {
            __syncthreads();  // Gt, St and the last query tile are read
            stage(Ai, ch, N, I * TT, nt, N, nullptr);
            stage(Yi, yh, xs, I * TT, nt, P, nullptr);
            __syncthreads();
            zero(g);
            zero(s);
            prod_nt(g, Ai, Aj, ty, tx);
            prod_nt(s, Yi, Xj, ty, tx);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int i = I * TT + ty + 16 * a;
#pragma unroll
                for (int bb = 0; bb < 4; ++bb) {
                    const int j = J * TT + tx + 16 * bb;
                    float M = 0.f, dG = 0.f;
                    if (j <= i && i < nt) {
                        const float e = expf(ls[i] - ls[j]);
                        const float sge = s[a][bb] * g[a][bb] * e;
                        M = g[a][bb] * e * dts[j];
                        dG = s[a][bb] * e * dts[j];
                        cd[bb] += sge;            // dM G E
                        cl[bb] += sge * dts[j];   // R = dM M
                    }
                    Gt[(ty + 16 * a) * LDF + tx + 16 * bb] = M;
                    St[(ty + 16 * a) * LDF + tx + 16 * bb] = dG;
                }
            }
            __syncthreads();
            prod_tn(dxa, Gt, Yi, ty, tx);  // dx_j += sum_i M_ij dy_i
            prod_tn(dba, St, Ai, ty, tx);  // dB_j += sum_i dG_ij C_i
        }
        // the columns' sums over the 16 row groups, in row-group order
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
            red[(ty * 2) * TT + tx + 16 * bb] = cd[bb];
            red[(ty * 2 + 1) * TT + tx + 16 * bb] = cl[bb];
        }
        __syncthreads();
        if (tid < TT) {
            float a0 = 0.f, a1 = 0.f;
            for (int r = 0; r < 16; ++r) {
                a0 += red[(r * 2) * TT + tid];
                a1 += red[(r * 2 + 1) * TT + tid];
            }
            const int j = J * TT + tid;
            dd[j] += a0;
            dl[j] -= a1;
        }
        // the state's update and D: dy of the key rows into Yi
        __syncthreads();  // red and Yi are read
        stage(Yi, yh, xs, J * TT, nt, P, nullptr);
        __syncthreads();
        zero(g);
        prod_nt(g, Aj, Hm, ty, tx);   // v_j[p] = sum_n dHn[p][n] B_j[n]
        zero(s);
        prod_nn(s, Xj, Hm, ty, tx);   // sum_p x_j[p] dHn[p][n]
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const int r = ty + 16 * a, j = J * TT + r;
            const float dec = j < nt ? expf(L - ls[j]) : 0.f;
            const float w = dec * dts[j];
            float dw = 0.f;
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) {
                const int p = tx + 16 * bb;
                const float xv = Xj[r * LDF + p], yv = Yi[r * LDF + p];
                dw = fmaf(xv, g[a][bb], dw);
                dsum = fmaf(yv, xv, dsum);
                dxa[a][bb] += fmaf(w, g[a][bb], Dh * yv);
                dba[a][bb] = fmaf(w, s[a][bb], dba[a][bb]);
            }
            dw = sum16(dw);
            if (tx == 0 && j < nt) {
                dd[j] += dw * dec;
                dl[j] -= dw * w;
                wdw[j] = dw * w;
            }
            if (j < nt) {
#pragma unroll
                for (int bb = 0; bb < 4; ++bb) {
                    const int p = tx + 16 * bb;
                    if (p < P)
                        dx[(row0 + j) * xs + (size_t)h * P + p] =
                            __float2bfloat16(dxa[a][bb]);
                    if (p < N) pB[(head * S + t0 + j) * N + p] = dba[a][bb];
                }
            }
        }
    }

    // dL: exp(L) dHn . H + sum_j w_j dw_j; dD; in fixed orders
    {
        const float* Hc = states + (head * n_chunks + ck) * P * N;
        const float* dHc = dHn + (head * n_chunks + ck) * P * N;
        float hd = 0.f;
        for (int e = tid; e < P * N; e += THREADS) hd = fmaf(Hc[e], dHc[e], hd);
        __syncthreads();  // red is read
        red[tid] = hd;
        red[THREADS + tid] = dsum;
        __syncthreads();
    }
    if (tid == 0) {
        float hd = 0.f, dsm = 0.f, wsum = 0.f;
        for (int r = 0; r < THREADS; ++r) {
            hd += red[r];
            dsm += red[THREADS + r];
        }
        for (int j = 0; j < nt; ++j) wsum += wdw[j];
        dl[nt - 1] += expf(L) * hd + wsum;
        // l = cumsum(dt A): dt_k's gradient through l is A sum_{i >= k} dl_i
        float rc = 0.f, da = 0.f;
        for (int k = nt - 1; k >= 0; --k) {
            rc += dl[k];
            ddt[(row0 + k) * Hs + h] = __float2bfloat16(fmaf(Ah, rc, dd[k]));
            da = fmaf(rc, dts[k], da);
        }
        pA[head * n_chunks + ck] = da;
        pD[head * n_chunks + ck] = dsm;
    }
}

static int set_smem(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Shapes as ssd.cu's; lbuf, states and decay the forward's scratch of the
// same call (states holding each chunk's entering state); dhT null for a
// zero gradient of hT. Scratch: dHn (B, Hs, chunks, P, N), pB, pC (B, Hs,
// S, N), pA, pD (B, Hs, chunks), all f32. Outputs: dx (B, S, Hs, P), ddt
// (B, S, Hs), dB, dC (B, S, N) bf16; dA, dD (Hs,), dh0 (B, Hs, P, N) f32.
// Three launches; returns cudaGetLastError() after them.
extern "C" int ssd_bwd_bf16(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* C, const void* D, const void* dy, const void* dhT,
    const void* lbuf, const void* states, const void* decay, void* dHn,
    void* dx, void* ddt, void* dA, void* dB, void* dC, void* dD, void* dh0,
    void* pB, void* pC, void* pA, void* pD, int B, int S, int Hs, int P,
    int N, int chunk, void* stream) {
    if (P % 8 || P > MAXW || N % 8 || N > MAXW || chunk < 1 || chunk > MAXC
        || S < 1)
        return (int)cudaErrorInvalidValue;
    const int c = chunk, n_chunks = (S + c - 1) / c;
    const size_t smem_a = (2 * TT * LDF + MAXC) * 4;
    const size_t smem_b = (7 * TT * LDF + 5 * MAXC + 2 * 16 * TT) * 4;
    int e = set_smem((const void*)ssd_bwd_state_kernel, smem_a);
    if (!e) e = set_smem((const void*)ssd_bwd_kernel, smem_b);
    if (e) return e;
    cudaStream_t st = (cudaStream_t)stream;
    ssd_bwd_state_kernel<<<dim3(Hs, B), THREADS, smem_a, st>>>(
        (const bf16*)dy, (const bf16*)C, (const float*)lbuf,
        (const float*)decay, (const float*)dhT, (float*)dHn, (float*)dh0, S,
        Hs, P, N, c);
    if ((e = (int)cudaGetLastError())) return e;
    ssd_bwd_kernel<<<dim3(n_chunks, Hs, B), THREADS, smem_b, st>>>(
        (const bf16*)x, (const bf16*)dt, (const float*)A, (const bf16*)Bm,
        (const bf16*)C, (const float*)D, (const bf16*)dy, (const float*)lbuf,
        (const float*)states, (const float*)decay, (const float*)dHn,
        (bf16*)dx, (bf16*)ddt, (float*)pB, (float*)pC, (float*)pA,
        (float*)pD, S, Hs, P, N, c);
    if ((e = (int)cudaGetLastError())) return e;
    // (c) dB, dC: element (b, e) adds its Hs heads' partials; dA, dD:
    // head h adds (b, h, k) over b, then k
    const size_t row = (size_t)S * N, nc = n_chunks;
    const Layout bc{B * row, row, Hs * row, 0, row, 1, Hs};
    const Layout ad{(size_t)Hs, 1, nc, Hs * nc, 1, B, n_chunks};
    launch_fixed_sum(bc, ad, ad, pB, pC, pA, pD, dB, dC, dA, dD, st);
    return (int)cudaGetLastError();
}
