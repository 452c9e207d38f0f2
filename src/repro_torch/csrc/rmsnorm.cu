// RMSNorm for Hopper (sm_90a): every block norm of the three served
// families, and qwen3-8b's qk-norm over (tokens, heads) rows of 128.
//
// Replaces: repro/kernels/rmsnorm.py, rmsnorm (_rmsnorm_kernel, the TPU
// kernel that normalizes (256, d) row tiles held in VMEM).
//
// Computes, per row of x (any leading shape, d the trailing dim): the mean
// of squares in f32, r = rsqrt(mean + eps), out = (x * r) * w in f32, cast
// to x's type (f32, bf16 or f16); w in any of those, read as f32.
//
// What bounds it on this card: bytes. One read and one write of x (and w
// once): 2 * rows * d * itemsize bytes over 3.35 TB/s, a few FLOP per byte.
// At the decode step's 8 rows that is 0.04 us, far below any launch: what
// a call costs there is the launch and one dependent chain of load,
// reduction, rsqrt and store, which the design keeps short.
//
// Design:
// - Threads per row are chosen by d alone, never by the row count, so a
//   row's reduction order is fixed by d and its bits do not depend on its
//   batch (the decode and verify path's batch invariance):
//   d <= 256 (qk-norm rows of 128): a warp per row, 8 rows a block, each
//   lane a run of 4 elements (8-byte loads at 16-bit types);
//   d > 256: a block per row, one 16-byte load per thread (d / 8 threads
//   at bf16, up to 1024, further runs at the same stride past that), a
//   warp-shuffle reduction, and one shared-memory step across warps.
// - A thread owns runs of VEC consecutive elements and sums their squares
//   in element order; the runs are loaded as vectors where d is a multiple
//   of VEC and the rows aligned, else element by element (a d of 33 or
//   960's tail), with the same arithmetic either way.
// - w's run is loaded together with x's, before the reduction, so its
//   latency hides behind x's (as vectors too where w is f32 or bf16);
//   stores are vectors of x's width.
// - The butterfly (xor) shuffle leaves the same sum in every lane: each
//   step adds the same two operands on both sides.
//
// The backward (rmsnorm_bwd, for training; the TPU kernel has none: the
// JAX package differentiates the XLA form, repro/kernels/ops.py:35), per
// row in f32: r = rsqrt(mean(x^2) + eps), xh = x * r,
// dx = r * (g * w - xh * mean(g * w * xh)) cast to x's type, and
// dw = sum over rows of g * xh. Bound by bytes too (x and g read, dx
// written). Design: threads per row fixed by d (a warp up to d = 256, 8
// rows of a block in flight; above, a block per row of d/8 threads rounded
// to warps), up to 8 columns a thread; a block walks a fixed run of
// `chunk` rows (the wrapper's rule: at least 16, at most 1024 runs a
// call) and leaves that run's dw in f32 registers, summed across its warps
// in warp order into one partial row; a second launch sums the partial
// rows per column in run order. No atomics: the same bits every run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define WARP_ROWS 8    // rows of a block on the warp path
#define WARP_D 256     // the widest row on the warp path
#define MAX_RUNS 2     // runs a thread owns on the block path

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
    return __float2half(v);
}

// w's element i as f32, whatever its type (0 f32, 1 bf16, 2 f16)
__device__ __forceinline__ float load_w(const void* w, int i, int wtype) {
    if (wtype == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
    if (wtype == 2) return __half2float(static_cast<const __half*>(w)[i]);
    return static_cast<const float*>(w)[i];
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Run {
    T v[VEC];
};

// a run of x starting at element e of the row (vector load, or element by
// element with the row's end masked), and w's matching elements
template <typename T, int VEC>
__device__ __forceinline__ void load_run(float* xv, float* wv, const T* row,
                                         const void* w, int wtype, int e,
                                         int d, bool vec) {
    if (vec) {
        const Run<T, VEC> r = *reinterpret_cast<const Run<T, VEC>*>(row + e);
#pragma unroll
        for (int k = 0; k < VEC; ++k) xv[k] = to_f(r.v[k]);
    } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) xv[k] = e + k < d ? to_f(row[e + k]) : 0.f;
    }
    if (vec && wtype == 0) {  // f32 w: 16-byte loads
#pragma unroll
        for (int k = 0; k < VEC; k += 4) {
            const float4 f = *reinterpret_cast<const float4*>(
                static_cast<const float*>(w) + e + k);
            wv[k] = f.x;
            wv[k + 1] = f.y;
            wv[k + 2] = f.z;
            wv[k + 3] = f.w;
        }
    } else if (vec && wtype == 1) {  // bf16 w: loads as wide as x's
        const Run<__nv_bfloat16, VEC> r = *reinterpret_cast<const Run<__nv_bfloat16, VEC>*>(
            static_cast<const __nv_bfloat16*>(w) + e);
#pragma unroll
        for (int k = 0; k < VEC; ++k) wv[k] = __bfloat162float(r.v[k]);
    } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) wv[k] = e + k < d ? load_w(w, e + k, wtype) : 0.f;
    }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_run(T* row, const float* xv,
                                          const float* wv, float r, int e,
                                          int d, bool vec) {
    if (vec) {
        Run<T, VEC> o;
#pragma unroll
        for (int k = 0; k < VEC; ++k) o.v[k] = from_f<T>(xv[k] * r * wv[k]);
        *reinterpret_cast<Run<T, VEC>*>(row + e) = o;
    } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
            if (e + k < d) row[e + k] = from_f<T>(xv[k] * r * wv[k]);
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// d <= WARP_D: a warp per row; lane l owns the runs l, l + 32, ...
template <typename T, int VEC>
__global__ void __launch_bounds__(32 * WARP_ROWS) rmsnorm_warp_kernel(
    const T* __restrict__ x, const void* __restrict__ w, int wtype,
    T* __restrict__ out, int rows, int d, float eps, int vec) {
    constexpr int RUNS = (WARP_D + 32 * VEC - 1) / (32 * VEC);
    const int row = blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const T* xr = x + (size_t)row * d;
    float xv[RUNS][VEC], wv[RUNS][VEC];
#pragma unroll
    for (int u = 0; u < RUNS; ++u) {
        const int e = (lane + 32 * u) * VEC;
        if (e < d) load_run<T, VEC>(xv[u], wv[u], xr, w, wtype, e, d, vec);
    }
    float ss = 0.f;
#pragma unroll
    for (int u = 0; u < RUNS; ++u)
        if ((lane + 32 * u) * VEC < d)
#pragma unroll
            for (int k = 0; k < VEC; ++k) ss = fmaf(xv[u][k], xv[u][k], ss);
    const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
    T* orow = out + (size_t)row * d;
#pragma unroll
    for (int u = 0; u < RUNS; ++u) {
        const int e = (lane + 32 * u) * VEC;
        if (e < d) store_run<T, VEC>(orow, xv[u], wv[u], r, e, d, vec);
    }
}

// d > WARP_D: a block per row; thread i owns the runs i, i + blockDim, ...
// (RUNS of them at most: 1, or 2 past 1024 runs)
template <typename T, int VEC, int RUNS>
__global__ void __launch_bounds__(1024) rmsnorm_block_kernel(
    const T* __restrict__ x, const void* __restrict__ w, int wtype,
    T* __restrict__ out, int d, float eps, int vec) {
    __shared__ float part[32];
    const int row = blockIdx.x;
    const int tid = threadIdx.x;
    const int nth = blockDim.x;
    const T* xr = x + (size_t)row * d;
    float xv[RUNS][VEC], wv[RUNS][VEC];
#pragma unroll
    for (int u = 0; u < RUNS; ++u) {
        const int e = (tid + u * nth) * VEC;
        if (e < d) load_run<T, VEC>(xv[u], wv[u], xr, w, wtype, e, d, vec);
    }
    float ss = 0.f;
#pragma unroll
    for (int u = 0; u < RUNS; ++u)
        if ((tid + u * nth) * VEC < d)
#pragma unroll
            for (int k = 0; k < VEC; ++k) ss = fmaf(xv[u][k], xv[u][k], ss);
    ss = warp_sum(ss);
    if ((tid & 31) == 0) part[tid >> 5] = ss;
    __syncthreads();
    if (tid < 32) {
        const float v = warp_sum(tid < (nth >> 5) ? part[tid] : 0.f);
        if (tid == 0) part[0] = v;
    }
    __syncthreads();
    const float r = rsqrtf(part[0] / (float)d + eps);
    T* orow = out + (size_t)row * d;
#pragma unroll
    for (int u = 0; u < RUNS; ++u) {
        const int e = (tid + u * nth) * VEC;
        if (e < d) store_run<T, VEC>(orow, xv[u], wv[u], r, e, d, vec);
    }
}

static bool aligned(const void* p, size_t n) {
    return (reinterpret_cast<uintptr_t>(p) % n) == 0;
}

template <typename T>
static int launch(const void* x, const void* w, int wtype, void* out,
                  int rows, int d, float eps, cudaStream_t stream) {
    if (d <= WARP_D) {
        constexpr int VEC = 4;
        const int vec = d % VEC == 0 && aligned(x, sizeof(T) * VEC)
                        && aligned(out, sizeof(T) * VEC) && aligned(w, 16);
        rmsnorm_warp_kernel<T, VEC><<<(rows + WARP_ROWS - 1) / WARP_ROWS,
                                      32 * WARP_ROWS, 0, stream>>>(
            (const T*)x, w, wtype, (T*)out, rows, d, eps, vec);
    } else {
        constexpr int VEC = 16 / sizeof(T);
        const int runs = (d + VEC - 1) / VEC;
        const int nth = runs > 1024 - 31 ? 1024 : (runs + 31) / 32 * 32;
        if ((runs + nth - 1) / nth > MAX_RUNS) return (int)cudaErrorInvalidValue;
        const int vec = d % VEC == 0 && aligned(x, 16) && aligned(out, 16)
                        && aligned(w, 16);
        if (runs > nth)
            rmsnorm_block_kernel<T, VEC, 2><<<rows, nth, 0, stream>>>(
                (const T*)x, w, wtype, (T*)out, d, eps, vec);
        else
            rmsnorm_block_kernel<T, VEC, 1><<<rows, nth, 0, stream>>>(
                (const T*)x, w, wtype, (T*)out, d, eps, vec);
    }
    return (int)cudaGetLastError();
}

// x and out (rows, d) contiguous of type xtype, w (d,) of type wtype
// (0 f32, 1 bf16, 2 f16); d at most 1024 * MAX_RUNS * 16 / itemsize (the
// wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out, int rows,
                           int d, int xtype, int wtype, float eps,
                           void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (xtype == 1)
        return launch<__nv_bfloat16>(x, w, wtype, out, rows, d, eps, st);
    if (xtype == 2) return launch<__half>(x, w, wtype, out, rows, d, eps, st);
    if (xtype == 0) return launch<float>(x, w, wtype, out, rows, d, eps, st);
    return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

#define BWD_COLS 8     // columns a thread owns at most

// a block walks rows [blockIdx.x * chunk, + chunk); `tpr` threads a row
// (32, or all of the block's), groups of tpr threads on rows g, g + G, ...
template <typename T>
__global__ void __launch_bounds__(1024) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const void* __restrict__ w, int wtype,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
    int rows, int d, int chunk, int tpr, float eps) {
    __shared__ float red[2][32];
    extern __shared__ float dw_red[];   // [G][d] where G > 1
    const int tid = threadIdx.x;
    const int G = blockDim.x / tpr;
    const int grp = tid / tpr;
    const int lt = tid - grp * tpr;
    float wv[BWD_COLS], acc[BWD_COLS];
#pragma unroll
    for (int k = 0; k < BWD_COLS; ++k) {
        const int c = lt + k * tpr;
        wv[k] = c < d ? load_w(w, c, wtype) : 0.f;
        acc[k] = 0.f;
    }
    const int r0 = blockIdx.x * chunk;
    const int r1 = min(r0 + chunk, rows);
    for (int row = r0 + grp; row < r1; row += G) {
        const T* xr = x + (size_t)row * d;
        const T* gr = g + (size_t)row * d;
        float xv[BWD_COLS], gv[BWD_COLS];
        float ss = 0.f, dot = 0.f;
#pragma unroll
        for (int k = 0; k < BWD_COLS; ++k) {
            const int c = lt + k * tpr;
            xv[k] = c < d ? to_f(xr[c]) : 0.f;
            gv[k] = c < d ? to_f(gr[c]) : 0.f;
            ss = fmaf(xv[k], xv[k], ss);
            dot = fmaf(gv[k] * wv[k], xv[k], dot);
        }
        ss = warp_sum(ss);
        dot = warp_sum(dot);
        if (tpr > 32) {  // the whole block is one row: across its warps
            if ((tid & 31) == 0) {
                red[0][tid >> 5] = ss;
                red[1][tid >> 5] = dot;
            }
            __syncthreads();
            if (tid < 32) {
                const bool in = tid < (blockDim.x >> 5);
                const float a = warp_sum(in ? red[0][tid] : 0.f);
                const float b = warp_sum(in ? red[1][tid] : 0.f);
                if (tid == 0) {
                    red[0][0] = a;
                    red[1][0] = b;
                }
            }
            __syncthreads();
            ss = red[0][0];
            dot = red[1][0];
            __syncthreads();  // read before the next row writes
        }
        const float r = rsqrtf(ss / (float)d + eps);
        const float m = dot * r / (float)d;   // mean(g * w * xh)
        T* dr = dx + (size_t)row * d;
#pragma unroll
        for (int k = 0; k < BWD_COLS; ++k) {
            const int c = lt + k * tpr;
            if (c < d) {
                const float xh = xv[k] * r;
                dr[c] = from_f<T>(r * (gv[k] * wv[k] - xh * m));
                acc[k] = fmaf(gv[k], xh, acc[k]);
            }
        }
    }
    float* out = part + (size_t)blockIdx.x * d;
    if (G == 1) {
#pragma unroll
        for (int k = 0; k < BWD_COLS; ++k) {
            const int c = lt + k * tpr;
            if (c < d) out[c] = acc[k];
        }
        return;
    }
#pragma unroll
    for (int k = 0; k < BWD_COLS; ++k) {
        const int c = lt + k * tpr;
        if (c < d) dw_red[grp * d + c] = acc[k];
    }
    __syncthreads();
    for (int c = tid; c < d; c += blockDim.x) {
        float v = 0.f;
        for (int j = 0; j < G; ++j) v += dw_red[j * d + c];
        out[c] = v;
    }
}

// dw[c] = the sum of the partial rows' column c, in run order: 32 columns
// a block, 32 threads a column each summing every 32nd run, then one
// thread the 32 sums in order
__global__ void __launch_bounds__(1024) rmsnorm_dw_kernel(
    const float* __restrict__ part, float* __restrict__ dw, int runs, int d) {
    __shared__ float s[32][33];
    const int c = blockIdx.x * 32 + threadIdx.x;
    float v = 0.f;
    if (c < d)
        for (int j = threadIdx.y; j < runs; j += 32) v += part[(size_t)j * d + c];
    s[threadIdx.y][threadIdx.x] = v;
    __syncthreads();
    if (threadIdx.y == 0 && c < d) {
        float t = 0.f;
        for (int j = 0; j < 32; ++j) t += s[j][threadIdx.x];
        dw[c] = t;
    }
}

template <typename T>
static int launch_bwd(const void* x, const void* w, int wtype, const void* g,
                      void* dx, float* part, float* dw, int rows, int d,
                      float eps, int chunk, cudaStream_t stream) {
    const int per_thread = (d + BWD_COLS - 1) / BWD_COLS;
    const int tpr = d <= WARP_D ? 32 : (per_thread + 31) / 32 * 32;
    if (tpr > 1024) return (int)cudaErrorInvalidValue;
    const int threads = tpr > 32 ? tpr : 32 * WARP_ROWS;
    const int groups = threads / tpr;
    const size_t smem = groups > 1 ? (size_t)groups * d * sizeof(float) : 0;
    const int runs = (rows + chunk - 1) / chunk;
    rmsnorm_bwd_kernel<T><<<runs, threads, smem, stream>>>(
        (const T*)x, w, wtype, (const T*)g, (T*)dx, part, rows, d, chunk, tpr,
        eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rmsnorm_dw_kernel<<<(d + 31) / 32, dim3(32, 32), 0, stream>>>(part, dw,
                                                                  runs, d);
    return (int)cudaGetLastError();
}

// x, g and dx (rows, d) contiguous of type xtype, w (d,) of type wtype
// (0 f32, 1 bf16, 2 f16), part (ceil(rows / chunk), d) f32 scratch, dw (d,)
// f32; d at most 8 * 1024. Two launches; returns cudaGetLastError().
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* g,
                           void* dx, void* part, void* dw, int rows, int d,
                           int xtype, int wtype, float eps, int chunk,
                           void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    float* pp = (float*)part;
    float* pw = (float*)dw;
    if (chunk <= 0) return (int)cudaErrorInvalidValue;
    if (xtype == 1)
        return launch_bwd<__nv_bfloat16>(x, w, wtype, g, dx, pp, pw, rows, d,
                                         eps, chunk, st);
    if (xtype == 2)
        return launch_bwd<__half>(x, w, wtype, g, dx, pp, pw, rows, d, eps,
                                  chunk, st);
    if (xtype == 0)
        return launch_bwd<float>(x, w, wtype, g, dx, pp, pw, rows, d, eps,
                                 chunk, st);
    return (int)cudaErrorInvalidValue;
}

__global__ void empty_kernel() {}

// An empty kernel: the floor under any launch, timed the same way.
extern "C" int empty_launch(void* stream) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
