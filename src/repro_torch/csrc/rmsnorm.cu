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
// dw = sum over rows of g * xh. Bound by bytes too: x and g read, dx
// written (3 rows * d * itemsize); at the training shapes ~0.03 ms.
// Design, to stream at the card's rate:
// - Threads a row fixed by d (and the type), so the reductions' order is:
//   d <= 256 half a warp of 16-byte runs (two rows a warp: at qwen3's qk
//   rows of 128 a lane has one run), 3 rows ahead of the row it reduces;
//   above, W warps of 16-byte runs (4 runs a thread, 8 where W would pass
//   8: a warp at smollm's 960, 4 at 4096), one row ahead. A row within a
//   warp reduces by shuffles alone; W > 1 warps add their sums in warp
//   order after one named barrier of the group a row (partials
//   double-buffered by the row's parity). A width that is no multiple of
//   the run (d 33), or rows not aligned to it, load element by element
//   with the same arithmetic.
// - x's and g's runs go through a ring in shared memory: each thread
//   copies its own runs there with cp.async, ahead of the row it reduces,
//   and reads them back in both passes (the reductions, then dx and dw),
//   so the rows in flight cost no registers. w is read once a block into
//   shared memory laid out [run][4 columns][thread], so that a warp's
//   16-byte reads of it hit distinct banks.
// - A block of 256 threads walks a fixed run of `chunk` rows (the
//   wrapper's rule: at least 32, at most 256 runs a call); each thread
//   keeps its columns' dw in f32 registers, the block's row groups add
//   theirs in group order into one partial row. A second launch (a
//   programmatic dependent, so that its launch overlaps the row kernel's
//   last blocks) sums the partial rows per column in a fixed order. No
//   atomics: the same bits every run; no fill of dw (the second launch
//   writes every column).

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

// the sum over LANES lanes (16 or 32) of a warp, by an xor butterfly that
// stays within each group of LANES; a half warp's shuffles name its own 16
// lanes only, since the other half may have a row fewer (a ragged run)
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
    const unsigned mask =
        LANES == 32 ? 0xffffffffu : 0xffffu << (threadIdx.x & 16);
#pragma unroll
    for (int o = LANES >> 1; o; o >>= 1)
        v += __shfl_xor_sync(mask, v, o);
    return v;
}

__device__ __forceinline__ float warp_sum(float v) { return group_sum<32>(v); }

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

#define BWD_THREADS 256   // a block: BWD_THREADS / tpr row groups

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// one 16-byte run of a row into shared memory: an asynchronous copy where
// the row is aligned for it, else element by element (the row's end as
// zeros)
template <typename T, int VEC>
__device__ __forceinline__ void copy_run(Run<T, VEC>* dst, const T* src,
                                         int e, int d, bool vec) {
    static_assert(sizeof(Run<T, VEC>) == 16, "a run is 16 bytes");
    if (vec) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     ::"r"(smem_addr(dst)), "l"(src + e) : "memory");
    } else {
        Run<T, VEC> r;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
            r.v[k] = e + k < d ? src[e + k] : from_f<T>(0.f);
        *dst = r;
    }
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// w's VEC columns of run u of thread lt (zeros past the row's end), from
// w laid out [run][4 columns][thread]
template <int VEC>
__device__ __forceinline__ void run_w(float* wv, const float4* wq, int u,
                                      int tpr, int lt) {
#pragma unroll
    for (int k4 = 0; k4 < VEC / 4; ++k4) {
        const float4 f = wq[(u * (VEC / 4) + k4) * tpr + lt];
        wv[4 * k4] = f.x;
        wv[4 * k4 + 1] = f.y;
        wv[4 * k4 + 2] = f.z;
        wv[4 * k4 + 3] = f.w;
    }
}

// A block walks rows [blockIdx.x * chunk, + chunk) (its run); group grp of
// its G groups of tpr threads (W = tpr / 32 warps) takes rows grp, grp + G,
// ... of the run. Thread lt owns runs lt, lt + tpr, ... of VEC columns
// (RUNS at most) and copies them itself into its own slots of a ring in
// shared memory, DEPTH rows ahead of the row it reduces (cp.async; no
// other thread reads them, so no barrier guards the ring). It sums its
// squares and its g w x in run and element order, the warp by butterfly,
// the group's W warps in warp order. dw: each thread's columns in f32
// registers over its rows, then the groups' sums in group order into the
// run's partial row.
template <typename T, int VEC, int RUNS, int DEPTH, int MINB, int LANES>
__global__ void __launch_bounds__(BWD_THREADS, MINB) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const void* __restrict__ w, int wtype,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
    int rows, int d, int chunk, int tpr, float eps, int vec) {
    constexpr int SLOTS = DEPTH + 1;
    __shared__ float2 red[2][BWD_THREADS / 32];   // [row parity][warp]
    // w as each thread reads it, laid out [run][4 columns][thread] so that
    // a warp's 16-byte reads of it hit distinct banks (RUNS VEC tpr floats);
    // then the ring [SLOTS][RUNS][x, g][thread]; after the rows, the
    // groups' sums [G][d] take the ring's place
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x;
    const int nth = blockDim.x;
    const int G = nth / tpr;
    const int grp = tid / tpr;
    const int lt = tid - grp * tpr;
    const int W = tpr > 32 ? tpr >> 5 : 1;   // warps a row
    const int wid = lt >> 5;
    constexpr int WQ = RUNS * VEC / 4;   // float4s of w a thread
    float4* wq = reinterpret_cast<float4*>(smem);
    Run<T, VEC>* ring = reinterpret_cast<Run<T, VEC>*>(wq + WQ * tpr);
    for (int i = tid; i < WQ * tpr; i += nth) {
        const int t = i % tpr, q = i / tpr;
        const int c = (t + q / (VEC / 4) * tpr) * VEC + q % (VEC / 4) * 4;
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            v[k] = c + k < d ? load_w(w, c + k, wtype) : 0.f;
        wq[i] = make_float4(v[0], v[1], v[2], v[3]);
    }

    const int r0 = blockIdx.x * chunk;
    const int len = min(chunk, rows - r0);
    const int n = len > grp ? (len - grp + G - 1) / G : 0;   // my rows
    auto issue = [&](int kk) {   // my runs of my row kk into its slots
        const int slot = kk % SLOTS;
        const size_t off = (size_t)(r0 + grp + kk * G) * d;
#pragma unroll
        for (int u = 0; u < RUNS; ++u) {
            const int e = (lt + u * tpr) * VEC;
            if (e < d) {
                copy_run(ring + ((slot * RUNS + u) * 2) * nth + tid, x + off,
                         e, d, vec);
                copy_run(ring + ((slot * RUNS + u) * 2 + 1) * nth + tid,
                         g + off, e, d, vec);
            }
        }
    };
#pragma unroll
    for (int s = 0; s < DEPTH; ++s) {
        if (s < n) issue(s);
        cp_commit();
    }
    __syncthreads();   // w

    float acc[RUNS][VEC];
#pragma unroll
    for (int u = 0; u < RUNS; ++u)
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[u][k] = 0.f;
    int par = 0;
    for (int kk = 0; kk < n; ++kk) {
        if (kk + DEPTH < n) issue(kk + DEPTH);   // into the slot freed last row
        cp_commit();
        cp_wait<DEPTH>();   // row kk's copies have landed
        const Run<T, VEC>* cur = ring + (kk % SLOTS) * RUNS * 2 * nth + tid;
        float ss = 0.f, dot = 0.f;
#pragma unroll
        for (int u = 0; u < RUNS; ++u) {
            const int e = (lt + u * tpr) * VEC;
            if (e < d) {
                const Run<T, VEC> xr = cur[(2 * u) * nth];
                const Run<T, VEC> gr = cur[(2 * u + 1) * nth];
                float wv[VEC];
                run_w<VEC>(wv, wq, u, tpr, lt);
#pragma unroll
                for (int k = 0; k < VEC; ++k) {
                    const float xv = to_f(xr.v[k]);
                    ss = fmaf(xv, xv, ss);
                    dot = fmaf(to_f(gr.v[k]) * wv[k], xv, dot);
                }
            }
        }
        ss = group_sum<LANES>(ss);
        dot = group_sum<LANES>(dot);
        if (W > 1) {  // the group's warps, in warp order
            if ((lt & 31) == 0) red[par][grp * W + wid] = make_float2(ss, dot);
            asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "r"(tpr)
                         : "memory");
            float2 a = red[par][grp * W];
            ss = a.x;
            dot = a.y;
            for (int j = 1; j < W; ++j) {
                a = red[par][grp * W + j];
                ss += a.x;
                dot += a.y;
            }
            par ^= 1;   // the next row writes the other half
        }
        const float r = rsqrtf(ss / (float)d + eps);
        const float m = dot * r / (float)d;   // mean(g * w * xh)
        T* dr = dx + (size_t)(r0 + grp + kk * G) * d;
#pragma unroll
        for (int u = 0; u < RUNS; ++u) {
            const int e = (lt + u * tpr) * VEC;
            if (e < d) {
                const Run<T, VEC> xr = cur[(2 * u) * nth];
                const Run<T, VEC> gr = cur[(2 * u + 1) * nth];
                Run<T, VEC> o;
                float wv[VEC];
                run_w<VEC>(wv, wq, u, tpr, lt);
#pragma unroll
                for (int k = 0; k < VEC; ++k) {
                    const float gv = to_f(gr.v[k]);
                    const float xh = to_f(xr.v[k]) * r;
                    o.v[k] = from_f<T>(r * (gv * wv[k] - xh * m));
                    acc[u][k] = fmaf(gv, xh, acc[u][k]);
                }
                if (vec) {
                    *reinterpret_cast<Run<T, VEC>*>(dr + e) = o;
                } else {
#pragma unroll
                    for (int k = 0; k < VEC; ++k)
                        if (e + k < d) dr[e + k] = o.v[k];
                }
            }
        }
    }
    float* out = part + (size_t)blockIdx.x * d;
    if (G == 1) {
#pragma unroll
        for (int u = 0; u < RUNS; ++u) {
            const int e = (lt + u * tpr) * VEC;
#pragma unroll
            for (int k = 0; k < VEC; ++k)
                if (e + k < d) out[e + k] = acc[u][k];
        }
        return;
    }
    float* sums = reinterpret_cast<float*>(ring);
    __syncthreads();   // every row done: the ring is free
#pragma unroll
    for (int u = 0; u < RUNS; ++u) {
        const int e = (lt + u * tpr) * VEC;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
            if (e + k < d) sums[grp * d + e + k] = acc[u][k];
    }
    __syncthreads();
    for (int c = tid; c < d; c += nth) {
        float v = sums[c];
        for (int j = 1; j < G; ++j) v += sums[j * d + c];
        out[c] = v;
    }
}

// dw[c] = the sum of the partial rows' column c: 32 columns a block, thread
// (c, y) sums runs y, y + 32, ... in order, then thread (c, 0) the 32 sums
// in y order. Launched as a programmatic dependent of the row kernel: its
// launch overlaps that kernel's last blocks, and it waits for the partial
// rows before it reads one.
__global__ void __launch_bounds__(1024) rmsnorm_dw_kernel(
    const float* __restrict__ part, float* __restrict__ dw, int runs, int d) {
    __shared__ float s[32][33];
    asm volatile("griddepcontrol.wait;" ::: "memory");
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

template <typename T, int VEC, int RUNS, int DEPTH, int MINB, int LANES>
static int launch_rows(const void* x, const void* w, int wtype, const void* g,
                       void* dx, float* part, int rows, int d, float eps,
                       int chunk, int tpr, int vec, cudaStream_t stream) {
    constexpr size_t RING = (size_t)(DEPTH + 1) * RUNS * 2 * BWD_THREADS
                            * sizeof(Run<T, VEC>);
    constexpr size_t MAX_SMEM = RING + RUNS * VEC * BWD_THREADS * sizeof(float);
    static bool attr_set = false;   // once per instance: it costs host time
    if (!attr_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            rmsnorm_bwd_kernel<T, VEC, RUNS, DEPTH, MINB, LANES>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
        if (err != cudaSuccess) return (int)err;
        attr_set = true;
    }
    const int groups = BWD_THREADS / tpr;
    const int nth = groups * tpr;
    const size_t ring = (size_t)(DEPTH + 1) * RUNS * 2 * nth
                        * sizeof(Run<T, VEC>);
    const size_t sums = (size_t)groups * d * sizeof(float);
    const size_t wbytes = (size_t)RUNS * VEC * tpr * sizeof(float);
    const size_t smem = wbytes + (ring > sums ? ring : sums);
    rmsnorm_bwd_kernel<T, VEC, RUNS, DEPTH, MINB, LANES>
        <<<(rows + chunk - 1) / chunk, nth, smem, stream>>>(
            (const T*)x, w, wtype, (const T*)g, (T*)dx, part, rows, d, chunk,
            tpr, eps, vec);
    return (int)cudaGetLastError();
}

// Threads a row, fixed by d and the type: up to WARP_D half a warp of
// 16-byte runs (2 a lane, 4 at f32), 3 rows ahead in the ring; above, W
// warps of 16-byte runs (4 a thread, or 8 where W would pass 8 warps), one
// row ahead.
template <typename T>
static int launch_bwd(const void* x, const void* w, int wtype, const void* g,
                      void* dx, float* part, float* dw, int rows, int d,
                      float eps, int chunk, cudaStream_t stream) {
    int err;
    constexpr int VEC = 16 / sizeof(T);
    const int vec = d % VEC == 0 && aligned(x, 16) && aligned(g, 16)
                    && aligned(dx, 16);
    if (d <= WARP_D) {
        constexpr int NR = WARP_D / (16 * VEC);   // 2 runs, 4 at f32
        err = launch_rows<T, VEC, NR, 3, 2, 16>(x, w, wtype, g, dx, part,
                                                rows, d, eps, chunk, 16, vec,
                                                stream);
    } else {
        const int runs = (d + VEC - 1) / VEC;
        const int w4 = (runs + 127) / 128;
        if (w4 <= BWD_THREADS / 32) {
            err = launch_rows<T, VEC, 4, 1, 2, 32>(x, w, wtype, g, dx, part,
                                                   rows, d, eps, chunk,
                                                   32 * w4, vec, stream);
        } else {
            const int w8 = (runs + 255) / 256;
            if (w8 > BWD_THREADS / 32) return (int)cudaErrorInvalidValue;
            err = launch_rows<T, VEC, 8, 1, 1, 32>(x, w, wtype, g, dx, part,
                                                   rows, d, eps, chunk,
                                                   32 * w8, vec, stream);
        }
    }
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((d + 31) / 32, 1, 1);
    cfg.blockDim = dim3(32, 32, 1);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e2 = cudaLaunchKernelEx(
        &cfg, rmsnorm_dw_kernel, (const float*)part, dw,
        (rows + chunk - 1) / chunk, d);
    if (e2 != cudaSuccess) return (int)e2;
    return (int)cudaGetLastError();
}

// x, g and dx (rows, d) contiguous of type xtype, w (d,) of type wtype
// (0 f32, 1 bf16, 2 f16), part (ceil(rows / chunk), d) f32 scratch, dw (d,)
// f32, every element of it written; d at most 8 * 1024. Two launches;
// returns cudaGetLastError().
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* g,
                           void* dx, void* part, void* dw, int rows, int d,
                           int xtype, int wtype, float eps, int chunk,
                           void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    float* pp = (float*)part;
    float* pw = (float*)dw;
    if (chunk <= 0 || rows <= 0 || d <= 0 || d > 8 * 1024)
        return (int)cudaErrorInvalidValue;
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
