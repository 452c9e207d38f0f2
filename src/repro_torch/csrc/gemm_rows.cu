// Row-invariant matrix product for Hopper (sm_90a): every product of the
// paged decode step (q, k, v and o projections, the MLP, the unembedding),
// and so of the speculative verify, which folds its window into that step.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA.
// It replaces torch.matmul (cuBLAS) on the paged decode entry point, because
// cuBLAS picks its kernel from the row count: on the H100 the first 8 rows
// of a 40-row 4096 x 1024 product differ from an 8-row product by up to a
// bf16 ulp, and a 40-row verify then disagrees with an 8-row decode step.
//
// Computes out (M, N) = x (M, K) @ w, bf16 operands, f32 sums, bf16 result
// (round to nearest even); w is (K, N) row-major, or (N, K) row-major (the
// transpose of a tied embedding, "nk").
//
// The contract: a row's result depends only on that row and w. No split-K;
// one f32 accumulator per output element walks K in one fixed order (one
// mma.sync step of 16 after another, zeros past K); the tile widths are
// chosen from N alone. The row count decides only how many 16-row tiles a
// block runs (a tile past M is not computed), and a row's tile runs the
// same instructions wherever the row sits in it.
//
// What bounds it on this card: bytes. At decode the rows are few (8 lanes,
// 40 in a k = 4 verify) and w is read once from device memory: 2 K N bytes
// over 3.35 TB/s; 2 M K N operations are far below the tensor cores' rate.
//
// Design (a simple kernel first; making it fast is later work):
// - a block owns BN columns (32, 64 or 128, by N) and up to 64 rows; its
//   4 warps split the columns, each running every row tile of the block;
// - x and w tiles stream through a 4-stage cp.async ring (zero-filled past
//   M, N and K), padded by 16 bytes a row so that ldmatrix reads hit
//   distinct banks. A w tile is 16 KB whatever BN (BK = 8192 / BN along
//   K), so that a narrow block, of which there are few (32 for N = 1024),
//   still keeps some 48 KB of weights in flight; the x tile holds only the
//   block's row tiles;
// - A fragments by ldmatrix, B by ldmatrix.trans (w as (K, N)) or
//   ldmatrix (w as (N, K)); m16n8k16 mma.sync with f32 accumulators.

#include "mma.cuh"

#define STAGES 4
#define MB 64       // rows a block holds at most
#define WARPS 4
#define PAD 8       // bf16 elements of padding a shared-memory row

template <int BN, bool NK>
struct Tile {
    static constexpr int BK = 8192 / BN;                 // K per stage
    static constexpr int XROW = BK + PAD;                // x row, elements
    static constexpr int WS = NK ? BN * (BK + PAD) : BK * (BN + PAD);
    // elements of one stage when the block runs mt row tiles of 16
    static __host__ __device__ constexpr int stage(int mt) {
        return mt * 16 * XROW + WS;
    }
    static __host__ __device__ constexpr int smem(int mt) {  // bytes
        return STAGES * stage(mt) * 2;
    }
};

template <int BN, bool NK>
__device__ __forceinline__ void load_stage(
    __nv_bfloat16* xs, __nv_bfloat16* ws, const __nv_bfloat16* x,
    const __nv_bfloat16* w, int M, int N, int K, int m0, int n0, int k0,
    int mt) {
    constexpr int BK = Tile<BN, NK>::BK;
    const int tid = threadIdx.x;
    // x: mt tiles of 16 rows, 8 chunks of 16 bytes a row
    for (int c = tid; c < mt * 16 * (BK / 8); c += WARPS * 32) {
        const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
        const bool ok = m0 + r < M && k0 + kc < K;
        const __nv_bfloat16* src = ok ? x + (size_t)(m0 + r) * K + k0 + kc : x;
        cp_async16_zfill(xs + r * (BK + PAD) + kc, src, ok);
    }
    if constexpr (NK) {  // w (N, K): BN rows of n, chunks along k
        for (int c = tid; c < BN * (BK / 8); c += WARPS * 32) {
            const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
            const bool ok = n0 + r < N && k0 + kc < K;
            const __nv_bfloat16* src =
                ok ? w + (size_t)(n0 + r) * K + k0 + kc : w;
            cp_async16_zfill(ws + r * (BK + PAD) + kc, src, ok);
        }
    } else {   // w (K, N): BK rows of k, chunks along n
        for (int c = tid; c < BK * (BN / 8); c += WARPS * 32) {
            const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
            const bool ok = k0 + r < K && n0 + nc < N;
            const __nv_bfloat16* src =
                ok ? w + (size_t)(k0 + r) * N + n0 + nc : w;
            cp_async16_zfill(ws + r * (BN + PAD) + nc, src, ok);
        }
    }
}

template <int BN, bool NK>
__global__ void __launch_bounds__(WARPS * 32)
gemm_rows_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K) {
    constexpr int WN = BN / WARPS;   // columns a warp owns
    constexpr int NT = WN / 8;       // its n8 tiles: 1, 2 or 4
    using T = Tile<BN, NK>;
    constexpr int BK = T::BK;
    extern __shared__ __align__(16) __nv_bfloat16 smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * MB;
    const int mt = min(4, (M - m0 + 15) / 16);   // row tiles of this block
    const int wn0 = warp * WN;
    const int KT = (K + BK - 1) / BK;
    const int STAGE = T::stage(mt), XS = mt * 16 * T::XROW;

    float acc[4][NT][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < KT)
            load_stage<BN, NK>(smem + s * STAGE, smem + s * STAGE + XS,
                               x, w, M, N, K, m0, n0, s * BK, mt);
        cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();   // stage kt landed; stage kt - 1 is free to refill
        const int nk = kt + STAGES - 1;
        if (nk < KT) {
            const int s = nk % STAGES;
            load_stage<BN, NK>(smem + s * STAGE, smem + s * STAGE + XS,
                               x, w, M, N, K, m0, n0, nk * BK, mt);
        }
        cp_async_commit();
        const __nv_bfloat16* xs = smem + (kt % STAGES) * STAGE;
        const __nv_bfloat16* ws = xs + XS;
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
            uint32_t b[NT][2];
            if constexpr (NK) {
                // w rows are n: matrix i of lane group i is (n tile i / 2,
                // k half i % 2), as it is
#pragma unroll
                for (int np = 0; np < NT; np += 2) {
                    if constexpr (NT == 1) {
                        const int l = lane & 15;
                        const __nv_bfloat16* p = ws + (wn0 + (l & 7)) * (BK + PAD)
                                                 + ks * 16 + (l >> 3) * 8;
                        ldsm_x2(b[0], p);
                    } else {
                        const int mat = lane >> 3;
                        const __nv_bfloat16* p =
                            ws + (wn0 + (np + (mat >> 1)) * 8 + (lane & 7)) * (BK + PAD)
                            + ks * 16 + (mat & 1) * 8;
                        uint32_t r[4];
                        ldsm_x4(r, p);
                        b[np][0] = r[0]; b[np][1] = r[1];
                        b[np + 1][0] = r[2]; b[np + 1][1] = r[3];
                    }
                }
            } else {
                // w rows are k: the same matrices, transposed
#pragma unroll
                for (int np = 0; np < NT; np += 2) {
                    if constexpr (NT == 1) {
                        const int l = lane & 15;
                        const __nv_bfloat16* p = ws + (ks * 16 + (l >> 3) * 8 + (l & 7)) * (BN + PAD)
                                                 + wn0;
                        ldsm_x2_trans(b[0], p);
                    } else {
                        const int mat = lane >> 3;
                        const __nv_bfloat16* p =
                            ws + (ks * 16 + (mat & 1) * 8 + (lane & 7)) * (BN + PAD)
                            + wn0 + (np + (mat >> 1)) * 8;
                        uint32_t r[4];
                        ldsm_x4_trans(r, p);
                        b[np][0] = r[0]; b[np][1] = r[1];
                        b[np + 1][0] = r[2]; b[np + 1][1] = r[3];
                    }
                }
            }
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
                if (mi < mt) {
                    uint32_t a[4];
                    const __nv_bfloat16* p =
                        xs + (mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * (BK + PAD)
                        + ks * 16 + (lane >> 4) * 8;
                    ldsm_x4(a, p);
#pragma unroll
                    for (int ni = 0; ni < NT; ++ni)
                        mma16816(acc[mi][ni], a[0], a[1], a[2], a[3],
                                 b[ni][0], b[ni][1]);
                }
            }
        }
    }
    cp_async_wait<0>();

    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
        if (mi >= mt) continue;
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
            const int col = n0 + wn0 + ni * 8 + 2 * t;
            if (col >= N) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = m0 + mi * 16 + g + 8 * h;
                if (row < M)
                    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
                        __floats2bfloat162_rn(acc[mi][ni][2 * h],
                                              acc[mi][ni][2 * h + 1]);
            }
        }
    }
}

template <int BN, bool NK>
static int launch(const void* x, const void* w, void* out, int M, int N,
                  int K, cudaStream_t stream) {
    static bool attr_set = false;   // once per instance: it costs host time
    if (!attr_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            gemm_rows_kernel<BN, NK>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            Tile<BN, NK>::smem(4));
        if (err != cudaSuccess) return (int)err;
        attr_set = true;
    }
    // shared memory for the row tiles of the fullest block (every block
    // but the last holds 4); the layout, never the arithmetic, follows it
    const int tiles = (M + 15) / 16;
    const int smem = Tile<BN, NK>::smem(tiles < 4 ? tiles : 4);
    const dim3 grid((N + BN - 1) / BN, (M + MB - 1) / MB);
    gemm_rows_kernel<BN, NK><<<grid, WARPS * 32, smem, stream>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
        (__nv_bfloat16*)out, M, N, K);
    return (int)cudaGetLastError();
}

template <bool NK>
static int launch_n(const void* x, const void* w, void* out, int M, int N,
                    int K, cudaStream_t stream) {
    // the tile width follows N alone, so that wide products keep many
    // columns a block and narrow ones still spread over the SMs
    if (N >= 32768) return launch<128, NK>(x, w, out, M, N, K, stream);
    if (N >= 8192) return launch<64, NK>(x, w, out, M, N, K, stream);
    return launch<32, NK>(x, w, out, M, N, K, stream);
}

// x (M, K), out (M, N) contiguous bf16; w contiguous bf16, (K, N) when nk
// is 0, (N, K) when nk is 1. K and N multiples of 8, pointers 16-byte
// aligned (the wrapper checks). Returns cudaGetLastError() after the
// launch.
extern "C" int gemm_rows_bf16(const void* x, const void* w, void* out, int M,
                              int N, int K, int nk, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8)
        return (int)cudaErrorInvalidValue;
    return nk ? launch_n<true>(x, w, out, M, N, K, st)
              : launch_n<false>(x, w, out, M, N, K, st);
}
