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
// The contract: a row's result depends only on that row and w, for every
// row count M >= 1. Every choice the kernel makes -- the tile width, the
// k step, the K segments, the merge order, the instruction shape, the
// cache policy -- is fixed by (K, N), the layout of w and the card's SM
// count (the plan, kernels/gemm_rows.py). M decides only how many 64-row
// passes run and how many x rows a stage loads. A row's sum over K is its
// tile's segments 0, 1, ..., S-1 added in that order in f32, each segment
// summed by one wgmma per 16 k in k order, then rounded once to bf16.
//
// What bounds it on this card: bytes. At decode the rows are few (8 lanes,
// 40 in a k = 4 verify) and w is read once from device memory: 2 K N bytes
// over 3.35 TB/s; 2 M K N operations are far below the tensor cores' rate.
//
// Design, against what held the first form (a grid of 64-column blocks,
// cp.async and mma.sync, no split) back:
// - Too few blocks on narrow products. A persistent grid, one block an
//   SM, walks a fixed list of work items (tile of BN columns, K segment),
//   tile by tile, block b taking items b, b + grid, ...; pass p (rows
//   64p .. 64p + 63) repeats the list. The plan cuts each tile into the
//   fewest segments that give every SM an item in one wave (k and v at N
//   1024: 16 tiles of 64 columns in 8 or 9 segments, 132 items), all
//   tiles at nearly the same k, so the SMs read the same rows of w at
//   once; the unembedding has more tiles than SMs and is not split.
// - Split-K merged in the same launch. An item of a split tile writes its
//   f32 partial (rows x BN) to scratch, then (a __threadfence, then an
//   atomicAdd on the shared counter buffer) waits until all the tile's
//   items have arrived -- they run in the same wave -- and merges its own
//   share of the tile's outputs, adding the partials in segment order
//   0..S-1 and rounding once; the last of them to leave resets the
//   counter to 0. An unsplit tile writes bf16 at once. (One block merging
//   a whole tile of 9 segments at 40 rows took longer than the tile's
//   loads; spread over the tile's blocks it is a ninth of that.)
// - No producer. A producer warpgroup keeps a ring of stages in flight,
//   tracked by mbarriers (full: the TMA bytes and 128 cp.async arrivals;
//   empty: the consumer threads), across items, so the next item's tiles
//   load during this item's epilogue. Its first thread loads the w tile
//   (BN / 64 boxes of 64 columns x BK) by TMA from a 2-D tensor map in the
//   128-byte swizzle (64-byte for (N, K) at BK 32), zero-filled past K and
//   N, marked evict-first in L2 where the plan says so; its 128 threads
//   load the stage's x rows (BK of K) with cp.async in the same swizzle,
//   zero-filled past M and K. (One warp issuing the x loads bound the
//   stage at 40 rows.) One consumer warpgroup per 64 columns multiplies.
// - x beside w, never in its place. A stage holds the w tile and an x tile
//   sized for 64 rows whatever M, so the ring's depth (192 KB: 12 stages
//   at BN 64, BK 64) is fixed by the plan, and the row count changes only
//   how many x rows are loaded. (An item's whole x at K 4096 and 64 rows
//   would be 512 KB, more than an SM's shared memory, so x streams beside
//   w rather than once per item.)
// - Tensor cores, operands swapped: out^T = w^T x^T. The w box is wgmma's
//   64-row A operand, loaded once a stage from shared memory into
//   registers by ldmatrix (transposed for (K, N)); the stage's x tile is
//   the K-major B operand in shared memory of one m64n64k16 a k16, whatever
//   M: one instruction shape, and a row is always column r % 64 of it, so
//   it sums the same way at every row count. A column's sums read only its
//   own x row, so the tile's rows past M are not cleared. (m64n8k16 a
//   group of 8 rows sums the same way too, but each costs about what one
//   m64n64k16 does, and with A read by descriptor every group read the
//   2 KB A slice from shared memory again.)
// - The host: one launch a product, no second merge kernel. The tensor map
//   of a w is encoded once into a launch record (gemm_rows_record) that the
//   wrapper caches per (pointer, shape, layout); x, out and the partials
//   need no descriptor, and the launch takes 8 arguments.
//
// The grouped product (gemm_rows_grouped_bf16): out (E, C, N) = buf (E, C,
// K) @ w (E, K, N), one launch for all E experts of an MoE layer's routed
// products on the paged decode step. It is the same kernel over a 3-D
// tensor map of w: the items are (expert, 64-row pass, tile), expert by
// expert, every tile whole (no K split: E tiles already fill the card), so
// an (expert, row) result depends only on that row and w[e] -- not on C,
// the row's rank, or which other experts have rows. With counts (E,) it
// skips every pass that lies wholly at or past counts[e] and reads and
// writes no row there: an expert no token chose costs no weight read.
//
// N need not be a multiple of 8 where w is (N, K) (a tied embedding of
// 49,155 rows): the map's rows are K long; the merge falls back to single
// columns where N is no multiple of 4. Where w is (K, N) the wrapper hands
// a copy padded to ld columns (the map's row pitch must be 16 bytes).

#include <cuda_bf16.h>
#include <new>

#include "tma.cuh"  // mbarriers, TMA, the wgmma descriptor and fences

#define SUB_N 64                    // columns of a consumer warpgroup
#define XROWS 64                    // rows of a pass
#define X_STAGE (XROWS * 128)       // an x tile: 64 rows of 128 bytes
#define RING_BYTES (192 * 1024)     // w and x tiles in flight, a block
#define PRODUCERS 128               // one producer warpgroup

// a block of WG consumer warpgroups: an item is WG * 64 columns, a w tile
// WG TMA boxes of 64 columns x BK, beside one x tile
template <int BK, int WG>
struct Ring {
    static constexpr int CONSUMERS = 128 * WG;
    static constexpr int THREADS = CONSUMERS + PRODUCERS;
    static constexpr int W_SUB = BK * SUB_N * 2;     // bytes of a TMA box
    static constexpr int W_STAGE = WG * W_SUB;
    static constexpr int STAGE = W_STAGE + X_STAGE;
    static constexpr int STAGES = RING_BYTES / STAGE;
    static constexpr int X_OFF = STAGES * W_STAGE;
    static constexpr int BAR_OFF = X_OFF + STAGES * X_STAGE;
    static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8;
    static constexpr int SMEM = BYTES + 1024;  // + slack to align the base
};

// D(64 x 64) += A(64 x 16, registers) * B(16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The A fragments of a TMA box (this warp's 16 of its 64 columns, the k16
// slice kk): lanes 8i..8i+7 address the rows of 8x8 matrix i, (columns +0,
// k +0), (+8, +0), (+0, +8), (+8, +8). (K, N): the box's rows are k, 128
// bytes of n each, read transposed; (N, K): its rows are n, 2 BK bytes of
// k each, read as they are. Each in the TMA's swizzle: 16-byte chunk c of
// row r sits at c ^ (r & 7) (128 bytes), c ^ ((r >> 1) & 3) (64 bytes).
template <int BK, bool TA>
__device__ __forceinline__ void load_a(uint32_t* a, const unsigned char* ws,
                                       int warp, int lane, int kk) {
    const int mi = lane >> 3, r = lane & 7;
    if constexpr (TA) {
        const int k = kk * 16 + (mi >> 1) * 8 + r;
        const int c = 2 * warp + (mi & 1);
        ldsm_x4_trans(a, ws + k * 128 + ((c ^ r) << 4));
    } else {
        const int n = warp * 16 + (mi & 1) * 8 + r;
        const int c = kk * 2 + (mi >> 1);
        if constexpr (BK == 64)
            ldsm_x4(a, ws + n * 128 + ((c ^ (n & 7)) << 4));
        else
            ldsm_x4(a, ws + n * 64 + ((c ^ ((n >> 1) & 3)) << 4));
    }
}

// wait until *cnt reaches n (a gpu-scope acquire); a wait of more than
// ~10 s (a broken protocol) traps, as mbar_wait does
__device__ __forceinline__ void wait_count(const unsigned int* cnt,
                                           unsigned int n) {
    long long start = 0;
    while (true) {
        unsigned int v;
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                     : "=r"(v) : "l"(cnt) : "memory");
        if (v >= n) return;
        if (!start) start = clock64();
        else if (clock64() - start > 20000000000LL) __trap();
    }
}

template <int N>  // a barrier of the N consumer threads
__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(N) : "memory");
}

// One item's k steps for one consumer warpgroup (its box h of each
// stage's w tile): wait for each stage, load the box's A fragments once,
// issue one m64n64k16 a k16 over the stage's 64 x rows, and release the
// stage when they are done.
template <int BK, bool TA, int WG>
__device__ __forceinline__ void mainloop(float (&acc)[8][4],
                                         unsigned char* smem, uint64_t* full,
                                         uint64_t* empty, int it, int steps) {
    using R = Ring<BK, WG>;
    const int h = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    for (int j = 0; j < steps; ++j, ++it) {
        const int st = it % R::STAGES;
        mbar_wait(&full[st], (it / R::STAGES) & 1);
        fence_proxy_async();   // the x rows came through cp.async
        const unsigned char* ws = smem + st * R::W_STAGE + h * R::W_SUB;
        const unsigned char* xs = smem + R::X_OFF + st * X_STAGE;
        uint32_t a[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            load_a<BK, TA>(a[kk], ws, warp, lane, kk);
        fence_regs<32>(&acc[0][0]);
        fence_regs<BK / 4>(&a[0][0]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_rs_n64(&acc[0][0], a[kk],
                         sw128_desc(xs + kk * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<32>(&acc[0][0]);
        mbar_arrive(&empty[st]);
    }
}

// The work items of a pass: tile t (bn columns) is cut into S_t segments
// of whole k steps, segment s being steps s KT / S_t .. (s + 1) KT / S_t - 1
// of the tile's KT; the first `extra` tiles have S_t = s_base + 1, the
// others s_base. Items are numbered tile by tile, segment by segment.
struct Item {
    int t, s, n_seg, k0, k1;
};

__device__ __forceinline__ Item item_at(int i, int KT, int s_base,
                                        int extra) {
    Item it;
    const int wide = extra * (s_base + 1);   // items of the longer tiles
    if (i < wide) {
        it.n_seg = s_base + 1;
        it.t = i / it.n_seg;
        it.s = i - it.t * it.n_seg;
    } else {
        it.n_seg = s_base;
        it.t = extra + (i - wide) / s_base;
        it.s = i - wide - (it.t - extra) * s_base;
    }
    it.k0 = it.s * KT / it.n_seg;
    it.k1 = (it.s + 1) * KT / it.n_seg;
    return it;
}

// G3: w is E experts' (K, N) matrices under a 3-D map, x and out E blocks
// of M rows; rows at or past counts[e] (where counts is given) are skipped
template <int BK, bool TA, int WG, bool G3>
__global__ void __launch_bounds__(Ring<BK, WG>::THREADS, 1)
gemm_rows_kernel(const __grid_constant__ CUtensorMap tw,
                 const __nv_bfloat16* __restrict__ x,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                 unsigned int* __restrict__ counters, int M, int N, int K,
                 int n_tiles, int s_base, int extra, int evict_first,
                 int n_exp, const long long* __restrict__ counts) {
    using R = Ring<BK, WG>;
    constexpr int CONSUMERS = R::CONSUMERS, BN = WG * SUB_N;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem =
        smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::BAR_OFF);
    uint64_t* empty = full + R::STAGES;

    if (threadIdx.x == 0) {
        for (int s = 0; s < R::STAGES; ++s) {
            // the TMA's arrival and one cp.async arrival a producer thread
            mbar_init(&full[s], 1 + PRODUCERS);
            mbar_init(&empty[s], CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int KT = (K + BK - 1) / BK;
    const int per_pass = n_tiles * s_base + extra;
    const int per_exp = (M + XROWS - 1) / XROWS * per_pass;
    const int total = n_exp * per_exp;

    if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
        const int pt = threadIdx.x - CONSUMERS;
        const uint64_t policy = evict_first_policy();
        int it = 0;
        for (int i = blockIdx.x; i < total; i += gridDim.x) {
            const int ex = i / per_exp, ri = i - ex * per_exp;
            const int p = ri / per_pass;
            const int Me = counts ? (int)min((long long)M, counts[ex]) : M;
            if (p * XROWS >= Me) continue;   // the consumers skip it too
            const Item item = item_at(ri - p * per_pass, KT, s_base, extra);
            const int m0 = p * XROWS, n0 = item.t * BN;
            const int rows8 = (min(XROWS, Me - m0) + 7) & ~7;
            const __nv_bfloat16* xe = x + (size_t)ex * M * K;
            for (int kt = item.k0; kt < item.k1; ++kt, ++it) {
                const int st = it % R::STAGES;
                // the stage's previous tiles released (passes at once on a
                // stage's first use)
                mbar_wait(&empty[st], ((it / R::STAGES) & 1) ^ 1);
                unsigned char* ws = smem + st * R::W_STAGE;
                if (pt == 0) {
                    mbar_expect_tx(&full[st], R::W_STAGE);
#pragma unroll
                    for (int h = 0; h < WG; ++h) {
                        const int c0 = TA ? n0 + h * SUB_N : kt * BK;
                        const int c1 = TA ? kt * BK : n0 + h * SUB_N;
                        if constexpr (G3) {
                            if (evict_first)
                                tma_load_3d_hint(ws + h * R::W_SUB, &tw,
                                                 &full[st], c0, c1, ex, policy);
                            else
                                tma_load_3d(ws + h * R::W_SUB, &tw, &full[st],
                                            c0, c1, ex);
                        } else if (evict_first) {
                            tma_load_2d_hint(ws + h * R::W_SUB, &tw, &full[st],
                                             c0, c1, policy);
                        } else {
                            tma_load_2d(ws + h * R::W_SUB, &tw, &full[st], c0,
                                        c1);
                        }
                    }
                }
                // x: rows8 rows x BK / 8 chunks of 16 bytes, chunk j of row
                // r at 16 * (j ^ (r & 7)) of its 128-byte row (the swizzle)
                unsigned char* xs = smem + R::X_OFF + st * X_STAGE;
                for (int c = pt; c < rows8 * (BK / 8); c += PRODUCERS) {
                    const int r = c / (BK / 8), j = c % (BK / 8);
                    const int m = m0 + r, k = kt * BK + j * 8;
                    const bool ok = m < Me && k < K;
                    cp_async16_zfill(xs + r * 128 + ((j ^ (r & 7)) << 4),
                                     ok ? xe + (size_t)m * K + k : x, ok);
                }
                cp_async_mbar_arrive(&full[st]);
            }
        }
        return;
    }

    // the consumer warpgroups: thread (warpgroup h, warp, lane) holds
    // columns n0 + c0 and n0 + c0 + 8 of rows r0 and r0 + 1 of each group
    // of 8 rows
    const int lane = threadIdx.x & 31;
    const int c0 = (threadIdx.x >> 7) * SUB_N + ((threadIdx.x >> 5) & 3) * 16
                   + (lane >> 2);
    const int r0 = 2 * (lane & 3);
    int it = 0;
    for (int i = blockIdx.x; i < total; i += gridDim.x) {
        const int ex = i / per_exp, ri = i - ex * per_exp;
        const int p = ri / per_pass;
        const int Me = counts ? (int)min((long long)M, counts[ex]) : M;
        if (p * XROWS >= Me) continue;
        const Item item = item_at(ri - p * per_pass, KT, s_base, extra);
        const int t = item.t, s = item.s, n_seg = item.n_seg;
        const int m0 = p * XROWS, n0 = t * BN;
        const int G = (min(XROWS, Me - m0) + 7) / 8;
        __nv_bfloat16* oute = out + (size_t)ex * M * N;
        const int steps = item.k1 - item.k0;

        float acc[8][4];
#pragma unroll
        for (int g = 0; g < 8; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
        mainloop<BK, TA, WG>(acc, smem, full, empty, it, steps);
        it += steps;

        if (n_seg == 1) {  // the whole tile: round and write
#pragma unroll
            for (int g = 0; g < 8; ++g) {
                if (g >= G) break;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int n = n0 + c0 + 8 * (e >> 1);
                    const int m = m0 + g * 8 + r0 + (e & 1);
                    if (n < N && m < Me)
                        oute[(size_t)m * N + n] = __float2bfloat16_rn(acc[g][e]);
                }
            }
            continue;
        }

        // split: the partial of segment s, part[s][m][n]
#pragma unroll
        for (int g = 0; g < 8; ++g) {
            if (g >= G) break;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int n = n0 + c0 + 8 * (e >> 1);
                const int m = m0 + g * 8 + r0 + (e & 1);
                if (n < N && m < M)
                    part[((size_t)s * M + m) * N + n] = acc[g][e];
            }
        }
        // every segment's block waits for the tile's other partials (they
        // run in the same wave: a split tile's items never outnumber the
        // grid), then merges its own share of the tile
        __threadfence();
        consumer_sync<CONSUMERS>();
        unsigned int* cnt = &counters[p * n_tiles + t];
        if (threadIdx.x == 0) {
            atomicAdd(cnt, 1u);
            wait_count(cnt, n_seg);
        }
        consumer_sync<CONSUMERS>();
        __threadfence();
        // the merge of this share of the tile's (rows x BN) outputs, 4 at
        // a time: segments 0..S-1 added in order, the loads of up to 16
        // segments in flight
        const int groups = min(XROWS, M - m0) * (BN / 4);
        const size_t seg = (size_t)M * N / 4;   // float4s of a segment
        for (int q = s * groups / n_seg + threadIdx.x;
             q < (s + 1) * groups / n_seg; q += CONSUMERS) {
            const int m = m0 + q / (BN / 4), n = n0 + (q % (BN / 4)) * 4;
            if (n >= N) continue;
            if (N & 3) {   // rows not 16-byte aligned: column by column
                for (int u = 0; u < 4 && n + u < N; ++u) {
                    float sum = 0.f;
                    for (int s0 = 0; s0 < n_seg; ++s0) {
                        const float v =
                            __ldcg(part + ((size_t)s0 * M + m) * N + n + u);
                        sum = s0 ? sum + v : v;
                    }
                    out[(size_t)m * N + n + u] = __float2bfloat16_rn(sum);
                }
                continue;
            }
            const float4* src =
                reinterpret_cast<const float4*>(part + (size_t)m * N + n);
            float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int s0 = 0; s0 < n_seg; s0 += 16) {
                float4 v[16];
#pragma unroll
                for (int u = 0; u < 16; ++u)
                    if (s0 + u < n_seg) v[u] = __ldcg(src + (s0 + u) * seg);
#pragma unroll
                for (int u = 0; u < 16; ++u) {
                    if (s0 + u >= n_seg) break;
                    if (s0 + u == 0) {
                        sum = v[u];
                    } else {
                        sum.x += v[u].x; sum.y += v[u].y;
                        sum.z += v[u].z; sum.w += v[u].w;
                    }
                }
            }
            const __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x, sum.y);
            const __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z, sum.w);
            *reinterpret_cast<uint2*>(out + (size_t)m * N + n) =
                make_uint2(pack_bf16(lo), pack_bf16(hi));
        }
        // the last of the tile's blocks to leave resets its counter (every
        // block has seen n_seg by then)
        if (threadIdx.x == 0
            && atomicAdd(cnt, 1u) == (unsigned int)(2 * n_seg - 1))
            *cnt = 0u;
    }
}

// ---------------------------------------------------------------------------
// host side: the launch record and the launch
// ---------------------------------------------------------------------------

// what a product's launches share: w's tensor map and the plan
struct Record {
    CUtensorMap map;
    int N, K, nk, bk, wg, n_tiles, s_base, extra, evict_first, n_exp;
};

template <int BK, bool TA, int WG, bool G3>
static int launch(const Record* rec, const void* x, void* out, void* part,
                  void* counters, const void* counts, int M, int grid,
                  cudaStream_t stream) {
    using R = Ring<BK, WG>;
    static bool attr_set = false;   // once per instance: it costs host time
    if (!attr_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            gemm_rows_kernel<BK, TA, WG, G3>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
        if (err != cudaSuccess) return (int)err;
        attr_set = true;
    }
    gemm_rows_kernel<BK, TA, WG, G3><<<grid, R::THREADS, R::SMEM, stream>>>(
        rec->map, (const __nv_bfloat16*)x, (__nv_bfloat16*)out, (float*)part,
        (unsigned int*)counters, M, rec->N, rec->K, rec->n_tiles, rec->s_base,
        rec->extra, rec->evict_first, G3 ? rec->n_exp : 1,
        (const long long*)counts);
    return (int)cudaGetLastError();
}

template <int BK, bool TA>
static int launch_wg(const Record* r, const void* x, void* out, void* part,
                     void* counters, int M, int grid, cudaStream_t st) {
    return r->wg == 2
        ? launch<BK, TA, 2, false>(r, x, out, part, counters, nullptr, M,
                                   grid, st)
        : launch<BK, TA, 1, false>(r, x, out, part, counters, nullptr, M,
                                   grid, st);
}

// The launch record of a w and its plan (kernels/gemm_rows.py::plan): w
// bf16, 16-byte aligned, (K, N) with rows ld >= N apart when nk is 0, (N,
// K) contiguous when nk is 1; K and ld multiples of 8 (the wrapper checks);
// bk 64 or 32, wg consumer warpgroups (1 or 2: tiles of 64 wg columns),
// s_base segments a tile and one more for the first `extra` tiles (at most
// the k steps), w's loads evict-first in L2 or not. n_exp > 0 makes the
// record of a grouped product (kernels/gemm_rows.py::plan_grouped): w is
// n_exp contiguous (K, N) matrices (nk 0, ld N), every tile whole. Writes
// the record's address to *rec; returns 0, or a cudaError_t when the plan or
// the map is refused.
extern "C" int gemm_rows_record(const void* w, int K, int N, int ld, int nk,
                                int bk, int wg, int s_base, int extra,
                                int evict_first, int n_exp, void** rec) {
    const int kt = (K + bk - 1) / bk;
    const int n_tiles = (N + wg * SUB_N - 1) / (wg * SUB_N);
    if (K <= 0 || N <= 0 || K % 8 || !(bk == 64 || bk == 32)
        || (!nk && (ld < N || ld % 8)) || !(wg == 1 || wg == 2) || s_base < 1
        || extra < 0 || extra >= n_tiles || s_base + (extra > 0) > kt
        || (n_exp > 0 && (nk || ld != N || s_base != 1 || extra)))
        return (int)cudaErrorInvalidValue;
    const EncodeTiled enc = encoder();
    if (!enc) return (int)cudaErrorNotSupported;
    Record* r = new (std::nothrow) Record;
    if (!r) return (int)cudaErrorMemoryAllocation;
    // (K, N): dims (N, K), a box of 64 columns x bk rows of k, 128 bytes
    // inner; (N, K): dims (K, N), a box of bk k x 64 rows of n, 2 bk bytes
    // inner; each in the swizzle of its inner width; grouped: dims (N, K,
    // n_exp), a box of one expert's (K, N) box
    const cuuint64_t dims[3] = {(cuuint64_t)(nk ? K : N),
                                (cuuint64_t)(nk ? N : K),
                                (cuuint64_t)(n_exp > 0 ? n_exp : 1)};
    const cuuint64_t strides[2] = {(cuuint64_t)(nk ? K : ld) * 2,
                                   (cuuint64_t)K * N * 2};
    const cuuint32_t box[3] = {(cuuint32_t)(nk ? bk : SUB_N),
                               (cuuint32_t)(nk ? SUB_N : bk), 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult res = enc(&r->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                             n_exp > 0 ? 3 : 2,
                             const_cast<void*>(w), dims, strides, box, unit,
                             CU_TENSOR_MAP_INTERLEAVE_NONE,
                             nk && bk == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_128B,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) {
        delete r;
        return (int)cudaErrorInvalidValue;
    }
    r->N = N; r->K = K; r->nk = nk; r->bk = bk; r->wg = wg;
    r->n_tiles = n_tiles; r->s_base = s_base; r->extra = extra;
    r->evict_first = evict_first;
    r->n_exp = n_exp;
    *rec = r;
    return 0;
}

// dynamic shared memory of a block at k step bk with wg consumer
// warpgroups (bytes)
extern "C" int gemm_rows_smem(int bk, int wg) {
    if (bk == 32) return wg == 2 ? Ring<32, 2>::SMEM : Ring<32, 1>::SMEM;
    return wg == 2 ? Ring<64, 2>::SMEM : Ring<64, 1>::SMEM;
}

extern "C" void gemm_rows_free_record(void* rec) {
    delete static_cast<Record*>(rec);
}

// x (M, K), out (M, N) contiguous bf16, 16-byte aligned; part S * M * N
// floats, S the most segments of a tile (unused when every tile is
// whole); counters ceil(M / 64) * n_tiles unsigned ints that are zero, and
// left zero; grid the plan's block count (the SM count, or the items of a
// pass where they are fewer).
// Returns cudaGetLastError() after the launch.
extern "C" int gemm_rows_bf16(const void* x, const void* rec, void* out,
                              void* part, void* counters, int M, int grid,
                              void* stream) {
    const Record* r = static_cast<const Record*>(rec);
    cudaStream_t st = (cudaStream_t)stream;
    // a split tile's blocks wait for each other: they must share a wave
    const bool split = r->s_base > 1 || r->extra > 0;
    if (M <= 0 || grid <= 0 || r->n_exp > 0
        || (split && r->n_tiles * r->s_base + r->extra > grid))
        return (int)cudaErrorInvalidValue;
    if (r->nk)
        return r->bk == 32
            ? launch_wg<32, false>(r, x, out, part, counters, M, grid, st)
            : launch_wg<64, false>(r, x, out, part, counters, M, grid, st);
    return r->bk == 32
        ? launch_wg<32, true>(r, x, out, part, counters, M, grid, st)
        : launch_wg<64, true>(r, x, out, part, counters, M, grid, st);
}

// The grouped product: buf (E, C, K), out (E, C, N) contiguous bf16,
// 16-byte aligned, rec a grouped record of E experts; counts (E,) int64
// (torch.bincount's type) or null: expert e's rows at or past counts[e]
// are neither read nor written. grid the plan's block count.
// Returns cudaGetLastError() after the launch.
extern "C" int gemm_rows_grouped_bf16(const void* buf, const void* rec,
                                      void* out, const void* counts, int C,
                                      int grid, void* stream) {
    const Record* r = static_cast<const Record*>(rec);
    cudaStream_t st = (cudaStream_t)stream;
    if (C <= 0 || grid <= 0 || r->n_exp <= 0 || r->bk != 64)
        return (int)cudaErrorInvalidValue;
    return r->wg == 2
        ? launch<64, true, 2, true>(r, buf, out, nullptr, nullptr, counts, C,
                                    grid, st)
        : launch<64, true, 1, true>(r, buf, out, nullptr, nullptr, counts, C,
                                    grid, st);
}
