// Flash-decode attention for Hopper (sm_90a): one query token per lane
// against that lane's cached keys and values. Shared by the paged kernel
// (paged_decode_attention.cu: keys reached through a page table) and the
// dense one (decode_attention.cu: keys contiguous per lane); a Layout type
// says where key t of lane b lives, nothing else differs.
//
// What bounds it on this card: bytes. Each lane reads len_b keys and values
// of K*D bf16 once; the arithmetic is 4*G*D FLOP per key and kv head, far
// below the ~295 FLOP/byte the H100 needs before compute binds. The bound
// is sum_b len_b * K * D * 2 (K and V) * 2 bytes over 3.35 TB/s. Reaching
// it takes many blocks with many bytes in flight, whatever the batch, and
// arithmetic short enough per tile to keep up with the loads.
//
// Design:
// - Split: each lane's keys are cut into fixed segments of SEG = 256 keys
//   (four 64-row pages). The grid is (B, K, ceil(cap / SEG)), cap being the
//   layout's capacity (S, or max_pages * P), which the host knows without a
//   device sync; a block whose segment starts at or past its lane's length
//   exits at once. At 8 lanes x 8 kv heads of up to 2048 keys that is up to
//   512 blocks of which those over live keys run, where one block per
//   (lane, kv head) gave 64.
// - A block is 2 warps. Warp w takes the segment's 32-key tiles w, w + 2,
//   ... and runs an f32 online softmax over them, on the tensor cores
//   (mma.sync m16n8k16, f32 accumulation): the G = H/K query heads of the kv
//   head are the rows of A (held in registers, G <= 8 of 16 rows), so
//   S = Q K^T takes K rows straight from shared memory as B, and the f32
//   scores, scaled by 1/sqrt(D) after the dot, sit in the accumulator
//   layout that is also the A layout of P V: P never leaves the registers.
//   P stays f32 to the product: it is split into a bf16 part and the bf16
//   rounding of the rest, each multiplied by V (ldmatrix.trans from the
//   row-major tile), so P V carries ~16 bits of each weight (relative error
//   ~2^-17) where bf16 P would carry 8. A row's max and sum are reduced
//   among the 4 threads of a quad.
// - Loads: each warp streams its tiles through its own 2-stage cp.async ring
//   in shared memory, so the next tile's K and V rows are in flight while
//   the current tile is computed. The paged layout reads the segment's page
//   ids into shared memory once, before the loads, so no row waits on a
//   page-table load. Keys at or past the lane's length (clamped to the
//   capacity) are never read; their V rows in the ring are zeroed and their
//   scores masked.
// - Merge: the block merges its 2 warps in warp order and writes an f32
//   partial (acc[G][D], m[G], l[G]) for its segment to scratch. Then a
//   counter per (lane, kv head) is raised (__threadfence, then atomicAdd);
//   the block that raises it last merges the lane's partials in one online
//   pass in segment order 0, 1, ..., n-1, whatever order they finished in
//   (the loads of several segments in flight at once), writes the output
//   and resets the counter to 0. No second launch. A lane with one segment
//   takes the same path. Which block merges may vary from run to run; the
//   arithmetic never does: a lane's segments and merge order depend only on
//   its length and SEG, never on B, on the grid or on the other lanes, so
//   its result is bitwise independent of its batch and two runs give the
//   same bits. A lane of length 0 writes zeros (its segment-0 block,
//   without a partial).
// - The counters (B*K of them) belong to one launch at a time: launches
//   that share a counter buffer run in stream order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
#define SEG 256    // keys per segment: a multiple of the page size 64
#define WARPS 2
#define THREADS (WARPS * 32)
#define TILE 32    // keys per warp tile: four 8-key mma columns
#define STAGES 2   // a warp's cp.async ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // wait until at most the newest N groups are in flight
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d += a * b on the tensor cores: m16n8k16, bf16 in, f32 accumulate; a is
// (16 x 16) row-major in 4 registers (rows r, r+8 / r, r+8 at columns c,
// c+8), b (16 x 8) in 2
__device__ __forceinline__ void mma16816(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed, from the rows that lanes 8i..8i+7
// address (matrix i)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Layout: a trivially copyable kernel argument with
//   int cap  -- the most keys a lane can hold (lengths are clamped to it),
//   IDS      -- the ints of shared memory its rows() may use, and
//   __device__ Rows rows(int b, int s0, int s1, int* ids) const -- the rows
//   of lane b's keys [s0, s1), where Rows::row(int t) gives key t's row
//   index in the cache (element offset row * K * D). rows() may fill `ids`
//   with every thread of the block; the caller syncs before using it.
template <int D, class Layout>  // D = 64 or 128; G = H / K <= 8
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(
    const __nv_bfloat16* __restrict__ q,        // (B, H, D)
    const __nv_bfloat16* __restrict__ k_cache,  // rows of (K, D)
    const __nv_bfloat16* __restrict__ v_cache,  // rows of (K, D)
    const int32_t* __restrict__ lengths,        // (B,)
    __nv_bfloat16* __restrict__ out,            // (B, H, D)
    float* __restrict__ partial,   // (B, K, n_seg, G * D + 16) f32 scratch
    unsigned int* __restrict__ counters,        // (B, K), zero between launches
    Layout layout, int H, int K, float scale) {
    constexpr int LD = D + 8;         // padded row: conflict-free fragments
    constexpr int CPR = D / 8;        // 16-byte chunks per row
    constexpr int STAGE = 2 * TILE * LD;  // bf16 elements: K rows, V rows
    const int b = blockIdx.x;
    const int kh = blockIdx.y;
    const int seg = blockIdx.z;
    const int n_seg = gridDim.z;
    const int G = H / K;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    __nv_bfloat16* ob = out + ((size_t)b * H + (size_t)kh * G) * D;

    const int len = max(0, min(lengths[b], layout.cap));
    const int s0 = seg * SEG;
    if (len == 0) {
        if (seg == 0)
            for (int i = threadIdx.x; i < G * D; i += THREADS)
                ob[i] = __float2bfloat16(0.f);
        return;
    }
    if (s0 >= len) return;
    const int s1 = min(s0 + SEG, len);
    const int n_live = (len + SEG - 1) / SEG;

    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem)
                          + warp * STAGES * STAGE;  // this warp's stages
    __shared__ int ids[Layout::IDS];
    __shared__ int last;

    const auto rows = layout.rows(b, s0, s1, ids);
    __syncthreads();

    const size_t rstride = (size_t)K * D;  // elements between two keys' rows
    const size_t head = (size_t)kh * D;
    // this warp's tiles of the segment: t0 = s0 + (warp + j * WARPS) * TILE
    const int n_tiles = (s1 - s0 + TILE - 1) / TILE;
    const int mine = n_tiles > warp ? (n_tiles - warp + WARPS - 1) / WARPS : 0;
    auto issue = [&](int j) {  // tile j of this warp into stage j % STAGES
        const int t0 = s0 + (warp + j * WARPS) * TILE;
        const int n = min(TILE, s1 - t0);
        __nv_bfloat16* kb = ring + (j % STAGES) * STAGE;
        __nv_bfloat16* vb = kb + TILE * LD;
        for (int i = lane; i < n * CPR; i += 32) {
            const int r = i / CPR;
            const int c = (i - r * CPR) * 8;
            const size_t src = rows.row(t0 + r) * rstride + head + c;
            cp_async16(kb + r * LD + c, k_cache + src);
            cp_async16(vb + r * LD + c, v_cache + src);
        }
        // V rows past the lane's end meet zero weights: make them zeros
        for (int i = n * CPR + lane; i < TILE * CPR; i += 32) {
            const int r = i / CPR;
            *reinterpret_cast<uint4*>(vb + r * LD + (i - r * CPR) * 8) =
                make_uint4(0u, 0u, 0u, 0u);
        }
    };
#pragma unroll
    for (int j = 0; j < STAGES; ++j) {  // one group per tile, empty or not
        if (j < mine) issue(j);
        cp_async_commit();
    }

    // A = Q: row h = lane / 4 is query head h of the kv head (rows >= G and
    // 8..15 are zero), columns 16 kk + cq (+1) and + 8 (+1)
    const int h = lane >> 2;
    const int cq = 2 * (lane & 3);
    uint32_t qa[D / 16][2];
    {
        const __nv_bfloat16* qh = q + ((size_t)b * H + (size_t)kh * G + h) * D;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            qa[kk][0] = h < G ? *reinterpret_cast<const uint32_t*>(qh + 16 * kk + cq) : 0u;
            qa[kk][1] = h < G ? *reinterpret_cast<const uint32_t*>(qh + 16 * kk + 8 + cq) : 0u;
        }
    }

    // this thread's state: row h; O columns 8 dt + cq (+1); l over its own
    // columns (reduced over the quad at the end)
    float o[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
        o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    float m = NEG_INF, l = 0.f;

    for (int j = 0; j < mine; ++j) {
        cp_async_wait<STAGES - 1>();  // tile j has landed
        __syncwarp();
        const int t0 = s0 + (warp + j * WARPS) * TILE;
        const __nv_bfloat16* kb = ring + (j % STAGES) * STAGE;
        const __nv_bfloat16* vb = kb + TILE * LD;

        // S = Q K^T: four 8-key columns, K rows as B (key 8 nt + h, d cq)
        float sc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
            sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const __nv_bfloat16* kr = kb + (8 * nt + h) * LD + 16 * kk + cq;
                mma16816(sc[nt], qa[kk][0], 0u, qa[kk][1], 0u,
                         *reinterpret_cast<const uint32_t*>(kr),
                         *reinterpret_cast<const uint32_t*>(kr + 8));
            }
        }
        // scale, mask keys past the lane's end, online softmax (f32)
        float x[8];
        float mx = NEG_INF;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const bool valid = t0 + 8 * nt + cq + e < s1;
                x[2 * nt + e] = valid ? sc[nt][e] * scale : NEG_INF;
                mx = fmaxf(mx, x[2 * nt + e]);
            }
        }
        const float m_new = fmaxf(m, quad_max(mx));
        const float alpha = expf(m - m_new);
        m = m_new;
        float p[8];
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            p[i] = x[i] > 0.5f * NEG_INF ? expf(x[i] - m_new) : 0.f;
            sum += p[i];
        }
        l = l * alpha + sum;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
            o[dt][0] *= alpha;
            o[dt][1] *= alpha;
        }
        // O += P V, P as bf16 hi + lo; V (keys x D, row-major) transposed
        // into B by ldmatrix: matrix i holds keys 16 ks + 8 (i & 1) + r at
        // columns 16 dp + 8 (i >> 1)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
            const __nv_bfloat162 h0 = __floats2bfloat162_rn(p[4 * ks], p[4 * ks + 1]);
            const __nv_bfloat162 h1 = __floats2bfloat162_rn(p[4 * ks + 2], p[4 * ks + 3]);
            const float2 f0 = __bfloat1622float2(h0);
            const float2 f1 = __bfloat1622float2(h1);
            const uint32_t hi0 = pack_bf16(h0), hi1 = pack_bf16(h1);
            const uint32_t lo0 = pack_bf16(__floats2bfloat162_rn(
                p[4 * ks] - f0.x, p[4 * ks + 1] - f0.y));
            const uint32_t lo1 = pack_bf16(__floats2bfloat162_rn(
                p[4 * ks + 2] - f1.x, p[4 * ks + 3] - f1.y));
            const int i = lane >> 3;
            const __nv_bfloat16* vr = vb + (16 * ks + 8 * (i & 1) + (lane & 7)) * LD
                                      + 8 * (i >> 1);
#pragma unroll
            for (int dp = 0; dp < D / 16; ++dp) {
                uint32_t vf[4];
                ldsm_x4_trans(vf, vr + 16 * dp);
                mma16816(o[2 * dp], hi0, 0u, hi1, 0u, vf[0], vf[1]);
                mma16816(o[2 * dp], lo0, 0u, lo1, 0u, vf[0], vf[1]);
                mma16816(o[2 * dp + 1], hi0, 0u, hi1, 0u, vf[2], vf[3]);
                mma16816(o[2 * dp + 1], lo0, 0u, lo1, 0u, vf[2], vf[3]);
            }
        }
        __syncwarp();  // the stage is rewritten next
        if (j + STAGES < mine) issue(j + STAGES);
        cp_async_commit();
    }
    l = quad_sum(l);

    // the segment's partial: the warps merged in warp order, each warp's
    // state staged in its own (now idle) ring: acc (G, D), m (G), l (G)
    float* state = reinterpret_cast<float*>(ring);
    if (h < G) {
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
            state[h * D + 8 * dt + cq] = o[dt][0];
            state[h * D + 8 * dt + cq + 1] = o[dt][1];
        }
        if (cq == 0) {
            state[G * D + h] = m;
            state[G * D + G + h] = l;
        }
    }
    __syncthreads();
    const int W = G * D + 16;  // floats of one partial: acc, m at +G*D, l at +8
    float* part = partial + ((size_t)(b * K + kh) * n_seg) * W;
    float* ps = part + (size_t)seg * W;
    for (int i = threadIdx.x; i < G * D; i += THREADS) {
        const int g = i / D;
        float mx = NEG_INF;
        for (int w = 0; w < WARPS; ++w) {
            const float* st = reinterpret_cast<const float*>(
                smem + (size_t)w * STAGES * STAGE * 2);
            mx = fmaxf(mx, st[G * D + g]);
        }
        float lt = 0.f, acc = 0.f;
        for (int w = 0; w < WARPS; ++w) {
            const float* st = reinterpret_cast<const float*>(
                smem + (size_t)w * STAGES * STAGE * 2);
            const float c = expf(st[G * D + g] - mx);
            lt = fmaf(st[G * D + G + g], c, lt);
            acc = fmaf(st[i], c, acc);
        }
        ps[i] = acc;
        if (i - g * D == 0) {
            ps[G * D + g] = mx;
            ps[G * D + 8 + g] = lt;
        }
    }

    // the last block of (lane, kv head) to finish merges the segments
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned int ticket = atomicAdd(&counters[b * K + kh], 1u);
        last = ticket == (unsigned int)(n_live - 1);
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // one online pass in segment order over 4 columns a thread; the loads
    // of a segment do not wait on the arithmetic of the one before
    for (int i = 4 * threadIdx.x; i < G * D; i += 4 * THREADS) {
        const int g = i / D;
        float mx = NEG_INF, lt = 0.f;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int sg = 0; sg < n_live; ++sg) {
            const float* pr = part + (size_t)sg * W;
            const float ms = __ldcg(pr + G * D + g);
            const float ls = __ldcg(pr + G * D + 8 + g);
            const float4 as = __ldcg(reinterpret_cast<const float4*>(pr + i));
            const float mn = fmaxf(mx, ms);
            const float co = expf(mx - mn), cn = expf(ms - mn);
            lt = lt * co + ls * cn;
            acc.x = acc.x * co + as.x * cn;
            acc.y = acc.y * co + as.y * cn;
            acc.z = acc.z * co + as.z * cn;
            acc.w = acc.w * co + as.w * cn;
            mx = mn;
        }
        const float lv = fmaxf(lt, 1e-30f);
        __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x / lv, acc.y / lv);
        __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z / lv, acc.w / lv);
        *reinterpret_cast<uint2*>(ob + i) = make_uint2(pack_bf16(lo), pack_bf16(hi));
    }
    if (threadIdx.x == 0) counters[b * K + kh] = 0u;
}

template <int D>
constexpr size_t ring_bytes() {
    return (size_t)WARPS * STAGES * 2 * TILE * (D + 8) * 2;
}

template <int D, class Layout>
static int launch_decode(const void* q, const void* k_cache,
                         const void* v_cache, const void* lengths, void* out,
                         void* partial, void* counters, Layout layout, int B,
                         int H, int K, float scale, cudaStream_t stream) {
    const int n_seg = (layout.cap + SEG - 1) / SEG;
    const size_t smem = ring_bytes<D>();
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            flash_decode_kernel<D, Layout>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid(B, K, n_seg);
    flash_decode_kernel<D, Layout><<<grid, THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache,
        (const __nv_bfloat16*)v_cache, (const int32_t*)lengths,
        (__nv_bfloat16*)out, (float*)partial, (unsigned int*)counters, layout,
        H, K, scale);
    return (int)cudaGetLastError();
}

// D must be 64 or 128 and H/K at most 8 (the wrappers check both).
// `partial` holds B * K * ceil(cap / SEG) * ((H/K) * D + 16) floats,
// `counters` B * K unsigned ints that are zero.
template <class Layout>
static int flash_decode(const void* q, const void* k_cache,
                        const void* v_cache, const void* lengths, void* out,
                        void* partial, void* counters, Layout layout, int B,
                        int H, int K, int D, float scale,
                        cudaStream_t stream) {
    if (K <= 0 || H % K || H / K > 8) return (int)cudaErrorInvalidValue;
    if (layout.cap <= 0)  // nothing can be attended: zeros
        return (int)cudaMemsetAsync(out, 0, (size_t)B * H * D * 2, stream);
    if (D == 128)
        return launch_decode<128>(q, k_cache, v_cache, lengths, out, partial,
                                  counters, layout, B, H, K, scale, stream);
    if (D == 64)
        return launch_decode<64>(q, k_cache, v_cache, lengths, out, partial,
                                 counters, layout, B, H, K, scale, stream);
    return (int)cudaErrorInvalidValue;
}
