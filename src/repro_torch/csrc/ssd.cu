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
// returning y (bf16) and the final state hT (f32), under an f32 contract.
//
// What bounds it on this card: bytes. At zamba2's prefill chunk (S = c =
// 256, Hs = 64, P = 64, N = 64) the call reads x and writes y (2 MB each),
// reads h0 and writes hT (1 MB each): ~6.3 MB, 1.9 us at 3.35 TB/s. Its
// products (C B^T per head, the masked product with x, the carried state's
// read and update, each f32 operand as two bf16 halves) are ~1 GFLOP,
// ~1 us at the bf16 tensor-core peak; its ~2.1 M exponentials ~0.5 us.
//
// Design: the chunked SSD's three phases, in two launches.
// - (a) ssd_state_kernel, grid (chunks, Hs, B), 8 warps: l of the chunk (a
//   scan whose shape depends only on the step index: 32-step warp scans,
//   tile carries added in tile order), written to f32 scratch that phase
//   (c) reads, so every phase uses the same bits of l; then the chunk's
//   local state S_c[p, n] = sum_j w_j x[j, p] B[j, n], w_j = exp(L - l_j)
//   dt_j, on the tensor cores over 64-step tiles (warp w: 16 rows of p,
//   half of n), and L = l_last; the chunk's x and B rows are loaded
//   (cp.async) while l is formed.
// - (b) in the same launch: the block of a head that finishes last (a
//   per-head counter: __threadfence, then atomicAdd, as flash_decode.cuh's
//   merge) walks the chunks in order, H_{c+1} = exp(L_c) H_c + S_c, an
//   elementwise pass, writing each chunk's entering state over its S_c and
//   the last to hT; it resets the counter. So the chunks' heavy work runs
//   in parallel and only the (P, N) pass is serial.
// - (c) ssd_y_kernel, grid (64-row query tiles, chunks, Hs * B), heaviest
//   tiles first, 4 warps of 16 query rows: all of the block's loads (C of
//   its rows, B and x of the key tiles up to the diagonal) are issued at
//   once with cp.async, one group per key tile, and waited on in order;
//   y = exp(l_i) C_i H^T first, then per key tile the Gram tile
//   G = C_i B_j^T, the weights M = G exp(l_i - l_j) dt_j (j > i masked),
//   and M x accumulated into the same registers; then + D x. It is
//   launched as a programmatic dependent of phase (a) (every block of (a)
//   signals at its start): its blocks stage x, B, C and dt while (a) still
//   runs, and wait for (a)'s completion (griddepcontrol.wait) only before
//   they read l and the entering state.
// - What bounds the two phases now (variants timed on the card at zamba2's
//   chunk, a scratch experiment): staging and per-block latency, not the
//   products. Removing phase (c)'s key-tile products left most of its
//   time, and a block stripped of nearly all its loads still took most
//   of the rest: each (query tile, head) block reads its key tiles' x and
//   B again (B and C per head, though all heads share them) and walks a
//   chain of dependent round trips. A second warpgroup per block (key
//   tiles split between them) did not move phase (c). Sharing B, C and
//   the Gram tile across the heads of a block, and a query-tile pair per
//   block over one staging of its key tiles, are the next steps.
// - mma.sync m16n8k16 (bf16 in, f32 accumulate), not wgmma: every product
//   is a 64-row tile owned 16 rows per warp, G's accumulators become M's
//   A fragments in registers (the decay, the mask and the hi + lo split are
//   per-thread work on them), and the f32 operands split into bf16 halves
//   are formed by the warp that uses them, with no warpgroup-wide staging
//   through swizzled shared memory. At ~1 GFLOP per call the warp-level
//   rate is well above what the bytes allow.
// - The Gram tile: each (head, query tile) block computes C_i B_j^T for its
//   own head on the tensor cores, once per key tile — 64 heads together
//   cost ~0.27 GFLOP per chunk. No block recomputes it for a slice of P.
// - f32 contract: C B^T has two bf16 operands (exact products, f32 sums);
//   every other product has one f32 operand, split into bf16 hi + lo —
//   the weights M in M x, the state H in C H^T, the weighted inputs w x in
//   (w x)^T B — so each keeps ~16 bits (TF32 would keep 10). The decay is
//   formed from the difference l_i - l_j, never as exp(l_i) exp(-l_j),
//   which overflows on long chunks.
// - The same bits however the sequence is cut: a chunk's l, S_c and y
//   tiles depend only on its own steps (tiles at fixed offsets from the
//   chunk's start; rows past its end are zeros), and the state passes
//   through the same f32 operation in either case, so one call over S
//   steps and successive calls of `chunk` steps carrying hT into h0 give
//   equal y and hT bit for bit.
// - Limits: P and N multiples of 8 up to 64, chunk up to 256 (the wrapper
//   raises otherwise). Columns past P or N up to the product's tile are
//   zeros in every staged operand.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

#define THREADS 256  // phase (a): 8 warps (16 rows of p, half of n each)
#define Y_THREADS 128  // phase (c): 4 warps, warp w owns query rows 16w..
#define TT 64        // steps of a key tile, rows of a query tile
#define LD 72        // bf16 row of a staged tile: 64 + 8 (fragment loads
                     // conflict-free; rows 16-byte aligned)
#define MAXW 64      // the most P and N
#define MAXC 256     // the most steps of a chunk

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------------------
// (a) + (b): l, the chunk's local state, then the state passed in order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 2) ssd_state_kernel(
    const bf16* __restrict__ x,    // (B, S, Hs, P)
    const bf16* __restrict__ dt,   // (B, S, Hs)
    const float* __restrict__ A,   // (Hs,)
    const bf16* __restrict__ Bm,   // (B, S, N)
    const float* __restrict__ h0,  // (B, Hs, P, N)
    float* __restrict__ hT,        // (B, Hs, P, N)
    float* __restrict__ lbuf,      // (B, Hs, chunks * c): l
    float* __restrict__ states,    // (B, Hs, chunks, P, N): S_c, then H_c
    float* __restrict__ decay,     // (B, Hs, chunks): L_c
    unsigned int* __restrict__ counters,  // (B * Hs), zero between launches
    int S, int Hs, int P, int N, int c) {
    const int ck = blockIdx.x;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int n_chunks = gridDim.x;
    const int t0 = ck * c;
    const int nt = min(c, S - t0);  // real steps; the rest are dt = 0 pads
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int CS = (c + 31) / 32 * 32;

    const int CT = (c + TT - 1) / TT * TT;
    // phase (c)'s grid may start now: it stages its inputs while this grid
    // runs, and waits for this grid's completion before it reads l or H
    asm volatile("griddepcontrol.launch_dependents;");

    extern __shared__ __align__(16) unsigned char smem[];
    bf16* xs = reinterpret_cast<bf16*>(smem);  // (CT, LD) x rows of the chunk
    bf16* bs = xs + CT * LD;                   // (CT, LD) B rows
    bf16* xh = bs + CT * LD;                   // (TT, LD) a tile's w x, bf16 hi
    bf16* xl = xh + TT * LD;                   // (TT, LD) w x, bf16 lo
    float* ls = reinterpret_cast<float*>(xl + TT * LD);  // (CS,) l
    float* ws = ls + CS;                       // (CS,) dt, then w
    float* carry = ws + CS;                    // (CS / 32,) scan tile sums
    __shared__ int last;

    // the chunk's x and B rows in flight while l is formed; rows past its
    // end (and columns past P, N) zeros
    const size_t row0 = (size_t)b * S + t0;
    for (int idx = tid; idx < CT * 8; idx += THREADS) {
        const int r = idx >> 3;
        const int cc = (idx & 7) * 8;
        if (r < nt && cc < P)
            cp_async16(xs + r * LD + cc, x + ((row0 + r) * Hs + h) * P + cc);
        else
            *reinterpret_cast<uint4*>(xs + r * LD + cc) = make_uint4(0u, 0u, 0u, 0u);
        if (r < nt && cc < N)
            cp_async16(bs + r * LD + cc, Bm + (row0 + r) * N + cc);
        else
            *reinterpret_cast<uint4*>(bs + r * LD + cc) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();

    // l: each 32-step tile scanned by one warp (Hillis-Steele), the tile
    // sums turned into carries in tile order, l = carry + local. The
    // operations that give l_r depend only on r and the steps up to r.
    const float a = A[h];
    for (int k = warp; k < CS / 32; k += THREADS / 32) {
        const int r = 32 * k + lane;
        const float d = r < nt ? __bfloat162float(dt[(row0 + r) * Hs + h]) : 0.f;
        float v = d * a;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float u = __shfl_up_sync(0xffffffffu, v, o);
            if (lane >= o) v += u;
        }
        ls[r] = v;
        ws[r] = d;
        if (lane == 31) carry[k] = v;
    }
    __syncthreads();
    if (tid == 0) {
        float run = 0.f;
        for (int k = 0; k < CS / 32; ++k) {
            const float s = carry[k];
            carry[k] = run;
            run += s;
        }
    }
    __syncthreads();
    float* lrow = lbuf + ((size_t)(b * Hs + h) * n_chunks + ck) * c;
    for (int r = tid; r < CS; r += THREADS) {
        const float l = carry[r >> 5] + ls[r];
        ls[r] = l;
        if (r < c) lrow[r] = l;
    }
    __syncthreads();
    const float L = ls[nt - 1];
    for (int r = tid; r < CS; r += THREADS)
        ws[r] = r < nt ? expf(L - ls[r]) * ws[r] : 0.f;
    cp_async_wait<0>();
    __syncthreads();

    // S_c = (w x)^T B over 64-step tiles: M = p (warp w: rows 16 (w % 4)..),
    // N = n (warp w: the half w / 4), K = steps; A = (w x)^T and B = B rows
    // both from row-major (step, *) tiles through ldmatrix.trans
    const int wp = 16 * (warp & 3);   // this warp's p rows
    const int nh = warp >> 2;         // and n half: columns 32 nh..
    float acc[MAXW / 16][4];
#pragma unroll
    for (int i = 0; i < MAXW / 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    const int m = lane >> 3;  // the ldmatrix matrix this lane addresses
    for (int k0 = 0; k0 < nt; k0 += TT) {
        // this tile's w x as bf16 hi + lo
#pragma unroll
        for (int q = 0; q < TT * 8 / THREADS; ++q) {
            const int idx = tid + q * THREADS;
            const int r = idx >> 3;
            const int cc = (idx & 7) * 8;
            const float w = k0 + r < nt ? ws[k0 + r] : 0.f;
            const uint4 raw = *reinterpret_cast<const uint4*>(xs + (k0 + r) * LD + cc);
            const bf16* xv = reinterpret_cast<const bf16*>(&raw);
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                split_bf16(__bfloat162float(xv[2 * e]) * w,
                           __bfloat162float(xv[2 * e + 1]) * w, hi[e], lo[e]);
            *reinterpret_cast<uint4*>(xh + r * LD + cc) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
            *reinterpret_cast<uint4*>(xl + r * LD + cc) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
        __syncthreads();
        if (wp < P && 32 * nh < N) {
#pragma unroll
            for (int ks = 0; ks < TT / 16; ++ks) {
                uint32_t ah[4], al[4];
                const int ar = 16 * ks + 8 * (m >> 1) + (lane & 7);
                const int ac = wp + 8 * (m & 1);
                ldsm_x4_trans(ah, xh + ar * LD + ac);
                ldsm_x4_trans(al, xl + ar * LD + ac);
                const bf16* brow = bs + (k0 + 16 * ks + 8 * (m & 1) + (lane & 7)) * LD
                                   + 32 * nh + 8 * (m >> 1);
#pragma unroll
                for (int dp = 0; dp < 2; ++dp) {
                    if (32 * nh + 16 * dp < N) {
                        uint32_t bf[4];
                        ldsm_x4_trans(bf, brow + 16 * dp);
                        mma16816(acc[2 * dp], ah[0], ah[1], ah[2], ah[3], bf[0], bf[1]);
                        mma16816(acc[2 * dp], al[0], al[1], al[2], al[3], bf[0], bf[1]);
                        mma16816(acc[2 * dp + 1], ah[0], ah[1], ah[2], ah[3], bf[2], bf[3]);
                        mma16816(acc[2 * dp + 1], al[0], al[1], al[2], al[3], bf[2], bf[3]);
                    }
                }
            }
        }
        __syncthreads();  // xh, xl are rewritten next
    }

    const size_t head = (size_t)(b * Hs + h);
    float* sc = states + (head * n_chunks + ck) * P * N;
#pragma unroll
    for (int j = 0; j < MAXW / 16; ++j) {
        const int n = 32 * nh + 8 * j + 2 * t;
        const int p0 = wp + g;
        if (n < N) {
            if (p0 < P)
                *reinterpret_cast<float2*>(sc + (size_t)p0 * N + n) =
                    make_float2(acc[j][0], acc[j][1]);
            if (p0 + 8 < P)
                *reinterpret_cast<float2*>(sc + (size_t)(p0 + 8) * N + n) =
                    make_float2(acc[j][2], acc[j][3]);
        }
    }
    if (tid == 0) decay[head * n_chunks + ck] = L;

    // (b): the head's last block to finish passes the state in chunk order
    __threadfence();
    __syncthreads();
    if (tid == 0)
        last = atomicAdd(&counters[head], 1u) == (unsigned int)(n_chunks - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    // a thread's PV float4s of the state, all loads of a chunk in flight
    // at once (P * N <= 4096 floats: PV = 8 at 128 threads)
    constexpr int PV = MAXW * MAXW / 4 / THREADS;
    const int PN = P * N;
    float* st = states + head * n_chunks * PN;
    float4 H[PV];
#pragma unroll
    for (int q = 0; q < PV; ++q) {
        const int e = 4 * (tid + q * THREADS);
        if (e < PN) H[q] = *reinterpret_cast<const float4*>(h0 + head * PN + e);
    }
    for (int k = 0; k < n_chunks; ++k) {
        const float f = expf(__ldcg(decay + head * n_chunks + k));
        float4 sv[PV];
#pragma unroll
        for (int q = 0; q < PV; ++q) {
            const int e = 4 * (tid + q * THREADS);
            if (e < PN) sv[q] = __ldcg(reinterpret_cast<const float4*>(st + k * PN + e));
        }
#pragma unroll
        for (int q = 0; q < PV; ++q) {
            const int e = 4 * (tid + q * THREADS);
            if (e < PN) {
                // the state entering chunk k, over its local state
                __stcg(reinterpret_cast<float4*>(st + k * PN + e), H[q]);
                H[q].x = f * H[q].x + sv[q].x;
                H[q].y = f * H[q].y + sv[q].y;
                H[q].z = f * H[q].z + sv[q].z;
                H[q].w = f * H[q].w + sv[q].w;
            }
        }
    }
#pragma unroll
    for (int q = 0; q < PV; ++q) {
        const int e = 4 * (tid + q * THREADS);
        if (e < PN) *reinterpret_cast<float4*>(hT + head * PN + e) = H[q];
    }
    if (tid == 0) counters[head] = 0u;
}

// ---------------------------------------------------------------------------
// (c): y per (query tile, chunk, head) from the state entering the chunk
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(Y_THREADS) ssd_y_kernel(
    const bf16* __restrict__ x,       // (B, S, Hs, P)
    const bf16* __restrict__ dt,      // (B, S, Hs)
    const bf16* __restrict__ Bm,      // (B, S, N)
    const bf16* __restrict__ C,       // (B, S, N)
    const float* __restrict__ D,      // (Hs,)
    const float* __restrict__ lbuf,   // (B, Hs, chunks * c)
    const float* __restrict__ states, // (B, Hs, chunks, P, N): H_c
    bf16* __restrict__ y,             // (B, S, Hs, P)
    int S, int Hs, int P, int N, int c) {
    const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
    const int ck = blockIdx.y;
    const int n_chunks = gridDim.y;
    const int h = blockIdx.z % Hs;
    const int b = blockIdx.z / Hs;
    const int t0 = ck * c;
    const int nt = min(c, S - t0);
    const int q0 = qt * TT;
    if (q0 >= nt) return;  // a tile of pads only
    const int n_kt = qt + 1;  // key tiles 0..qt
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g = lane >> 2;
    const int t = lane & 3;

    extern __shared__ __align__(16) unsigned char smem[];
    bf16* cs = reinterpret_cast<bf16*>(smem);  // (TT, LD) C of the query rows
    bf16* hh = cs + TT * LD;                   // (TT, LD) H (p, n), bf16 hi
    bf16* hl = hh + TT * LD;                   // (TT, LD) H, bf16 lo
    bf16* kv = hl + TT * LD;                   // per key tile: B (TT, LD), x (TT, LD)
    float* ls = reinterpret_cast<float*>(kv + n_kt * 2 * TT * LD);  // (n_kt * TT,)
    float* ds = ls + n_kt * TT;                // (n_kt * TT,) dt

    // every load in flight at once: group 0 = C and key tile 0, group k =
    // key tile k; rows past the chunk's end (and columns past P, N) zeros
    const size_t row0 = (size_t)b * S + t0;
    auto stage = [&](bf16* dst, const bf16* src, size_t stride, int r0,
                     int width) {
        for (int idx = tid; idx < TT * 8; idx += Y_THREADS) {
            const int r = idx >> 3;
            const int cc = (idx & 7) * 8;
            if (r0 + r < nt && cc < width)
                cp_async16(dst + r * LD + cc, src + (row0 + r0 + r) * stride + cc);
            else
                *reinterpret_cast<uint4*>(dst + r * LD + cc) = make_uint4(0u, 0u, 0u, 0u);
        }
    };
    for (int k = 0; k < n_kt; ++k) {
        if (k == 0) stage(cs, C, N, q0, N);
        stage(kv + k * 2 * TT * LD, Bm, N, k * TT, N);
        stage(kv + k * 2 * TT * LD + TT * LD, x + (size_t)h * P, (size_t)Hs * P,
              k * TT, P);
        cp_async_commit();
    }

    // meanwhile: dt of the keys; then, once phase (a)'s grid has completed
    // (griddepcontrol.wait; a no-op without a programmatic launch), l and
    // the entering state H, all loads in flight at once, H split into bf16
    // halves
#pragma unroll
    for (int q = 0; q < MAXC / Y_THREADS; ++q) {
        const int r = tid + q * Y_THREADS;
        if (r < n_kt * TT)
            ds[r] = r < nt ? __bfloat162float(dt[(row0 + r) * Hs + h]) : 0.f;
    }
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const float* lrow = lbuf + ((size_t)(b * Hs + h) * n_chunks + ck) * c;
    const float* hc = states + ((size_t)(b * Hs + h) * n_chunks + ck) * P * N;
    {
        constexpr int PV = MAXW * MAXW / 4 / Y_THREADS;  // float4s a thread
        float4 v[PV];
#pragma unroll
        for (int q = 0; q < PV; ++q) {
            const int i = 4 * (tid + q * Y_THREADS);
            if (i < P * N) v[q] = *reinterpret_cast<const float4*>(hc + i);
        }
#pragma unroll
        for (int q = 0; q < MAXC / Y_THREADS; ++q) {
            const int r = tid + q * Y_THREADS;
            if (r < n_kt * TT) ls[r] = r < c ? lrow[r] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < PV; ++q) {
            const int i = 4 * (tid + q * Y_THREADS);
            if (i < P * N) {
                const int p = i / N;
                const int n = i - p * N;  // N % 8 == 0: 4 in one row
                uint2 hi, lo;
                split_bf16(v[q].x, v[q].y, hi.x, lo.x);
                split_bf16(v[q].z, v[q].w, hi.y, lo.y);
                *reinterpret_cast<uint2*>(hh + p * LD + n) = hi;
                *reinterpret_cast<uint2*>(hl + p * LD + n) = lo;
            }
        }
        // N an odd multiple of 8: the last k step of C H^T reads 8 columns
        // past N, which must be zeros (C's are; stale shared memory could
        // hold a NaN, and 0 * NaN is NaN)
        if (N & 8) {
            for (int p = tid; p < P; p += Y_THREADS) {
                *reinterpret_cast<uint4*>(hh + p * LD + N) = make_uint4(0u, 0u, 0u, 0u);
                *reinterpret_cast<uint4*>(hl + p * LD + N) = make_uint4(0u, 0u, 0u, 0u);
            }
        }
    }
    cp_async_wait_dyn(n_kt - 1);  // group 0 has landed
    __syncthreads();

    // the warp's C rows as A fragments (rows i = 16 warp + g, + 8; k = n)
    const int ra = 16 * warp + g;
    uint32_t ca[MAXW / 16][4];
#pragma unroll
    for (int kk = 0; kk < MAXW / 16; ++kk) {
        if (16 * kk < N) {
            ca[kk][0] = ld_u32(cs + ra * LD + 16 * kk + 2 * t);
            ca[kk][1] = ld_u32(cs + (ra + 8) * LD + 16 * kk + 2 * t);
            ca[kk][2] = ld_u32(cs + ra * LD + 16 * kk + 8 + 2 * t);
            ca[kk][3] = ld_u32(cs + (ra + 8) * LD + 16 * kk + 8 + 2 * t);
        }
    }
    const int i0 = q0 + ra;  // this thread's rows of the chunk: i0, i0 + 8
    const float li0 = ls[i0], li1 = ls[i0 + 8];

    // y = exp(l_i) * (C_i H^T), H as hi + lo (B[k = n][col = p] = H[p][n])
    float yacc[MAXW / 8][4];
#pragma unroll
    for (int i = 0; i < MAXW / 8; ++i) yacc[i][0] = yacc[i][1] = yacc[i][2] = yacc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MAXW / 16; ++kk) {
        if (16 * kk < N) {
#pragma unroll
            for (int pb = 0; pb < MAXW / 8; ++pb) {
                if (8 * pb < P) {
                    const int o = (8 * pb + g) * LD + 16 * kk + 2 * t;
                    mma16816(yacc[pb], ca[kk][0], ca[kk][1], ca[kk][2], ca[kk][3],
                             ld_u32(hh + o), ld_u32(hh + o + 8));
                    mma16816(yacc[pb], ca[kk][0], ca[kk][1], ca[kk][2], ca[kk][3],
                             ld_u32(hl + o), ld_u32(hl + o + 8));
                }
            }
        }
    }
    {
        const float e0 = expf(li0), e1 = expf(li1);
#pragma unroll
        for (int pb = 0; pb < MAXW / 8; ++pb) {
            yacc[pb][0] *= e0;
            yacc[pb][1] *= e0;
            yacc[pb][2] *= e1;
            yacc[pb][3] *= e1;
        }
    }

    const int m = lane >> 3;
    for (int kt = 0; kt < n_kt; ++kt) {
        if (kt) {
            cp_async_wait_dyn(n_kt - 1 - kt);
            __syncthreads();
        }
        const bf16* bt = kv + kt * 2 * TT * LD;
        const bf16* xt = bt + TT * LD;
        // G = C_i B_j^T (16 rows x 64 keys per warp)
        float gacc[TT / 8][4];
#pragma unroll
        for (int nb = 0; nb < TT / 8; ++nb) gacc[nb][0] = gacc[nb][1] = gacc[nb][2] = gacc[nb][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < MAXW / 16; ++kk) {
            if (16 * kk < N) {
#pragma unroll
                for (int nb = 0; nb < TT / 8; ++nb) {
                    const int o = (8 * nb + g) * LD + 16 * kk + 2 * t;
                    mma16816(gacc[nb], ca[kk][0], ca[kk][1], ca[kk][2], ca[kk][3],
                             ld_u32(bt + o), ld_u32(bt + o + 8));
                }
            }
        }
        // M = G exp(l_i - l_j) dt_j, keys past the row masked (the
        // diagonal tile only), then M x with M as bf16 hi + lo
        const bool diag = kt == qt;
#pragma unroll
        for (int nb = 0; nb < TT / 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int j = kt * TT + 8 * nb + 2 * t + e;
                const float lj = ls[j], dj = ds[j];
                gacc[nb][e] = (!diag || j <= i0) ? gacc[nb][e] * expf(li0 - lj) * dj : 0.f;
                gacc[nb][2 + e] = (!diag || j <= i0 + 8)
                    ? gacc[nb][2 + e] * expf(li1 - lj) * dj : 0.f;
            }
        }
#pragma unroll
        for (int ks = 0; ks < TT / 16; ++ks) {
            uint32_t ah[4], al[4];
            split_bf16(gacc[2 * ks][0], gacc[2 * ks][1], ah[0], al[0]);
            split_bf16(gacc[2 * ks][2], gacc[2 * ks][3], ah[1], al[1]);
            split_bf16(gacc[2 * ks + 1][0], gacc[2 * ks + 1][1], ah[2], al[2]);
            split_bf16(gacc[2 * ks + 1][2], gacc[2 * ks + 1][3], ah[3], al[3]);
            // x (keys x P, row-major) transposed into B by ldmatrix: matrix
            // m holds keys 16 ks + 8 (m & 1) + r at columns 16 dp + 8 (m >> 1)
            const bf16* xr = xt + (16 * ks + 8 * (m & 1) + (lane & 7)) * LD + 8 * (m >> 1);
#pragma unroll
            for (int dp = 0; dp < MAXW / 16; ++dp) {
                if (16 * dp < P) {
                    uint32_t xf[4];
                    ldsm_x4_trans(xf, xr + 16 * dp);
                    mma16816(yacc[2 * dp], ah[0], ah[1], ah[2], ah[3], xf[0], xf[1]);
                    mma16816(yacc[2 * dp], al[0], al[1], al[2], al[3], xf[0], xf[1]);
                    mma16816(yacc[2 * dp + 1], ah[0], ah[1], ah[2], ah[3], xf[2], xf[3]);
                    mma16816(yacc[2 * dp + 1], al[0], al[1], al[2], al[3], xf[2], xf[3]);
                }
            }
        }
    }

    // + D x (x of the query rows: the diagonal key tile), then y in bf16
    const bf16* xq = kv + qt * 2 * TT * LD + TT * LD;
    const float dsk = D[h];
#pragma unroll
    for (int pb = 0; pb < MAXW / 8; ++pb) {
        const int p = 8 * pb + 2 * t;
        if (p >= P) continue;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int i = i0 + 8 * u;
            if (i >= nt) continue;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xq + (ra + 8 * u) * LD + p));
            *reinterpret_cast<__nv_bfloat162*>(
                y + ((row0 + i) * Hs + h) * P + p) = __floats2bfloat162_rn(
                    yacc[pb][2 * u] + dsk * xv.x, yacc[pb][2 * u + 1] + dsk * xv.y);
        }
    }
}

static int set_smem(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// P and N multiples of 8 up to 64, 1 <= chunk <= 256
// (the wrapper checks). Scratch: lbuf B*Hs*chunks*c floats, states
// B*Hs*chunks*P*N (16-byte aligned), decay B*Hs*chunks; counters B*Hs
// unsigned ints that are zero. Returns cudaGetLastError() after the
// launches (or the attribute call's error).
extern "C" int ssd_bf16(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* C, const void* D, const void* h0, void* y, void* hT,
    void* lbuf, void* states, void* decay, void* counters,
    int B, int S, int Hs, int P, int N, int chunk, void* stream) {
    if (P % 8 || P > MAXW || N % 8 || N > MAXW || chunk < 1 || chunk > MAXC)
        return (int)cudaErrorInvalidValue;
    const int c = chunk;
    const int n_chunks = (S + c - 1) / c;
    const int n_qt = (c + TT - 1) / TT;
    const int cs = (c + 31) / 32 * 32;
    const int ct = n_qt * TT;
    const size_t smem_a = (2 * ct + 2 * TT) * LD * 2 + (2 * cs + cs / 32) * 4;
    const size_t smem_c = (3 + 2 * n_qt) * TT * LD * 2 + 2 * n_qt * TT * 4;
    int e = set_smem((const void*)ssd_state_kernel, smem_a);
    if (!e) e = set_smem((const void*)ssd_y_kernel, smem_c);
    if (e) return e;
    cudaStream_t st = (cudaStream_t)stream;
    ssd_state_kernel<<<dim3(n_chunks, Hs, B), THREADS, smem_a, st>>>(
        (const bf16*)x, (const bf16*)dt, (const float*)A, (const bf16*)Bm,
        (const float*)h0, (float*)hT, (float*)lbuf, (float*)states,
        (float*)decay, (unsigned int*)counters, S, Hs, P, N, c);
    e = (int)cudaGetLastError();
    if (e) return e;
    // phase (c) by programmatic dependent launch: its blocks may start
    // once every block of phase (a) runs, and stage their inputs meanwhile
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_qt, n_chunks, Hs * B);
    cfg.blockDim = dim3(Y_THREADS);
    cfg.dynamicSmemBytes = smem_c;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = (int)cudaLaunchKernelEx(
        &cfg, ssd_y_kernel, (const bf16*)x, (const bf16*)dt, (const bf16*)Bm,
        (const bf16*)C, (const float*)D, (const float*)lbuf,
        (const float*)states, (bf16*)y, S, Hs, P, N, c);
    if (e) return e;
    return (int)cudaGetLastError();
}
