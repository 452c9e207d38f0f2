// Causal (or non-causal) GQA flash attention for Hopper (sm_90a): the
// chunked-prefill attention over the gathered context pages.
//
// Replaces: repro/kernels/flash_attention.py, flash_attention (_flash_kernel,
// the TPU kernel whose grid carries online-softmax statistics across
// sequential key blocks in VMEM scratch).
//
// What bounds it on this card: operations. At the prefill chunk's shapes
// (Sq = 256 queries, D = 128) every key tile loaded is used by 64 queries,
// so the work is 4*D FLOP per (query, head, attended key) against
// 2*D*2 bytes per key and kv head: well above the H100's ~295 FLOP/byte.
// The bound is 4*D*H*sum_q keys_attended FLOP over 989 TFLOP/s (bf16 tensor
// cores).
//
// Design:
// - Grid (B*H, ceil(Sq/64)). A block of 4 warps takes 64 query rows of head
//   h and reads kv head h / (H/K): GQA without expanding K/V in memory.
// - It loops over 64-key tiles up to the causal limit q_offset + last row,
//   so tiles entirely above the diagonal are never loaded. Keys at
//   kpos >= Sk and kpos > qpos are masked; ragged Sq and Sk are zero-filled
//   on load and cut on store. q_offset and Sk are runtime ints.
// - Q K^T and P V run on the tensor cores through WMMA 16x16x16 bf16 tiles
//   with f32 accumulation. Each warp owns 16 query rows end to end (its
//   scores, softmax statistics and output rows), so after a tile is loaded
//   the warps need no block barrier until the next load.
// - The softmax is online and f32: the scores are scaled by 1/sqrt(D) after
//   the f32-accumulated dot, where the reference scales q in f32 before it
//   (flash_attention.py:65); the two differ by f32 rounding only. The
//   probabilities are rounded to bf16 for the P V product, and the row sum l
//   adds the rounded values, so the weights that are normalized are the
//   weights that were used.
// - The output accumulator lives in shared memory in f32 (64 x D), rescaled
//   by each row's alpha before the P V product accumulates into it.
// - Shared-memory rows are padded (bf16 rows by 8 elements, f32 rows by 4)
//   so that the WMMA tile loads of consecutive rows do not hit one bank.
// - Simple first: no TMA, no wgmma, no double buffering of the K/V tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

#define NEG_INF (-1e30f)
#define BQ 64
#define BK 64
#define THREADS 128
#define SLD (BK + 4)   // f32 score row stride
#define PLD (BK + 8)   // bf16 probability row stride

__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, Sq, H, D)
    const __nv_bfloat16* __restrict__ k,  // (B, Sk, K, D)
    const __nv_bfloat16* __restrict__ v,  // (B, Sk, K, D)
    __nv_bfloat16* __restrict__ out,      // (B, Sq, H, D)
    int Sq, int Sk, int H, int K, int D, int causal, int q_offset,
    float scale) {
    const int b = blockIdx.x / H;
    const int h = blockIdx.x - b * H;
    const int kh = h / (H / K);
    const int q0 = blockIdx.y * BQ;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    const int LD = D + 8;   // bf16 row stride of the q, k, v tiles
    const int OLD = D + 4;  // f32 row stride of the output accumulator
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // (BQ, LD)
    __nv_bfloat16* ks = qs + BQ * LD;                             // (BK, LD)
    __nv_bfloat16* vs = ks + BK * LD;                             // (BK, LD)
    float* ss = reinterpret_cast<float*>(vs + BK * LD);           // (BQ, SLD)
    __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(ss + BQ * SLD);  // (BQ, PLD)
    float* os = reinterpret_cast<float*>(ps + BQ * PLD);          // (BQ, OLD)
    float* m = os + BQ * OLD;                                     // (BQ,)
    float* l = m + BQ;                                            // (BQ,)
    float* alpha = l + BQ;                                        // (BQ,)

    const int vecs = D / 8;  // 16-byte vectors per row
    const size_t q_row = (size_t)H * D;
    const size_t kv_row = (size_t)K * D;
    for (int i = tid; i < BQ * vecs; i += THREADS) {
        const int r = i / vecs;
        const int c = i - r * vecs;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (q0 + r < Sq)
            val = reinterpret_cast<const uint4*>(
                q + ((size_t)b * Sq + q0 + r) * q_row + (size_t)h * D)[c];
        reinterpret_cast<uint4*>(qs + r * LD)[c] = val;
    }
    for (int i = tid; i < BQ * OLD; i += THREADS) os[i] = 0.f;
    if (tid < BQ) {
        m[tid] = NEG_INF;
        l[tid] = 0.f;
    }

    // keys this block can attend: up to the last real row's position
    const int last_row = min(q0 + BQ, Sq) - 1;
    const int kend = causal ? min(Sk, q_offset + last_row + 1) : Sk;
    const int n_tiles = (kend + BK - 1) / BK;
    const int r0 = warp * 16;  // this warp's 16 query rows

    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();  // previous tile fully consumed (and q/os ready)
        for (int i = tid; i < BK * vecs; i += THREADS) {
            const int r = i / vecs;
            const int c = i - r * vecs;
            uint4 kv = make_uint4(0u, 0u, 0u, 0u);
            uint4 vv = make_uint4(0u, 0u, 0u, 0u);
            if (k0 + r < Sk) {
                const size_t src = ((size_t)b * Sk + k0 + r) * kv_row + (size_t)kh * D;
                kv = reinterpret_cast<const uint4*>(k + src)[c];
                vv = reinterpret_cast<const uint4*>(v + src)[c];
            }
            reinterpret_cast<uint4*>(ks + r * LD)[c] = kv;
            reinterpret_cast<uint4*>(vs + r * LD)[c] = vv;
        }
        __syncthreads();

        // S[r0:r0+16, :] = Q[r0:r0+16, :] K^T
        for (int cb = 0; cb < BK / 16; ++cb) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
            wmma::fill_fragment(sc, 0.f);
            for (int kk = 0; kk < D / 16; ++kk) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
                wmma::load_matrix_sync(qa, qs + r0 * LD + kk * 16, LD);
                wmma::load_matrix_sync(kb, ks + cb * 16 * LD + kk * 16, LD);
                wmma::mma_sync(sc, qa, kb, sc);
            }
            wmma::store_matrix_sync(ss + r0 * SLD + cb * 16, sc, SLD, wmma::mem_row_major);
        }
        __syncwarp();

        // online softmax over the warp's rows: two lanes per row, 32 keys each
        {
            const int row = r0 + (lane >> 1);
            const int c0 = (lane & 1) * 32;
            const int qpos = q_offset + q0 + row;
            float* srow = ss + row * SLD;
            float mx = NEG_INF;
            for (int c = c0; c < c0 + 32; ++c) {
                const int kpos = k0 + c;
                float s = srow[c] * scale;
                if (kpos >= Sk || (causal && kpos > qpos)) s = NEG_INF;
                srow[c] = s;
                mx = fmaxf(mx, s);
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            const float m_prev = m[row];
            const float m_new = fmaxf(m_prev, mx);
            float sum = 0.f;
            for (int c = c0; c < c0 + 32; ++c) {
                const __nv_bfloat16 p = __float2bfloat16(expf(srow[c] - m_new));
                ps[row * PLD + c] = p;
                sum += __bfloat162float(p);
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            __syncwarp();
            if ((lane & 1) == 0) {
                const float a = expf(m_prev - m_new);
                alpha[row] = a;
                l[row] = l[row] * a + sum;
                m[row] = m_new;
            }
            __syncwarp();
        }
        for (int i = lane; i < 16 * D; i += 32) {
            const int r = r0 + i / D;
            os[r * OLD + (i % D)] *= alpha[r];
        }
        __syncwarp();

        // O[r0:r0+16, :] += P[r0:r0+16, :] V
        for (int db = 0; db < D / 16; ++db) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc;
            wmma::load_matrix_sync(oc, os + r0 * OLD + db * 16, OLD, wmma::mem_row_major);
            for (int kk = 0; kk < BK / 16; ++kk) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
                wmma::load_matrix_sync(pa, ps + r0 * PLD + kk * 16, PLD);
                wmma::load_matrix_sync(vb, vs + kk * 16 * LD + db * 16, LD);
                wmma::mma_sync(oc, pa, vb, oc);
            }
            wmma::store_matrix_sync(os + r0 * OLD + db * 16, oc, OLD, wmma::mem_row_major);
        }
    }
    __syncthreads();

    for (int i = tid; i < BQ * D; i += THREADS) {
        const int r = i / D;
        if (q0 + r >= Sq) continue;
        const int d = i - r * D;
        const float lv = fmaxf(l[r], 1e-30f);
        out[((size_t)b * Sq + q0 + r) * q_row + (size_t)h * D + d] =
            __float2bfloat16(os[r * OLD + d] / lv);
    }
}

extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* out,
    int B, int Sq, int Sk, int H, int K, int D, int causal, int q_offset,
    float scale, void* stream) {
    const size_t smem = (size_t)(BQ + 2 * BK) * (D + 8) * sizeof(__nv_bfloat16)
        + (size_t)BQ * (SLD * sizeof(float) + PLD * sizeof(__nv_bfloat16))
        + (size_t)(BQ * (D + 4) + 3 * BQ) * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid(B * H, (Sq + BQ - 1) / BQ);
    flash_attention_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)out,
        Sq, Sk, H, K, D, causal, q_offset, scale);
    return (int)cudaGetLastError();
}
