// Flash-decode attention for Hopper (sm_90a) over a dense cache: one query
// token per lane against that lane's contiguous (S, K, D) keys and values.
//
// Replaces: repro/kernels/decode_attention.py, decode_attention
// (_decode_kernel, the TPU kernel whose grid walks (lane, k-block) and
// skips k-blocks past the lane's length with pl.when).
//
// The kernel is flash_decode.cuh's (which carries the design note and the
// bound), shared with the paged kernel; here key t of lane b is row
// b * S + t of the (B, S, K, D) cache. Lengths are clamped to S, so the
// kernel never reads past a lane's rows; keys at or past the length are
// never read; a lane of length 0 gives zeros, as the TPU kernel's
// acc / max(l, 1e-30) does. A lane's keys are never split across blocks, so
// its result does not depend on the batch: the dense engine is the oracle
// for the batch-invariant paged decode.

#include "flash_decode.cuh"

struct DenseLayout {
    int S;    // rows per lane
    int cap;  // S

    struct Lane {
        size_t base;  // b * S
        __device__ __forceinline__ size_t row(int t) const {
            return base + t;
        }
    };
    __device__ __forceinline__ Lane lane(int b) const {
        return {(size_t)b * S};
    }
};

extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int S, int H, int K, int D, float scale, void* stream) {
    const DenseLayout layout{S, S};
    return flash_decode(q, k, v, lengths, out, layout, B, H, K, D, scale,
                        (cudaStream_t)stream);
}
