// Paged flash-decode attention for Hopper (sm_90a): one query token per lane
// against that lane's pages of a shared KV page pool.
//
// Replaces: repro/kernels/paged_decode_attention.py, paged_decode_attention
// (_paged_decode_kernel, the TPU kernel whose grid walks (lane, page) with
// the page table delivered by scalar prefetch).
//
// The kernel is flash_decode.cuh's (which carries the design note and the
// bound); here key t of lane b lives in page page_table[b][t / P] at row
// t % P, and each block reads the page ids of its segment of the lane into
// shared memory once, before its loads. Keys past a partly filled page's
// last valid row are never read.

#include "flash_decode.cuh"

struct PagedLayout {
    const int32_t* page_table;  // (B, max_pages)
    int P;                      // rows per page
    int max_pages;
    int cap;                    // max_pages * P
    static constexpr int IDS = SEG;  // page ids of a segment (P >= 1)

    struct Rows {
        const int* ids;  // the segment's page ids, from page `first` on
        int P;
        int first;
        __device__ __forceinline__ size_t row(int t) const {
            const int p = t / P;
            return (size_t)ids[p - first] * P + (t - p * P);
        }
    };
    // keys [s0, s1) lie in pages s0 / P .. (s1 - 1) / P: at most SEG of them
    __device__ __forceinline__ Rows rows(int b, int s0, int s1,
                                         int* ids) const {
        const int first = s0 / P;
        const int n = (s1 - 1) / P - first + 1;
        const int32_t* table = page_table + (size_t)b * max_pages + first;
        for (int i = threadIdx.x; i < n; i += blockDim.x) ids[i] = table[i];
        return {ids, P, first};
    }
};

// partial: B * K * ceil(max_pages * P / 256) * ((H/K) * D + 16) floats of
// scratch; counters: B * K unsigned ints, zero (the kernel leaves them zero).
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, void* partial,
    void* counters, int B, int H, int K, int D, int P, int max_pages,
    float scale, void* stream) {
    const PagedLayout layout{(const int32_t*)page_table, P, max_pages,
                             max_pages * P};
    return flash_decode(q, k_pages, v_pages, lengths, out, partial, counters,
                        layout, B, H, K, D, scale, (cudaStream_t)stream);
}
