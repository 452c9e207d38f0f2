// Paged flash-decode attention for Hopper (sm_90a): one query token per lane
// against that lane's pages of a shared KV page pool.
//
// Replaces: repro/kernels/paged_decode_attention.py, paged_decode_attention
// (_paged_decode_kernel, the TPU kernel whose grid walks (lane, page) with
// the page table delivered by scalar prefetch).
//
// The kernel is flash_decode.cuh's (which carries the design note and the
// bound); here key t of lane b lives in page page_table[b][t / P] at row
// t % P, and each block reads its lane's page ids itself. Keys past a
// partly filled page's last valid row are never read.

#include "flash_decode.cuh"

struct PagedLayout {
    const int32_t* page_table;  // (B, max_pages)
    int P;                      // rows per page
    int max_pages;
    int cap;                    // max_pages * P

    struct Lane {
        const int32_t* table;
        int P;
        __device__ __forceinline__ size_t row(int t) const {
            return (size_t)table[t / P] * P + t % P;
        }
    };
    __device__ __forceinline__ Lane lane(int b) const {
        return {page_table + (size_t)b * max_pages, P};
    }
};

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out,
    int B, int H, int K, int D, int P, int max_pages, float scale,
    void* stream) {
    const PagedLayout layout{(const int32_t*)page_table, P, max_pages,
                             max_pages * P};
    return flash_decode(q, k_pages, v_pages, lengths, out, layout, B, H, K, D,
                        scale, (cudaStream_t)stream);
}
