// knn_select_smalld: the small-d selection, counterpart of the TPU kernels
// K8, mcevidence_tpu/ops/knn_pallas.py:_knn_kernel_packed_smalld (via
// knn_select_pallas_smalld), and K9, :_knn_kernel_packed_smalld_batched (via
// knn_select_pallas_smalld_batched): the opt-in `pallas_smalld` engine for
// chains of d <= 16 coordinates.  The bodies and their contract are in
// knn_common.cuh; this source gives them the Compact<D> layout.
//
// What K8 does on the TPU and what this layout does about it: K8 skips the
// matrix unit, whose 128-wide contraction is >= 87% zero padding at
// d <= 16, and sums d_real per-coordinate squared differences over a
// reference tile pre-transposed to (d, TR).  Here D = d_real is a template
// parameter (1..16), so the distance loop is unrolled over exactly the true
// coordinates and the rows are stored unpadded (no float4 padding to 8
// columns as in knn_select.cu).  The small-k body stages its tiles as laid
// out in global memory (every thread reads the same row, a broadcast); the
// large-k body stages them coordinate-major, tile[c][row], as K8's `rt`.
// Rows of D floats need not start on 16 bytes, so both copy 4 bytes at a
// time.  Exact, so the selection meets K8's <= 2^-12 quantisation contract
// with room to spare.

#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_common.cuh"

namespace {

using knn::Dispatch;
using knn::dispatch_large_k;
using knn::dispatch_small_k;

// [rows, D] f32 rows, unpadded: row i starts at i * D.
template <int D>
struct Compact {
    static constexpr int kWidth = D;
    static constexpr int kVec = 1;

    static __device__ __forceinline__ void load_query(float (&qv)[D],
                                                      const float* q,
                                                      long long row) {
#pragma unroll
        for (int c = 0; c < D; ++c) qv[c] = __ldg(q + row * D + c);
    }
};

// one instantiation of each body for every true width D = 1..16; any other
// width gets no body and the entry point returns cudaErrorInvalidValue
#define KNN_SMALLD_WIDTHS(X) \
    X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
    X(14) X(15) X(16)

Dispatch compact_body(int d, bool large) {
    switch (d) {
#define KNN_CASE(D) \
        case D: return large ? dispatch_large_k<Compact<D>> : dispatch_small_k<Compact<D>>;
        KNN_SMALLD_WIDTHS(KNN_CASE)
#undef KNN_CASE
        default: return nullptr;
    }
}

}  // namespace

extern "C" {

// Arguments of both entry points:
//   q, r            [batch, q_rows, d] and [batch, r_rows, d] f32, unpadded
//   nq, nr          int32 [batch] on the device, or null (q_rows; nr_all)
//   d               the true width, 1 <= d <= 16
//   out_d2, out_idx [batch, q_rows, k]
//   rechecks        (knn_select_smalld_small_k only) as knn_select.cu's
// knn_select_smalld_small_k takes 1 <= k, k - self_mode <= 16.
int knn_select_smalld_small_k(const float* q, const float* r, int batch,
                              int q_rows, int r_rows, const int* nq,
                              const int* nr, int nr_all, int d, int k,
                              int self_mode, float* out_d2, int* out_idx,
                              void* stream, int device,
                              unsigned long long* rechecks) {
    return static_cast<int>(knn::run(compact_body(d, false), q, r, batch,
                                     q_rows, r_rows, nq, nr, nr_all, k,
                                     self_mode, out_d2, out_idx, stream,
                                     device, rechecks));
}

// knn_select_smalld_large_k takes 1 <= k <= 256.
int knn_select_smalld_large_k(const float* q, const float* r, int batch,
                              int q_rows, int r_rows, const int* nq,
                              const int* nr, int nr_all, int d, int k,
                              int self_mode, float* out_d2, int* out_idx,
                              void* stream, int device) {
    return static_cast<int>(knn::run(compact_body(d, true), q, r, batch,
                                     q_rows, r_rows, nq, nr, nr_all, k,
                                     self_mode, out_d2, out_idx, stream,
                                     device, nullptr));
}

}  // extern "C"
