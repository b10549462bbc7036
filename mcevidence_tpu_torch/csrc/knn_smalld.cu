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
// coordinates, the rows are stored unpadded (no float4 padding to 8 columns
// as in knn_select.cu), and the small-k body stages its reference tile in
// shared memory coordinate-major, tile[c][row], as K8's `rt`.  The large-k
// body reads each row's D floats through the read-only cache.  Exact, so
// the selection meets K8's <= 2^-12 quantisation contract with room to
// spare.

#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_common.cuh"

namespace {

using knn::Dispatch;
using knn::dispatch_large_k;
using knn::dispatch_small_k;
using knn::kTile;

// [rows, D] f32 rows, unpadded: row i starts at i * D.
template <int D>
struct Compact {
    static constexpr int kWidth = D;
    static constexpr int kTileFloats = kTile * D;

    static __device__ __forceinline__ void load_query(float (&qv)[D],
                                                      const float* q,
                                                      long long row) {
#pragma unroll
        for (int c = 0; c < D; ++c) qv[c] = __ldg(q + row * D + c);
    }

    // coalesced global reads, coordinate-major stores
    static __device__ __forceinline__ void stage(float* tile, const float* r,
                                                 int base, int rows) {
        const float* src = r + (long long)base * D;
        for (int t = threadIdx.x; t < rows * D; t += blockDim.x) {
            const int jj = t / D;
            tile[(t - jj * D) * kTile + jj] = src[t];
        }
    }

    static __device__ __forceinline__ float tile_dist(const float (&qv)[D],
                                                      const float* tile,
                                                      int jj) {
        float acc = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
            const float t = qv[c] - tile[c * kTile + jj];
            acc = fmaf(t, t, acc);
        }
        return acc;
    }

    static __device__ __forceinline__ float row_dist(const float (&qv)[D],
                                                     const float* r,
                                                     long long j) {
        float acc = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
            const float t = qv[c] - __ldg(r + j * D + c);
            acc = fmaf(t, t, acc);
        }
        return acc;
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
// knn_select_smalld_small_k takes 1 <= k, k - self_mode <= 16.
int knn_select_smalld_small_k(const float* q, const float* r, int batch,
                              int q_rows, int r_rows, const int* nq,
                              const int* nr, int nr_all, int d, int k,
                              int self_mode, float* out_d2, int* out_idx,
                              void* stream, int device) {
    return static_cast<int>(knn::run(compact_body(d, false), q, r, batch,
                                     q_rows, r_rows, nq, nr, nr_all, k,
                                     self_mode, out_d2, out_idx, stream,
                                     device));
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
                                     device));
}

}  // extern "C"
