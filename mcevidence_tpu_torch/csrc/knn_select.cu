// Hand-written Hopper kernels for the kNN candidate selection, on rows
// zero-padded from d to DP = 8, 16, 32 or 64 columns (zero columns add
// exactly 0).  The bodies and their contract are in knn_common.cuh.
//
// knn_select_small_k (the small-k body): counterpart of the TPU kernels K1,
// mcevidence_tpu/ops/knn_pallas.py:_knn_kernel_packedn (n_tiles=2, reached
// through knn_select_pallas_packed2), behind the k-dependent dispatch, and
// K5, :_knn_kernel_packed2_batched (the same selection with a batch grid
// axis), used for k_sel < 14.  It is also K4's counterpart below k = 14,
// :_knn_kernel (exact f32 top-k through knn_select_pallas), whose returned
// d2 the fast precision consumes.  Exact, so it meets K1's and K5's
// <= 2^-11 quantisation bound with room to spare.  The forced
// `pallas_packed2` engine takes K1's own truncated ranking instead
// (knn_packed.cu).
//
// knn_select_large_k (the large-k body): counterpart of the TPU kernels K2,
// :_knn_kernel_binned_packed, and K3, :_knn_kernel_binned (both reached
// through knn_select_pallas_binned), used for k_sel >= 14: the refine
// guard's retry and first passes at kmax >= 10.  With a batch it is also
// K5's counterpart at k_sel >= 14 (K5 takes any k, and the grid's
// thin-margin retries ask for kmax+24 and kmax+104), and K4's counterpart
// from k = 14 on the fast path.  It is exact, so it meets K2's <= 5e-7
// loss bound and K3's exact contract, with no 262,144-row cap.
//
// The layout is knn_padded.cuh's; what bounds each body on the card and
// what its design does about it is in knn_common.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_common.cuh"
#include "knn_padded.cuh"

namespace {

knn::Dispatch padded_body(int dp, bool large) {
    return large ? knn::padded_large_k<>(dp) : knn::padded_small_k<>(dp);
}

}  // namespace

extern "C" {

// Arguments of both entry points:
//   q, r            [batch, q_rows, dp] and [batch, r_rows, dp] f32
//   nq, nr          int32 [batch] on the device, or null (q_rows; nr_all)
//   dp              the padded width, one of 8, 16, 32, 64
//   out_d2, out_idx [batch, q_rows, k]
//   rechecks        (knn_select_small_k only) an int64 counter on the
//                   device that the small-k body adds its exact rechecks
//                   to (knn_common.cuh), or null
// knn_select_small_k takes 1 <= k, k - self_mode <= 16.
int knn_select_small_k(const float* q, const float* r, int batch, int q_rows,
                       int r_rows, const int* nq, const int* nr, int nr_all,
                       int dp, int k, int self_mode, float* out_d2,
                       int* out_idx, void* stream, int device,
                       unsigned long long* rechecks) {
    return static_cast<int>(knn::run(padded_body(dp, false), q, r, batch,
                                     q_rows, r_rows, nq, nr, nr_all, k,
                                     self_mode, out_d2, out_idx, stream,
                                     device, rechecks));
}

// knn_select_large_k takes 1 <= k <= 256.
int knn_select_large_k(const float* q, const float* r, int batch, int q_rows,
                       int r_rows, const int* nq, const int* nr, int nr_all,
                       int dp, int k, int self_mode, float* out_d2,
                       int* out_idx, void* stream, int device) {
    return static_cast<int>(knn::run(padded_body(dp, true), q, r, batch,
                                     q_rows, r_rows, nq, nr, nr_all, k,
                                     self_mode, out_d2, out_idx, stream,
                                     device, nullptr));
}

}  // extern "C"
