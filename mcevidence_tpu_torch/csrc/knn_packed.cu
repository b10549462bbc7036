// Hand-written Hopper kernels for the packed (truncated-key) kNN selections
// and the prologue study, on knn_padded.cuh's Padded<DP> rows.  The bodies
// and their contract are in knn_common.cuh.
//
// knn_select_packed_small_k / knn_select_packed_large_k: counterparts of the
// TPU kernels K6, mcevidence_tpu/ops/knn_pallas.py:_knn_kernel_packed
// (reached through knn_select_pallas_packed), and K7,
// :_knn_kernel_packed_batched (through knn_select_pallas_packed_batched,
// the same selection with a batch grid axis and per-member counts), at
// low_bits = 11; and of K1, :_knn_kernel_packedn (n_tiles=2, through
// knn_select_pallas_packed2) as a forced engine, at low_bits = 12.  Those
// kernels pack the f32 bits of d2 and a tile-local column into one int32,
// so they rank by d2 with its low `low_bits` mantissa bits cleared, ties by
// the smaller index, and return the truncated d2 (<= 2^-12 or 2^-11 below
// the exact value).  The fast precision consumes that d2 directly, so an
// exact stand-in would miss their answer by the quantisation's bias.  Here
// the index has its own 32 bits of the 64-bit key, so no tile-local column
// is needed: TruncKey<B> clears the low B bits of d2 and keeps j whole,
// which is exactly the TPU kernels' total order.  The small-k body runs
// below k = 14, the large-k body up to k = 256.
//
// knn_select_prologue: counterpart of the round-5 prologue ablation of K1,
// scripts/bench_prologue.py:_kernel (through knn_variant), on the small-k
// body at low_bits = 12.  Of its three cuts:
//   A  one wide matrix product instead of two halves and a concatenation:
//      there is no GPU counterpart, because these kernels take distances by
//      differences, with no matrix product to fuse;
//   B  sentinel reference rows (1e18) set once by the wrapper instead of
//      the per-tile `gcol < nr` mask: here the wrapper pads the centred
//      reference allocation to a multiple of kTile with such rows, so the
//      inner loop runs a constant kTile rows with no `min(kTile, nr - base)`
//      bound ((1e18)^2 * 64 ~ 6.4e37 stays finite in f32); slots whose
//      d2 > 1e30 come back absent (bench_prologue.py:152-154);
//   C  the self pin only where it can matter: every small-k body now runs
//      the j != self_row test only for a candidate that beats its row's
//      worst key, so B and BC run the same code.
// `cuts` takes B (1) or B and C (3).
//
// What bounds these kernels on the card, and what the bodies do about it,
// is in knn_common.cuh.  The key policy changes only the key and the
// small-k screen's threshold, so the truncation costs one AND a candidate
// (in the small-k body a recheck) and one OR a rebuilt floor.

#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_common.cuh"
#include "knn_padded.cuh"

namespace {

using knn::Dispatch;
using knn::TruncKey;

Dispatch packed_body(int dp, int low_bits, bool large) {
    switch (low_bits) {
        case 11:
            return large ? knn::padded_large_k<TruncKey<11>>(dp)
                         : knn::padded_small_k<TruncKey<11>>(dp);
        case 12:
            return large ? knn::padded_large_k<TruncKey<12>>(dp)
                         : knn::padded_small_k<TruncKey<12>>(dp);
        default: return nullptr;
    }
}

Dispatch prologue_body(int dp, int cuts) {
    switch (cuts) {
        case 1:  // B
        case 3:  // B and C: C is part of every small-k body
            return knn::padded_small_k<TruncKey<12>, knn::kCutBound>(dp);
        default: return nullptr;
    }
}

}  // namespace

extern "C" {

// Arguments of the packed entry points: those of knn_select.cu's, and
//   low_bits        11 (K6, K7) or 12 (K1)
//   rechecks        (knn_select_packed_small_k only) as knn_select.cu's,
//                   after low_bits
// knn_select_packed_small_k takes 1 <= k, k - self_mode <= 16;
// knn_select_packed_large_k takes 1 <= k <= 256.
int knn_select_packed_small_k(const float* q, const float* r, int batch,
                              int q_rows, int r_rows, const int* nq,
                              const int* nr, int nr_all, int dp, int k,
                              int self_mode, float* out_d2, int* out_idx,
                              void* stream, int device, int low_bits,
                              unsigned long long* rechecks) {
    return static_cast<int>(knn::run(packed_body(dp, low_bits, false), q, r,
                                     batch, q_rows, r_rows, nq, nr, nr_all,
                                     k, self_mode, out_d2, out_idx, stream,
                                     device, rechecks));
}

int knn_select_packed_large_k(const float* q, const float* r, int batch,
                              int q_rows, int r_rows, const int* nq,
                              const int* nr, int nr_all, int dp, int k,
                              int self_mode, float* out_d2, int* out_idx,
                              void* stream, int device, int low_bits) {
    return static_cast<int>(knn::run(packed_body(dp, low_bits, true), q, r,
                                     batch, q_rows, r_rows, nq, nr, nr_all,
                                     k, self_mode, out_d2, out_idx, stream,
                                     device, nullptr));
}

// knn_select_prologue: as knn_select_packed_small_k at low_bits = 12, with
//   r_rows = nr_all the reference rows padded to a multiple of 128 with
//                   sentinel rows (1e18 in every column)
//   cuts            1 (B) or 3 (B and C)
//   rechecks        as knn_select.cu's, after cuts
int knn_select_prologue(const float* q, const float* r, int batch,
                        int q_rows, int r_rows, const int* nq, const int* nr,
                        int nr_all, int dp, int k, int self_mode,
                        float* out_d2, int* out_idx, void* stream, int device,
                        int cuts, unsigned long long* rechecks) {
    if (nr_all % knn::kTile != 0) return cudaErrorInvalidValue;
    return static_cast<int>(knn::run(prologue_body(dp, cuts), q, r, batch,
                                     q_rows, r_rows, nq, nr, nr_all, k,
                                     self_mode, out_d2, out_idx, stream,
                                     device, rechecks));
}

}  // extern "C"
