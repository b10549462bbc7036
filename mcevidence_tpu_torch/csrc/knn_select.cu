// Hand-written Hopper kernels for the kNN candidate selection, on rows
// zero-padded from d to DP = 8, 16, 32 or 64 columns (zero columns add
// exactly 0).  The bodies and their contract are in knn_common.cuh.
//
// knn_select_small_k (the small-k body): counterpart of the TPU kernels K1,
// mcevidence_tpu/ops/knn_pallas.py:_knn_kernel_packedn (n_tiles=2, reached
// through knn_select_pallas_packed2), and K5, :_knn_kernel_packed2_batched
// (the same selection with a batch grid axis), used for k_sel < 14.  It is
// also K4's counterpart below k = 14, :_knn_kernel (exact f32 top-k through
// knn_select_pallas), whose returned d2 the fast precision consumes.  Exact,
// so it meets K1's and K5's <= 2^-11 quantisation bound with room to spare.
//
// knn_select_large_k (the large-k body): counterpart of the TPU kernels K2,
// :_knn_kernel_binned_packed, and K3, :_knn_kernel_binned (both reached
// through knn_select_pallas_binned), used for k_sel >= 14: the refine
// guard's retry and first passes at kmax >= 10.  With a batch it is also
// K5's counterpart at k_sel >= 14 (K5 takes any k, and the grid's
// thin-margin retries ask for kmax+24 and kmax+104), and K4's counterpart
// from k = 14 on the fast path.  Its per-lane lists are K2's lane bins with
// depth k: no candidate is lost, so it meets K2's <= 5e-7 loss bound and
// K3's exact contract, with no 262,144-row cap.
//
// The small-k body reads the shared tile as float4 rows; the large-k body
// reads float4 rows through L1 from L2.  Tensor-core distance tiles, a TMA
// ring and a warp-shared insertion threshold are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_common.cuh"

namespace {

using knn::Dispatch;
using knn::dispatch_large_k;
using knn::dispatch_small_k;
using knn::kTile;

template <int DP>
__device__ __forceinline__ float sq_dist(const float (&qv)[DP],
                                         const float4* row) {
    float acc = 0.0f;
#pragma unroll
    for (int c4 = 0; c4 < DP / 4; ++c4) {
        const float4 v = row[c4];
        float t = qv[4 * c4 + 0] - v.x;
        acc = fmaf(t, t, acc);
        t = qv[4 * c4 + 1] - v.y;
        acc = fmaf(t, t, acc);
        t = qv[4 * c4 + 2] - v.z;
        acc = fmaf(t, t, acc);
        t = qv[4 * c4 + 3] - v.w;
        acc = fmaf(t, t, acc);
    }
    return acc;
}

// [rows, DP] f32 rows; the small-k tile holds kTile rows as float4s.
template <int DP>
struct Padded {
    static_assert(DP % 4 == 0, "DP is a multiple of 4");
    static constexpr int kWidth = DP;
    static constexpr int kTileFloats = kTile * DP;

    static __device__ __forceinline__ void load_query(float (&qv)[DP],
                                                      const float* q,
                                                      long long row) {
        const float4* q4 = reinterpret_cast<const float4*>(q) + row * (DP / 4);
#pragma unroll
        for (int c4 = 0; c4 < DP / 4; ++c4) {
            const float4 v = __ldg(q4 + c4);
            qv[4 * c4 + 0] = v.x;
            qv[4 * c4 + 1] = v.y;
            qv[4 * c4 + 2] = v.z;
            qv[4 * c4 + 3] = v.w;
        }
    }

    static __device__ __forceinline__ void stage(float* tile, const float* r,
                                                 int base, int rows) {
        float4* t4 = reinterpret_cast<float4*>(tile);
        const float4* r4 =
            reinterpret_cast<const float4*>(r) + (long long)base * (DP / 4);
        for (int t = threadIdx.x; t < rows * (DP / 4); t += blockDim.x)
            t4[t] = r4[t];
    }

    static __device__ __forceinline__ float tile_dist(const float (&qv)[DP],
                                                      const float* tile,
                                                      int jj) {
        return sq_dist<DP>(
            qv, reinterpret_cast<const float4*>(tile) + jj * (DP / 4));
    }

    static __device__ __forceinline__ float row_dist(const float (&qv)[DP],
                                                     const float* r,
                                                     long long j) {
        const float4* r4 = reinterpret_cast<const float4*>(r) + j * (DP / 4);
        float4 rowv[DP / 4];
#pragma unroll
        for (int c4 = 0; c4 < DP / 4; ++c4) rowv[c4] = __ldg(r4 + c4);
        return sq_dist<DP>(qv, rowv);
    }
};

Dispatch padded_body(int dp, bool large) {
    switch (dp) {
        case 8: return large ? dispatch_large_k<Padded<8>> : dispatch_small_k<Padded<8>>;
        case 16: return large ? dispatch_large_k<Padded<16>> : dispatch_small_k<Padded<16>>;
        case 32: return large ? dispatch_large_k<Padded<32>> : dispatch_small_k<Padded<32>>;
        case 64: return large ? dispatch_large_k<Padded<64>> : dispatch_small_k<Padded<64>>;
        default: return nullptr;
    }
}

}  // namespace

extern "C" {

// Arguments of both entry points:
//   q, r            [batch, q_rows, dp] and [batch, r_rows, dp] f32
//   nq, nr          int32 [batch] on the device, or null (q_rows; nr_all)
//   dp              the padded width, one of 8, 16, 32, 64
//   out_d2, out_idx [batch, q_rows, k]
// knn_select_small_k takes 1 <= k, k - self_mode <= 16.
int knn_select_small_k(const float* q, const float* r, int batch, int q_rows,
                       int r_rows, const int* nq, const int* nr, int nr_all,
                       int dp, int k, int self_mode, float* out_d2,
                       int* out_idx, void* stream, int device) {
    return static_cast<int>(knn::run(padded_body(dp, false), q, r, batch,
                                     q_rows, r_rows, nq, nr, nr_all, k,
                                     self_mode, out_d2, out_idx, stream,
                                     device));
}

// knn_select_large_k takes 1 <= k <= 256.
int knn_select_large_k(const float* q, const float* r, int batch, int q_rows,
                       int r_rows, const int* nq, const int* nr, int nr_all,
                       int dp, int k, int self_mode, float* out_d2,
                       int* out_idx, void* stream, int device) {
    return static_cast<int>(knn::run(padded_body(dp, true), q, r, batch,
                                     q_rows, r_rows, nq, nr, nr_all, k,
                                     self_mode, out_d2, out_idx, stream,
                                     device));
}

const char* knn_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
