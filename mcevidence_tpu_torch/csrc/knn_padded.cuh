// The Padded<DP> row layout of knn_common.cuh's bodies: rows zero-padded
// from d to DP = 8, 16, 32 or 64 columns (zero columns add exactly 0), so
// every row starts on 16 bytes: query rows load as float4s, and reference
// rows are copied into shared memory 16 bytes at a time.  Shared by
// knn_select.cu (exact keys) and knn_packed.cu (truncated keys, the prologue
// cut).

#pragma once

#include <cuda_runtime.h>

#include "knn_common.cuh"

namespace knn {

// [rows, DP] f32 rows
template <int DP>
struct Padded {
    static_assert(DP % 4 == 0, "DP is a multiple of 4");
    static constexpr int kWidth = DP;
    static constexpr int kVec = 4;

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
};

// The launcher of one body on Padded<dp> with key policy Key, or null when
// dp is not one of 8, 16, 32, 64.
template <class Key = ExactKey, int Cuts = 0>
Dispatch padded_small_k(int dp) {
    switch (dp) {
        case 8: return dispatch_small_k<Padded<8>, Key, Cuts>;
        case 16: return dispatch_small_k<Padded<16>, Key, Cuts>;
        case 32: return dispatch_small_k<Padded<32>, Key, Cuts>;
        case 64: return dispatch_small_k<Padded<64>, Key, Cuts>;
        default: return nullptr;
    }
}

template <class Key = ExactKey>
Dispatch padded_large_k(int dp) {
    switch (dp) {
        case 8: return dispatch_large_k<Padded<8>, Key>;
        case 16: return dispatch_large_k<Padded<16>, Key>;
        case 32: return dispatch_large_k<Padded<32>, Key>;
        case 64: return dispatch_large_k<Padded<64>, Key>;
        default: return nullptr;
    }
}

}  // namespace knn
