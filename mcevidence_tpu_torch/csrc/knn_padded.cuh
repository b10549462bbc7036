// The Padded<DP> row layout of knn_common.cuh's bodies: rows zero-padded
// from d to DP = 8, 16, 32 or 64 columns (zero columns add exactly 0), read
// as float4s.  The small-k body stages kTile rows of it in shared memory;
// the large-k body reads rows through L1 from L2.  Shared by knn_select.cu
// (exact keys) and knn_packed.cu (truncated keys, the prologue cuts).

#pragma once

#include <cuda_runtime.h>

#include "knn_common.cuh"

namespace knn {

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
