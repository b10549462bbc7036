// The wide selection: a hand-written Hopper kernel for the shapes past the
// limits of the two bodies of knn_common.cuh, k > 256 candidates or rows
// wider than 64 coordinates.  It replaces no TPU kernel of its own: it is
// the port's cover for the shapes that the TPU kernels K2
// (mcevidence_tpu/ops/knn_pallas.py:_knn_kernel_binned_packed), K4
// (:_knn_kernel) and K6 (:_knn_kernel_packed) take in the JAX package and
// the two bodies do not: the refine guard's retry at kmax >= 59
// (4 (kmax + 4) + 8 > 256), `fast` past kmax = 256, the grid's last retry
// past kmax = 152, and any chain wider than 64 parameters.
//
// It keeps the contract of knn_common.cuh (per batch member b = blockIdx.y:
// d2 ascending, absent slots (+inf, -1), the self row pinned to slot 0, a
// runtime nr[b] and nq[b]), for any k <= the reference rows and any width d,
// on rows of exactly d floats (no padding).  Key is a policy of
// knn_common.cuh: ExactKey for the exact dispatch, TruncKey<11>/<12> for the
// packed selections, so K6/K7 and the forced K1 keep the TPU's truncation
// order past k = 256.  The k smallest keys under the total order are unique,
// and d2 is summed in coordinate order with the same FMA as the two bodies,
// so where both apply the wide kernel returns the same bits as they do.
//
// Design: a block of W warps takes W consecutive query rows, one a warp.
// The block stages the member's reference rows kWideTile at a time, and the
// coordinates kWideChunk at a time, into a coordinate-major shared tile
// (runtime d: a row wider than a chunk takes several stages, each lane
// carrying its rows' partial sums in registers), with the block's query
// coordinates of the same chunk beside it.  Lane l takes tile rows
// l, l + 32, ...: 32 rows at once, in distinct banks.  Each warp keeps, per
// query row, a list of 2 kp keys (kp = the kept keys rounded up to a power
// of two, at least kWideMinKeys): [0, kp) the kp smallest so far, sorted,
// [kp, 2 kp) a buffer.  A candidate whose key is under the threshold (the
// kept keys' keep-th) is appended to the buffer at its rank in the warp's
// ballot; when fewer than 32 free slots remain, the warp sorts all 2 kp keys
// by a bitonic network (kp compare-swaps a stage) and empties the buffer.
// A query accepts ~k (1 + ln(N / k)) keys, so a row sorts a few times.
// The lists live in shared memory while W lists of 2 kp keys fit beside the
// tile (kp <= 8192 at one warp), else in a global workspace of the caller's,
// one list per query row of the launch; the wrapper then launches the query
// rows in chunks [row0, row1) so that the workspace stays bounded.
//
// Memory: shared, kWideChunk (kWideTile + 1) + 32 W floats (33.0 KB at
// W = 8) and, unless the workspace holds them, 16 kp W bytes (64 KB at
// k = 264 and W = 8); global workspace 16 kp bytes a query row of a chunk.
//
// What bounds it on the H100: like the two bodies, the f32 issue of the
// differences (2 instructions a coordinate a pair), here with two shared
// reads beside them (the tile's and the query's: the width is a runtime
// value, so the query stays in shared memory), plus the sorts.  Simplicity
// first: it runs only where the two faster bodies cannot.

#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_common.cuh"

namespace {

using knn::kEmpty;
using knn::kFullMask;

constexpr int kWideTile = 256;              // reference rows a tile
constexpr int kWideChunk = 32;              // coordinates a stage
constexpr int kWideStride = kWideTile + 1;  // floats between two coordinates
constexpr int kRowsPerLane = kWideTile / 32;
constexpr int kWideMinKeys = 64;            // a step adds at most 32 keys
constexpr int kWideMaxWarps = 8;
constexpr size_t kWideMaxShared = 227 * 1024;

__host__ __device__ size_t wide_shared_bytes(int kp, int warps,
                                             bool global_keys) {
    const size_t keys = global_keys ? 0 : (size_t)warps * 2 * kp * 8;
    return keys + (size_t)(kWideChunk * kWideStride + warps * kWideChunk) * 4;
}

// sort a[0, n) ascending (n a power of two) by the 32 lanes of a warp; `a`
// may lie in shared or global memory
__device__ void warp_sort(unsigned long long* a, int n, int lane) {
    for (int size = 2; size <= n; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int t = lane; t < (n >> 1); t += 32) {
                const int lo = 2 * t - (t & (stride - 1));
                const int hi = lo + stride;
                const unsigned long long x = a[lo], y = a[hi];
                if ((y < x) == ((lo & size) == 0)) {
                    a[lo] = y;
                    a[hi] = x;
                }
            }
            __threadfence_block();
            __syncwarp();
        }
    }
}

// fold the buffer keys[kp, 2 kp) into the list keys[0, kp) and empty the
// buffer; returns the keep-th smallest key, the same in every lane
__device__ unsigned long long merge_list(unsigned long long* keys, int kp,
                                         int keep, int lane) {
    __threadfence_block();
    __syncwarp();
    warp_sort(keys, 2 * kp, lane);
    const unsigned long long kth = keys[keep - 1];
    for (int i = kp + lane; i < 2 * kp; i += 32) keys[i] = kEmpty;
    __threadfence_block();
    __syncwarp();
    return kth;
}

template <class Key>
__global__ void __launch_bounds__(kWideMaxWarps * 32)
knn_wide_kernel(const float* __restrict__ q, const float* __restrict__ r,
                knn::Members m, int d, int k, int self_mode, int kp,
                int row0, int row1, unsigned long long* work,
                float* __restrict__ out_d2, int* __restrict__ out_idx) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int warps = blockDim.x >> 5;
    unsigned long long* shared_keys =
        reinterpret_cast<unsigned long long*>(smem_raw);
    float* tile = reinterpret_cast<float*>(
        shared_keys + (work ? 0 : (size_t)warps * 2 * kp));
    float* qs = tile + kWideChunk * kWideStride;
    const Key key_of{};
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.y;
    const int nq = m.queries(b);
    const int nr = m.refs(b);
    q += (long long)b * m.q_rows * d;
    r += (long long)b * m.r_rows * d;
    out_d2 += (long long)b * m.q_rows * k;
    out_idx += (long long)b * m.q_rows * k;

    const int first = row0 + blockIdx.x * warps;
    const int row = first + warp;
    const int end = min(row1, nq);  // rows of this launch that search
    if (row < row1 && row >= nq) {
        // a padded query row: absent slots, no search
        for (int s = lane; s < k; s += 32)
            knn::write_slot(out_d2, out_idx, (long long)row * k + s, kEmpty);
    }
    const bool active = row < end;
    const int keep = self_mode ? k - 1 : k;
    if (active && self_mode && lane == 0) {
        out_d2[(long long)row * k] = 0.0f;
        out_idx[(long long)row * k] = row;
    }
    // the whole block is padding, or only the self slot is asked for
    if (first >= end || keep <= 0) return;

    const int self_row = (self_mode && active) ? row : -1;
    unsigned long long* keys = nullptr;
    if (active) {
        keys = work ? work + ((long long)b * (row1 - row0) + (row - row0)) *
                                 2 * kp
                    : shared_keys + (long long)warp * 2 * kp;
        for (int i = lane; i < 2 * kp; i += 32) keys[i] = kEmpty;
        __threadfence_block();
        __syncwarp();
    }
    unsigned long long threshold = kEmpty;
    int count = 0;  // keys in the buffer
    for (int base = 0; base < nr; base += kWideTile) {
        const int rows = min(kWideTile, nr - base);
        float acc[kRowsPerLane];
#pragma unroll
        for (int i = 0; i < kRowsPerLane; ++i) acc[i] = 0.0f;
        for (int c0 = 0; c0 < d; c0 += kWideChunk) {
            const int dc = min(kWideChunk, d - c0);
            // every warp is done with the previous stage
            __syncthreads();
            const float* src = r + (long long)base * d + c0;
            for (int t = threadIdx.x; t < rows * dc; t += blockDim.x) {
                const int jj = t / dc;
                const int c = t - jj * dc;
                tile[c * kWideStride + jj] = src[(long long)jj * d + c];
            }
            for (int t = threadIdx.x; t < warps * dc; t += blockDim.x) {
                const int w = t / dc;
                const int c = t - w * dc;
                const int qr = first + w;
                qs[w * kWideChunk + c] =
                    qr < end ? q[(long long)qr * d + c0 + c] : 0.0f;
            }
            __syncthreads();
            if (!active) continue;
            const float* qw = qs + warp * kWideChunk;
            for (int c = 0; c < dc; ++c) {
                const float qc = qw[c];
                const float* col = tile + c * kWideStride + lane;
#pragma unroll
                for (int i = 0; i < kRowsPerLane; ++i) {
                    const float t = qc - col[32 * i];
                    acc[i] = fmaf(t, t, acc[i]);
                }
            }
        }
        if (!active) continue;  // the same in every lane of the warp
#pragma unroll
        for (int i = 0; i < kRowsPerLane; ++i) {
            const int jj = lane + 32 * i;
            const int j = base + jj;
            const unsigned long long key = key_of(acc[i], j);
            const bool take = jj < rows && j != self_row && key < threshold;
            const unsigned mask = __ballot_sync(kFullMask, take);
            if (mask == 0) continue;
            if (take)
                keys[kp + count + __popc(mask & ((1u << lane) - 1u))] = key;
            count += __popc(mask);
            if (count > kp - 32) {
                threshold = merge_list(keys, kp, keep, lane);
                count = 0;
            }
        }
    }
    if (!active) return;
    if (count > 0) merge_list(keys, kp, keep, lane);
    const long long o = (long long)row * k + (self_mode ? 1 : 0);
    for (int e = lane; e < keep; e += 32)
        knn::write_slot(out_d2, out_idx, o + e, keys[e]);
}

template <class Key>
cudaError_t launch_wide(const float* q, const float* r, int batch,
                        const knn::Members& m, int d, int k, int self_mode,
                        int kp, int warps, int row0, int row1,
                        unsigned long long* work, float* out_d2,
                        int* out_idx, cudaStream_t stream) {
    const size_t smem = wide_shared_bytes(kp, warps, work != nullptr);
    const auto kernel = knn_wide_kernel<Key>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const dim3 grid((row1 - row0 + warps - 1) / warps, batch);
    kernel<<<grid, warps * 32, smem, stream>>>(q, r, m, d, k, self_mode, kp,
                                               row0, row1, work, out_d2,
                                               out_idx);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Arguments: those of knn_select.cu's entry points, with
//   d               the rows' width (any d >= 1; rows of exactly d floats)
//   low_bits        0 (exact keys), 11 or 12 (truncated keys)
//   kp              keys a list keeps: a power of two >= max(k - self_mode,
//                   64)
//   warps           query rows a block (1..8)
//   row0, row1      the query rows of each member this launch takes
//   workspace       null (the lists in shared memory), or
//                   [batch, row1 - row0, 2 kp] uint64 on the device
// Takes any 1 <= k <= r_rows.
int knn_select_wide(const float* q, const float* r, int batch, int q_rows,
                    int r_rows, const int* nq, const int* nr, int nr_all,
                    int d, int k, int self_mode, float* out_d2, int* out_idx,
                    void* stream, int device, int low_bits, int kp, int warps,
                    int row0, int row1, void* workspace) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (batch <= 0 || q_rows <= 0 || k <= 0 || row1 <= row0)
        return cudaSuccess;
    const int keep = self_mode ? k - 1 : k;
    auto* work = static_cast<unsigned long long*>(workspace);
    if (batch > 65535 || d < 1 || warps < 1 || warps > kWideMaxWarps ||
        kp < kWideMinKeys || (kp & (kp - 1)) != 0 || kp < keep || row0 < 0 ||
        row1 > q_rows ||
        wide_shared_bytes(kp, warps, work != nullptr) > kWideMaxShared)
        return cudaErrorInvalidValue;
    const knn::Members m{q_rows, r_rows, nq, nr, nr_all};
    const auto s = static_cast<cudaStream_t>(stream);
    switch (low_bits) {
        case 0:
            err = launch_wide<knn::ExactKey>(q, r, batch, m, d, k, self_mode,
                                             kp, warps, row0, row1, work,
                                             out_d2, out_idx, s);
            break;
        case 11:
            err = launch_wide<knn::TruncKey<11>>(q, r, batch, m, d, k,
                                                 self_mode, kp, warps, row0,
                                                 row1, work, out_d2, out_idx,
                                                 s);
            break;
        case 12:
            err = launch_wide<knn::TruncKey<12>>(q, r, batch, m, d, k,
                                                 self_mode, kp, warps, row0,
                                                 row1, work, out_d2, out_idx,
                                                 s);
            break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}

}  // extern "C"
