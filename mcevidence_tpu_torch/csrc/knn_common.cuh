// The kNN selection kernels: candidate keys, the two selection bodies and
// their launchers, templated on a row layout and a key policy.  Each source
// instantiates the bodies for its own layouts and keys and defines its C
// entry points:
//   knn_select.cu  Padded<DP> (knn_padded.cuh): rows zero-padded to
//                  DP = 8/16/32/64 columns; exact keys
//   knn_smalld.cu  Compact<D>: rows of exactly D <= 16 columns; exact keys
//   knn_packed.cu  Padded<DP>; truncated keys (TruncKey<B>), and the
//                  prologue-cut small-k body
// so the sources compile in parallel.
//
// Shared contract (the same as the TPU kernels they replace), per batch
// member b = blockIdx.y of a batch of B members laid out back to back:
//   q    f32 [B, q_rows, W]  query rows, centred by the wrapper (W: the
//                            layout's width, L::kWidth)
//   r    f32 [B, r_rows, W]  reference rows, centred the same way
//   nq[b], nr[b]             the member's valid query and reference rows,
//                            int32 arrays on the device (the counterpart of
//                            the TPU kernels' SMEM nr_ref[b]); a null array
//                            means every member has q_rows queries and
//                            nr_all reference rows
//   out  f32 d2 [B, q_rows, k] ascending, int32 idx [B, q_rows, k]
//   reference rows at or past nr[b] are never read; query rows at or past
//   nq[b] write +inf and -1 into every slot and do no other work
//   absent slots (fewer than k candidates) hold +inf and -1
//   self mode (query row i is reference row i): slot 0 holds (0, i) even when
//   a duplicate point with a smaller index sits at distance 0
//
// The unbatched selections are the case B = 1 with null count arrays.
//
// Distances are sums of squared differences in f32 FMA on the CUDA cores, in
// coordinate order: no matrix-product identity, so no cancellation, no TF32
// and d2 >= 0 by construction.  Padding columns add exactly 0, so both
// layouts give the same d2 bit for bit.  Candidates are ranked by a 64-bit
// key (bits << 32) | index, which breaks ties by the smaller index:
//   ExactKey     bits = float_bits(d2), which orders non-negative floats
//                exactly; the selection is exact
//   a policy K   any functor K()(d2, j) giving such a key, e.g. with the low
//                mantissa bits of d2 cleared (knn_packed.cu's TruncKey)
// A slot's d2 is decoded from its key, so a truncating policy returns the
// truncated d2.  +inf keeps its bits under truncation (its mantissa is 0).
//
// A layout L provides
//   kWidth       floats per row as laid out
//   kTileFloats  shared floats of one small-k tile of kTile reference rows
//   load_query(qv, q, row)      query row `row` into registers
//   stage(tile, r, base, rows)  reference rows [base, base + rows) into the
//                               shared tile (all threads of the block)
//   tile_dist(qv, tile, jj)     d2 to tile row jj
//   row_dist(qv, r, j)          d2 to reference row j, read from global
//                               memory through the read-only cache
//
// Each launcher returns cudaGetLastError() after its launch; it allocates
// nothing and does not synchronise.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace knn {

constexpr unsigned long long kEmpty = 0xFFFFFFFFFFFFFFFFull;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kSmallThreads = 128;
constexpr int kTile = 128;            // reference rows per small-k tile
constexpr int kLargeMaxK = 256;
constexpr int kLargeMaxWarps = 8;
constexpr int kLargeSmemTarget = 64 * 1024;

// Where batch member b lives and how many of its rows are valid.
struct Members {
    int q_rows;          // allocated query rows per member (output rows too)
    int r_rows;          // allocated reference rows per member
    const int* nq;       // valid query rows per member, or null: q_rows
    const int* nr;       // valid reference rows per member, or null: nr_all
    int nr_all;

    __device__ __forceinline__ int queries(int b) const {
        return nq ? nq[b] : q_rows;
    }
    __device__ __forceinline__ int refs(int b) const {
        return nr ? nr[b] : nr_all;
    }
};

__device__ __forceinline__ unsigned long long make_key(float d2, int j) {
    return (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) |
           static_cast<unsigned>(j);
}

// the exact ranking: every bit of d2
struct ExactKey {
    __device__ __forceinline__ unsigned long long operator()(float d2,
                                                             int j) const {
        return make_key(d2, j);
    }
};

// Compile-time cuts of the small-k body (the prologue study, knn_packed.cu):
//   kCutBound  the reference allocation is padded by the caller to a multiple
//              of kTile with sentinel rows (1e18 in every column) and nr is
//              that padded count: every tile is full, so the inner loop has
//              no min(kTile, nr - base) bound; a slot whose d2 > 1e30 (a
//              sentinel) comes back absent
//   kCutPin    the self test j != self_row runs only in the one tile whose
//              base is the block's first query row (kTile == kSmallThreads)
constexpr int kCutBound = 1;
constexpr int kCutPin = 2;

__device__ __forceinline__ void write_slot(float* out_d2, int* out_idx,
                                           long long pos,
                                           unsigned long long key) {
    if (key == kEmpty) {
        out_d2[pos] = __int_as_float(0x7F800000);
        out_idx[pos] = -1;
    } else {
        out_d2[pos] = __uint_as_float(static_cast<unsigned>(key >> 32));
        out_idx[pos] = static_cast<int>(key & 0xFFFFFFFFull);
    }
}

// Insert key into a thread's sorted register list best[0..KP) (ascending),
// dropping the largest.  The caller has checked key < best[KP - 1].
template <int KP>
__device__ __forceinline__ void insert_sorted(unsigned long long (&best)[KP],
                                              unsigned long long key) {
    best[KP - 1] = key;
#pragma unroll
    for (int s = KP - 1; s > 0; --s) {
        const unsigned long long a = best[s - 1], c = best[s];
        best[s - 1] = a < c ? a : c;
        best[s] = a < c ? c : a;
    }
}

// Insert key into lane `lane`'s sorted list of `keep` keys laid out
// [slot][lane] in shared memory; returns the new worst key of the list.
// The caller has checked key < the current worst.
__device__ __forceinline__ unsigned long long insert_lane_list(
        unsigned long long* list, int keep, int lane,
        unsigned long long key) {
    int s = keep - 1;
    while (s > 0 && list[(s - 1) * 32 + lane] > key) {
        list[s * 32 + lane] = list[(s - 1) * 32 + lane];
        --s;
    }
    list[s * 32 + lane] = key;
    return list[(keep - 1) * 32 + lane];
}

// Merge the 32 lanes' sorted lists of `keep` keys: pop the warp-wide
// minimum of the list heads `keep` times and write slots first..first+keep
// of output row o (lane 0 writes).  Keys are unique (distinct indices), so
// exactly one lane advances per pop.
__device__ __forceinline__ void merge_lane_lists(
        const unsigned long long* list, int keep, int lane, float* out_d2,
        int* out_idx, long long o, int first) {
    int h = 0;
    unsigned long long head = keep > 0 ? list[lane] : kEmpty;
    for (int s = 0; s < keep; ++s) {
        unsigned long long mn = head;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const unsigned long long other =
                __shfl_xor_sync(kFullMask, mn, off);
            mn = other < mn ? other : mn;
        }
        if (mn != kEmpty && head == mn) {
            ++h;
            head = h < keep ? list[h * 32 + lane] : kEmpty;
        }
        if (lane == 0) write_slot(out_d2, out_idx, o + first + s, mn);
    }
}

// ---------------------------------------------------------------------------
// The small-k body (k_sel < 14).  One thread per query row, blockIdx.y the
// batch member.  The block streams the member's reference rows through a
// shared tile of kTile rows; every thread reads the same tile row at the
// same time (a broadcast, no bank conflict).  Each thread keeps its sorted
// top-KP keys in registers (KP is k rounded up to a power of two, so every
// index into the list is static) and inserts by one compare-swap pass.  Key
// ranks the candidates; Cuts (a mask of kCutBound and kCutPin) are the
// prologue study's compile-time cuts.
// ---------------------------------------------------------------------------

static_assert(kTile == kSmallThreads,
              "kCutPin: one tile holds all of a block's self rows");

template <class L, int KP, class Key = ExactKey, int Cuts = 0>
__global__ void __launch_bounds__(kSmallThreads)
knn_small_k_kernel(const float* __restrict__ q, const float* __restrict__ r,
                   Members m, int k, int self_mode,
                   float* __restrict__ out_d2, int* __restrict__ out_idx) {
    constexpr int W = L::kWidth;
    const Key key_of{};
    __shared__ __align__(16) float tile[L::kTileFloats];
    const int b = blockIdx.y;
    const int nq = m.queries(b);
    const int nr = m.refs(b);
    q += (long long)b * m.q_rows * W;
    r += (long long)b * m.r_rows * W;
    out_d2 += (long long)b * m.q_rows * k;
    out_idx += (long long)b * m.q_rows * k;

    const int first = blockIdx.x * blockDim.x;
    const int row = first + threadIdx.x;
    if (row >= nq && row < m.q_rows) {
        // a padded query row: absent slots, no search
        for (int s = 0; s < k; ++s)
            write_slot(out_d2, out_idx, (long long)row * k + s, kEmpty);
    }
    if (first >= nq) return;  // the whole block is padding
    const bool active = row < nq;
    const int self_row = (self_mode && active) ? row : -1;

    float qv[W] = {};
    if (active) L::load_query(qv, q, row);
    unsigned long long best[KP];
#pragma unroll
    for (int s = 0; s < KP; ++s) best[s] = kEmpty;

    for (int base = 0; base < nr; base += kTile) {
        const int rows = (Cuts & kCutBound) ? kTile : min(kTile, nr - base);
        __syncthreads();
        L::stage(tile, r, base, rows);
        __syncthreads();
        if (!active) continue;
        if ((Cuts & kCutPin) && base != first) {
            // no self row of this block lies in this tile
            for (int jj = 0; jj < rows; ++jj) {
                const unsigned long long key =
                    key_of(L::tile_dist(qv, tile, jj), base + jj);
                if (key < best[KP - 1]) insert_sorted<KP>(best, key);
            }
            continue;
        }
        for (int jj = 0; jj < rows; ++jj) {
            const int j = base + jj;
            const unsigned long long key =
                key_of(L::tile_dist(qv, tile, jj), j);
            if (key < best[KP - 1] && j != self_row)
                insert_sorted<KP>(best, key);
        }
    }
    if (!active) return;
    const long long o = (long long)row * k;
    int slot = 0;
    if (self_mode) {
        out_d2[o] = 0.0f;
        out_idx[o] = row;
        slot = 1;
    }
#pragma unroll
    for (int s = 0; s < KP; ++s) {
        unsigned long long key = best[s];
        // a sentinel row won the slot: fewer valid candidates than k
        if ((Cuts & kCutBound) && key != kEmpty &&
            __uint_as_float(static_cast<unsigned>(key >> 32)) > 1e30f)
            key = kEmpty;
        if (slot + s < k) write_slot(out_d2, out_idx, o + slot + s, key);
    }
}

// ---------------------------------------------------------------------------
// The large-k body (14 <= k_sel <= 256).  One warp per query row,
// blockIdx.y the batch member.  Lane l scans reference rows l, l+32, ...
// straight from global memory (no shared tile, so no block barrier: a
// warp's insertions never hold another warp) and keeps a private sorted list
// of up to k keys in dynamic shared memory, laid out [slot][lane] so a
// warp's accesses fall in distinct banks.  No candidate is ever lost.  A
// final merge pops the warp-wide minimum of the list heads k times with
// __shfl_xor_sync.  Key ranks the candidates.
// ---------------------------------------------------------------------------

template <class L, class Key = ExactKey>
__global__ void knn_large_k_kernel(const float* __restrict__ q,
                                   const float* __restrict__ r, Members m,
                                   int k, int self_mode,
                                   float* __restrict__ out_d2,
                                   int* __restrict__ out_idx) {
    constexpr int W = L::kWidth;
    const Key key_of{};
    extern __shared__ unsigned long long lists[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.y;
    const int row = blockIdx.x * (blockDim.x >> 5) + warp;
    if (row >= m.q_rows) return;  // the whole warp leaves together
    const int nq = m.queries(b);
    const int nr = m.refs(b);
    q += (long long)b * m.q_rows * W;
    r += (long long)b * m.r_rows * W;
    const long long o = ((long long)b * m.q_rows + row) * k;
    if (row >= nq) {
        // a padded query row: absent slots, no search
        for (int s = lane; s < k; s += 32)
            write_slot(out_d2, out_idx, o + s, kEmpty);
        return;
    }
    const int keep = self_mode ? k - 1 : k;
    const int self_row = self_mode ? row : -1;
    unsigned long long* list = lists + (long long)warp * keep * 32;

    float qv[W];
    L::load_query(qv, q, row);
    for (int s = 0; s < keep; ++s) list[s * 32 + lane] = kEmpty;

    if (keep > 0) {
        unsigned long long worst = kEmpty;
        for (int j = lane; j < nr; j += 32) {
            const unsigned long long key = key_of(L::row_dist(qv, r, j), j);
            if (key < worst && j != self_row)
                worst = insert_lane_list(list, keep, lane, key);
        }
    }
    __syncwarp();

    int slot = 0;
    if (self_mode) {
        if (lane == 0) {
            out_d2[o] = 0.0f;
            out_idx[o] = row;
        }
        slot = 1;
    }
    merge_lane_lists(list, keep, lane, out_d2, out_idx, o, slot);
}

template <class L, int KP, class Key, int Cuts>
cudaError_t launch_small(const float* q, const float* r, int batch,
                         const Members& m, int k, int self_mode,
                         float* out_d2, int* out_idx, cudaStream_t stream) {
    const dim3 grid((m.q_rows + kSmallThreads - 1) / kSmallThreads, batch);
    knn_small_k_kernel<L, KP, Key, Cuts><<<grid, kSmallThreads, 0, stream>>>(
        q, r, m, k, self_mode, out_d2, out_idx);
    return cudaGetLastError();
}

template <class L, class Key = ExactKey, int Cuts = 0>
cudaError_t dispatch_small_k(const float* q, const float* r, int batch,
                             const Members& m, int k, int self_mode,
                             float* out_d2, int* out_idx,
                             cudaStream_t stream) {
    // keys kept per thread: k, less the self slot, rounded up to 2^m
    const int keep = self_mode ? k - 1 : k;
    if (keep <= 1)
        return launch_small<L, 1, Key, Cuts>(q, r, batch, m, k, self_mode, out_d2, out_idx, stream);
    if (keep <= 2)
        return launch_small<L, 2, Key, Cuts>(q, r, batch, m, k, self_mode, out_d2, out_idx, stream);
    if (keep <= 4)
        return launch_small<L, 4, Key, Cuts>(q, r, batch, m, k, self_mode, out_d2, out_idx, stream);
    if (keep <= 8)
        return launch_small<L, 8, Key, Cuts>(q, r, batch, m, k, self_mode, out_d2, out_idx, stream);
    if (keep <= 16)
        return launch_small<L, 16, Key, Cuts>(q, r, batch, m, k, self_mode, out_d2, out_idx, stream);
    return cudaErrorInvalidValue;
}

template <class L, class Key = ExactKey>
cudaError_t dispatch_large_k(const float* q, const float* r, int batch,
                             const Members& m, int k, int self_mode,
                             float* out_d2, int* out_idx,
                             cudaStream_t stream) {
    if (k > kLargeMaxK) return cudaErrorInvalidValue;
    const int keep = self_mode ? k - 1 : k;
    const int per_warp = (keep > 0 ? keep : 1) * 32 * (int)sizeof(unsigned long long);
    int warps = kLargeSmemTarget / per_warp;
    warps = warps < 1 ? 1 : (warps > kLargeMaxWarps ? kLargeMaxWarps : warps);
    const int smem = warps * per_warp;
    cudaError_t err = cudaFuncSetAttribute(
        knn_large_k_kernel<L, Key>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((m.q_rows + warps - 1) / warps, batch);
    knn_large_k_kernel<L, Key><<<grid, warps * 32, smem, stream>>>(
        q, r, m, k, self_mode, out_d2, out_idx);
    return cudaGetLastError();
}

using Dispatch = cudaError_t (*)(const float*, const float*, int,
                                 const Members&, int, int, float*, int*,
                                 cudaStream_t);

// The body of every C entry point: `d` is the launcher for the layout the
// caller asked for, or null when no layout fits its width.
inline cudaError_t run(Dispatch d, const float* q, const float* r, int batch,
                       int q_rows, int r_rows, const int* nq, const int* nr,
                       int nr_all, int k, int self_mode, float* out_d2,
                       int* out_idx, void* stream, int device) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (batch <= 0 || q_rows <= 0 || k <= 0) return cudaSuccess;
    if (batch > 65535 || d == nullptr) return cudaErrorInvalidValue;
    const Members m{q_rows, r_rows, nq, nr, nr_all};
    return d(q, r, batch, m, k, self_mode, out_d2, out_idx,
             static_cast<cudaStream_t>(stream));
}

}  // namespace knn
