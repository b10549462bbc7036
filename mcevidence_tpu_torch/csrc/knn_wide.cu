// The wide selection: hand-written Hopper kernels for the shapes past the
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
// runtime nr[b] and nq[b]), for any k <= the reference rows and any width d.
// Key is a policy of knn_common.cuh: ExactKey for the exact dispatch,
// TruncKey<11>/<12> for the packed selections, so K6/K7 and the forced K1
// keep the TPU's truncation order past k = 256.  The k smallest keys under
// the total order are unique, and d2 is summed in coordinate order with the
// same FMA as the two bodies (zero padding columns add exactly 0), so both
// routes return the same bits, and the same bits as the two bodies where
// those apply.
//
// Two routes; the wrapper (ops/knn_hopper.py:wide_plan) picks one from
// (d, keep = k - self_mode, low_bits):
//
// Route A, the warp-queue body: exact keys, d <= 64, keep <= 1024.  The
// large-k body's WarpSelect (knn_common.cuh) with a warp queue of N = 16 or
// 32 keys a lane (512 or 1024 keys) on Padded<DP> rows (the wrapper pads d
// to DP = 8/16/32/64), the query row in registers, one query row a warp,
// and the reference rows streamed through the large body's double-buffered
// coordinate-major cp.async tiles (stage_columns), one barrier a tile.  A
// merge into the warp queue costs ~N shuffles a register stage, so here the
// candidates do not wait in two-key thread queues (a merge whenever one
// lane holds two keys: ~3-4 keys a merge) but are appended by ballot to a
// buffer of 64 keys a warp in shared memory, and every merge takes 32 of
// them: one bitonic sort across the lanes, a fold against the warp queue's
// last register, a bitonic merge.  A query accepts ~k (1 + ln(N / k)) keys,
// so a row merges ~k (1 + ln(N / k)) / 32 times.  The block's warps are
// fixed per (DP, N) by kWarpRouteWarps.
//
// Route B, the list body: everything else (truncated keys past k = 256,
// d > 64, keep > 1024).  The width is a runtime value:
//   - a block of W warps takes 2 query rows a warp (kListQueries); the
//     block's query rows are staged once into shared memory, row-major with
//     a stride of d rounded up to 4 (zeros past d), and read as float4s;
//   - the reference rows pass through two coordinate-major tiles of 256
//     rows by 32 coordinates, tile[c * 257 + jj], filled by cp.async while
//     the block works on the other, one barrier a stage; a chunk shorter
//     than 32 coordinates is zero-padded to a multiple of 4.  Lane l takes
//     rows l, l + 32, ... (8 a lane, in distinct banks) against both of its
//     warp's query rows, so one tile read feeds two pairs;
//   - per query row a list of 2 kp keys (kp = the kept keys rounded up to a
//     power of two, at least 64): [0, kp) the kp smallest so far, sorted;
//     [kp, 2 kp) a buffer that takes the candidates under the threshold
//     (the list's keep-th key) by ballot.  When it can no longer take a
//     step's 32 keys, the buffer alone is sorted (kp keys) and folded into
//     the list: the elementwise min of the list and the reversed buffer
//     holds the kp smallest of both as a bitonic sequence, which one
//     bitonic merge of log2 kp stages sorts;
//   - the lists live in shared memory while a block's fit beside the tiles,
//     else in a global workspace of the caller's, one list per query row of
//     the launch, and the wrapper launches the query rows in chunks [row0,
//     row1) that keep the workspace bounded.  The choice is a template flag,
//     so shared lists are addressed as shared memory.
//
// Memory: route A, shared, the large body's two tiles (33 KB) and 512 B a
// warp; route B, shared, two tiles of 32 x 257 floats (64.3 KB), 8 floats a
// query row and 4 bytes a coordinate for the staged query rows, and unless
// the workspace holds them 16 kp bytes a query row.
//
// What bounds them on the H100: as for the two bodies, issuing the f32
// differences (2 instructions a coordinate a pair) and the shared reads
// beside them (route A: one a coordinate a pair; route B: one for two pairs),
// then the merges (route A: ~k (1 + ln(N / k)) / 32 a row, each ~N
// shuffles a stage).

#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_common.cuh"
#include "knn_padded.cuh"

namespace {

using knn::kEmpty;
using knn::kFullMask;

// ---------------------------------------------------------------------------
// Route A: the warp-queue body
// ---------------------------------------------------------------------------

constexpr int kWarpBuffer = 64;  // candidate keys a warp buffers

// warps a block of route A's body on Padded<DP> with N keys a lane: 16 (at
// most 128 registers a thread), but 8 (up to 255) for DP = 64 and N = 32,
// which spills 316 bytes at 16 warps.  Measured on the H100 at N=32768-65536
// rows: 16 warps take 74 ms against 106 at DP = 64, N = 16 and 30 against
// 38 at DP = 32, N = 32 (44 bytes of spills), and within 3% of 8 warps at
// the other pairs, none of which spills at 16 warps at DP <= 16.
__host__ __device__ constexpr int kWarpRouteWarps(int dp, int n) {
    return dp == 64 && n == 32 ? 8 : 16;
}

template <int DP>
__host__ __device__ constexpr int warp_shared_bytes(int warps) {
    return 2 * DP * knn::large_tile_stride<DP>() * (int)sizeof(float) +
           warps * kWarpBuffer * 8;
}

// Merge the first min(count, 32) buffered keys into the warp queue (those
// no longer under the threshold drop out), move the rest (count - 32 < 32)
// to the front of the buffer, and return how many remain.  Updates the
// threshold.
template <int N>
__device__ __forceinline__ int merge_buffer(unsigned long long (&warp_q)[N],
                                            unsigned long long* buf,
                                            int count,
                                            unsigned long long& threshold,
                                            int keep, int lane) {
    __syncwarp();  // every lane's appended keys are visible
    unsigned long long v = lane < count ? buf[lane] : kEmpty;
    if (v >= threshold) v = kEmpty;
    const int rest = count > 32 ? count - 32 : 0;
    if (lane < rest) buf[lane] = buf[32 + lane];
    if (__any_sync(kFullMask, v != kEmpty)) {
        v = knn::sort_lanes(v, lane);
        const unsigned long long rev = __shfl_xor_sync(kFullMask, v, 31);
        if (rev < warp_q[N - 1]) warp_q[N - 1] = rev;
        knn::merge_bitonic<N>(warp_q, lane);
        threshold = knn::kth_key<N>(warp_q, keep);
    }
    __syncwarp();  // the moved keys are visible before the next append
    return rest;
}

template <int DP, int N, int kWarps = kWarpRouteWarps(DP, N)>
__global__ void __launch_bounds__(kWarps * 32)
knn_warp_kernel(const float* __restrict__ q, const float* __restrict__ r,
                knn::Members m, int k, int self_mode,
                float* __restrict__ out_d2, int* __restrict__ out_idx) {
    using L = knn::Padded<DP>;
    constexpr int TR = knn::large_tile_rows<DP>();
    constexpr int S = knn::large_tile_stride<DP>();
    constexpr int kTileFloats = DP * S;
    const knn::ExactKey key_of{};
    // two tiles, then a buffer of kWarpBuffer keys a warp
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.y;
    const int nq = m.queries(b);
    const int nr = m.refs(b);
    q += (long long)b * m.q_rows * DP;
    r += (long long)b * m.r_rows * DP;
    out_d2 += (long long)b * m.q_rows * k;
    out_idx += (long long)b * m.q_rows * k;

    const int first = blockIdx.x * kWarps;
    const int row = first + warp;
    const int keep = self_mode ? k - 1 : k;
    if (row >= nq && row < m.q_rows) {
        // a padded query row: absent slots, no search
        for (int s = lane; s < k; s += 32)
            knn::write_slot(out_d2, out_idx, (long long)row * k + s, kEmpty);
    }
    const bool active = row < nq;  // the same in every lane of the warp
    if (active && self_mode && lane == 0) {
        out_d2[(long long)row * k] = 0.0f;
        out_idx[(long long)row * k] = row;
    }
    // the whole block is padding, or only the self slot is asked for
    if (first >= nq || keep <= 0) return;

    const int self_row = (self_mode && active) ? row : -1;
    float qv[DP] = {};
    if (active) L::load_query(qv, q, row);
    unsigned long long warp_q[N];
#pragma unroll
    for (int s = 0; s < N; ++s) warp_q[s] = kEmpty;
    unsigned long long threshold = kEmpty;
    int count = 0;  // keys in the warp's buffer
    unsigned long long* buf =
        reinterpret_cast<unsigned long long*>(smem + 2 * kTileFloats) +
        warp * kWarpBuffer;

    const int tiles = (nr + TR - 1) / TR;
    if (tiles > 0) {
        knn::stage_columns<L>(smem, r, 0, min(TR, nr));
        knn::copy_commit();
    }
    for (int t = 0; t < tiles; ++t) {
        const int base = t * TR;
        const int rows = min(TR, nr - base);
        knn::copy_wait();
        // tile t has landed everywhere, and every warp is done with the
        // buffer the next copy overwrites
        __syncthreads();
        if (t + 1 < tiles) {
            const int next = base + TR;
            knn::stage_columns<L>(smem + ((t + 1) & 1) * kTileFloats, r, next,
                                  min(TR, nr - next));
            knn::copy_commit();
        }
        if (!active) continue;
        const float* tile = smem + (t & 1) * kTileFloats;
        const int span = (rows + 31) & ~31;
        for (int jj = lane; jj < span; jj += 32) {
            float d2 = 0.0f;
#pragma unroll
            for (int c = 0; c < DP; ++c) {
                const float tt = qv[c] - tile[c * S + jj];
                d2 = fmaf(tt, tt, d2);
            }
            const int j = base + jj;
            const unsigned long long key = jj < rows ? key_of(d2, j) : kEmpty;
            const bool take = key < threshold && j != self_row;
            // one vote a step: the buffer changes only in the steps where a
            // lane of the warp takes a key
            const unsigned mask = __ballot_sync(kFullMask, take);
            if (mask == 0) continue;
            if (take) buf[count + __popc(mask & ((1u << lane) - 1u))] = key;
            count += __popc(mask);
            if (count >= 32)
                count = merge_buffer<N>(warp_q, buf, count, threshold, keep,
                                        lane);
        }
    }
    if (!active) return;
    if (count > 0) merge_buffer<N>(warp_q, buf, count, threshold, keep, lane);
    const long long o = (long long)row * k + (self_mode ? 1 : 0);
#pragma unroll
    for (int s = 0; s < N; ++s) {
        const int e = s * 32 + lane;
        if (e < keep) knn::write_slot(out_d2, out_idx, o + e, warp_q[s]);
    }
}

template <int DP, int N, int kWarps = kWarpRouteWarps(DP, N)>
cudaError_t launch_warp(const float* q, const float* r, int batch,
                        const knn::Members& m, int k, int self_mode,
                        float* out_d2, int* out_idx, cudaStream_t stream) {
    constexpr int smem = warp_shared_bytes<DP>(kWarps);
    static_assert(smem <= 48 * 1024, "route A's shared memory fits the "
                                     "default");
    const dim3 grid((m.q_rows + kWarps - 1) / kWarps, batch);
    knn_warp_kernel<DP, N, kWarps><<<grid, kWarps * 32, smem, stream>>>(
        q, r, m, k, self_mode, out_d2, out_idx);
    return cudaGetLastError();
}

// route A on Padded<dp> with a warp queue of kp = 32 N keys
cudaError_t dispatch_warp(int dp, int kp, const float* q, const float* r,
                          int batch, const knn::Members& m, int k,
                          int self_mode, float* out_d2, int* out_idx,
                          cudaStream_t stream) {
#define KNN_WARP_CASE(DP, N)                                              \
    if (dp == DP && kp == 32 * N)                                         \
        return launch_warp<DP, N>(q, r, batch, m, k, self_mode, out_d2, \
                                  out_idx, stream);
    KNN_WARP_CASE(8, 16)
    KNN_WARP_CASE(16, 16)
    KNN_WARP_CASE(32, 16)
    KNN_WARP_CASE(64, 16)
    KNN_WARP_CASE(8, 32)
    KNN_WARP_CASE(16, 32)
    KNN_WARP_CASE(32, 32)
    KNN_WARP_CASE(64, 32)
#undef KNN_WARP_CASE
    return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Route B: the list body
// ---------------------------------------------------------------------------

constexpr int kListTile = 256;              // reference rows a tile
constexpr int kListChunk = 32;              // coordinates a stage
constexpr int kListStride = kListTile + 1;  // floats between two coordinates
constexpr int kStageFloats = kListChunk * kListStride;
constexpr int kRowsPerLane = kListTile / 32;
constexpr int kListQueries = 2;             // query rows a warp
constexpr int kListMinKeys = 64;            // a step adds at most 32 keys
constexpr int kListMaxWarps = 16;
constexpr size_t kMaxShared = 227 * 1024;

// floats of a staged query row: d rounded up to 4, so rows start on 16
// bytes
__host__ __device__ inline int query_stride(int d) { return (d + 3) & ~3; }

__host__ __device__ inline size_t list_key_bytes(int kp, int warps) {
    return (size_t)warps * kListQueries * 2 * kp * 8;
}

__host__ __device__ inline size_t list_shared_bytes(int d, int kp, int warps,
                                                    bool global_keys) {
    return (global_keys ? 0 : list_key_bytes(kp, warps)) +
           (2 * (size_t)kStageFloats +
            (size_t)warps * kListQueries * query_stride(d)) *
               sizeof(float);
}

// coordinates [c0, c0 + dc) of reference rows [base, base + rows) into a
// coordinate-major tile by 4-byte cp.async (coalesced reads along each
// row); coordinates [dc, dc rounded up to 4) of those rows are set to 0
__device__ __forceinline__ void stage_chunk(float* tile, const float* r,
                                            int d, int base, int rows, int c0,
                                            int dc) {
    const float* src = r + (long long)base * d + c0;
    for (int t = threadIdx.x; t < rows * dc; t += blockDim.x) {
        const int jj = t / dc;
        const int c = t - jj * dc;
        knn::copy_async<1>(tile + c * kListStride + jj,
                           src + (long long)jj * d + c);
    }
    const int pad = query_stride(dc) - dc;
    for (int t = threadIdx.x; t < rows * pad; t += blockDim.x) {
        const int jj = t / pad;
        tile[(dc + t - jj * pad) * kListStride + jj] = 0.0f;
    }
}

// sort a[0, n) ascending (n a power of two) by the 32 lanes of a warp
__device__ __forceinline__ void sort_keys(unsigned long long* a, int n,
                                          int lane) {
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
            __syncwarp();
        }
    }
}

// fold the buffer keys[kp, 2 kp) into the sorted list keys[0, kp) and empty
// the buffer; returns the keep-th smallest key, the same in every lane
__device__ __forceinline__ unsigned long long merge_list(
        unsigned long long* keys, int kp, int keep, int lane) {
    unsigned long long* buf = keys + kp;
    __syncwarp();  // every lane's appended keys are visible
    sort_keys(buf, kp, lane);
    // the list ascending against the buffer descending: the elementwise min
    // holds the kp smallest of both, as a bitonic sequence
    for (int i = lane; i < kp; i += 32) {
        const unsigned long long y = buf[kp - 1 - i];
        if (y < keys[i]) keys[i] = y;
    }
    __syncwarp();
    for (int stride = kp >> 1; stride > 0; stride >>= 1) {
        for (int t = lane; t < (kp >> 1); t += 32) {
            const int lo = 2 * t - (t & (stride - 1));
            const int hi = lo + stride;
            const unsigned long long x = keys[lo], y = keys[hi];
            if (y < x) {
                keys[lo] = y;
                keys[hi] = x;
            }
        }
        __syncwarp();
    }
    const unsigned long long kth = keys[keep - 1];
    for (int i = lane; i < kp; i += 32) buf[i] = kEmpty;
    __syncwarp();
    return kth;
}

template <class Key, bool kGlobalLists>
__global__ void __launch_bounds__(kListMaxWarps * 32)
knn_list_kernel(const float* __restrict__ q, const float* __restrict__ r,
                knn::Members m, int d, int k, int self_mode, int kp,
                int row0, int row1, unsigned long long* work,
                float* __restrict__ out_d2, int* __restrict__ out_idx) {
    constexpr int R = kListQueries;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int warps = blockDim.x >> 5;
    const int qstride = query_stride(d);
    unsigned long long* shared_keys =
        reinterpret_cast<unsigned long long*>(smem_raw);
    float* tiles = reinterpret_cast<float*>(
        smem_raw + (kGlobalLists ? 0 : list_key_bytes(kp, warps)));
    float* qs = tiles + 2 * kStageFloats;
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

    const int first = row0 + blockIdx.x * warps * R;  // the block's rows
    const int end = min(row1, nq);  // rows of this launch that search
    const int keep = self_mode ? k - 1 : k;
    int row[R], self_row[R];
    bool active[R], any = false;
#pragma unroll
    for (int i = 0; i < R; ++i) {
        row[i] = first + warp * R + i;
        if (row[i] < row1 && row[i] >= nq) {
            // a padded query row: absent slots, no search
            for (int s = lane; s < k; s += 32)
                knn::write_slot(out_d2, out_idx, (long long)row[i] * k + s,
                                kEmpty);
        }
        active[i] = row[i] < end;  // the same in every lane of the warp
        any |= active[i];
        self_row[i] = (self_mode && active[i]) ? row[i] : -1;
        if (active[i] && self_mode && lane == 0) {
            out_d2[(long long)row[i] * k] = 0.0f;
            out_idx[(long long)row[i] * k] = row[i];
        }
    }
    // the whole block is padding, or only the self slot is asked for
    if (first >= end || keep <= 0) return;

    unsigned long long* keys[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        keys[i] = nullptr;
        if (!active[i]) continue;
        keys[i] = kGlobalLists
                      ? work + ((long long)b * (row1 - row0) + (row[i] - row0)) *
                                   2 * kp
                      : shared_keys + (long long)(warp * R + i) * 2 * kp;
        for (int e = lane; e < 2 * kp; e += 32) keys[i][e] = kEmpty;
    }
    // the block's query rows, once (visible after the first stage's barrier)
    for (int t = threadIdx.x; t < warps * R * qstride; t += blockDim.x) {
        const int w = t / qstride;
        const int c = t - w * qstride;
        const int qr = first + w;
        qs[t] = (qr < end && c < d) ? q[(long long)qr * d + c] : 0.0f;
    }

    const int chunks = (d + kListChunk - 1) / kListChunk;
    const int stages = (nr + kListTile - 1) / kListTile * chunks;
    if (stages > 0) {
        stage_chunk(tiles, r, d, 0, min(kListTile, nr), 0,
                    min(kListChunk, d));
        knn::copy_commit();
    }
    float acc[R][kRowsPerLane];
    unsigned long long threshold[R];
    int count[R];  // keys in each buffer
#pragma unroll
    for (int i = 0; i < R; ++i) {
        threshold[i] = kEmpty;
        count[i] = 0;
    }
    for (int s = 0; s < stages; ++s) {
        const int t = s / chunks;
        const int ch = s - t * chunks;
        const int base = t * kListTile;
        const int c0 = ch * kListChunk;
        knn::copy_wait();
        // stage s has landed everywhere, and every warp is done with the
        // buffer the next copy overwrites
        __syncthreads();
        if (s + 1 < stages) {
            const int t1 = (s + 1) / chunks;
            const int c1 = (s + 1 - t1 * chunks) * kListChunk;
            const int b1 = t1 * kListTile;
            stage_chunk(tiles + ((s + 1) & 1) * kStageFloats, r, d, b1,
                        min(kListTile, nr - b1), c1, min(kListChunk, d - c1));
            knn::copy_commit();
        }
        if (!any) continue;  // the same in every lane of the warp
        if (ch == 0) {
#pragma unroll
            for (int i = 0; i < R; ++i)
#pragma unroll
                for (int j = 0; j < kRowsPerLane; ++j) acc[i][j] = 0.0f;
        }
        const float* tile = tiles + (s & 1) * kStageFloats + lane;
        const float* qw = qs + warp * R * qstride + c0;
        const int dc4 = query_stride(min(kListChunk, d - c0));
        for (int c = 0; c < dc4; c += 4) {
            float qc[R][4];
#pragma unroll
            for (int i = 0; i < R; ++i) {
                const float4 v =
                    *reinterpret_cast<const float4*>(qw + i * qstride + c);
                qc[i][0] = v.x;
                qc[i][1] = v.y;
                qc[i][2] = v.z;
                qc[i][3] = v.w;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float* col = tile + (c + e) * kListStride;
#pragma unroll
                for (int j = 0; j < kRowsPerLane; ++j) {
                    const float x = col[32 * j];
#pragma unroll
                    for (int i = 0; i < R; ++i) {
                        const float tt = qc[i][e] - x;
                        acc[i][j] = fmaf(tt, tt, acc[i][j]);
                    }
                }
            }
        }
        if (ch + 1 < chunks) continue;
        // the tile's last chunk: its rows' d2 are whole
        const int rows = min(kListTile, nr - base);
#pragma unroll
        for (int i = 0; i < R; ++i) {
            if (!active[i]) continue;
#pragma unroll
            for (int j = 0; j < kRowsPerLane; ++j) {
                const int jj = lane + 32 * j;
                const int idx = base + jj;
                const unsigned long long key = key_of(acc[i][j], idx);
                const bool take =
                    jj < rows && idx != self_row[i] && key < threshold[i];
                const unsigned mask = __ballot_sync(kFullMask, take);
                if (mask == 0) continue;
                if (take)
                    keys[i][kp + count[i] +
                            __popc(mask & ((1u << lane) - 1u))] = key;
                count[i] += __popc(mask);
                if (count[i] > kp - 32) {
                    threshold[i] = merge_list(keys[i], kp, keep, lane);
                    count[i] = 0;
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
        if (!active[i]) continue;
        if (count[i] > 0) merge_list(keys[i], kp, keep, lane);
        __syncwarp();
        const long long o = (long long)row[i] * k + (self_mode ? 1 : 0);
        for (int e = lane; e < keep; e += 32)
            knn::write_slot(out_d2, out_idx, o + e, keys[i][e]);
    }
}

template <class Key>
cudaError_t launch_list(const float* q, const float* r, int batch,
                        const knn::Members& m, int d, int k, int self_mode,
                        int kp, int warps, int row0, int row1,
                        unsigned long long* work, float* out_d2,
                        int* out_idx, cudaStream_t stream) {
    const size_t smem = list_shared_bytes(d, kp, warps, work != nullptr);
    const auto kernel = work ? knn_list_kernel<Key, true>
                             : knn_list_kernel<Key, false>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int rows = warps * kListQueries;
    const dim3 grid((row1 - row0 + rows - 1) / rows, batch);
    kernel<<<grid, warps * 32, smem, stream>>>(q, r, m, d, k, self_mode, kp,
                                               row0, row1, work, out_d2,
                                               out_idx);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Arguments: those of knn_select.cu's entry points, with
//   d               route 0: the Padded width DP (8, 16, 32, 64) of rows
//                   zero-padded from the true width; route 1: the rows'
//                   width d >= 1 (rows of exactly d floats)
//   low_bits        0 (exact keys); route 1 also 11 or 12 (truncated keys)
//   route           0: the warp-queue body (A), 1: the list body (B)
//   kp              route 0: the warp queue's keys, 512 or 1024 (32 N),
//                   >= k - self_mode; route 1: the keys a list keeps, a
//                   power of two >= max(k - self_mode, 64)
//   warps           route 0: 0 (the body fixes its warps a block,
//                   kWarpRouteWarps); route 1: warps a block (1..16), two
//                   query rows each
//   row0, row1      the query rows of each member this launch takes (route
//                   0: all of them)
//   workspace       null (the lists in shared memory), or, route 1 only,
//                   [batch, row1 - row0, 2 kp] uint64 on the device
// Takes any 1 <= k <= r_rows.
int knn_select_wide(const float* q, const float* r, int batch, int q_rows,
                    int r_rows, const int* nq, const int* nr, int nr_all,
                    int d, int k, int self_mode, float* out_d2, int* out_idx,
                    void* stream, int device, int low_bits, int route, int kp,
                    int warps, int row0, int row1, void* workspace) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (batch <= 0 || q_rows <= 0 || k <= 0 || row1 <= row0)
        return cudaSuccess;
    const int keep = self_mode ? k - 1 : k;
    auto* work = static_cast<unsigned long long*>(workspace);
    if (batch > 65535 || row0 < 0 || row1 > q_rows || kp < keep)
        return cudaErrorInvalidValue;
    const knn::Members m{q_rows, r_rows, nq, nr, nr_all};
    const auto s = static_cast<cudaStream_t>(stream);
    if (route == 0) {
        if (low_bits != 0 || warps != 0 || work != nullptr || row0 != 0 ||
            row1 != q_rows)
            return cudaErrorInvalidValue;
        return static_cast<int>(dispatch_warp(d, kp, q, r, batch, m, k,
                                              self_mode, out_d2, out_idx, s));
    }
    if (route != 1 || d < 1 || warps < 1 || warps > kListMaxWarps ||
        kp < kListMinKeys || (kp & (kp - 1)) != 0 ||
        list_shared_bytes(d, kp, warps, work != nullptr) > kMaxShared)
        return cudaErrorInvalidValue;
    switch (low_bits) {
        case 0:
            err = launch_list<knn::ExactKey>(q, r, batch, m, d, k, self_mode,
                                             kp, warps, row0, row1, work,
                                             out_d2, out_idx, s);
            break;
        case 11:
            err = launch_list<knn::TruncKey<11>>(q, r, batch, m, d, k,
                                                 self_mode, kp, warps, row0,
                                                 row1, work, out_d2, out_idx,
                                                 s);
            break;
        case 12:
            err = launch_list<knn::TruncKey<12>>(q, r, batch, m, d, k,
                                                 self_mode, kp, warps, row0,
                                                 row1, work, out_d2, out_idx,
                                                 s);
            break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}

}  // extern "C"
