// The kNN selection kernels: candidate keys, the two selection bodies and
// their launchers, templated on a row layout and a key policy.  Each source
// instantiates the bodies for its own layouts and keys and defines its C
// entry points:
//   knn_select.cu  Padded<DP> (knn_padded.cuh): rows zero-padded to
//                  DP = 8/16/32/64 columns; exact keys
//   knn_smalld.cu  Compact<D>: rows of exactly D <= 16 columns; exact keys
//   knn_packed.cu  Padded<DP>; truncated keys (TruncKey<B>), and the
//                  prologue-cut small-k body
// Each source builds into a library of its own (ops/_build.py), loaded at
// the first call of one of its entry points.  knn_wide.cu holds the bodies
// for the shapes past these bodies' limits (k > 256, or rows wider than 64
// columns), on the same keys and the same contract: a warp-queue body
// built from the large-k body's parts, and a list body for a runtime width.
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
//   rechecks                 an int64 counter on the device, or null: the
//                            small-k body adds the pairs its screen passed
//                            to the exact recheck (below); the large-k body
//                            counts nothing
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
// Both bodies keep the k smallest keys under this total order, so every
// design of them returns the same bits.
//
// A layout L provides
//   kWidth       floats per row as laid out
//   kVec         floats per asynchronous copy of a row piece: 4 where every
//                row starts on 16 bytes (Padded), else 1
//   load_query(qv, q, row)      query row `row` into registers
// The bodies stage reference rows into shared memory themselves.
//
// Each launcher returns cudaGetLastError() after its launch; it allocates
// nothing and does not synchronise.
//
// What bounds the bodies on the H100, and what the design does about it.
// The TPU kernels (K1-K9, mcevidence_tpu/ops/knn_pallas.py) take d2 by the
// matrix identity on the matrix unit.  Here the exact contract rules that
// out as the returned d2, in TF32, 3xTF32 or f32 alike: `fast` consumes
// it, and near neighbours in whitened space (d2 ~ 0.06 against |q|^2 ~ 8)
// would lose ~1e-5 of it to cancellation.  So every returned d2 is a sum of
// differences on the CUDA cores, 2 f32 instructions a coordinate (subtract,
// FMA).  The bound of the TPU kernel's matrix work (2 d flops a pair at the
// f32 peak) is 1.03 ms at N = 65536, d = 8, and 263 ms at N = 2^20: one
// FMA a coordinate a pair.
//   small-k  bound by instruction issue: every shared read, compare and
//            branch is one more instruction a pair.  So the identity serves
//            as a screen that is never stricter than the exact compare,
//            and only the pairs it passes are recomputed by differences:
//            - a pair's score is W FMAs from a start value of its tile
//              row's: s = -|r|^2 (1 - e) / 2 + sum_c q_c r_c, in coordinate
//              order, which is -(d2 - |q|^2) / 2 up to rounding, so a pair
//              costs one FMA a coordinate where the differences cost two.
//              The block computes the start values of a step's rows in
//              shared memory (one row a thread, W FMAs, one more barrier a
//              step); a thread holds up to two query rows, so one broadcast
//              read of a tile row (and of its start value) feeds both;
//            - a query row's floor is -((w (1 + e) + 2^-100) - |q|^2 (1 -
//              e)) / 2 in two FMAs, with w the largest d2 whose key can
//              still beat the worst kept key (its high word under ExactKey;
//              under TruncKey<B> that word with its B low bits set, the
//              next truncation step less one ulp: Key::widest); it is
//              rebuilt only after an insert.  The four scores of a screen's
//              tile rows are folded by fmaxf and compared once, as !(most <
//              floor);
//            - only inside a passing screen, and only for a pair whose own
//              score passes, is d2 recomputed by differences, keyed and
//              inserted exactly as before (the self test last), so a pair
//              enters the list iff its exact key beats the worst kept key:
//              the returned (d2, idx) keep their bits for every key policy.
//            The slack e = (W + 2) 2^-19 is 8x what the screen needs, from
//            Higham's gamma_n = n u / (1 - n u), u = 2^-24: the difference
//            form's d2 lies within gamma_(W+2) d2 of the real |q - r|^2;
//            |r|^2 and |q|^2 are W-term FMA sums (within gamma_W); the
//            score's W FMAs onto its start value add at most gamma_W
//            (|r|^2 + 2 |q| |r|) <= gamma_W (2 |r|^2 + |q|^2); the floor's
//            two FMAs round once each.  So a pair whose difference-form d2
//            is <= w scores >= its row's floor once e >= 3 gamma_W + 2 u
//            and e >= gamma_(W+2) + 2 u, i.e. e = 4 (W + 2) u suffices,
//            and the 2^-100 covers the subnormal range.  A screen passes
//            everything while a list holds kEmpty or an infinite or NaN key
//            (floor -inf), for a query row with |q|^2 > 2^100 or NaN (so
//            no score overflows), and for a tile row with |r|^2 > 2^126 or
//            NaN (start value +inf); a NaN score is hidden by fmaxf only
//            where a coordinate of r is inf or NaN, whose exact d2 is inf
//            or NaN and beats no finite worst key.  kCutBound's 1e18 rows
//            (|r|^2 <= 6.4e37 < 2^126) are screened like any other.  A
//            loose slack costs rechecks, never results: ~k (1 + ln(N /
//            2k)) a query row and part, under 0.03% of the pairs at 2^20.
//            Two threads share each query row, one tile each, so a card
//            holds twice the warps, and merge their lists at the end; the
//            tiles are double-buffered with cp.async.
//   large-k  WarpSelect (Johnson, Douze and Jegou, arXiv:1702.08734): a
//            warp's lanes take 32 different reference rows at a time from
//            a coordinate-major shared tile (conflict-free), against one
//            warp-wide threshold, the k-th key of a warp queue sorted
//            across the registers; only keys under it enter a lane's short
//            thread queue, one vote a step finds the rare step that queued
//            one, and a full queue anywhere in the warp merges all of them
//            into the warp queue by bitonic networks of __shfl_xor_sync.  A
//            query accepts ~k (1 + ln(N / k)) keys, so the sweep, not the
//            selection, sets the time; one tile load feeds every warp of
//            the block.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace knn {

constexpr unsigned long long kEmpty = 0xFFFFFFFFFFFFFFFFull;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kSmallThreads = 128;
constexpr int kTile = 128;             // reference rows per small-k tile
constexpr int kScreen = 4;             // small-k tile rows a screen
constexpr int kSplit = 2;              // small-k threads a query row
static_assert(kTile % kScreen == 0, "a screen never crosses a tile");
constexpr int kLargeMaxK = 256;
constexpr int kLargeWarps = 16;        // warps per large-k block
constexpr int kLargeTileFloats = 4096;  // floats of one large-k tile
constexpr int kThreadQueue = 2;        // keys a lane holds between merges

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

__device__ __forceinline__ unsigned high_word(unsigned long long key) {
    return static_cast<unsigned>(key >> 32);
}

// A key policy also gives widest(h): the largest f32 bits of a d2 >= 0 whose
// key's high word is at most h, the small-k screen's threshold.

// the exact ranking: every bit of d2
struct ExactKey {
    __device__ __forceinline__ unsigned long long operator()(float d2,
                                                             int j) const {
        return make_key(d2, j);
    }
    static __device__ __forceinline__ unsigned widest(unsigned h) {
        return h;
    }
};

// the TPU packed kernels' ranking: d2's f32 bits with the low B mantissa
// bits cleared, above the index (knn_packed.cu, knn_wide.cu)
template <int B>
struct TruncKey {
    static_assert(0 < B && B < 23, "B clears mantissa bits only");
    static constexpr unsigned kLow = (1u << B) - 1u;
    __device__ __forceinline__ unsigned long long operator()(float d2,
                                                             int j) const {
        return (static_cast<unsigned long long>(__float_as_uint(d2) & ~kLow)
                << 32) |
               static_cast<unsigned>(j);
    }
    static __device__ __forceinline__ unsigned widest(unsigned h) {
        return h | kLow;
    }
};

// The prologue study's compile-time cut of the small-k body (knn_packed.cu):
//   kCutBound  the reference allocation is padded by the caller to a multiple
//              of kTile with sentinel rows (1e18 in every column) and nr is
//              that padded count: every tile is full, so the inner loop has
//              no min(kTile, nr - base) bound; a slot whose d2 > 1e30 (a
//              sentinel) comes back absent
// (The study's cut C, the self test only where it can matter, is part of
// every small-k body.)
constexpr int kCutBound = 1;

__device__ __forceinline__ void write_slot(float* out_d2, int* out_idx,
                                           long long pos,
                                           unsigned long long key) {
    if (key == kEmpty) {
        out_d2[pos] = __int_as_float(0x7F800000);
        out_idx[pos] = -1;
    } else {
        out_d2[pos] = __uint_as_float(high_word(key));
        out_idx[pos] = static_cast<int>(key & 0xFFFFFFFFull);
    }
}

// ---------------------------------------------------------------------------
// Asynchronous copies from global to shared memory (cp.async): a 16-byte
// copy bypasses L1, a 4-byte one goes through it.
// ---------------------------------------------------------------------------

template <int V>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
    static_assert(V == 1 || V == 4, "cp.async copies 4 or 16 bytes");
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (V == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                     "l"(src)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                     "l"(src)
                     : "memory");
}

__device__ __forceinline__ void copy_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_wait() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The small-k body (k_sel < 14).  Each thread holds R query rows (R = 2 up
// to 16 columns and k - self_mode <= 8, else 1), blockIdx.y the batch
// member, and kSplit threads share each query row.  The block streams the
// member's reference rows a step of kSplit tiles of kTile rows at a time,
// laid out as in global memory: while the block reads one step, cp.async
// fills the other buffer; once a step has landed, each thread computes one
// of its rows' screen start values (screen_start) into shared memory, and
// part h of the threads takes tile h of the step, two barriers a step.
// Every thread of a part reads the same tile row at the same time (a
// broadcast, no bank conflict) and scores R pairs from it; only the pairs
// the screen passes are recomputed by differences and keyed (sweep_tile).
// Each thread keeps its sorted top-KP keys per row in registers (KP is k
// rounded up to a power of two, so every index into the list is static) and
// inserts by one compare-swap pass; at the end the other parts hand their
// lists to part 0 through shared memory.  Key ranks the candidates; Cuts is
// the prologue study's kCutBound or 0.
// ---------------------------------------------------------------------------

template <int W, int KP>
__host__ __device__ constexpr int small_rows() {
    return W <= 16 && KP <= 8 ? 2 : 1;
}

// The screen's constants (see "What bounds the bodies" above): the relative
// slack e of a W-column row, the absolute slack of a floor, and the squared
// norms past which a query row's screen or a tile row's score passes
// everything.
template <int W>
__host__ __device__ constexpr float screen_slack() {
    return (W + 2) * 0x1p-19f;
}
constexpr float kScreenAbsSlack = 0x1p-100f;
constexpr float kQueryNormCap = 0x1p100f;
constexpr float kRowNormCap = 0x1p126f;

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

// reference rows [base, base + rows) into `tile` as laid out in global memory
template <class L>
__device__ __forceinline__ void stage_rows(float* tile, const float* r,
                                           int base, int rows) {
    constexpr int V = L::kVec;
    const float* src = r + (long long)base * L::kWidth;
    for (int t = threadIdx.x; t < rows * (L::kWidth / V); t += blockDim.x)
        copy_async<V>(tile + t * V, src + (long long)t * V);
}

// columns [c, c + V) of a staged row: one 16-byte read where V = 4
template <int V>
__device__ __forceinline__ void load_piece(float (&v)[V], const float* at) {
    if constexpr (V == 4) {
        const float4 x = *reinterpret_cast<const float4*>(at);
        v[0] = x.x;
        v[1] = x.y;
        v[2] = x.z;
        v[3] = x.w;
    } else {
        v[0] = at[0];
    }
}

// |x|^2 of a query row in registers, summed in coordinate order
template <int W>
__device__ __forceinline__ float square_norm(const float (&x)[W]) {
    float n = 0.0f;
#pragma unroll
    for (int c = 0; c < W; ++c) n = fmaf(x[c], x[c], n);
    return n;
}

// A staged row's screen start value, -|r|^2 (1 - e) / 2 (|r|^2 summed in
// coordinate order), or +inf (its scores pass) where |r|^2 is past
// kRowNormCap or NaN.
template <class L>
__device__ __forceinline__ float screen_start(const float* row) {
    constexpr int W = L::kWidth, V = L::kVec;
    float n = 0.0f;
#pragma unroll
    for (int c = 0; c < W; c += V) {
        float v[V];
        load_piece<V>(v, row + c);
#pragma unroll
        for (int e = 0; e < V; ++e) n = fmaf(v[e], v[e], n);
    }
    return n <= kRowNormCap ? n * (-0.5f * (1.0f - screen_slack<W>()))
                            : __int_as_float(0x7F800000);
}

// A query row's floor: a pair whose key can beat `worst` scores at least
// this.  -inf (everything passes) while the list holds kEmpty or an
// infinite or NaN key, and where |q|^2 (qn) is past kQueryNormCap or NaN.
template <class Key, int W>
__device__ __forceinline__ float screen_floor(unsigned long long worst,
                                              float qn) {
    constexpr float e = screen_slack<W>();
    const unsigned h = Key::widest(high_word(worst));
    if (h >= 0x7F800000u || !(qn <= kQueryNormCap))
        return -__int_as_float(0x7F800000);
    return -0.5f * fmaf(-qn, 1.0f - e,
                        fmaf(__uint_as_float(h), 1.0f + e, kScreenAbsSlack));
}

// The screen's scores of R query rows against one staged reference row,
// each W FMAs onto the row's start value in coordinate order.
template <class L, int R>
__device__ __forceinline__ void row_scores(float (&s)[R],
                                           const float (&qv)[R][L::kWidth],
                                           const float* row, float start) {
    constexpr int W = L::kWidth, V = L::kVec;
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] = start;
#pragma unroll
    for (int c = 0; c < W; c += V) {
        float v[V];
        load_piece<V>(v, row + c);
#pragma unroll
        for (int e = 0; e < V; ++e) {
#pragma unroll
            for (int i = 0; i < R; ++i) s[i] = fmaf(qv[i][c + e], v[e], s[i]);
        }
    }
}

// d2 of one query row to one staged reference row, the sum of squared
// differences in coordinate order: the value the list keeps and returns
template <class L>
__device__ __forceinline__ float row_dist(const float (&q)[L::kWidth],
                                          const float* row) {
    constexpr int W = L::kWidth, V = L::kVec;
    float d2 = 0.0f;
#pragma unroll
    for (int c = 0; c < W; c += V) {
        float v[V];
        load_piece<V>(v, row + c);
#pragma unroll
        for (int e = 0; e < V; ++e) {
            const float t = q[c + e] - v[e];
            d2 = fmaf(t, t, d2);
        }
    }
    return d2;
}

// Tile rows [0, rows) (reference rows base + jj, start values start[jj])
// against a thread's R query rows: kScreen rows' scores at a time, then one
// screen a query row, the largest of its scores against its floor; inside a
// passing screen each pair whose own score passes is recomputed by
// differences (counted in `checked`), keyed and inserted, and the floor is
// rebuilt after an insert.  Two screens a loop pass (unrolled: 3% faster at
// 2^20 rows on the H100).  kWhole: rows == kTile, so no row of a screen lies
// past `rows`.
template <class L, int R, int KP, class Key, bool kWhole>
__device__ __forceinline__ void sweep_tile(
        unsigned long long (&best)[R][KP], float (&floor)[R],
        const float (&qv)[R][L::kWidth], const float (&qn)[R],
        const bool (&active)[R], const float* tile, const float* start,
        int base, int rows, const int (&self_row)[R], unsigned& checked) {
    constexpr int W = L::kWidth;
    const Key key_of{};
    const int span = kWhole ? kTile : rows;
#pragma unroll 2
    for (int jj = 0; jj < span; jj += kScreen) {
        float s[kScreen][R];
#pragma unroll
        for (int g = 0; g < kScreen; ++g)
            row_scores<L, R>(s[g], qv, tile + (jj + g) * W, start[jj + g]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
            float most = s[0][i];  // row jj lies before `rows`
#pragma unroll
            for (int g = 1; g < kScreen; ++g)
                if (kWhole || jj + g < rows) most = fmaxf(most, s[g][i]);
            if (most < floor[i]) continue;
            bool moved = false;
#pragma unroll
            for (int g = 0; g < kScreen; ++g) {
                if (!(kWhole || jj + g < rows) || !active[i] ||
                    s[g][i] < floor[i])
                    continue;
                ++checked;
                const int j = base + jj + g;
                const unsigned long long key =
                    key_of(row_dist<L>(qv[i], tile + (jj + g) * W), j);
                if (key < best[i][KP - 1] && j != self_row[i]) {
                    insert_sorted<KP>(best[i], key);
                    moved = true;
                }
            }
            if (moved) floor[i] = screen_floor<Key, W>(best[i][KP - 1], qn[i]);
        }
    }
}

template <class L, int KP, class Key = ExactKey, int Cuts = 0>
__global__ void __launch_bounds__(kSmallThreads * kSplit)
knn_small_k_kernel(const float* __restrict__ q, const float* __restrict__ r,
                   Members m, int k, int self_mode,
                   float* __restrict__ out_d2, int* __restrict__ out_idx,
                   unsigned long long* __restrict__ rechecks) {
    constexpr int W = L::kWidth;
    constexpr int R = small_rows<W, KP>();
    constexpr int kStep = kSplit * kTile;       // reference rows a step
    constexpr int kStepFloats = kStep * W;
    extern __shared__ __align__(16) float smem[];  // two steps' tiles
    __shared__ float starts[kStep];  // the current step's start values
    const int b = blockIdx.y;
    const int nq = m.queries(b);
    const int nr = m.refs(b);
    q += (long long)b * m.q_rows * W;
    r += (long long)b * m.r_rows * W;
    out_d2 += (long long)b * m.q_rows * k;
    out_idx += (long long)b * m.q_rows * k;

    // kSplit threads share each query row; part h takes tile h of a step
    const int part = threadIdx.x / kSmallThreads;
    const int lane_row = threadIdx.x % kSmallThreads;
    const int first = blockIdx.x * (R * kSmallThreads);
    int row[R], self_row[R];
    bool active[R], any = false;
#pragma unroll
    for (int i = 0; i < R; ++i) {
        row[i] = first + i * kSmallThreads + lane_row;
        if (part == 0 && row[i] >= nq && row[i] < m.q_rows) {
            // a padded query row: absent slots, no search
            for (int s = 0; s < k; ++s)
                write_slot(out_d2, out_idx, (long long)row[i] * k + s,
                           kEmpty);
        }
        active[i] = row[i] < nq;
        any |= active[i];
        self_row[i] = (self_mode && active[i]) ? row[i] : -1;
    }
    if (first >= nq) return;  // the whole block is padding

    float qv[R][W] = {};
    float qn[R], floor[R];
    unsigned long long best[R][KP];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        if (active[i]) L::load_query(qv[i], q, row[i]);
        qn[i] = square_norm<W>(qv[i]);
#pragma unroll
        for (int s = 0; s < KP; ++s) best[i][s] = kEmpty;
        // an inactive row's screen passes nothing finite
        floor[i] = active[i] ? screen_floor<Key, W>(kEmpty, qn[i])
                             : __int_as_float(0x7F800000);
    }
    unsigned checked = 0;

    const int steps = (nr + kStep - 1) / kStep;
    if (steps > 0) {
        stage_rows<L>(smem, r, 0, min(kStep, nr));
        copy_commit();
    }
    for (int t = 0; t < steps; ++t) {
        const int base = t * kStep + part * kTile;
        // rows of this part's tile that lie before nr; with kCutBound nr is
        // a multiple of kTile, so a tile is whole or past the end
        const int left = nr - base;
        const float* step = smem + (t & 1) * kStepFloats;
        copy_wait();
        // step t has landed everywhere, and every thread is done with the
        // buffer the next copy overwrites and with the start values
        __syncthreads();
        if (t + 1 < steps) {
            const int next = (t + 1) * kStep;
            stage_rows<L>(smem + ((t + 1) & 1) * kStepFloats, r, next,
                          min(kStep, nr - next));
            copy_commit();
        }
        for (int x = threadIdx.x; x < min(kStep, nr - t * kStep);
             x += blockDim.x)
            starts[x] = screen_start<L>(step + x * W);
        __syncthreads();
        if (!any) continue;
        const float* tile = step + part * (kTile * W);
        const float* start = starts + part * kTile;
        if (left >= kTile)
            sweep_tile<L, R, KP, Key, true>(best, floor, qv, qn, active, tile,
                                            start, base, kTile, self_row,
                                            checked);
        else if (!(Cuts & kCutBound) && left > 0)
            sweep_tile<L, R, KP, Key, false>(best, floor, qv, qn, active,
                                             tile, start, base, left,
                                             self_row, checked);
    }
    if (rechecks != nullptr) {
        // the block's rechecks, one global atomic a block
        __shared__ unsigned long long block_checked;
        if (threadIdx.x == 0) block_checked = 0;
        __syncthreads();
        atomicAdd(&block_checked, static_cast<unsigned long long>(checked));
        __syncthreads();
        if (threadIdx.x == 0) atomicAdd(rechecks, block_checked);
    }
    if (kSplit > 1) {
        // parts 1.. hand their lists to part 0 through shared memory, one
        // query row of the thread at a time
        unsigned long long* lists = reinterpret_cast<unsigned long long*>(smem);
#pragma unroll
        for (int i = 0; i < R; ++i) {
            __syncthreads();
            if (part > 0) {
#pragma unroll
                for (int s = 0; s < KP; ++s)
                    lists[((part - 1) * KP + s) * kSmallThreads + lane_row] =
                        best[i][s];
            }
            __syncthreads();
            if (part == 0 && active[i]) {
                for (int h = 0; h < kSplit - 1; ++h) {
#pragma unroll
                    for (int s = 0; s < KP; ++s) {
                        const unsigned long long key =
                            lists[(h * KP + s) * kSmallThreads + lane_row];
                        if (key < best[i][KP - 1])
                            insert_sorted<KP>(best[i], key);
                    }
                }
            }
        }
    }
    if (part > 0) return;
#pragma unroll
    for (int i = 0; i < R; ++i) {
        if (!active[i]) continue;
        const long long o = (long long)row[i] * k;
        int slot = 0;
        if (self_mode) {
            out_d2[o] = 0.0f;
            out_idx[o] = row[i];
            slot = 1;
        }
#pragma unroll
        for (int s = 0; s < KP; ++s) {
            unsigned long long key = best[i][s];
            // a sentinel row won the slot: fewer valid candidates than k
            if ((Cuts & kCutBound) && key != kEmpty &&
                __uint_as_float(high_word(key)) > 1e30f)
                key = kEmpty;
            if (slot + s < k) write_slot(out_d2, out_idx, o + slot + s, key);
        }
    }
}

// ---------------------------------------------------------------------------
// The large-k body (14 <= k_sel <= 256), WarpSelect.  A block of kLargeWarps
// warps, each owning QW query rows (2 up to 16 columns and 64 keys, else 1),
// blockIdx.y the batch member.  The block streams the member's reference rows through
// two coordinate-major shared tiles, tile[c * S + jj], filled by 4-byte
// cp.async from coalesced global reads (S pads each coordinate's run so the
// copies' stores fall in distinct banks too), one barrier a tile.  Lane l
// takes tile rows l, l + 32, ...: 32 rows at once, in distinct banks.
//
// Per query row: a warp queue of the 32 N smallest keys seen (N = 1, 2, 4
// or 8 keys a lane, 32 N >= k), sorted across the warp with element e in
// register e / 32 of lane e % 32; the threshold, its keep-th key, the same
// in every lane; and in each lane a thread queue of up to kThreadQueue keys
// under the threshold.  One vote a step tells whether any lane took a key;
// only then does the warp ask whether a lane's queue is full, and if so it
// merges every lane's queue, one key a lane a round: the round's 32 keys
// are sorted by a bitonic network across the lanes, folded into the warp
// queue's last register against their reverse (which leaves the 32 N
// smallest as a bitonic sequence), and the warp queue is re-sorted by a
// bitonic merge.  Keys that no longer beat the threshold drop out first.
// ---------------------------------------------------------------------------

template <int W, int N>
__host__ __device__ constexpr int large_queries() {
    return W <= 16 && N <= 2 ? 2 : 1;
}

// reference rows per large-k tile: a power of two, with the tile within
// kLargeTileFloats
template <int W>
__host__ __device__ constexpr int large_tile_rows() {
    int t = 1024;
    while (t > 32 && t * W > kLargeTileFloats) t >>= 1;
    return t;
}

// floats between two coordinates' runs: 32 consecutive copies (t / W rows,
// t % W columns) land in distinct banks when S = ceil(32 / W) mod 32
template <int W>
__host__ __device__ constexpr int large_tile_stride() {
    return large_tile_rows<W>() + (32 + W - 1) / W;
}

// reference rows [base, base + rows) into `tile` coordinate-major
template <class L>
__device__ __forceinline__ void stage_columns(float* tile, const float* r,
                                              int base, int rows) {
    constexpr int W = L::kWidth, S = large_tile_stride<W>();
    const float* src = r + (long long)base * W;
    for (int t = threadIdx.x; t < rows * W; t += blockDim.x) {
        const int jj = t / W;
        copy_async<1>(tile + (t - jj * W) * S + jj, src + t);
    }
}

__device__ __forceinline__ void compare_lanes(unsigned long long& v,
                                              int stride, bool keep_min) {
    const unsigned long long o = __shfl_xor_sync(kFullMask, v, stride);
    v = (keep_min == (o < v)) ? o : v;
}

// sort one key a lane ascending across the warp (bitonic)
__device__ __forceinline__ unsigned long long sort_lanes(unsigned long long v,
                                                         int lane) {
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
        const bool up = (lane & size) == 0;
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1)
            compare_lanes(v, stride, ((lane & stride) == 0) == up);
    }
    return v;
}

// sort a bitonic sequence of 32 N keys (element e: register e / 32, lane
// e % 32) ascending
template <int N>
__device__ __forceinline__ void merge_bitonic(unsigned long long (&a)[N],
                                              int lane) {
#pragma unroll
    for (int s = N / 2; s > 0; s >>= 1) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
            if (i & s) continue;
            const unsigned long long lo = a[i] < a[i + s] ? a[i] : a[i + s];
            const unsigned long long hi = a[i] < a[i + s] ? a[i + s] : a[i];
            a[i] = lo;
            a[i + s] = hi;
        }
    }
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
#pragma unroll
        for (int i = 0; i < N; ++i)
            compare_lanes(a[i], stride, (lane & stride) == 0);
    }
}

// the keep-th smallest key of a sorted warp queue, in every lane
template <int N>
__device__ __forceinline__ unsigned long long kth_key(
        const unsigned long long (&a)[N], int keep) {
    const int reg = (keep - 1) >> 5;
    unsigned long long v = a[0];
#pragma unroll
    for (int i = 1; i < N; ++i)
        if (i == reg) v = a[i];
    return __shfl_sync(kFullMask, v, (keep - 1) & 31);
}

// merge every lane's thread queue into the warp queue; updates the
// threshold and empties the thread queues
template <int N>
__device__ __forceinline__ void merge_queues(
        unsigned long long (&warp_q)[N],
        unsigned long long (&thread_q)[kThreadQueue], int& count,
        unsigned long long& threshold, int keep, int lane) {
#pragma unroll
    for (int s = 0; s < kThreadQueue; ++s) {
        unsigned long long v =
            (s < count && thread_q[s] < threshold) ? thread_q[s] : kEmpty;
        if (!__any_sync(kFullMask, v != kEmpty)) continue;
        v = sort_lanes(v, lane);
        const unsigned long long rev = __shfl_xor_sync(kFullMask, v, 31);
        if (rev < warp_q[N - 1]) warp_q[N - 1] = rev;
        merge_bitonic<N>(warp_q, lane);
        threshold = kth_key<N>(warp_q, keep);
    }
    count = 0;
}

template <class L, int N, class Key = ExactKey>
__global__ void __launch_bounds__(kLargeWarps * 32)
knn_large_k_kernel(const float* __restrict__ q, const float* __restrict__ r,
                   Members m, int k, int self_mode,
                   float* __restrict__ out_d2, int* __restrict__ out_idx) {
    constexpr int W = L::kWidth;
    constexpr int QW = large_queries<W, N>();
    constexpr int TR = large_tile_rows<W>();
    constexpr int S = large_tile_stride<W>();
    constexpr int kTileFloats = W * S;
    const Key key_of{};
    extern __shared__ __align__(16) float smem[];  // two tiles
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.y;
    const int nq = m.queries(b);
    const int nr = m.refs(b);
    q += (long long)b * m.q_rows * W;
    r += (long long)b * m.r_rows * W;
    out_d2 += (long long)b * m.q_rows * k;
    out_idx += (long long)b * m.q_rows * k;

    const int first = blockIdx.x * (kLargeWarps * QW);
    const int keep = self_mode ? k - 1 : k;
    int row[QW], self_row[QW];
    bool active[QW], any = false;
#pragma unroll
    for (int i = 0; i < QW; ++i) {
        row[i] = first + warp * QW + i;
        if (row[i] >= nq && row[i] < m.q_rows) {
            // a padded query row: absent slots, no search
            for (int s = lane; s < k; s += 32)
                write_slot(out_d2, out_idx, (long long)row[i] * k + s,
                           kEmpty);
        }
        active[i] = row[i] < nq;
        any |= active[i];
        self_row[i] = (self_mode && active[i]) ? row[i] : -1;
        if (active[i] && self_mode && lane == 0) {
            out_d2[(long long)row[i] * k] = 0.0f;
            out_idx[(long long)row[i] * k] = row[i];
        }
    }
    // the whole block is padding, or only the self slot is asked for
    if (first >= nq || keep <= 0) return;

    float qv[QW][W] = {};
    unsigned long long warp_q[QW][N], thread_q[QW][kThreadQueue];
    unsigned long long threshold[QW];
    int count[QW];
#pragma unroll
    for (int i = 0; i < QW; ++i) {
        if (active[i]) L::load_query(qv[i], q, row[i]);
#pragma unroll
        for (int s = 0; s < N; ++s) warp_q[i][s] = kEmpty;
#pragma unroll
        for (int s = 0; s < kThreadQueue; ++s) thread_q[i][s] = kEmpty;
        threshold[i] = kEmpty;
        count[i] = 0;
    }

    const int tiles = (nr + TR - 1) / TR;
    if (tiles > 0) {
        stage_columns<L>(smem, r, 0, min(TR, nr));
        copy_commit();
    }
    for (int t = 0; t < tiles; ++t) {
        const int base = t * TR;
        const int rows = min(TR, nr - base);
        copy_wait();
        // tile t has landed everywhere, and every warp is done with the
        // buffer the next copy overwrites
        __syncthreads();
        if (t + 1 < tiles) {
            const int next = base + TR;
            stage_columns<L>(smem + ((t + 1) & 1) * kTileFloats, r, next,
                             min(TR, nr - next));
            copy_commit();
        }
        if (!any) continue;  // the same in every lane of the warp
        const float* tile = smem + (t & 1) * kTileFloats;
        const int span = (rows + 31) & ~31;
        for (int jj = lane; jj < span; jj += 32) {
            float d2[QW];
#pragma unroll
            for (int i = 0; i < QW; ++i) d2[i] = 0.0f;
#pragma unroll
            for (int c = 0; c < W; ++c) {
                const float x = tile[c * S + jj];
#pragma unroll
                for (int i = 0; i < QW; ++i) {
                    const float tt = qv[i][c] - x;
                    d2[i] = fmaf(tt, tt, d2[i]);
                }
            }
            const int j = base + jj;
            unsigned long long key[QW];
            bool take[QW], any_take = false;
#pragma unroll
            for (int i = 0; i < QW; ++i) {
                key[i] = (jj < rows && active[i]) ? key_of(d2[i], j) : kEmpty;
                take[i] = key[i] < threshold[i] && j != self_row[i];
                any_take |= take[i];
            }
            // one vote a step: the queues change only in the rare step
            // where a lane of the warp takes a key
            if (!__any_sync(kFullMask, any_take)) continue;
#pragma unroll
            for (int i = 0; i < QW; ++i) {
                if (take[i]) {
#pragma unroll
                    for (int s = kThreadQueue - 1; s > 0; --s)
                        thread_q[i][s] = thread_q[i][s - 1];
                    thread_q[i][0] = key[i];
                    ++count[i];
                }
                if (__any_sync(kFullMask, count[i] == kThreadQueue))
                    merge_queues<N>(warp_q[i], thread_q[i], count[i],
                                    threshold[i], keep, lane);
            }
        }
    }
    if (!any) return;
#pragma unroll
    for (int i = 0; i < QW; ++i) {
        if (__any_sync(kFullMask, count[i] > 0))
            merge_queues<N>(warp_q[i], thread_q[i], count[i], threshold[i],
                            keep, lane);
        if (!active[i]) continue;
        const long long o = (long long)row[i] * k + (self_mode ? 1 : 0);
#pragma unroll
        for (int s = 0; s < N; ++s) {
            const int e = s * 32 + lane;
            if (e < keep) write_slot(out_d2, out_idx, o + e, warp_q[i][s]);
        }
    }
}

template <class L, int KP, class Key, int Cuts>
cudaError_t launch_small(const float* q, const float* r, int batch,
                         const Members& m, int k, int self_mode,
                         float* out_d2, int* out_idx,
                         unsigned long long* rechecks, cudaStream_t stream) {
    constexpr int rows = small_rows<L::kWidth, KP>() * kSmallThreads;
    constexpr int tiles = 2 * kSplit * kTile * L::kWidth * (int)sizeof(float);
    constexpr int lists = (kSplit - 1) * KP * kSmallThreads * 8;
    constexpr int smem = tiles > lists ? tiles : lists;
    const auto kernel = knn_small_k_kernel<L, KP, Key, Cuts>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
    }
    const dim3 grid((m.q_rows + rows - 1) / rows, batch);
    kernel<<<grid, kSmallThreads * kSplit, smem, stream>>>(
        q, r, m, k, self_mode, out_d2, out_idx, rechecks);
    return cudaGetLastError();
}

template <class L, class Key = ExactKey, int Cuts = 0>
cudaError_t dispatch_small_k(const float* q, const float* r, int batch,
                             const Members& m, int k, int self_mode,
                             float* out_d2, int* out_idx,
                             unsigned long long* rechecks,
                             cudaStream_t stream) {
    // keys kept per thread: k, less the self slot, rounded up to 2^m
    const int keep = self_mode ? k - 1 : k;
    if (keep <= 1)
        return launch_small<L, 1, Key, Cuts>(q, r, batch, m, k, self_mode, out_d2, out_idx, rechecks, stream);
    if (keep <= 2)
        return launch_small<L, 2, Key, Cuts>(q, r, batch, m, k, self_mode, out_d2, out_idx, rechecks, stream);
    if (keep <= 4)
        return launch_small<L, 4, Key, Cuts>(q, r, batch, m, k, self_mode, out_d2, out_idx, rechecks, stream);
    if (keep <= 8)
        return launch_small<L, 8, Key, Cuts>(q, r, batch, m, k, self_mode, out_d2, out_idx, rechecks, stream);
    if (keep <= 16)
        return launch_small<L, 16, Key, Cuts>(q, r, batch, m, k, self_mode, out_d2, out_idx, rechecks, stream);
    return cudaErrorInvalidValue;
}

template <class L, int N, class Key>
cudaError_t launch_large(const float* q, const float* r, int batch,
                         const Members& m, int k, int self_mode,
                         float* out_d2, int* out_idx, cudaStream_t stream) {
    constexpr int W = L::kWidth;
    constexpr int rows = kLargeWarps * large_queries<W, N>();
    constexpr int smem = 2 * W * large_tile_stride<W>() * (int)sizeof(float);
    static_assert(smem <= 48 * 1024, "the large-k tiles fit the default");
    const dim3 grid((m.q_rows + rows - 1) / rows, batch);
    knn_large_k_kernel<L, N, Key><<<grid, kLargeWarps * 32, smem, stream>>>(
        q, r, m, k, self_mode, out_d2, out_idx);
    return cudaGetLastError();
}

// (the large-k body has no screen; its entry points pass a null `rechecks`)
template <class L, class Key = ExactKey>
cudaError_t dispatch_large_k(const float* q, const float* r, int batch,
                             const Members& m, int k, int self_mode,
                             float* out_d2, int* out_idx,
                             unsigned long long* /*rechecks*/,
                             cudaStream_t stream) {
    if (k > kLargeMaxK) return cudaErrorInvalidValue;
    // keys a lane holds in the warp queue: k, less the self slot, over 32,
    // rounded up to 2^m
    const int keep = self_mode ? k - 1 : k;
    if (keep <= 32)
        return launch_large<L, 1, Key>(q, r, batch, m, k, self_mode, out_d2, out_idx, stream);
    if (keep <= 64)
        return launch_large<L, 2, Key>(q, r, batch, m, k, self_mode, out_d2, out_idx, stream);
    if (keep <= 128)
        return launch_large<L, 4, Key>(q, r, batch, m, k, self_mode, out_d2, out_idx, stream);
    return launch_large<L, 8, Key>(q, r, batch, m, k, self_mode, out_d2, out_idx, stream);
}

using Dispatch = cudaError_t (*)(const float*, const float*, int,
                                 const Members&, int, int, float*, int*,
                                 unsigned long long*, cudaStream_t);

// The body of every C entry point: `d` is the launcher for the layout the
// caller asked for, or null when no layout fits its width.
inline cudaError_t run(Dispatch d, const float* q, const float* r, int batch,
                       int q_rows, int r_rows, const int* nq, const int* nr,
                       int nr_all, int k, int self_mode, float* out_d2,
                       int* out_idx, void* stream, int device,
                       unsigned long long* rechecks) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (batch <= 0 || q_rows <= 0 || k <= 0) return cudaSuccess;
    if (batch > 65535 || d == nullptr) return cudaErrorInvalidValue;
    const Members m{q_rows, r_rows, nq, nr, nr_all};
    return d(q, r, batch, m, k, self_mode, out_d2, out_idx, rechecks,
             static_cast<cudaStream_t>(stream));
}

}  // namespace knn

// Every library holds one source, which includes this header once, and
// exports the message of each cudaError_t code its entry points return.
extern "C" const char* knn_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
