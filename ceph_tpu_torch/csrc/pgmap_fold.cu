// The mon PGMap's summary fold over the first n rows of its columns:
//   stale   = (now - stamp) > 6.0        (a NaN age is never stale)
//   hist[sid * 2 + stale] += 1           (hist_len = 2 * state names)
//   sums    = [num_objects, missing, backfill_remaining, scrub_errors,
//              rows whose key falls outside [0, hist_len)]
// all int64 and exact: integer atomics give the same answer in any order.
//
// Replaces K11, ceph_tpu/mon/pgmap.py::_jax_summary_fold (:727-748), the
// jitted fold of PGMap.summary_arrays(use_jax=True).
//
// Bound on the H100: bytes, 48 a row (sid, stamp and the four counters,
// int64 or float64), one pass.  One grid-stride pass: each warp takes 32
// consecutive rows a step (eight-byte loads, coalesced), forms the age in
// float64 as numpy does, and adds its keys by warp aggregation: the lanes
// that share a key (__match_any_sync) elect one leader, which adds their
// count (almost every row of a real map is "active+clean" and fresh, so
// per-lane atomics would serialise on one counter).  Up to
// kSharedCap keys the counters are a per-block histogram of int32 in
// shared memory, flushed with one 64-bit atomic per non-zero bin; above
// it the leaders add straight into the int64 histogram in device memory.
// The four sums and the out-of-range count are register sums, reduced by
// warp shuffles and across the block's warps in shared memory, then one
// 64-bit atomicAdd each per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 5;
constexpr int kSharedCap = 8192;          // int32 bins: 32 KiB of shared
constexpr double kStaleGrace = 6.0;       // PG_STALE_GRACE, seconds

using u64 = unsigned long long;

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
pgmap_fold_kernel(const long long* __restrict__ sid,
                  const double* __restrict__ stamp, double now,
                  const long long* __restrict__ objs,
                  const long long* __restrict__ miss,
                  const long long* __restrict__ back,
                  const long long* __restrict__ errs, long long n,
                  int hist_len, u64* __restrict__ hist,
                  u64* __restrict__ sums) {
    extern __shared__ int bins[];          // hist_len when kShared
    __shared__ long long part[kWarps][kSums];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (kShared) {
        for (int b = threadIdx.x; b < hist_len; b += kThreads) bins[b] = 0;
        __syncthreads();
    }
    long long s[kSums] = {0, 0, 0, 0, 0};
    const long long step = (long long)gridDim.x * kThreads;
    // the loop bound is the warp's first row, so a warp's lanes iterate
    // together and every __match_any_sync sees all 32
    for (long long base = (long long)blockIdx.x * kThreads + warp * 32;
         base < n; base += step) {
        const long long i = base + lane;
        int key = -1;
        if (i < n) {
            const double age = now - stamp[i];
            const long long k = sid[i] * 2 +
                                ((age == age && age > kStaleGrace) ? 1 : 0);
            if (k >= 0 && k < hist_len) key = (int)k;
            else s[4] += 1;
            s[0] += objs[i];
            s[1] += miss[i];
            s[2] += back[i];
            s[3] += errs[i];
        }
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (key >= 0 && lane == __ffs(peers) - 1) {
            const int c = __popc(peers);
            if (kShared) atomicAdd(&bins[key], c);
            else atomicAdd(&hist[key], (u64)c);
        }
    }
#pragma unroll
    for (int j = 0; j < kSums; ++j) {
        const long long v = warp_sum(s[j]);
        if (lane == 0) part[warp][j] = v;
    }
    __syncthreads();
    if (threadIdx.x < kSums) {
        long long v = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += part[w][threadIdx.x];
        if (v) atomicAdd(&sums[threadIdx.x], (u64)v);   // two's complement
    }
    if (kShared) {
        for (int b = threadIdx.x; b < hist_len; b += kThreads)
            if (bins[b]) atomicAdd(&hist[b], (u64)bins[b]);
    }
}

}  // namespace

// out: hist_len + 5 int64, zeroed by the caller; blocks: grid size
extern "C" int ctt_pgmap_fold(const void* sid, const void* stamp, double now,
                              const void* objs, const void* miss,
                              const void* back, const void* errs,
                              long long n, int hist_len, void* out,
                              int blocks, void* stream) {
    if (n <= 0 || hist_len <= 0 || blocks <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    u64* hist = (u64*)out;
    u64* sums = hist + hist_len;
    const long long* a = (const long long*)sid;
    const double* t = (const double*)stamp;
    const long long* o = (const long long*)objs;
    const long long* m = (const long long*)miss;
    const long long* b = (const long long*)back;
    const long long* e = (const long long*)errs;
    if (hist_len <= kSharedCap)
        pgmap_fold_kernel<true><<<blocks, kThreads,
                                  hist_len * sizeof(int), s>>>(
            a, t, now, o, m, b, e, n, hist_len, hist, sums);
    else
        pgmap_fold_kernel<false><<<blocks, kThreads, 0, s>>>(
            a, t, now, o, m, b, e, n, hist_len, hist, sums);
    return (int)cudaGetLastError();
}
