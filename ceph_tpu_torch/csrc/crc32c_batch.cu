// CRC-32C (Castagnoli, reflected, RFC 3720) of every row of one or two
// [n, L] uint8 row sets of the same length, each row chained from its own
// seed.
//
// Replaces two jnp programs of ceph_tpu (no pallas_call there, but on the
// main path): the contribution matmul of scrub/crc32c_jax.py::_batch_kernel
// (:275-290, K6) and the digest half of ops/gf_jax.py::GFEncodeDigest._make.run
// (:325-339, K5).  On the TPU both expand every byte to 8 bit planes and
// multiply by a [8L, 32] GF(2) matrix on the MXU; that moves 8x the data and
// would not be exact as a float product past 2^24, so here the CRC is a table
// CRC, split over many threads and recombined with GF(2) shift operators.
//
// Every linear map is a set of nibble tables (16 uint32 entries each, built
// on the host): a 32-bit operator is 8 tables, the raw CRC of one 16-byte
// granule 32.  A 16-entry table fills 16 distinct shared-memory banks, so a
// warp's lookups never conflict (byte tables would conflict ~3x on random
// data); the whole set is 23 KiB, copied into shared memory once per block
// by cp.async.
//
// The kernel is latency-bound at the write lane's shapes (one round of
// short items), so every load an item needs (its operator, its seed, the
// tables on the block's first item, its first 4 tiles) is issued before the
// first wait, and the tiles land in a shared-memory ring by cp.async, one
// commit group each, so a tile is folded as soon as it has landed (loads
// into registers would wait for all four).
//
// Geometry (chosen by the wrapper from the SM count; the row is treated as
// front-padded with virtual zero granules, which leave a zero raw register
// at zero):
//   * a tile is 256 granules (4 KiB); a segment is `tps` tiles; a row is
//     `nseg` segments; work items are (row, segment) pairs walked by a
//     persistent grid of at most 4 blocks per SM;
//   * thread t of a block takes granule t of each tile, so a warp reads 512
//     contiguous bytes per load; it keeps 4 tiles in flight, and its
//     register moves one tile ahead with A^(16*256);
//   * each thread moves its register to the end of its warp with its lane's
//     operator A^(16 (31 - lane)), the warp XORs them by shuffles, each warp
//     sum moves to the end of the tile with its warp's operator, and the
//     first warp XORs the 8 sums: two table applications, no per-thread
//     32-column gather and no log-depth chain of lookups;
//   * one thread moves the segment's CRC to the end of the row
//     (A^(16*256*tps*(nseg-1-s)), host table per geometry) and adds the seed
//     term A^L (seed ^ ~0) ^ ~0 in segment 0; a row of one segment is
//     stored; otherwise (at most 32 segments) each segment XORs
//     (CRC << 32 | 1 << s) into a per-row 64-bit word with one atomic, and
//     the segment whose XOR completes the mask stores the row's CRC and
//     clears the word.  The output needs no zeroing launch before the
//     kernel, and no segment waits on another.
//
// Bound on the H100: bytes (each row read once, ~3.35 TB/s) against 40
// conflict-free shared lookups per 16 bytes (32 data nibbles, 8 for the
// tile shift) at one warp lookup per clock per SM, about 2.5 us per 8 MiB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 4;           // tiles loaded before the first fold
constexpr int kBlocksPerSM = 4;
constexpr int kOp = 8 * 16;         // words of one 32-bit operator
constexpr int kShift = 32 * 16;     // blob: data tables, then the shift,
constexpr int kLane = kShift + kOp; // the 32 lane operators (lane-major),
constexpr int kWarp = kLane + 32 * kOp;  // the 8 warp operators
constexpr int kBlob = kWarp + 8 * kOp;
constexpr int kCopies = 16;         // copies of the tables in device memory

__device__ __forceinline__ uint32_t apply_op(const uint32_t* __restrict__ op,
                                             uint32_t v) {
    uint32_t r = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) r ^= op[i * 16 + ((v >> (4 * i)) & 15u)];
    return r;
}

// raw CRC, from a zero register, of the 16 bytes of w
__device__ __forceinline__ uint32_t fold16(const uint32_t* __restrict__ d,
                                           const uint4 w) {
    const uint32_t q[4] = {w.x, w.y, w.z, w.w};
    uint32_t r = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i)
            r ^= d[(j * 8 + i) * 16 + ((q[j] >> (4 * i)) & 15u)];
    return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// copy this thread's granule of tile tl into its ring slot (zeros for the
// virtual front pad) as one commit group; past the segment's end the
// group is empty, so every thread always has kAhead groups behind it
__device__ __forceinline__ void stage_tile(uint4* slot, const uint4* p,
                                           long long tl, long long end,
                                           int tid, long long pad) {
    if (tl < end) {
        const long long g = tl * kThreads + tid - pad;
        cp_async16(slot, g >= 0 ? p + g : p, g >= 0 ? 16 : 0);
    }
    cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
crc32c_kernel(const uint4* __restrict__ set_a, const uint4* __restrict__ set_b,
              int rows_a, int nrows, const uint32_t* __restrict__ seeds,
              uint32_t* __restrict__ out, long long ngran, int tps, int nseg,
              const uint32_t* __restrict__ blob,
              const uint32_t* __restrict__ seg_ops,
              const uint32_t* __restrict__ seed_op,
              unsigned long long* __restrict__ acc) {
    __shared__ __align__(16) uint32_t tab[kBlob + kOp];   // + seed operator
    __shared__ __align__(16) uint4 ring[kAhead][kThreads];  // tiles in flight
    __shared__ uint32_t seg[kOp];           // this item's segment operator
    __shared__ uint32_t red[kThreads / 32];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const long long pad = (long long)nseg * tps * kThreads - ngran;
    const long long items = (long long)nrows * nseg;
    // the tables are read from one of kCopies copies, so that the blocks'
    // first reads spread over the L2 instead of all hitting the same lines
    const uint32_t* copy = blob + (blockIdx.x % kCopies) * kBlob;
    bool have_tables = false;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
        const long long row = it / nseg;
        const int s = (int)(it - row * nseg);
        const uint4* p = row < rows_a ? set_a + row * ngran
                                      : set_b + (row - rows_a) * ngran;
        const long long end = (long long)(s + 1) * tps;
        long long tl = (long long)s * tps;
        // tiles wholly in the virtual front pad (segment 0 only)
        if (tl < pad / kThreads) tl = pad / kThreads;
        // every load the item needs is in flight before the first wait:
        // its operator, its seed, the tables (once), its first tiles
        const uint32_t opw =
            tid < kOp ? __ldg(seg_ops + (long long)(nseg - 1 - s) * kOp + tid)
                      : 0u;
        const uint32_t seed = (tid == 0 && s == 0) ? __ldg(seeds + row) : 0u;
        if (!have_tables) {
            for (int c = tid; c < (kBlob + kOp) / 4; c += kThreads)
                cp_async16(tab + 4 * c, c < kBlob / 4 ? copy + 4 * c
                                                      : seed_op + 4 * c - kBlob,
                           16);
            cp_async_commit();
        }
        // one commit group per tile, kAhead in flight; a thread reads back
        // only its own granules, so no barrier guards the ring
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
            stage_tile(ring[u] + tid, p, tl + u, end, tid, pad);
        cp_async_wait<kAhead>();            // the tables
        if (!have_tables) have_tables = true;
        if (tid < kOp) seg[tid] = opw;
        __syncthreads();
        uint32_t reg = 0u;
        for (int u = 0; tl < end; ++tl, u = (u + 1) % kAhead) {
            cp_async_wait<kAhead - 1>();    // tile tl has landed
            const uint4 w = ring[u][tid];
            reg = apply_op(tab + kShift, reg) ^ fold16(tab, w);
            stage_tile(ring[u] + tid, p, tl + kAhead, end, tid, pad);
        }
        // move each register to the end of its warp (lane operator
        // A^(16 (31 - lane)), tables interleaved by lane so the 32 lanes
        // read 32 banks), XOR the warp, move each warp sum to the end of
        // the tile (A^(16 * 32 * (7 - warp))), XOR the 8 warps
        uint32_t y = 0u;
#pragma unroll
        for (int i = 0; i < 8; ++i)
            y ^= tab[kLane + (i * 16 + ((reg >> (4 * i)) & 15u)) * 32 + lane];
#pragma unroll
        for (int j = 0; j < 5; ++j)
            y ^= __shfl_xor_sync(0xFFFFFFFFu, y, 1 << j);
        if (lane == 0) red[tid >> 5] = apply_op(tab + kWarp + (tid >> 5) * kOp, y);
        __syncthreads();
        if (tid < 32) {
            uint32_t x = red[lane & 7];
#pragma unroll
            for (int j = 0; j < 3; ++j)
                x ^= __shfl_xor_sync(0xFFFFFFFFu, x, 1 << j);
            if (lane == 0) {
                uint32_t v = apply_op(seg, x);
                if (s == 0)
                    v ^= apply_op(tab + kBlob, seed ^ 0xFFFFFFFFu) ^
                         0xFFFFFFFFu;
                if (nseg == 1) {
                    out[row] = v;
                } else {
                    // one 64-bit atomic a segment: the high word XORs the
                    // segments' CRCs, the low word their bits; the segment
                    // that completes the mask stores and clears the word
                    const uint32_t bit = 1u << s;
                    const uint32_t full =
                        nseg == 32 ? 0xFFFFFFFFu : (1u << nseg) - 1u;
                    const unsigned long long old = atomicXor(
                        acc + row, ((unsigned long long)v << 32) | bit);
                    if (((uint32_t)old ^ bit) == full) {
                        out[row] = (uint32_t)(old >> 32) ^ v;
                        acc[row] = 0ull;
                    }
                }
            }
        }
        __syncthreads();
    }
}

}  // namespace

// Rows [0, rows_a) are set_a's, rows [rows_a, nrows) set_b's; both hold
// ngran 16-byte granules a row, 16-byte aligned; blob holds kCopies copies
// of the tables.  With nseg > 1 (at most 32), acc holds nrows zeroed
// 64-bit words, which the kernel leaves at zero again.
extern "C" int ctt_crc32c_batch(const void* set_a, const void* set_b,
                                int rows_a, int nrows, const void* seeds,
                                void* out, long long ngran, int tps, int nseg,
                                const void* blob, const void* seg_ops,
                                const void* seed_op, void* acc, int grid,
                                void* stream) {
    if (nrows <= 0 || grid <= 0) return 0;
    crc32c_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)set_a, (const uint4*)set_b, rows_a, nrows,
        (const uint32_t*)seeds, (uint32_t*)out, ngran, tps, nseg,
        (const uint32_t*)blob, (const uint32_t*)seg_ops,
        (const uint32_t*)seed_op, (unsigned long long*)acc);
    return (int)cudaGetLastError();
}
