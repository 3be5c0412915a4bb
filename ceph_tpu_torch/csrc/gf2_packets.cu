// GF(2) packet product: out[b, r, :] = XOR over c with sel[r, c] = 1 of
// in[b, c, :], on packets of 4-byte words (the wrapper pads a packet to a
// multiple of 4 bytes).
//
// Replaces ceph_tpu/ec/bitmatrix.py::BitMatrixECEngine._jit_apply.go (K10,
// :216-227), which expands packets into bit planes and runs an int8 matmul
// of the 0/1 selector on the MXU.  On the GPU no multiply is needed, and no
// bit of the selector is tested on the card: the host turns the selector
// into an XOR schedule (for each output row, the list of input packets it
// XORs, as jerasure_dumb_bitmatrix_to_schedule does), so the kernel does one
// XOR per one of the matrix and copies an identity row.
//
//   * each thread owns 16 bytes of every packet of one stripe (4 words,
//     as uint4 when packets are 16-byte multiples), or 8 bytes (one uint2)
//     when they are 8-byte multiples, as the smoke's 24968-byte liberation
//     packets are; a warp's loads of a packet are contiguous;
//   * it stages its bytes of up to `chunk` (48) input packets in shared
//     memory with cp.async, all in flight at once, so each input word is
//     read from device memory once for all R output rows (decode's 42
//     included); a thread reads back only what it copied, so threads
//     never wait on one another;
//   * the warps of a block take neighbouring tiles, so a block reads 2 KiB
//     of each packet at once; at N = 42 an SM holds 16 warps of 8-byte
//     lanes (84 KiB of staging a block) or 8 of 16-byte lanes.  Other warps'
//     copies overlap a warp's XORs.  On the H100 (PERF.md) 8-byte
//     lanes ran faster than 16-byte ones at the encode shape (more warps
//     in the same shared memory), and a double-buffered variant (two
//     stages per warp in flight) slower (fewer warps fit);
//   * then, row by row, it XORs the staged words its row's schedule lists
//     and stores them; selectors of more than `chunk` columns run in
//     passes, each later pass XORing into the rows already stored.
//
// The schedule (CSR: row offsets, then each entry's packet index within
// its pass) is copied into shared memory once per block when it is small.
//
// Bound on the H100: bytes, N + R packets per stripe; at the smoke's encode
// shape (64 MiB in, 21 MiB out) ~27 us at 3.35 TB/s.  Shared traffic per
// lane: N stores plus one load per one of the matrix (89 at liberation
// k=6 w=7 encode, 333 at its (0, 1) decode), well under shared bandwidth.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// W words of a packet a lane (16 bytes, or 8 for 8-byte vectors); a warp
// covers 32 W words of a packet, and a block 2 KiB of each packet
template <int W> __host__ __device__ constexpr int tile_words() { return 32 * W; }
template <int W> __host__ __device__ constexpr int warps() {
    return 512 / tile_words<W>();
}
constexpr int kMaxStaged = 4096;    // schedule ints staged in shared memory

template <int V>
__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (V == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     :: "r"(d), "l"(src));
    else if constexpr (V == 2)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
                     :: "r"(d), "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                     :: "r"(d), "l"(src));
}

template <int V>
__device__ __forceinline__ void load_vec(const uint32_t* p, uint32_t* r) {
    if constexpr (V == 4) {
        const uint4 x = *reinterpret_cast<const uint4*>(p);
        r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
    } else if constexpr (V == 2) {
        const uint2 x = *reinterpret_cast<const uint2*>(p);
        r[0] = x.x; r[1] = x.y;
    } else {
        r[0] = *p;
    }
}

template <int V>
__device__ __forceinline__ void store_vec(uint32_t* p, const uint32_t* r) {
    if constexpr (V == 4)
        *reinterpret_cast<uint4*>(p) = make_uint4(r[0], r[1], r[2], r[3]);
    else if constexpr (V == 2)
        *reinterpret_cast<uint2*>(p) = make_uint2(r[0], r[1]);
    else
        *p = r[0];
}

// V: words per vector (4 when packets are 16-byte multiples, 2 for
// 8-byte multiples, else 1); each lane handles U = W / V vectors of a
// packet, 32 V words apart
template <int V, int W>
__global__ void __launch_bounds__(warps<W>() * 32)
gf2_packets_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   const int* __restrict__ sched, int sched_len, int rows,
                   int n, int chunk, long long pwords, long long tiles_per_b,
                   long long tiles) {
    constexpr int U = W / V;
    constexpr int kWarps = warps<W>();
    constexpr int kTileWords = tile_words<W>();
    extern __shared__ uint4 smem_raw[];
    uint32_t* smem = reinterpret_cast<uint32_t*>(smem_raw);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int* sch = sched;
    if (sched_len <= kMaxStaged) {
        int* staged = reinterpret_cast<int*>(smem + kWarps * chunk * kTileWords);
        for (int i = threadIdx.x; i < sched_len; i += blockDim.x)
            staged[i] = sched[i];
        __syncthreads();
        sch = staged;
    }
    const int nchunks = (n + chunk - 1) / chunk;
    const int* ent = sch + nchunks * rows + 1;
    uint32_t* buf = smem + warp * chunk * kTileWords + lane * V;

    for (long long tile = (long long)blockIdx.x * kWarps + warp; tile < tiles;
         tile += (long long)gridDim.x * kWarps) {
        const long long b = tile / tiles_per_b;
        const long long w0 = (tile - b * tiles_per_b) * kTileWords + lane * V;
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) ok[u] = w0 + u * 32 * V < pwords;
        const uint32_t* src = in + b * n * pwords + w0;
        uint32_t* dst = out + b * rows * pwords + w0;
        for (int ch = 0; ch < nchunks; ++ch) {
            const int c0 = ch * chunk;
            const int nc = min(chunk, n - c0);
            for (int c = 0; c < nc; ++c)
#pragma unroll
                for (int u = 0; u < U; ++u)
                    if (ok[u])
                        cp_async<V>(buf + c * kTileWords + u * 32 * V,
                                    src + (long long)(c0 + c) * pwords +
                                        u * 32 * V);
            asm volatile("cp.async.commit_group;" ::: "memory");
            asm volatile("cp.async.wait_all;" ::: "memory");
            const int* offs = sch + ch * rows;
            for (int r = 0; r < rows; ++r) {
                uint32_t acc[W] = {};
                uint32_t* o = dst + (long long)r * pwords;
                if (ch > 0)
#pragma unroll
                    for (int u = 0; u < U; ++u)
                        if (ok[u]) load_vec<V>(o + u * 32 * V, acc + u * V);
                const int e1 = offs[r + 1];
#pragma unroll 4
                for (int e = offs[r]; e < e1; ++e) {
                    const uint32_t* p = buf + ent[e] * kTileWords;
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        uint32_t w[V];
                        load_vec<V>(p + u * 32 * V, w);
#pragma unroll
                        for (int v = 0; v < V; ++v) acc[u * V + v] ^= w[v];
                    }
                }
#pragma unroll
                for (int u = 0; u < U; ++u)
                    if (ok[u]) store_vec<V>(o + u * 32 * V, acc + u * V);
            }
        }
    }
}

template <int V, int W>
int launch(const void* in, void* out, const void* sched, int sched_len,
           int batch, int rows, int n, int chunk, long long pwords,
           cudaStream_t stream) {
    constexpr int kWarps = warps<W>();
    constexpr int kTileWords = tile_words<W>();
    const long long tiles_per_b = (pwords + kTileWords - 1) / kTileWords;
    const long long tiles = (long long)batch * tiles_per_b;
    const size_t smem = (size_t)kWarps * chunk * kTileWords * 4 +
                        (sched_len <= kMaxStaged ? (size_t)sched_len * 4 : 0);
    auto kern = gf2_packets_kernel<V, W>;
    // one query per variant and shared size (a race costs a repeated query)
    static size_t seen_smem = ~(size_t)0;
    static int sms = 0, per_sm = 0;
    if (seen_smem != smem) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kWarps * 32, smem);
        seen_smem = smem;
    }
    const long long want = (tiles + kWarps - 1) / kWarps;
    const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
    kern<<<(unsigned)(want < cap ? want : cap), kWarps * 32, smem, stream>>>(
        (const uint32_t*)in, (uint32_t*)out, (const int*)sched, sched_len,
        rows, n, chunk, pwords, tiles_per_b, tiles);
    return (int)cudaGetLastError();
}

}  // namespace

// in [batch, n, pwords] words, out [batch, rows, pwords] words; sched the
// int32 XOR schedule of sched_len entries for `chunk` input packets a pass
// (ec/bitmatrix.py::xor_schedule).
extern "C" int ctt_gf2_packets(const void* in, void* out, const void* sched,
                               int sched_len, int batch, int rows, int n,
                               int chunk, long long pwords, void* stream) {
    if ((long long)batch * pwords <= 0 || rows <= 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    const uintptr_t align = (uintptr_t)in | (uintptr_t)out;
    if (pwords % 4 == 0 && align % 16 == 0)
        return launch<4, 4>(in, out, sched, sched_len, batch, rows, n, chunk,
                         pwords, st);
    if (pwords % 2 == 0 && align % 8 == 0)
        return launch<2, 2>(in, out, sched, sched_len, batch, rows, n, chunk,
                         pwords, st);
    return launch<1, 4>(in, out, sched, sched_len, batch, rows, n, chunk, pwords,
                     st);
}
