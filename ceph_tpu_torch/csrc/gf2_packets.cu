// GF(2) packet product: out[b, r, :] = XOR over c with sel[r, c] = 1 of
// in[b, c, :], on packets of 4-byte words (the wrapper pads a packet to a
// multiple of 4 bytes).
//
// Replaces ceph_tpu/ec/bitmatrix.py::BitMatrixECEngine._jit_apply.go (K10,
// :216-227), which expands packets into bit planes and runs an int8 matmul
// of the 0/1 selector on the MXU.  On the GPU no multiply is needed: the
// selector travels as column bitmasks (mask[tile][c], bit t = sel[32 tile +
// t, c], built on the host and staged in shared memory), and each thread
// owns one 4-byte word column of one stripe.  It reads every input packet's
// word once per tile of output rows and XORs it into the accumulators its
// column mask selects; a column with no bit in the tile is skipped without
// a load.  The mask is the same for every thread of the block, so the
// per-row tests never diverge.
//
// Registers: decode has R = k*w output rows (42 at k=6, w=7); one word per
// row in registers and tiles of at most 32 rows keep that in registers.
// The row tile is a template parameter so that encode (R = 2w) does not pay
// for 32 rows.
//
// Bound on the H100: bytes, N + R words per word column; at the smoke's
// encode shape (64 MiB in, 21 MiB out) ~27 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;    // masks staged in shared memory per pass

template <int RT>
__global__ void gf2_packets_kernel(const uint32_t* __restrict__ in,
                                   uint32_t* __restrict__ out,
                                   const uint32_t* __restrict__ masks,
                                   int rows, int n, long long pwords,
                                   long long total) {
    __shared__ uint32_t sm[kChunk];
    constexpr uint32_t kTileMask =
        RT >= 32 ? 0xFFFFFFFFu : (1u << (RT & 31)) - 1u;
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = idx < total;
    const long long b = live ? idx / pwords : 0;
    const long long col = live ? idx - b * pwords : 0;
    const uint32_t* src = in + b * (long long)n * pwords + col;
    uint32_t* dst = out + b * (long long)rows * pwords + col;
    const int ntiles = (rows + 31) / 32;

    // RT < 32 only when rows <= RT: then there is one tile and the
    // accumulators cover it
    for (int tile = 0; tile < ntiles; ++tile) {
        uint32_t acc[RT];
#pragma unroll
        for (int t = 0; t < RT; ++t) acc[t] = 0u;
        for (int c0 = 0; c0 < n; c0 += kChunk) {
            const int cn = min(kChunk, n - c0);
            __syncthreads();
            for (int t = threadIdx.x; t < cn; t += blockDim.x)
                sm[t] = masks[(long long)tile * n + c0 + t];
            __syncthreads();
            if (!live) continue;
            for (int c = 0; c < cn; ++c) {
                const uint32_t m = sm[c] & kTileMask;
                if (m == 0u) continue;
                const uint32_t w = __ldg(src + (long long)(c0 + c) * pwords);
#pragma unroll
                for (int t = 0; t < RT; ++t)
                    if ((m >> t) & 1u) acc[t] ^= w;
            }
        }
        if (live) {
#pragma unroll
            for (int t = 0; t < RT; ++t)
                if (tile * 32 + t < rows)
                    dst[(long long)(tile * 32 + t) * pwords] = acc[t];
        }
    }
}

}  // namespace

// in [batch, n, pwords] words, out [batch, rows, pwords] words, masks
// [ceil(rows / 32), n] uint32 column bitmasks.
extern "C" int ctt_gf2_packets(const void* in, void* out, const void* masks,
                               int batch, int rows, int n, long long pwords,
                               void* stream) {
    const long long total = (long long)batch * pwords;
    if (total <= 0 || rows <= 0) return 0;
    const long long blocks = (total + kThreads - 1) / kThreads;
    const cudaStream_t st = (cudaStream_t)stream;
    const uint32_t* i = (const uint32_t*)in;
    uint32_t* o = (uint32_t*)out;
    const uint32_t* mk = (const uint32_t*)masks;
    if (rows <= 8)
        gf2_packets_kernel<8><<<(unsigned)blocks, kThreads, 0, st>>>(
            i, o, mk, rows, n, pwords, total);
    else if (rows <= 16)
        gf2_packets_kernel<16><<<(unsigned)blocks, kThreads, 0, st>>>(
            i, o, mk, rows, n, pwords, total);
    else
        gf2_packets_kernel<32><<<(unsigned)blocks, kThreads, 0, st>>>(
            i, o, mk, rows, n, pwords, total);
    return (int)cudaGetLastError();
}
