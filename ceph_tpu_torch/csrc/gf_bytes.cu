// GF(2^8) matrix x byte chunks: out[b, j, c] = XOR_i coef[j, i] * in[b, i, c]
// on uint8 rows of any length (the wrapper pads rows to a multiple of 16).
//
// Replaces ceph_tpu/ops/gf_pallas.py::_gf_apply_pallas (K4, the pallas_call
// at :105, kernel _gf_kernel :59).  The TPU kernel expands each byte into
// 8 int8 bit planes and runs a GF(2) matmul on the MXU.  On the GPU the
// same map is ISA-L's split-nibble table product (its pshufb loop),
// with PRMT, the byte permute, as the 16-entry lookup:
//
//   c * x = LO[c][x & 15] ^ HI[c][x >> 4]
//
// LO/HI are 16-byte tables per coefficient (32 B, built on the host and
// staged in shared memory).  A 16-entry lookup of four bytes at once is two
// __byte_perm over the table's two 8-byte halves, picked per byte by bit 3
// of the nibble.  Each thread owns a 16-byte column segment of one stripe:
// it reads 16 B of each of the k input rows once per register tile of
// output rows, and writes 16 B of each output row.
//
// Bound on the H100: bytes, (k + m) per column: 64 MiB + 24 MiB at
// 3.35 TB/s is ~27 us at the ec_bench shape (k=8, m=3).  The lookups cost
// ~k * (14 + 12 m) integer ops per 4-byte word, so at k=8 this kernel is
// limited by issue rate, like gf_words.  Output rows beyond what fits in
// the shared tables tile over grid.y; inside a block, rows run kRowTile at a
// time in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowTile = 8;     // output rows held in registers per pass
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t nibble_sel(uint32_t n) {
    // bytes of n hold 0..15; PRMT selector of their low 3 bits, one
    // selector nibble per output byte
    const uint32_t v = n & 0x07070707u;
    const uint32_t t = v | (v >> 4);
    return (t & 0xFFu) | ((t >> 8) & 0xFF00u);
}

__device__ __forceinline__ uint32_t nibble_hi_mask(uint32_t n) {
    return ((n >> 3) & 0x01010101u) * 0xFFu;
}

// 16-entry byte lookup of four nibbles: tab = 4 words (entries 0..15)
__device__ __forceinline__ uint32_t lookup16(const uint32_t* tab,
                                             uint32_t sel, uint32_t hmask) {
    const uint32_t a = __byte_perm(tab[0], tab[1], sel);
    const uint32_t b = __byte_perm(tab[2], tab[3], sel);
    return a ^ ((a ^ b) & hmask);
}

__global__ void gf_bytes_kernel(const uint4* __restrict__ in,
                                uint4* __restrict__ out,
                                const uint32_t* __restrict__ tables,
                                int k, int rows, int rows_per_block,
                                long long nseg, long long total) {
    extern __shared__ uint32_t tab[];   // [rows_per_block][k][8] words
    const int j_begin = blockIdx.y * rows_per_block;
    const int j_count = min(rows_per_block, rows - j_begin);
    const int ntab = j_count * k * 8;
    const uint32_t* src_tab = tables + (long long)j_begin * k * 8;
    for (int t = threadIdx.x; t < ntab; t += blockDim.x) tab[t] = src_tab[t];
    __syncthreads();

    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const long long b = idx / nseg;
    const long long s = idx - b * nseg;
    const uint4* src = in + b * (long long)k * nseg + s;
    uint4* dst = out + (b * (long long)rows + j_begin) * nseg + s;

    for (int j0 = 0; j0 < j_count; j0 += kRowTile) {
        uint32_t acc[kRowTile][4];
#pragma unroll
        for (int t = 0; t < kRowTile; ++t)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[t][q] = 0u;
        for (int i = 0; i < k; ++i) {
            const uint4 x = __ldg(src + (long long)i * nseg);
            const uint32_t w[4] = {x.x, x.y, x.z, x.w};
            uint32_t lsel[4], lmask[4], hsel[4], hmask[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const uint32_t lo = w[q] & 0x0F0F0F0Fu;
                const uint32_t hi = (w[q] >> 4) & 0x0F0F0F0Fu;
                lsel[q] = nibble_sel(lo);
                lmask[q] = nibble_hi_mask(lo);
                hsel[q] = nibble_sel(hi);
                hmask[q] = nibble_hi_mask(hi);
            }
#pragma unroll
            for (int t = 0; t < kRowTile; ++t) {
                if (j0 + t < j_count) {
                    const uint32_t* lt = tab + ((j0 + t) * k + i) * 8;
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        acc[t][q] ^= lookup16(lt, lsel[q], lmask[q])
                                   ^ lookup16(lt + 4, hsel[q], hmask[q]);
                }
            }
        }
#pragma unroll
        for (int t = 0; t < kRowTile; ++t) {
            if (j0 + t < j_count)
                dst[(long long)(j0 + t) * nseg] =
                    make_uint4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
        }
    }
}

}  // namespace

// in [batch, k, 16 * nseg] bytes, out [batch, rows, 16 * nseg] bytes, both
// 16-byte aligned; tables [rows][k][8] words (LO then HI, 16 B each);
// rows_per_block output rows share one block's shared tables.
extern "C" int ctt_gf_bytes(const void* in, void* out, const void* tables,
                            int batch, int k, int rows, int rows_per_block,
                            long long nseg, void* stream) {
    const long long total = (long long)batch * nseg;
    if (total <= 0 || rows <= 0) return 0;
    const size_t smem = (size_t)rows_per_block * k * 8 * sizeof(uint32_t);
    const long long blocks = (total + kThreads - 1) / kThreads;
    const dim3 grid((unsigned)blocks,
                    (unsigned)((rows + rows_per_block - 1) / rows_per_block));
    gf_bytes_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint4*)in, (uint4*)out, (const uint32_t*)tables, k, rows,
        rows_per_block, nseg, total);
    return (int)cudaGetLastError();
}
