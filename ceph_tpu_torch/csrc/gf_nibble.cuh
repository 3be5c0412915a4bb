// The split-nibble GF(2^8) matrix product shared by gf_words.cu (K1/K3) and
// gf_bytes.cu (K4): out[b, j, c] = XOR_i c[j, i] * in[b, i, c], applied
// bytewise to every 32-bit word of [batch, k, nw] words.  The TPU kernels
// expand bytes to int8 bit planes and run a GF(2) matmul on the MXU.  Here
// the product is ISA-L's split-nibble table product,
// c * x = LO[c][x & 15] ^ HI[c][x >> 4], with PRMT (the byte permute) as a
// 16-entry lookup of four bytes at once.  Each entry file includes this
// header and defines its own C entry over gf_nibble_apply().
//
// Bound on the H100: bytes, (k + rows) * 4 per word column: 64 MiB read and
// 24 MiB written at the ec_bench shape (k=8, rows=3) is ~27 us at 3.35 TB/s.
// The design before this one (a SWAR loop over the 8 bits of every input
// word, one shared-memory table load per bit and output row, output rows
// four at a time) spent ~8 k (4 + 2 rows) integer ops and 8 k rows shared
// loads per word and re-read all k inputs for every four output rows: it
// was issue-bound at 3x its bound.  This one:
//
// - per input word, ~12 ops build the two PRMT selectors (low and high
//   nibbles, bits 0-2 packed into the selector's four nibbles) and the two
//   byte masks of bit 3 (PRMT's sign-replicate mode); they are shared by
//   every output row;
// - per input word and output row, 4 PRMT + 3 LOP3: the two halves of each
//   16-entry table are looked up and picked by the mask, and both nibble
//   products fold into the accumulator;
// - each thread owns a 16-byte segment (4 words) of a column, so each
//   coefficient's 32-byte table is two broadcast 16-byte shared loads per
//   4 words; all rows of a launch (up to 8, else grid.y tiles) sit
//   in registers, so each input byte is read once;
// - the input segments of a chunk of kChunk rows are all loaded before
//   any is used, so kChunk * 16 B per thread are in flight;
// - the tables are zero-padded in shared memory to whole chunks and to
//   the register tile of rows, so the loops carry no guard and the
//   compiler hoists the shared loads ahead of their use (guards there
//   serialised each 16-byte table load with its PRMTs);
// - a persistent grid (a few blocks per SM) walks the segments with a
//   grid stride: the table copy to shared memory happens once per block
//   and the batch/segment split is carried incrementally, with no division
//   in the loop.
//
// A column count that is not a multiple of 4 takes the unaligned variant:
// four masked 4-byte loads and stores per row instead of one 16-byte one.
// The kernel works in uint32 and stores through the int32 view, so bit 31
// comes out as the TPU's wrapping repack gives it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;       // input rows loaded before use
// blocks per SM the register budget is cut for (3: <= 85 registers, 2:
// <= 128), for more warps to hide the loads' latency; chip_smoke.py prints
// each variant's registers and spills
template <int RT> constexpr int min_blocks() { return RT <= 3 ? 3 : 2; }

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
    uint32_t d;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
    return d;
}

// Per input word: PRMT selectors of the low 3 bits of each byte's low
// (lsel) and high (hsel) nibble, and 0xFF/0x00 byte masks of each
// nibble's bit 3 (PRMT's sign-replicate mode on the byte's top bit).
struct Sel {
    uint32_t lsel, hsel, lmask, hmask;
};

__device__ __forceinline__ Sel selectors(uint32_t w) {
    const uint32_t lo = w & 0x07070707u;
    const uint32_t hi = (w >> 4) & 0x07070707u;
    // bytes 0 and 2 of (v | v >> 4) hold nibble pairs (b0, b1), (b2, b3)
    const uint32_t lp = lo | (lo >> 4);
    const uint32_t hp = hi | (hi >> 4);
    Sel s;
    s.lsel = prmt(lp, 0u, 0x3320u);
    s.hsel = prmt(hp, 0u, 0x3320u);
    s.lmask = prmt(w << 4, 0u, 0xBA98u);
    s.hmask = prmt(w, 0u, 0xBA98u);
    return s;
}

// acc ^ LO[x & 15] ^ HI[x >> 4] for the four bytes of x; t = LO (words
// 0..3, entries 0..15), u = HI
__device__ __forceinline__ uint32_t mul_acc(uint32_t acc, const uint4& t,
                                            const uint4& u, const Sel& s) {
    const uint32_t la = prmt(t.x, t.y, s.lsel);
    const uint32_t lb = prmt(t.z, t.w, s.lsel);
    const uint32_t ha = prmt(u.x, u.y, s.hsel);
    const uint32_t hb = prmt(u.z, u.w, s.hsel);
    acc ^= la ^ ha;
    acc ^= (la ^ lb) & s.lmask;
    acc ^= (ha ^ hb) & s.hmask;
    return acc;
}

template <int RT, bool VEC>
__global__ void __launch_bounds__(kThreads, min_blocks<RT>())
gf_words_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                const uint4* __restrict__ tables, int k, int rows,
                long long nw, long long nseg, long long total) {
    // [RT][kpad][LO, HI]: zero tables past k and past the block's rows, so
    // the loops below run whole chunks and all RT rows without a guard
    // (a zero input word looks up entry 0, which is 0 in every table)
    extern __shared__ uint4 tab[];
    const int kpad = (k + kChunk - 1) / kChunk * kChunk;
    const int k4 = (k + kChunk / 2 - 1) / (kChunk / 2) * (kChunk / 2);
    const int j_begin = blockIdx.y * RT;
    const int j_count = min(RT, rows - j_begin);
    for (int t = threadIdx.x; t < RT * kpad * 2; t += blockDim.x) {
        const int j = t / (kpad * 2), i = (t >> 1) - j * kpad;
        tab[t] = j < j_count && i < k
            ? tables[((long long)(j_begin + j) * k + i) * 2 + (t & 1)]
            : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();

    const long long stride = (long long)gridDim.x * blockDim.x;
    long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    long long b = idx / nseg, s = idx - b * nseg;
    const long long db = stride / nseg, ds = stride - db * nseg;

    for (; idx < total; idx += stride) {
        const long long c = s * 4;
        const uint32_t* src = in + b * k * nw + c;
        uint32_t acc[RT][4];
#pragma unroll
        for (int t = 0; t < RT; ++t)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[t][q] = 0u;

        for (int i0 = 0; i0 < kpad; i0 += kChunk) {
            uint32_t x[kChunk][4];
#pragma unroll
            for (int ii = 0; ii < kChunk; ++ii) {
                const uint32_t* p = src + (long long)(i0 + ii) * nw;
                const bool live = i0 + ii < k;
                if (VEC) {
                    const uint4 v = live
                        ? __ldg(reinterpret_cast<const uint4*>(p))
                        : make_uint4(0u, 0u, 0u, 0u);
                    x[ii][0] = v.x; x[ii][1] = v.y;
                    x[ii][2] = v.z; x[ii][3] = v.w;
                } else {
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        x[ii][q] = live && c + q < nw ? __ldg(p + q) : 0u;
                }
            }
#pragma unroll
            for (int ii = 0; ii < kChunk; ++ii) {
                // the second half of a chunk past k4 holds only zero rows:
                // skip it (k <= 4, the lrc layers)
                if (ii >= kChunk / 2 && i0 + ii >= k4) break;
                Sel sel[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) sel[q] = selectors(x[ii][q]);
#pragma unroll
                for (int t = 0; t < RT; ++t) {
                    const uint4* tp = tab + (t * kpad + i0 + ii) * 2;
                    const uint4 lo = tp[0], hi = tp[1];
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        acc[t][q] = mul_acc(acc[t][q], lo, hi, sel[q]);
                }
            }
        }

        uint32_t* dst = out + (b * rows + j_begin) * nw + c;
#pragma unroll
        for (int t = 0; t < RT; ++t) {
            if (t < j_count) {
                uint32_t* p = dst + (long long)t * nw;
                if (VEC) {
                    *reinterpret_cast<uint4*>(p) =
                        make_uint4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
                } else {
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        if (c + q < nw) p[q] = acc[t][q];
                }
            }
        }
        s += ds;
        b += db;
        if (s >= nseg) {
            s -= nseg;
            ++b;
        }
    }
}

template <int RT, bool VEC>
int launch(const void* in, void* out, const void* tables, int batch, int k,
           int rows, long long nw, cudaStream_t stream) {
    const long long nseg = (nw + 3) / 4;
    const long long total = (long long)batch * nseg;
    const size_t smem = (size_t)RT * ((k + kChunk - 1) / kChunk * kChunk) * 32;
    auto kern = gf_words_kernel<RT, VEC>;
    // one query per variant and table size: the per-stripe lrc launches
    // come by the thousand (a race here costs a repeated query only)
    static size_t seen_smem = ~(size_t)0;
    static int sms = 0, per_sm = 0;
    if (seen_smem != smem) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, smem);
        seen_smem = smem;
    }
    const long long want = (total + kThreads - 1) / kThreads;
    const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const dim3 grid((unsigned)(want < cap ? want : cap),
                    (unsigned)((rows + RT - 1) / RT));
    kern<<<grid, kThreads, smem, stream>>>(
        (const uint32_t*)in, (uint32_t*)out, (const uint4*)tables, k, rows,
        nw, nseg, total);
    return (int)cudaGetLastError();
}

template <bool VEC>
int launch_rows(const void* in, void* out, const void* tables, int batch,
                int k, int rows, int rows_per_block, long long nw,
                cudaStream_t st) {
#define CTT_RT(n) \
    case n: return launch<n, VEC>(in, out, tables, batch, k, rows, nw, st)
    switch (rows_per_block) {
        CTT_RT(1); CTT_RT(2); CTT_RT(3); CTT_RT(4);
        CTT_RT(5); CTT_RT(6); CTT_RT(7); CTT_RT(8);
    }
#undef CTT_RT
    return (int)cudaErrorInvalidValue;
}

// in [batch, k, nw] words, out [batch, rows, nw] words (4-byte aligned; the
// 16-byte variant runs when nw % 4 == 0 and both are 16-byte aligned);
// tables [rows][k][8] words (LO then HI, 16 B each); rows_per_block
// (1..8, the register tile) output rows share one block's shared tables,
// the rest tile over grid.y.
inline int gf_nibble_apply(const void* in, void* out, const void* tables,
                           int batch, int k, int rows, int rows_per_block,
                           long long nw, cudaStream_t st) {
    if ((long long)batch * nw <= 0 || rows <= 0) return 0;
    const bool vec = nw % 4 == 0 && (uintptr_t)in % 16 == 0
                     && (uintptr_t)out % 16 == 0;
    return vec ? launch_rows<true>(in, out, tables, batch, k, rows,
                                   rows_per_block, nw, st)
               : launch_rows<false>(in, out, tables, batch, k, rows,
                                    rows_per_block, nw, st);
}

}  // namespace
