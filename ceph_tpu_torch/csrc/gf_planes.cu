// Multiply resident bit planes by a GF(2) block-diagonal matrix and repack:
//   planes [B, 32k, nw] int8 (from gf_expand) -> out [B, rows, nw] uint32
//   out[b, t, c] bit q = parity over r of (planes[b, r, c] & 1) * M[q*rows + t, r]
//
// Replaces ceph_tpu/ops/gf_pallas2.py::_gf_apply_planes (K2, the pallas_call
// at :340, body _gf_planes_kernel :323-332): an int8 MXU matmul with int32
// accumulate, `& 1` and a weighted repack into int32 words.  Here the same
// product, and the repack, run on Hopper's int8 tensor cores (mma.sync
// m16n8k32).
//
// Bound on the H100: bytes, 32k plane bytes read and 4 rows bytes written
// per word column: 64 MiB + 4.5 MiB at the recovery lane's shape
// ([2, 256, 131072] planes, rows=9, k=8) is ~23 us at 3.35 TB/s.  The design
// before this one (one thread per word column testing each of the 32k plane
// rows and XORing `rows` precomputed words, four output rows a pass) issued
// 32k * rows shared loads per column and re-read every plane for each four
// output rows: 12% of its bound.  This one:
//
// - M is zero outside its four diagonal blocks, one per byte position b of
//   the word: output bits 8b..8b+7 take plane rows [8k b, 8k (b+1)) only.
//   Each b is one product of its [32, 8k] slice of planes (M = 32 word
//   columns of a warp tile, two m16 tiles) with the [8k, 8 rows] block
//   (N = one n8 tile per output row t, column s'; K = plane rows s k + i,
//   zero-padded to k32 steps): a quarter of the dense work.  The block
//   (the host's B operand) sits in shared memory in fragment order, one
//   8-byte load per lane, output row and k-step.
// - A warp's planes stream through a private ring of kStages slices (32
//   plane rows x 32 columns, 1 KiB) in shared memory, filled by cp.async
//   kStages - 1 k-steps ahead of the tensor cores, across tile boundaries:
//   3 KiB per warp in flight without registers.  Rows sit in the slice at
//   slot (r & 3) * 8 + (r >> 2), so lane (g, tig) reads 4-byte words of
//   rows 4 tig + p at columns 4g..4g+3 without bank conflicts, and
//   transposes the 4 x 4 bytes with PRMT into A fragments (m16 tile mi:
//   row g <-> column 4g + 2mi, row g + 8 <-> column 4g + 2mi + 1).
// - The accumulators of up to kMaxNt output rows stay in registers (the
//   row count is a template parameter, so no loop carries a guard), and
//   each plane byte is read from device memory once for rows <= 9; more
//   rows run in passes of 8 that stage the planes again.
// - Epilogue per byte position: `acc & 1` of four output rows is packed
//   by PRMT into an A fragment of a second product (int8 0/1, K = 4 rows
//   x 8 bits), whose constant B weighs bit s' of row u by 2^s' in column
//   u: its result is the output byte of each (word, row), which one PRMT
//   drops into the word.  No shuffles: the tensor cores do the gather.
// - A persistent grid walks the (stripe, 32-column) warp tiles with a
//   grid stride.  More rows than fit shared memory tile over grid.y.
//
// The word is assembled in uint32 and stored through the int32 view, so
// bit 31 comes out as the TPU's wrapping int32 repack gives it.  A word count
// that is not a multiple of 16 stages its slices by masked byte loads (the
// cp.async variant needs every plane row 16-byte aligned).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;       // word columns per warp tile
constexpr int kMaxNt = 9;       // output rows (n8 tiles) held in registers
constexpr int kStages = 4;      // k-step slices in flight per warp
constexpr int kSlice = 32 * kCols;   // bytes of one k-step slice

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
    uint32_t d;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
    return d;
}

// Row r of a slice lives at 32-byte slot (r & 3) * 8 + (r >> 2): lane
// (g, tig) then reads rows 4 tig + p (+ 16) from banks 8 tig + g, all 32
// distinct.
__device__ __forceinline__ int slot_of(int r) { return (r & 3) * 8 + (r >> 2); }

// Where one warp's producer stands in its sequence of k-step slices:
// tile, output-row pass, byte position, k-step; `row` points at the
// slice's first plane row in the tile's first column, `krem` counts the
// byte position's rows from there, `colok` says whether this lane's
// 16-byte chunk lies inside the row.
struct Cursor {
    long long tile, col;    // col: this lane's chunk's first column
    const int8_t* base;     // plane row 0 of the tile's stripe, its column
    const int8_t* row;
    int grp, b, ks, krem;
    bool colok;
};

__device__ __forceinline__ void seek(Cursor& c, const int8_t* planes,
                                     long long tiles, long long ntile,
                                     long long nw, int k8, int lane) {
    const bool live = c.tile < tiles;
    const long long bi = live ? c.tile / ntile : 0;
    const long long col0 = live ? (c.tile - bi * ntile) * kCols : 0;
    c.base = planes + bi * 4 * (long long)k8 * nw + col0;
    c.row = c.base;
    c.krem = live ? k8 : 0;
    c.col = col0 + 16 * (lane & 1);
    c.colok = c.col < nw;
}

// Stage slice `cur` into `slice` (kSlice bytes): 32 plane rows x 32
// columns, rows past the byte position's 8k and columns past nw zero.
// Lane l stages 16-byte chunk (l & 1) of rows l >> 1 and 16 + (l >> 1),
// at byte offsets off0 and off0 + 16 nw from the slice's first row.
// VEC (nw % 16 == 0): two cp.async; otherwise masked byte loads and
// 16-byte shared stores.  Commits one group either way.
template <bool VEC>
__device__ __forceinline__ void stage(uint8_t* slice, const Cursor& cur,
                                      long long off0, long long nw,
                                      int lane) {
    const int r0 = lane >> 1, c = 16 * (lane & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * h;
        const bool ok = cur.colok && r < cur.krem;
        const int8_t* src = cur.row + off0 + (h ? 16 * nw : 0);
        uint8_t* dst = slice + slot_of(r) * 32 + c;
        if (VEC) {
            const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                         :: "r"(d), "l"(ok ? src : cur.base),
                            "r"(ok ? 16 : 0));
        } else {
            uint32_t w[4] = {0u, 0u, 0u, 0u};
            if (ok)
#pragma unroll
                for (int j = 0; j < 16; ++j)
                    if (cur.col + j < nw)
                        w[j >> 2] |= (uint32_t)(uint8_t)__ldg(src + j)
                                     << (8 * (j & 3));
            *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// this lane's B fragment of row tile nt0 at k-step ks; tile n follows at
// n * 32
__device__ __forceinline__ const uint2* bfr_step(const uint2* bfr, int ks,
                                                 int ntpad, int nt0, int lane) {
    return bfr + (ks * ntpad + nt0) * 32 + lane;
}

// D = A B with unsigned bytes (B up to 128), C = 0
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "r"(0));
}

// bit 0 of the low bytes of a, b, c, d as bytes 0..3
__device__ __forceinline__ uint32_t pack_bits(int a, int b, int c, int d) {
    return prmt(prmt(a, b, 0x0040u), prmt(c, d, 0x0040u), 0x5410u)
           & 0x01010101u;
}

template <int NTR, bool VEC>
__global__ void __launch_bounds__(kThreads)
gf_planes_kernel(const int8_t* __restrict__ planes, uint32_t* __restrict__ out,
                 const uint2* __restrict__ frags, int k, int rows,
                 int nt_per_block, long long nw, long long ntile,
                 long long tiles) {
    constexpr int NG = (NTR + 3) / 4;   // groups of 4 rows for the gather
    extern __shared__ uint2 smem[];     // B [kt][ntpad][32], then kStages
                                        // slices per warp
    const int k8 = 8 * k, kt = (k8 + 31) / 32;
    const int nt_begin = blockIdx.y * nt_per_block;
    const int nt_count = min(nt_per_block, rows - nt_begin);
    const int ngrp = (nt_count + NTR - 1) / NTR;
    const int ntpad = (nt_per_block + NTR - 1) / NTR * NTR;
    // B fragments regrouped k-step major, rows past nt_count zero, so a
    // pass's NTR tiles sit at fixed offsets and need no guard
    for (int t = threadIdx.x; t < kt * ntpad * 32; t += blockDim.x) {
        const int ln = t & 31, n = (t >> 5) % ntpad, ks = (t >> 5) / ntpad;
        smem[t] = n < nt_count
            ? frags[((long long)(nt_begin + n) * kt + ks) * 32 + ln]
            : make_uint2(0u, 0u);
    }
    __syncthreads();

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tig = lane & 3;
    uint8_t* ring = reinterpret_cast<uint8_t*>(smem + kt * ntpad * 32)
                  + warp * kStages * kSlice;
    // the gather's B: row 4tig + j (16 + 4tig + j) of column g is
    // 2^(2tig + (j & 1)) where g is the slot's row of the group
    uint32_t gb0 = 0u, gb1 = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const uint32_t w = 1u << (2 * tig + (j & 1));
        if (g == (j >> 1)) gb0 |= w << (8 * j);
        if (g == 2 + (j >> 1)) gb1 |= w << (8 * j);
    }
    const long long tstride = (long long)gridDim.x * kWarps;
    const long long first = (long long)blockIdx.x * kWarps + warp;
    const long long off0 = (long long)(lane >> 1) * nw + 16 * (lane & 1);
    const long long k8nw = (long long)k8 * nw;

    // producer: kStages - 1 slices ahead of the consumer, across tiles
    Cursor pc;
    pc.tile = first;
    pc.grp = pc.b = pc.ks = 0;
    seek(pc, planes, tiles, ntile, nw, k8, lane);
    auto advance = [&](Cursor& c) {
        if (++c.ks < kt) {
            c.row += 32 * nw;
            c.krem -= 32;
            return;
        }
        c.ks = 0;
        c.krem = k8;
        if (++c.b == 4) {
            c.b = 0;
            if (++c.grp == ngrp) {
                c.grp = 0;
                c.tile += tstride;
                seek(c, planes, tiles, ntile, nw, k8, lane);
                return;
            }
        }
        c.row = c.base + c.b * k8nw;
    };
    for (int s = 0; s < kStages - 1; ++s) {
        stage<VEC>(ring + s * kSlice, pc, off0, nw, lane);
        advance(pc);
    }
    int slot = 0;
    // this lane's words of a slice: rows 4 tig + p (+ 16) at column 4g
    const int lds_off = tig * 8 + g;

    for (long long tile = first; tile < tiles; tile += tstride) {
        const long long bi = tile / ntile;
        const long long col0 = (tile - bi * ntile) * kCols;
        for (int nt0 = 0; nt0 < nt_count; nt0 += NTR) {
            uint32_t W[2][NG][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int G = 0; G < NG; ++G)
#pragma unroll
                    for (int q = 0; q < 4; ++q) W[mi][G][q] = 0u;
            for (int b = 0; b < 4; ++b) {
                int acc[2][NTR][4];
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                    for (int n = 0; n < NTR; ++n)
#pragma unroll
                        for (int q = 0; q < 4; ++q) acc[mi][n][q] = 0;
                for (int ks = 0; ks < kt; ++ks) {
                    asm volatile("cp.async.wait_group %0;"
                                 :: "n"(kStages - 2) : "memory");
                    __syncwarp();
                    // x[4h + p] = 4 columns 4g.. of slice row 16h + 4tig + p,
                    // at slot p * 8 + 4h + tig
                    const uint32_t* sl =
                        reinterpret_cast<const uint32_t*>(ring + slot * kSlice)
                        + lds_off;
                    uint32_t x[8];
#pragma unroll
                    for (int h = 0; h < 2; ++h)
#pragma unroll
                        for (int p = 0; p < 4; ++p)
                            x[4 * h + p] = sl[(p * 8 + 4 * h) * 8]
                                         & 0x01010101u;
                    const uint2* bs = bfr_step(smem, ks, ntpad, nt0, lane);
                    uint2 bv[NTR];
#pragma unroll
                    for (int n = 0; n < NTR; ++n) bv[n] = bs[n * 32];
                    // refill the slot every lane finished reading last step
                    stage<VEC>(ring + ((slot + kStages - 1) % kStages) * kSlice,
                               pc, off0, nw, lane);
                    advance(pc);
                    slot = (slot + 1) % kStages;
                    // 4 x 4 byte transposes: T[h][j] = rows 16h + 4tig + 0..3
                    // of column 4g + j; m-tile mi takes columns 4g + 2mi
                    // (row g) and 4g + 2mi + 1 (row g + 8)
                    uint32_t T[2][4];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const uint32_t* v = x + 4 * h;
                        const uint32_t t0 = prmt(v[0], v[1], 0x5140u);
                        const uint32_t t1 = prmt(v[2], v[3], 0x5140u);
                        const uint32_t t2 = prmt(v[0], v[1], 0x7362u);
                        const uint32_t t3 = prmt(v[2], v[3], 0x7362u);
                        T[h][0] = prmt(t0, t1, 0x5410u);
                        T[h][1] = prmt(t0, t1, 0x7632u);
                        T[h][2] = prmt(t2, t3, 0x5410u);
                        T[h][3] = prmt(t2, t3, 0x7632u);
                    }
                    const uint32_t a[2][4] = {
                        {T[0][0], T[0][1], T[1][0], T[1][1]},
                        {T[0][2], T[0][3], T[1][2], T[1][3]}};
#pragma unroll
                    for (int n = 0; n < NTR; ++n)
#pragma unroll
                        for (int mi = 0; mi < 2; ++mi)
                            mma_s8(acc[mi][n], a[mi], bv[n].x, bv[n].y);
                }
                // byte b of every word: bit s' of output row t sits in
                // acc[mi][t][*] at column s'; a second product with the
                // weights 2^s' gathers the 8 bits of each byte, four rows
                // at a time, and PRMT drops the byte into the word
                const uint32_t sel = (0x3210u & ~(0xFu << (4 * b)))
                                   | (4u << (4 * b));
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                    for (int G = 0; G < NG; ++G) {
                        const int* u0 = acc[mi][4 * G];
                        const int* u1 = acc[mi][min(4 * G + 1, NTR - 1)];
                        const int* u2 = acc[mi][min(4 * G + 2, NTR - 1)];
                        const int* u3 = acc[mi][min(4 * G + 3, NTR - 1)];
                        constexpr int z = 0;
                        const bool h1 = 4 * G + 1 < NTR, h2 = 4 * G + 2 < NTR,
                                   h3 = 4 * G + 3 < NTR;
                        const uint32_t a2[4] = {
                            pack_bits(u0[0], u0[1], h1 ? u1[0] : z,
                                      h1 ? u1[1] : z),
                            pack_bits(u0[2], u0[3], h1 ? u1[2] : z,
                                      h1 ? u1[3] : z),
                            pack_bits(h2 ? u2[0] : z, h2 ? u2[1] : z,
                                      h3 ? u3[0] : z, h3 ? u3[1] : z),
                            pack_bits(h2 ? u2[2] : z, h2 ? u2[3] : z,
                                      h3 ? u3[2] : z, h3 ? u3[3] : z)};
                        int d[4];
                        mma_u8(d, a2, gb0, gb1);
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                            W[mi][G][q] = prmt(W[mi][G][q], d[q], sel);
                    }
            }
            // lane (g, tig < 2) holds rows t = nt_begin + nt0 + 4G + 2tig
            // + (q & 1) of columns 4g + 2mi + (q >> 1)
            if (tig < 2) {
                uint32_t* dst = out + (bi * rows + nt_begin + nt0) * nw
                              + col0 + 4 * g;
#pragma unroll
                for (int G = 0; G < NG; ++G)
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int tl = 4 * G + 2 * tig + (q & 1);
                        if (tl < NTR && nt0 + tl < nt_count) {
                            uint32_t* d = dst + tl * nw + (q >> 1);
                            const long long col = col0 + 4 * g + (q >> 1);
#pragma unroll
                            for (int mi = 0; mi < 2; ++mi)
                                if (col + 2 * mi < nw) d[2 * mi] = W[mi][G][q];
                        }
                    }
            }
        }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
}

template <int NTR, bool VEC>
int launch(const void* planes, void* out, const void* frags, int batch,
           int k, int rows, int nt_per_block, long long nw,
           cudaStream_t stream) {
    const int kt = (8 * k + 31) / 32;
    const long long ntile = (nw + kCols - 1) / kCols;
    const long long tiles = (long long)batch * ntile;
    const int ntpad = (nt_per_block + NTR - 1) / NTR * NTR;
    const size_t smem = (size_t)ntpad * kt * 32 * sizeof(uint2)
                      + (size_t)kWarps * kStages * kSlice;
    auto kern = gf_planes_kernel<NTR, VEC>;
    // one query per variant and operand size (a race here costs a
    // repeated query only)
    static size_t seen_smem = ~(size_t)0;
    static int sms = 0, per_sm = 0;
    if (seen_smem != smem) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, smem);
        seen_smem = smem;
    }
    const long long want = (tiles + kWarps - 1) / kWarps;
    const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const dim3 grid((unsigned)(want < cap ? want : cap),
                    (unsigned)((rows + nt_per_block - 1) / nt_per_block));
    kern<<<grid, kThreads, smem, stream>>>(
        (const int8_t*)planes, (uint32_t*)out, (const uint2*)frags, k, rows,
        nt_per_block, nw, ntile, tiles);
    return (int)cudaGetLastError();
}

template <bool VEC>
int launch_nt(const void* planes, void* out, const void* frags, int batch,
              int k, int rows, int nt_per_block, long long nw,
              cudaStream_t st) {
#define CTT_NT(n) \
    case n: return launch<n, VEC>(planes, out, frags, batch, k, rows, \
                                  nt_per_block, nw, st)
    switch (nt_per_block <= kMaxNt ? nt_per_block : kMaxNt - 1) {
        CTT_NT(1); CTT_NT(2); CTT_NT(3); CTT_NT(4); CTT_NT(5);
        CTT_NT(6); CTT_NT(7); CTT_NT(8); CTT_NT(9);
    }
#undef CTT_NT
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// planes [batch, 32k, nw] int8, out [batch, rows, nw] words; frags
// [rows][ceil(8k/32)][32 lanes] x 2 words, the B operand in mma fragment
// order; nt_per_block output rows share one block's shared copy, the rest
// tile over grid.y.
extern "C" int ctt_gf_planes(const void* planes, void* out, const void* frags,
                             int batch, int k, int rows, int nt_per_block,
                             long long nw, void* stream) {
    if ((long long)batch * nw <= 0 || rows <= 0) return 0;
    if (nt_per_block <= 0) return (int)cudaErrorInvalidValue;
    const bool vec = nw % 16 == 0 && (uintptr_t)planes % 16 == 0;
    cudaStream_t st = (cudaStream_t)stream;
    return vec ? launch_nt<true>(planes, out, frags, batch, k, rows,
                                 nt_per_block, nw, st)
               : launch_nt<false>(planes, out, frags, batch, k, rows,
                                  nt_per_block, nw, st);
}
