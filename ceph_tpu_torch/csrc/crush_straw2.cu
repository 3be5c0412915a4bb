// The straw2 choose of one CRUSH descent level for a batch of lanes:
//   out[i] = items[row][argmax_j draw(j)],
//   draw(j) = trunc_div(ln16[hash32_3(x, hash_id[j], r) & 0xFFFF], w[j])
// (INT64_MIN when w[j] == 0; the first maximum wins, item 0 seeds it).
//
// Replaces the device program of ceph_tpu/crush/jax_mapper.py: straw2()
// (:958) with _straw2_draws (:228) and _ln16_s_tbl (:53).  The TPU
// program looks crush_ln up with one-hot MXU limb products
// (_straw2_numerator_onehot, :124-212) and divides by magic-number
// multiplies (_magicu64, :65, :214), because per-element gathers and
// 64-bit divides are slow there.  The GPU gathers from a 512 KiB table
// that stays in L2, and has a native 32-bit ALU and a 64-bit divide.
//
// Bound on the H100: the integer ALU pipe.  Per lane and item,
// crush_hash32_3 compiles to IADD3 / SHF / LOP3 triples on the ALU pipe
// (left shifts as IMAD.SHL), then one table gather, the software 64-bit
// divide (mostly IMAD on the FMA pipe) and a compare: ~254 instructions,
// ~173 of them ALU (chip_smoke.py's [sass] line counts them from the
// SASS); the bytes (16 B in and 4 B out per lane, the bucket tables
// once) are small beside that.  The
// design is the simple one: one thread per lane walks its row's items in
// order from global memory (a level's rows are few and stay in L1/L2).
// chip_smoke.py times it at the host level of the 4096-OSD map.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kSeed = 1315423911u;

#define CTT_MIX(a, b, c)              \
    do {                              \
        a = a - b - c; a ^= c >> 13;  \
        b = b - c - a; b ^= a << 8;   \
        c = c - a - b; c ^= b >> 13;  \
        a = a - b - c; a ^= c >> 12;  \
        b = b - c - a; b ^= a << 16;  \
        c = c - a - b; c ^= b >> 5;   \
        a = a - b - c; a ^= c >> 3;   \
        b = b - c - a; b ^= a << 10;  \
        c = c - a - b; c ^= b >> 15;  \
    } while (0)

__device__ __forceinline__ uint32_t hash32_3(uint32_t a, uint32_t b,
                                             uint32_t c) {
    uint32_t h = kSeed ^ a ^ b ^ c;
    uint32_t x = 231232u, y = 1232u;
    CTT_MIX(a, b, h);
    CTT_MIX(c, x, h);
    CTT_MIX(y, a, h);
    CTT_MIX(b, x, h);
    CTT_MIX(y, c, h);
    return h;
}

__global__ void __launch_bounds__(kThreads)
crush_straw2_kernel(const int* __restrict__ rows, const int* __restrict__ xs,
                    const int* __restrict__ rs, const int* __restrict__ pos,
                    int* __restrict__ out, const int* __restrict__ items,
                    const int* __restrict__ hash_ids,
                    const long long* __restrict__ weights,
                    const int* __restrict__ sizes,
                    const long long* __restrict__ ln16, int lanes, int nb,
                    int S, int P) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= lanes) return;
    const int row = rows[i];
    const uint32_t x = (uint32_t)xs[i], r = (uint32_t)rs[i];
    const int p = min(max(pos[i], 0), P - 1);
    const int size = sizes[row];
    const int* hid = hash_ids + (long long)row * S;
    const long long* w = weights + ((long long)p * nb + row) * S;
    int best = 0;
    long long best_draw = 0;
    for (int j = 0; j < size; ++j) {
        const uint32_t u = hash32_3(x, (uint32_t)__ldg(hid + j), r) & 0xFFFFu;
        const long long wj = __ldg(w + j);
        const long long draw =
            wj > 0 ? __ldg(ln16 + u) / wj : (long long)INT64_MIN;
        if (j == 0 || draw > best_draw) {
            best = j;
            best_draw = draw;
        }
    }
    out[i] = items[(long long)row * S + best];
}

}  // namespace

// rows, xs (u32 bits), rs, pos [lanes] int32; out [lanes] int32; items and
// hash_ids [nb, S] int32; weights [P, nb, S] int64; sizes [nb] int32; ln16
// [65536] int64.  Rows must lie in [0, nb).
extern "C" int ctt_crush_straw2(const void* rows, const void* xs,
                                const void* rs, const void* pos, void* out,
                                const void* items, const void* hash_ids,
                                const void* weights, const void* sizes,
                                const void* ln16, int lanes, int nb, int S,
                                int P, void* stream) {
    if (lanes <= 0) return 0;
    const unsigned grid = (unsigned)((lanes + kThreads - 1) / kThreads);
    crush_straw2_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)rows, (const int*)xs, (const int*)rs, (const int*)pos,
        (int*)out, (const int*)items, (const int*)hash_ids,
        (const long long*)weights, (const int*)sizes,
        (const long long*)ln16, lanes, nb, S, P);
    return (int)cudaGetLastError();
}
