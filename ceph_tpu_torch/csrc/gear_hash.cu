// Gear hashes of a [rows, L] uint8 batch -> [rows, L] uint32:
//   h_i = sum_{j<32, j<=i} GEAR[x_{i-j}] << j   (mod 2^32, per row)
// the boundary scan of content-defined chunking.
//
// Replaces K8, ceph_tpu/compress/chunker.py::_gear_kernel (:47, its kern
// :60-67): 32 shifted adds of the gathered gear values, zero-padded at the
// front of each row (the gear values, not the bytes: GEAR[0] != 0).
//
// Bound on the H100: bytes, 1 read + 4 written per position (the output is
// four times the input).  The sum equals the recurrence h <- (h << 1) +
// GEAR[x] run from h = 0 at the row start, because older terms shift out of
// the word.  So a lane takes 16 consecutive bytes (one 16-byte load) and
// runs the recurrence over them from 0: q_k, k = 0..15, and P = q_15, the
// hash of its own bytes alone.  The true hash at its position k is
//   q_k + ((P_prev1 + (P_prev2 << 16)) << (k + 1))
// with P_prev1, P_prev2 the P of the two 16-byte chunks before it (32
// bytes reach back into both), taken from the neighbouring lanes by a
// shuffle.  Each output then costs one shared-memory table load, a shift
// and two adds, with no 32-term sum and no warm-up.  A warp covers 32
// chunks and writes the outputs of the last 30: lanes 0 and 1 only supply
// the P of the two chunks before (zero before the row start).  The
// 256-entry table sits in shared memory; random bytes hit its banks
// randomly (a few-way conflict), which stays under the memory bound.
//
// Rows whose length is a multiple of 16 on a 16-byte aligned tensor (the
// batch engine's pow2 buckets) take uint4 loads and stores.  A lane's 16
// outputs are 64 contiguous bytes: stored straight from its registers,
// each store instruction would cover 32 lines 64 B apart, half a 32-byte
// sector each (the first design, 50% of the bound at [64, 1 MiB] on the
// H100).  So the warp stages its outputs in shared memory (a rotation per
// lane keeps both sides free of bank conflicts) and writes them as 16
// contiguous bytes a lane, 512 contiguous bytes an instruction.  Any other
// length takes the same arithmetic on byte loads and word stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;          // bytes a lane takes
constexpr int kOutChunks = 30;      // chunks a warp writes
constexpr int kStage = 4 * 32;      // uint4 of a warp's staged outputs
constexpr unsigned kFull = 0xffffffffu;

// Shared-memory slot of uint4 s (0..3) of lane l's outputs.  The four of a
// lane rotate by l >> 1, so the 8 lanes of each phase of a 16-byte store,
// and the 8 consecutive uint4 read back, hit 8 distinct 16-byte bank groups.
__device__ __forceinline__ int stage_slot(int l, int s) {
    return 4 * l + ((s + (l >> 1)) & 3);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gear_hash_kernel(const uint8_t* __restrict__ in, uint32_t* __restrict__ out,
                 const uint32_t* __restrict__ gear, long long length,
                 long long chunks_per_row, long long warps_per_row,
                 long long total_warps) {
    __shared__ uint32_t g[256];
    __shared__ uint4 stage[kVec ? kWarps * kStage : 1];
    for (int i = threadIdx.x; i < 256; i += kThreads) g[i] = gear[i];
    __syncthreads();
    const int lane = threadIdx.x & 31;
    uint4* ws = stage + (kVec ? (threadIdx.x >> 5) * kStage : 0);
    for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
         w < total_warps; w += (long long)gridDim.x * kWarps) {
        const long long row = w / warps_per_row;
        const long long c0 = (w - row * warps_per_row) * kOutChunks;
        const long long c = c0 + lane - 2;
        const uint8_t* rin = in + row * length;
        const bool have = c >= 0 && c < chunks_per_row;
        uint32_t q[kChunk] = {};
        uint32_t h = 0;
        if (have) {
            uint8_t b[kChunk];
            if (kVec) {
                const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                    rin + c * kChunk));
                const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int k = 0; k < kChunk; ++k)
                    b[k] = (uint8_t)(words[k >> 2] >> (8 * (k & 3)));
            } else {
#pragma unroll
                for (int k = 0; k < kChunk; ++k) {
                    const long long p = c * kChunk + k;
                    b[k] = p < length ? __ldg(rin + p) : 0;
                }
            }
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
                h = (h << 1) + g[b[k]];
                q[k] = h;
            }
        }
        const uint32_t p1 = __shfl_up_sync(kFull, h, 1);
        const uint32_t p2 = __shfl_up_sync(kFull, h, 2);
        const uint32_t h0 = p1 + (p2 << 16);
        if (kVec) {
            // stage the 16 outputs; the warp's 30 chunks are staged uint4
            // 8..127 (lanes 2..31), written back contiguously
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                uint4 v;
                v.x = q[4 * s + 0] + (h0 << (4 * s + 1));
                v.y = q[4 * s + 1] + (h0 << (4 * s + 2));
                v.z = q[4 * s + 2] + (h0 << (4 * s + 3));
                v.w = q[4 * s + 3] + (h0 << (4 * s + 4));
                ws[stage_slot(lane, s)] = v;
            }
            __syncwarp();
            uint4* dst = reinterpret_cast<uint4*>(out + row * length +
                                                  c0 * kChunk);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const int idx = 32 * t + lane;      // staged uint4
                const int src = idx >> 2;           // the lane it is from
                if (idx >= 8 && c0 + src - 2 < chunks_per_row)
                    dst[idx - 8] = ws[stage_slot(src, idx & 3)];
            }
            __syncwarp();
        } else if (have && lane >= 2) {
            uint32_t* rout = out + row * length + c * kChunk;
#pragma unroll
            for (int k = 0; k < kChunk; ++k)
                if (c * kChunk + k < length) rout[k] = q[k] + (h0 << (k + 1));
        }
    }
}

}  // namespace

extern "C" int ctt_gear_hash(const void* in, void* out, const void* gear,
                             int rows, long long length, int vec,
                             void* stream) {
    if (rows <= 0 || length <= 0) return 0;
    const long long chunks = (length + kChunk - 1) / kChunk;
    const long long warps_per_row = (chunks + kOutChunks - 1) / kOutChunks;
    const long long total = warps_per_row * rows;
    long long blocks = (total + kWarps - 1) / kWarps;
    if (blocks > 8192) blocks = 8192;      // grid-stride over the rest
    cudaStream_t s = (cudaStream_t)stream;
    if (vec)
        gear_hash_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
            (const uint8_t*)in, (uint32_t*)out, (const uint32_t*)gear,
            length, chunks, warps_per_row, total);
    else
        gear_hash_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
            (const uint8_t*)in, (uint32_t*)out, (const uint32_t*)gear,
            length, chunks, warps_per_row, total);
    return (int)cudaGetLastError();
}
