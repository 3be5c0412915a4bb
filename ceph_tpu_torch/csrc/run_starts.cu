// Run starts of a [rows, L] uint8 batch -> [rows, L] bool (bytes 0/1):
//   out[r][i] = x[r][i] != x[r][i-1] for i > 0, and out[r][0] = 1
// the device scan of the rle codec's run-length pass.
//
// Replaces K9, ceph_tpu/compress/codec.py::_boundary_kernel (:88, its kern
// :98-103): the compare of each byte with the one before it, as int16 with
// -1 before column 0 (so column 0 is always a run start).
//
// Bound on the H100: bytes, 1 read + 1 written per position.  One compare
// per byte: a thread takes 16 bytes with one 16-byte load, builds the
// "previous byte" vector by a funnel shift of its own words and a one-byte
// halo (the byte before its 16, read through the L1 that its neighbour's
// load just filled), compares four bytes at a time (__vcmpne4) and writes
// 16 result bytes with one 16-byte store.  Rows whose length is a multiple
// of 16 on a 16-byte aligned tensor take this path; any other length takes
// one byte per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;

__global__ void __launch_bounds__(kThreads)
run_starts_vec_kernel(const uint8_t* __restrict__ in,
                      uint8_t* __restrict__ out, long long chunks_per_row,
                      long long total) {
    for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
         t < total; t += (long long)gridDim.x * kThreads) {
        const long long c = t % chunks_per_row;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(in) + t);
        // the byte before the chunk; at a row start any byte that
        // differs from x[0] (column 0 is always a run start)
        const uint32_t halo = c ? __ldg(in + t * kVec - 1)
                                : (~v.x & 0xffu);
        uint4 prev;
        prev.x = (v.x << 8) | halo;
        prev.y = __funnelshift_l(v.x, v.y, 8);
        prev.z = __funnelshift_l(v.y, v.z, 8);
        prev.w = __funnelshift_l(v.z, v.w, 8);
        uint4 r;
        r.x = __vcmpne4(v.x, prev.x) & 0x01010101u;
        r.y = __vcmpne4(v.y, prev.y) & 0x01010101u;
        r.z = __vcmpne4(v.z, prev.z) & 0x01010101u;
        r.w = __vcmpne4(v.w, prev.w) & 0x01010101u;
        reinterpret_cast<uint4*>(out)[t] = r;
    }
}

__global__ void __launch_bounds__(kThreads)
run_starts_byte_kernel(const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out, long long length,
                       long long total) {
    for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
         t < total; t += (long long)gridDim.x * kThreads) {
        const long long i = t % length;
        out[t] = i == 0 || __ldg(in + t) != __ldg(in + t - 1);
    }
}

}  // namespace

extern "C" int ctt_run_starts(const void* in, void* out, int rows,
                              long long length, int vec, void* stream) {
    if (rows <= 0 || length <= 0) return 0;
    const long long total = vec ? (long long)rows * (length / kVec)
                                : (long long)rows * length;
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 16384) blocks = 16384;    // grid-stride over the rest
    cudaStream_t s = (cudaStream_t)stream;
    if (vec)
        run_starts_vec_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
            (const uint8_t*)in, (uint8_t*)out, length / kVec, total);
    else
        run_starts_byte_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
            (const uint8_t*)in, (uint8_t*)out, length, total);
    return (int)cudaGetLastError();
}
