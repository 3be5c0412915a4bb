// GF(2^8) matrix x byte chunks: out[b, j, c] = XOR_i coef[j, i] * in[b, i, c]
// on uint8 rows whose length is a multiple of 4 (the wrapper zero-pads the
// tail: zero bytes map to zero bytes).
//
// Replaces ceph_tpu/ops/gf_pallas.py::_gf_apply_pallas (K4, the pallas_call
// at :105, kernel _gf_kernel :59).  The TPU kernel expands each byte into
// 8 int8 bit planes and runs a GF(2) matmul on the MXU.  K4 computes the
// same map over the same bytes as gf_words (K1/K3), so it is the byte-layout
// instance of the same kernel: the rows are viewed as 32-bit words and run
// through gf_nibble.cuh (split-nibble tables zero-padded in shared memory,
// no guard in the hot loop, 8 input rows of 16 B loaded per chunk, a
// persistent grid-stride loop).  The design this replaced loaded one input
// row at a time, kept a row guard inside its hot loop and copied its
// tables once per 16-byte segment's block: 46% of its bytes bound.
//
// Bound on the H100: bytes, (k + rows) per column: 64 MiB read and 24 MiB
// written at the ec_bench shape (k=8, rows=3) is ~27 us at 3.35 TB/s.

#include "gf_nibble.cuh"

// in [batch, k, n] bytes, out [batch, rows, n] bytes, n % 4 == 0, both
// 4-byte aligned; tables [rows][k][8] words (LO then HI, 16 B each);
// rows_per_block output rows share one block's shared tables.
extern "C" int ctt_gf_bytes(const void* in, void* out, const void* tables,
                            int batch, int k, int rows, int rows_per_block,
                            long long n, void* stream) {
    if (n % 4) return (int)cudaErrorInvalidValue;
    return gf_nibble_apply(in, out, tables, batch, k, rows, rows_per_block,
                           n / 4, (cudaStream_t)stream);
}
