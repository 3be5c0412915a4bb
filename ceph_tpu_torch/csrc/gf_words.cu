// GF(2^8) matrix x word-resident chunks (K1, and K3 through a uint8 -> int32
// view of the same bytes): out[b, j, c] = XOR_i c[j, i] * in[b, i, c]
// applied bytewise to every int32 word.
//
// Replaces ceph_tpu/ops/gf_pallas2.py::_gf_apply_words (K1, the pallas_call
// at :217) and _gf_apply_pallas2 (K3, :113).  The kernel, its design and
// its bound are in gf_nibble.cuh, which gf_bytes.cu (K4) shares.

#include "gf_nibble.cuh"

// in [batch, k, nw] words, out [batch, rows, nw] words, tables [rows][k][8]
// words: see gf_nibble_apply.
extern "C" int ctt_gf_words(const void* in, void* out, const void* tables,
                            int batch, int k, int rows, int rows_per_block,
                            long long nw, void* stream) {
    return gf_nibble_apply(in, out, tables, batch, k, rows, rows_per_block,
                           nw, (cudaStream_t)stream);
}
