// Kernel B: prepend the `.rsn` prepad and lay each row out as bytes.
//
// Replaces the XLA epilogue raisin_tpu/ops/arithmetic_pallas.py:_assemble_rows
// (the prepad shift, the final partial word and the byte swap). The stream
// of T raw bits gets pad = 8 - T%8 bits (1..8, pattern 0..01) in front
// (raisin_tpu/bitkit/packing.py:pack_prepad_sentinel), so every output word
// is a funnel shift of two neighbouring raw words; word -1 is the pattern 1.
//
// What bounds it: memory traffic, one 4-byte read pair and one 4-byte write
// per output word. One thread per output word, neighbouring threads on
// neighbouring words, so loads and stores coalesce.
#include "arith_common.cuh"

namespace {

// Raw word j of a T-bit stream, with the bits at and past T cleared.
__device__ __forceinline__ uint32_t raw_word(const uint32_t* row, int j, int T) {
    const long long start = 32LL * j;
    if (start >= T) return 0u;
    uint32_t w = row[j];
    const long long keep = T - start;
    if (keep < 32) w &= ~(0xFFFFFFFFu >> keep);
    return w;
}

__global__ void arith_prepad_kernel(const uint32_t* __restrict__ raw,
                                    const int32_t* __restrict__ bits,
                                    uint32_t* __restrict__ rows,
                                    int32_t* __restrict__ byte_lens, int B, int capw) {
    const size_t gid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (gid >= (size_t)B * capw) return;
    const int b = (int)(gid / capw);
    const int j = (int)(gid % capw);
    const int T = bits[b];
    const int pad = 8 - (T & 7);  // 8 when the stream is byte-aligned
    const uint32_t* row = raw + (size_t)b * capw;
    const uint32_t cur = raw_word(row, j, T);
    const uint32_t prev = j == 0 ? 1u : raw_word(row, j - 1, T);
    const uint32_t v = (prev << (32 - pad)) | (cur >> pad);
    rows[gid] = __byte_perm(v, 0, 0x0123);  // stream order = byte order
    if (j == 0) byte_lens[b] = (T + pad) >> 3;
}

}  // namespace

extern "C" int rsn_arith_prepad(const void* raw, const void* bits, void* rows, void* byte_lens,
                                int B, int capw, void* stream) {
    const int threads = 256;
    const size_t total = (size_t)B * capw;
    const unsigned grid = (unsigned)((total + threads - 1) / threads);
    arith_prepad_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)raw, (const int32_t*)bits, (uint32_t*)rows, (int32_t*)byte_lens, B, capw);
    return (int)cudaGetLastError();
}
