// Counting-Bloom insert (K1) and solidity probe (K2) for Hopper.
//
// K1 kmerax_bloom_insert replaces the Pallas kernel
//   kmerax/spectrum/pallas_bloom.py::_insert_kernel (via insert_pallas).
// K2 kmerax_bloom_query_solid replaces
//   kmerax/spectrum/pallas_bloom.py::_query_kernel (via query_solid_pallas).
//
// Addressing (DESIGN.md §5): every k-mer owns one 128-counter block row of
// the int32 table and d <= 4 lanes in it, packed 7 bits each in `lanepack`.
// K1 adds +1 per probe (a repeated lane gets +2); K2 reports whether every
// probed lane is >= t. Invalid k-mers add nothing and report 0.
//
// What bounds them on an H100: the table is 2^log2_width int32 counters,
// 2 GiB at log2_width=29, far above the 50 MB L2, so each k-mer is a
// random 512-byte row of device memory: one to four 32-byte sectors, with
// atomics for K1. Both kernels are latency- and sector-bound, not ALU-bound.
// The TPU kernel's whole design (DMA the table into VMEM, build one-hot rows
// on the MXU, serial row RMW) exists because a TPU has no scattered
// atomics; a GPU has them in L2, so the port is one thread per k-mer with
// global atomicAdd (integer adds commute: table bytes equal the plain
// index_add_ version for any order). Binning k-mers by block range to keep
// a slab of the table in L2, and hashing inside the kernel, are later work.

#include "kmerax.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void bloom_insert_kernel(int32_t* __restrict__ table,
                                    const int32_t* __restrict__ block,
                                    const int32_t* __restrict__ lanepack,
                                    const uint8_t* __restrict__ valid,
                                    int64_t n, int d) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !valid[i]) return;
    int32_t* row = table + (size_t)(uint32_t)block[i] * 128;
    uint32_t lp = (uint32_t)lanepack[i];
    for (int j = 0; j < d; ++j) atomicAdd(row + ((lp >> (7 * j)) & 127u), 1);
}

__global__ void bloom_query_solid_kernel(const int32_t* __restrict__ table,
                                         const int32_t* __restrict__ block,
                                         const int32_t* __restrict__ lanepack,
                                         const uint8_t* __restrict__ valid,
                                         uint8_t* __restrict__ out, int64_t n,
                                         int d, int t) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = valid[i] && kmerax_probe_solid(table, (uint32_t)block[i],
                                            (uint32_t)lanepack[i], d, t);
}

unsigned grid_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int kmerax_bloom_insert(int32_t* table, const int32_t* block,
                                   const int32_t* lanepack,
                                   const uint8_t* valid, int64_t n, int d,
                                   cudaStream_t stream) {
    if (n > 0)
        bloom_insert_kernel<<<grid_for(n), kThreads, 0, stream>>>(
            table, block, lanepack, valid, n, d);
    return (int)cudaGetLastError();
}

extern "C" int kmerax_bloom_query_solid(const int32_t* table,
                                        const int32_t* block,
                                        const int32_t* lanepack,
                                        const uint8_t* valid, uint8_t* out,
                                        int64_t n, int d, int t,
                                        cudaStream_t stream) {
    if (n > 0)
        bloom_query_solid_kernel<<<grid_for(n), kThreads, 0, stream>>>(
            table, block, lanepack, valid, out, n, d, t);
    return (int)cudaGetLastError();
}

extern "C" const char* kmerax_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
