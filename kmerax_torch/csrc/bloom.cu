// Counting-Bloom insert (K1), its routed-row form on a range shard (K1r) and
// round-start window solidity (K2) for Hopper.
//
// K1 kmerax_bloom_insert replaces the Pallas kernel
//   kmerax/spectrum/pallas_bloom.py::_insert_kernel (via insert_pallas),
// and with it the count step's addressing that XLA fused into the Pallas
// kernel's producer (extract, canonical form, hash; kmerax/pipeline/run.py
// count step).
// K2 kmerax_bloom_query_solid replaces
//   kmerax/spectrum/pallas_bloom.py::_query_kernel (via query_solid_pallas)
// as the correct round calls it, kmerax/ops/correct.py::_window_counts:
// it takes the round's (B, L) int32 read batch and last_j and returns the
// solidity of every window, with the addressing done in the kernel.
//
// Addressing (DESIGN.md §5): every k-mer owns one 128-counter block row of
// the int32 table and d <= 4 lanes in it, 7 bits each of its second hash.
// The row comes from kmerax_block (kmerax.cuh) under the bucket scheme, a
// template parameter: the hash scheme's low bits of h1, or the minimizer
// scheme's bucket above them (k-m+1 more mix32 per k-mer).
// K1 adds +1 per probe (a repeated lane gets +2); K2 reports whether every
// probed lane is >= t. Invalid k-mers add nothing and report 0.
//
// Both take the read batch itself and do their own addressing: eager
// PyTorch fuses nothing, so computing the addresses in torch cost ~270
// dispatched ops and their int64 temporaries per batch around one launch
// (K1's count step; K2's _window_counts, twice a batch). One warp per read
// (8 reads per block): the warp packs the read once into shared memory
// (2-bit words and an N bitmask, kmerax.cuh), then lane l takes windows l,
// l+32, ...: W funnel shifts give the window's words, the N bits its
// validity, and the shared helpers its canonical form and hash.
// K1: each probe is one atomicAdd whose result is unused (a RED in L2).
// With a pending buffer the kernel also writes the window's row: the
// canonical words, or all 0xFFFFFFFF for an invalid window (the bytes of
// to_u32_bits(mask_invalid(...))). The valid count is a ballot per warp and
// one 64-bit atomicAdd per block.
// K2: a window is solid iff it starts in [0, last_j[r]], holds no base >= 4
// and passes the two-round probe (kmerax.cuh, shared with K3); each warp
// step writes 32 consecutive output bytes.
//
// K1r kmerax_bloom_insert_rows replaces the same Pallas kernel in its
// routed-row form: insert_pallas(..., local_bits=...) as
// kmerax/spectrum/sharded.py::sharded_insert_step calls it on a mesh. It
// takes the canonical k-mer rows that the bucket all-to-all brought to this
// rank ((N, W) 32-bit words, the sentinel row where invalid, and an (N,)
// valid mask) and adds them into this rank's 2^local_bits range shard of the
// table: the block comes from the GLOBAL table's addressing (kmerax_block
// with the global block mask, so the minimizer scheme's bucket bits land
// where they do in the whole table), then keeps its low local_bits - 7 bits
// (DESIGN.md §12: the shard bits are the top bits of the block). One thread
// per row; a probe is one atomicAdd, as in K1. With a pending buffer it also
// writes the row (the sentinel where invalid) at row off + i.
//
// What bounds them on an H100: the table is 2^log2_width int32 counters,
// 2 GiB at log2_width=29, far above the 50 MB L2, so each k-mer touches
// one random 512-byte row: ~3.6 distinct 32-byte sectors for K1's d=4,
// each read and written once, and for K2 one sector for a k-mer that fails
// its first lane, up to d for a solid one. That sector floor, not the few
// bytes per k-mer of the byte bound, is what a kernel can approach; the
// addressing's ~130 int32 operations per k-mer sit under it. K1r reads
// a valid byte a row and the 4W bytes of a valid row only (the sentinel
// slots, most of the capacity at route_safety 4, are never read) and has
// the same sector floor on its 2^local_bits shard; with no extraction or
// canonical form, its addressing is the two hashes (~50 operations a k-mer
// at W = 2).

#include "kmerax.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;    // reads per block

// the warp packs one read of L bases (positions past L read as 4) into P
// (2 nch + 1 code words, the last one 0) and N (nch N-mask words); every
// lane calls it
template <typename Base>
static __device__ __forceinline__ void pack_read(uint32_t* P, uint32_t* N,
                                                 const Base* row, int L,
                                                 int lane) {
    const int nch = (L + 31) / 32;
    for (int c = 0; c < nch; ++c) {
        const int p = 32 * c + lane;
        const int b = p < L ? (int)row[p] : 4;
        kmerax_pack_chunk(P, N, c, lane, (uint32_t)b, b >= 4);
    }
    if (lane == 0) P[2 * nch] = 0;
    __syncwarp();
}

template <int W, bool kMinimizer>
__global__ void bloom_insert_kernel(int32_t* __restrict__ table,
                                    const int8_t* __restrict__ bases, int B,
                                    int L, int k, uint32_t block_mask, int d,
                                    int m, int log2_buckets,
                                    uint32_t* __restrict__ pending,
                                    int64_t off,
                                    unsigned long long* __restrict__ n_valid) {
    extern __shared__ uint32_t smem[];
    __shared__ unsigned block_valid;
    const int nch = (L + 31) / 32;           // 32-base chunks of a read
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    uint32_t* P = smem + warp * (3 * nch + 1);   // 2 nch + 1 code words
    uint32_t* N = P + 2 * nch + 1;               // nch N-mask words
    if (threadIdx.x == 0) block_valid = 0;
    const int64_t r = (int64_t)blockIdx.x * kWarps + warp;
    unsigned n_ok = 0;                       // the same on every lane
    if (r < B) {                             // warp-uniform
        pack_read(P, N, bases + r * L, L, lane);
        const int nk = L - k + 1;
        for (int j0 = 0; j0 < nk; j0 += 32) {
            const int j = j0 + lane;
            const bool in = j < nk;
            const bool ok = in && kmerax_span_clear(N, j, k);
            uint32_t words[W];
            if (ok) {
                kmerax_window_words<W>(P, j, k, words);
                kmerax_canonicalize(words, W, k);
                const uint32_t h1 = kmerax_kmer_hash(words, W,
                                                     KMERAX_HASH_SEED_1);
                const uint32_t h2 = kmerax_kmer_hash(words, W,
                                                     KMERAX_HASH_SEED_2);
                int32_t* trow = table + (size_t)kmerax_block<W, kMinimizer>(
                    words, k, h1, block_mask, m, log2_buckets) * 128;
                for (int i = 0; i < d; ++i)
                    atomicAdd(trow + ((h2 >> (7 * i)) & 127u), 1);
            }
            if (pending != nullptr && in) {
                uint32_t* out = pending + (off + r * nk + j) * W;
#pragma unroll
                for (int wi = 0; wi < W; ++wi)
                    out[wi] = ok ? words[wi] : KMERAX_FULL_MASK;
            }
            n_ok += __popc(__ballot_sync(KMERAX_FULL_MASK, ok));
        }
    }
    __syncthreads();
    if (lane == 0 && n_ok) atomicAdd(&block_valid, n_ok);
    __syncthreads();
    if (threadIdx.x == 0 && block_valid)
        atomicAdd(n_valid, (unsigned long long)block_valid);
}

template <int W, bool kMinimizer>
__global__ void bloom_query_solid_kernel(const int32_t* __restrict__ table,
                                         const int32_t* __restrict__ bases,
                                         int B, int L, int k,
                                         const int32_t* __restrict__ last_j,
                                         uint32_t block_mask, int d, int m,
                                         int log2_buckets, int t,
                                         uint8_t* __restrict__ out) {
    extern __shared__ uint32_t smem[];
    const int nch = (L + 31) / 32;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t r = (int64_t)blockIdx.x * kWarps + warp;
    if (r >= B) return;                      // warp-uniform; no barrier
    const int lj = last_j[r];
    uint32_t* P = smem + warp * (3 * nch + 1);
    uint32_t* N = P + 2 * nch + 1;
    pack_read(P, N, bases + r * L, L, lane);
    const int nk = L - k + 1;
    uint8_t* orow = out + r * nk;
    for (int j0 = 0; j0 < nk; j0 += 32) {
        const int j = j0 + lane;
        bool solid = false;
        if (j < nk && j <= lj && kmerax_span_clear(N, j, k)) {
            uint32_t words[W];
            kmerax_window_words<W>(P, j, k, words);
            kmerax_canonicalize(words, W, k);
            const uint32_t h1 = kmerax_kmer_hash(words, W, KMERAX_HASH_SEED_1);
            const uint32_t h2 = kmerax_kmer_hash(words, W, KMERAX_HASH_SEED_2);
            solid = kmerax_probe_two_rounds(
                table, kmerax_block<W, kMinimizer>(words, k, h1, block_mask,
                                                   m, log2_buckets),
                h2, d, t);
        }
        if (j < nk) orow[j] = solid;
    }
}

template <int W, bool kMinimizer>
__global__ void bloom_insert_rows_kernel(int32_t* __restrict__ table,
                                         const uint32_t* __restrict__ rows,
                                         const uint8_t* __restrict__ rvalid,
                                         int64_t N, int k, uint32_t block_mask,
                                         uint32_t local_mask, int d, int m,
                                         int log2_buckets,
                                         uint32_t* __restrict__ pending,
                                         int64_t off) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;
    const bool ok = rvalid[i] != 0;
    uint32_t words[W];
#pragma unroll
    for (int wi = 0; wi < W; ++wi)          // a sentinel slot's words unread
        words[wi] = ok ? rows[i * W + wi] : KMERAX_FULL_MASK;
    if (ok) {
        const uint32_t h1 = kmerax_kmer_hash(words, W, KMERAX_HASH_SEED_1);
        const uint32_t h2 = kmerax_kmer_hash(words, W, KMERAX_HASH_SEED_2);
        const uint32_t block = kmerax_block<W, kMinimizer>(
            words, k, h1, block_mask, m, log2_buckets) & local_mask;
        int32_t* trow = table + (size_t)block * 128;
        for (int j = 0; j < d; ++j)
            atomicAdd(trow + ((h2 >> (7 * j)) & 127u), 1);
    }
    if (pending != nullptr) {
        uint32_t* out = pending + (off + i) * W;
#pragma unroll
        for (int wi = 0; wi < W; ++wi)
            out[wi] = words[wi];
    }
}

cudaError_t smem_bytes(int L, size_t* smem) {
    *smem = (size_t)kWarps * (3 * ((L + 31) / 32) + 1) * sizeof(uint32_t);
    return *smem > 48 * 1024 ? cudaErrorInvalidValue : cudaSuccess;
}

}  // namespace

extern "C" int kmerax_bloom_insert(int32_t* table, const int8_t* bases,
                                   int B, int L, int k, uint32_t block_mask,
                                   int d, int m, int log2_buckets,
                                   int32_t* pending, int64_t off,
                                   int64_t* n_valid, cudaStream_t stream) {
    if (B <= 0) return (int)cudaGetLastError();
    size_t smem;
    if (smem_bytes(L, &smem) != cudaSuccess) return (int)cudaErrorInvalidValue;
    uint32_t* pend = reinterpret_cast<uint32_t*>(pending);
    auto* nv = reinterpret_cast<unsigned long long*>(n_valid);
    const unsigned grid = (unsigned)((B + kWarps - 1) / kWarps);
    return (int)kmerax_dispatch(k, m, [&](auto w, auto mz) {
        bloom_insert_kernel<decltype(w)::value, decltype(mz)::value>
            <<<grid, kThreads, smem, stream>>>(table, bases, B, L, k,
                                               block_mask, d, m, log2_buckets,
                                               pend, off, nv);
        return cudaGetLastError();
    });
}

extern "C" int kmerax_bloom_query_solid(const int32_t* table,
                                        const int32_t* bases, int B, int L,
                                        int k, const int32_t* last_j,
                                        uint32_t block_mask, int d, int m,
                                        int log2_buckets, int t, uint8_t* out,
                                        cudaStream_t stream) {
    if (B <= 0) return (int)cudaGetLastError();
    size_t smem;
    if (smem_bytes(L, &smem) != cudaSuccess) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((B + kWarps - 1) / kWarps);
    return (int)kmerax_dispatch(k, m, [&](auto w, auto mz) {
        bloom_query_solid_kernel<decltype(w)::value, decltype(mz)::value>
            <<<grid, kThreads, smem, stream>>>(table, bases, B, L, k, last_j,
                                               block_mask, d, m, log2_buckets,
                                               t, out);
        return cudaGetLastError();
    });
}

extern "C" int kmerax_bloom_insert_rows(int32_t* table, const int32_t* rows,
                                        const uint8_t* rvalid, int64_t N,
                                        int k, uint32_t block_mask,
                                        uint32_t local_mask, int d, int m,
                                        int log2_buckets, int32_t* pending,
                                        int64_t off, cudaStream_t stream) {
    if (N <= 0) return (int)cudaGetLastError();
    const auto* r = reinterpret_cast<const uint32_t*>(rows);
    uint32_t* pend = reinterpret_cast<uint32_t*>(pending);
    const unsigned grid = (unsigned)((N + kThreads - 1) / kThreads);
    return (int)kmerax_dispatch(k, m, [&](auto w, auto mz) {
        bloom_insert_rows_kernel<decltype(w)::value, decltype(mz)::value>
            <<<grid, kThreads, 0, stream>>>(table, r, rvalid, N, k,
                                            block_mask, local_mask, d, m,
                                            log2_buckets, pend, off);
        return cudaGetLastError();
    });
}

extern "C" const char* kmerax_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
