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
// Both take the counter layout as a template parameter (kmerax.cuh): i32,
// or p16, the Pallas kernels' `packed16` branches (pallas_bloom.py:97-103,
// a saturating halfword add; :232-235, the halfword read), two 16-bit
// counters a word, so the table is half the bytes. K1's p16 add groups the
// warp's probes that hit one counter, then raises each by CAS, all CASes of
// a step in flight together (CounterP16::add, with the argument for its
// result); K2's p16 probe reads the halfword.
//
// Addressing (DESIGN.md §5): every k-mer owns one 128-counter block row of
// the int32 table and d <= 4 lanes in it, 7 bits each of its second hash.
// The row comes from kmerax_block (kmerax.cuh) under the bucket scheme, a
// template parameter: the hash scheme's low bits of h1, or the minimizer
// scheme's bucket above them: in K1 and K2 the least of the k-m+1 m-mer
// hashes the warp staged once for the read (below); K1r, whose rows have no
// read, mixes k-m+1 m-mers a k-mer (kmerax_block<W, true>).
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
// valid mask) and adds the valid ones into this rank's 2^local_bits range
// shard of the table: the block comes from the GLOBAL table's addressing
// (kmerax_block with the global block mask, so the minimizer scheme's bucket
// bits land where they do in the whole table), then keeps its low
// local_bits - 7 bits (DESIGN.md §12: the shard bits are the top bits of
// the block). With a pending buffer it writes the valid rows only, compacted
// in slot order from row off (rows[rvalid]), and it reports their count.
// Most slots are empty (route_safety 4 at one sender: a fifth are valid),
// so it works on the valid rows only, in one launch: a block takes a tile
// of 256 spt slots (spt = 2 or 4 routed slots a thread, the wrapper's
// choice, so that a launch has ~1,000 blocks or more), turns its valid
// bytes into a bit mask a thread, lists the
// tile's valid slots in shared memory in order (a block scan), and one warp
// finds the tile's offset among all valid rows by a decoupled look-back
// over the tiles before it while the other warps hash and insert the
// listed rows; then the block copies their words to pending. The order is
// the slots' whatever the schedule, so the pending rows are deterministic.
//
// What bounds them on an H100: the table is 2^log2_width int32 counters,
// 2 GiB at log2_width=29, far above the 50 MB L2, so each k-mer touches
// one random 512-byte row: ~3.6 distinct 32-byte sectors for K1's d=4,
// each read and written once, and for K2 one sector for a k-mer that fails
// its first lane, up to d for a solid one. That sector floor, not the few
// bytes per k-mer of the byte bound, is what a kernel can approach; the
// addressing's ~130 int32 operations per k-mer sit under it. K1r reads
// a valid byte a slot and the 4W bytes of a valid row (again, from cache,
// for its pending copy), writes 4W bytes a valid row, and has the same
// sector floor on its 2^local_bits shard; with no extraction or canonical
// form, its addressing is the two hashes (~50 operations a k-mer at W = 2).
// Visiting the slice one region at a time does not pay on an H100: the
// same rows sorted by block, or grouped by 256 or 512 MiB region, took
// 0.82-0.90 of the routed order's time (chip_smoke._k1r_orders, NVIDIA
// H100 80GB HBM3 at 700 W), so the rows are not binned.
// p16 halves the table and keeps the sectors a k-mer touches (its d lanes
// still lie in one 512-byte word row), so its floor is K1's and K2's
// above; at the CLI's 2^24 counters a p16 table (32 MiB) fits the L2 and
// an i32 one (64 MiB) does not. K1's p16 add reads the word before its
// CAS: a warp step waits on two trips to the L2 (all its reads, then all
// its CASes) where the i32 REDs wait on none.

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

// K1 and K2 under the minimizer scheme: the warp stages its read's m-mer
// hashes (kmerax.cuh) once, after packing it (K2: only those of the windows
// it probes, j <= last_j). Each of the read's L-m+1 positions
// gets F (forward m-mer) and R (its reverse complement) in two arrays
// whose bases lie a multiple of 32 words apart, so that the 32 lanes of a
// window step, each on its own strand, read 32 distinct banks. A window's
// minimizer is then the least of its k-m+1 entries of the kept strand's
// array (kmerax_canonical_strand): shared loads and mins, no mix32. (Block
// prefix and suffix minima of width k-m+1, one min of two a k-mer, took
// the same time within 2 % on an H100 at twice the shared memory:
// PERF.md.)

// words of one staged array for reads of L bases, rounded up to 32
static __host__ __device__ __forceinline__ int mmer_stride(int L, int m) {
    return (L - m + 1 + 31) / 32 * 32;
}

// the warp fills its staging S (F, then R at S + stride) for the packed
// read P: nm = L-m+1 positions
static __device__ __forceinline__ void stage_mmers(const uint32_t* P,
                                                   uint32_t* S, int stride,
                                                   int nm, int m, int lane) {
    for (int p = lane; p < nm; p += 32) {
        const uint32_t x = kmerax_mmer(P, p, m);
        S[p] = kmerax_mix32(x);
        S[stride + p] = kmerax_mix32(kmerax_mmer_rc(x, m));
    }
    __syncwarp();
}

// the minimizer of the k-mer at j (its m-mers j..j+w-1) on the strand kept
static __device__ __forceinline__ uint32_t staged_minimizer(
    const uint32_t* S, int stride, int j, int w, bool fwd) {
    const uint32_t* a = S + (fwd ? 0 : stride);
    uint32_t best = KMERAX_FULL_MASK;
    for (int i = j; i < j + w; ++i) best = min(best, a[i]);
    return best;
}

template <int W, bool kMinimizer, typename Counter>
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
        [[maybe_unused]] uint32_t* S = nullptr;
        [[maybe_unused]] int stride = 0;
        if constexpr (kMinimizer) {
            stride = mmer_stride(L, m);
            S = smem + kWarps * (3 * nch + 1) + warp * 2 * stride;
            stage_mmers(P, S, stride, L - m + 1, m, lane);
        }
        for (int j0 = 0; j0 < nk; j0 += 32) {
            const int j = j0 + lane;
            const bool in = j < nk;
            const bool ok = in && kmerax_span_clear(N, j, k);
            uint32_t words[W];
            uint32_t block = 0, h2 = 0;
            if (ok) {
                kmerax_window_words<W>(P, j, k, words);
                if constexpr (kMinimizer) {
                    const bool fwd = kmerax_canonical_strand(words, W, k);
                    const uint32_t h1 = kmerax_kmer_hash(words, W,
                                                         KMERAX_HASH_SEED_1);
                    h2 = kmerax_kmer_hash(words, W, KMERAX_HASH_SEED_2);
                    block = kmerax_bucket_block(
                        staged_minimizer(S, stride, j, k - m + 1, fwd), h1,
                        block_mask, log2_buckets);
                } else {
                    kmerax_canonicalize(words, W, k);
                    const uint32_t h1 = kmerax_kmer_hash(words, W,
                                                         KMERAX_HASH_SEED_1);
                    h2 = kmerax_kmer_hash(words, W, KMERAX_HASH_SEED_2);
                    block = kmerax_block<W, kMinimizer>(
                        words, k, h1, block_mask, m, log2_buckets);
                }
                if constexpr (!Counter::kWarpAdd)
                    Counter::add(table, block, h2, d);
            }
            // the p16 add is the warp's: every lane calls it (the loop
            // bounds are warp-uniform)
            if constexpr (Counter::kWarpAdd)
                Counter::add(table, block, h2, d, ok);
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

template <int W, bool kMinimizer, typename Counter>
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
    [[maybe_unused]] uint32_t* S = nullptr;
    [[maybe_unused]] int stride = 0;
    if constexpr (kMinimizer) {
        // K1's staging, of the m-mers the probed windows j <= last_j hold
        // only: positions p < min(L, last_j + k) - m + 1, none if last_j < 0
        stride = mmer_stride(L, m);
        S = smem + kWarps * (3 * nch + 1) + warp * 2 * stride;
        stage_mmers(P, S, stride, lj < 0 ? 0 : min(L, lj + k) - m + 1, m,
                    lane);
    }
    uint8_t* orow = out + r * nk;
    for (int j0 = 0; j0 < nk; j0 += 32) {
        const int j = j0 + lane;
        bool solid = false;
        if (j < nk && j <= lj && kmerax_span_clear(N, j, k)) {
            uint32_t words[W];
            kmerax_window_words<W>(P, j, k, words);
            if constexpr (kMinimizer) {
                const bool fwd = kmerax_canonical_strand(words, W, k);
                const uint32_t h1 = kmerax_kmer_hash(words, W,
                                                     KMERAX_HASH_SEED_1);
                const uint32_t h2 = kmerax_kmer_hash(words, W,
                                                     KMERAX_HASH_SEED_2);
                solid = Counter::solid(
                    table,
                    kmerax_bucket_block(
                        staged_minimizer(S, stride, j, k - m + 1, fwd), h1,
                        block_mask, log2_buckets),
                    h2, d, t);
            } else {
                kmerax_canonicalize(words, W, k);
                const uint32_t h1 = kmerax_kmer_hash(words, W,
                                                     KMERAX_HASH_SEED_1);
                const uint32_t h2 = kmerax_kmer_hash(words, W,
                                                     KMERAX_HASH_SEED_2);
                solid = Counter::solid(
                    table, kmerax_block<W, kMinimizer>(words, k, h1,
                                                       block_mask, m,
                                                       log2_buckets),
                    h2, d, t);
            }
        }
        if (j < nk) orow[j] = solid;
    }
}

// K1r's tiles: 256 threads and spt = 1, 2 or 4 routed slots a thread, up
// to 1,024 slots a tile; the valid rows of a tile are listed in shared
// memory in slot order
constexpr int kMaxSlotsPerThread = 4;
constexpr int kMaxTileSlots = kThreads * kMaxSlotsPerThread;

// a tile's status word in the look-back: (epoch << 34) | (flag << 32) |
// count, where the flag says whether the count is the tile's own valid rows
// (kAggregate) or those of every tile up to and including it (kPrefix).
// A word of another epoch (an earlier launch) is not ready yet.
constexpr uint64_t kAggregate = 1, kPrefix = 2;

static __device__ __forceinline__ uint64_t tile_word(uint32_t epoch,
                                                     uint64_t flag,
                                                     uint32_t count) {
    return ((uint64_t)epoch << 34) | (flag << 32) | count;
}

// the exclusive prefix of this tile's valid rows over the tiles before it
// (decoupled look-back, run by one warp): lane l reads the status of tile
// tile-1-l, waits until every lane's is of this epoch, and sums the counts
// down to the nearest inclusive prefix; if none is in the window it goes
// 32 tiles further back. Tile 0's word is always a prefix.
static __device__ int64_t look_back(const uint64_t* status, int tile,
                                    uint32_t epoch, int lane) {
    int64_t excl = 0;
    for (int pred = tile - 1;; pred -= 32) {
        const int i = pred - lane;
        uint64_t s = tile_word(epoch, kPrefix, 0);      // before tile 0
        bool ready;
        do {
            if (i >= 0)
                s = *reinterpret_cast<const volatile uint64_t*>(status + i);
            ready = (uint32_t)(s >> 34) == epoch;
        } while (!__all_sync(KMERAX_FULL_MASK, ready));
        const unsigned pre = __ballot_sync(KMERAX_FULL_MASK,
                                           ((s >> 32) & 3u) == kPrefix);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        unsigned long long c = lane <= stop ? (uint32_t)s : 0u;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            c += __shfl_xor_sync(KMERAX_FULL_MASK, c, o);
        excl += c;
        if (pre) return excl;
    }
}

template <int W, bool kMinimizer>
__global__ void __launch_bounds__(kThreads)
bloom_insert_rows_kernel(int32_t* __restrict__ table,
                         const uint32_t* __restrict__ rows,
                         const uint8_t* __restrict__ rvalid, int64_t N,
                         int k, uint32_t block_mask, uint32_t local_mask,
                         int d, int m, int log2_buckets,
                         uint32_t* __restrict__ pending, int64_t off,
                         uint64_t* status, uint32_t epoch, int spt,
                         int64_t* __restrict__ n_valid) {
    __shared__ uint16_t idx[kMaxTileSlots];  // the tile's valid slots
    __shared__ uint32_t warp_sum[kWarps];
    __shared__ int64_t tile_off;             // valid rows before the tile
    const int tile = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t base = (int64_t)tile * kThreads * spt;
    // 1. this thread's spt valid bytes as a bit mask
    const int64_t s0 = base + threadIdx.x * spt;
    uint32_t bits = 0;
    for (int b = 0; b < spt; ++b)
        if (s0 + b < N && rvalid[s0 + b]) bits |= 1u << b;
    // 2. block-wide exclusive scan of the counts; list the valid slots in
    // slot order
    const uint32_t cnt = __popc(bits);
    uint32_t incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(KMERAX_FULL_MASK, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    uint32_t pos = incl - cnt, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        const uint32_t x = warp_sum[w];
        pos += w < warp ? x : 0u;
        total += x;
    }
    for (uint32_t b = bits; b; b &= b - 1)
        idx[pos++] = (uint16_t)(threadIdx.x * spt + __ffs(b) - 1);
    __syncthreads();
    // 3. warp 0 publishes the tile's count and finds its offset while the
    // other warps start the insert
    if (warp == 0) {
        int64_t excl = 0;
        if (tile == 0) {
            if (lane == 0)
                *reinterpret_cast<volatile uint64_t*>(status) =
                    tile_word(epoch, kPrefix, total);
        } else {
            if (lane == 0)
                *reinterpret_cast<volatile uint64_t*>(status + tile) =
                    tile_word(epoch, kAggregate, total);
            excl = look_back(status, tile, epoch, lane);
            if (lane == 0)
                *reinterpret_cast<volatile uint64_t*>(status + tile) =
                    tile_word(epoch, kPrefix, (uint32_t)(excl + total));
        }
        if (lane == 0) {
            tile_off = excl;
            if (tile == gridDim.x - 1) *n_valid = excl + total;
        }
    }
    // 4. the insert: one valid row a thread, in list order
    for (uint32_t j = threadIdx.x; j < total; j += kThreads) {
        const uint32_t* row = rows + (base + idx[j]) * W;
        uint32_t words[W];
#pragma unroll
        for (int wi = 0; wi < W; ++wi) words[wi] = row[wi];
        const uint32_t h1 = kmerax_kmer_hash(words, W, KMERAX_HASH_SEED_1);
        const uint32_t h2 = kmerax_kmer_hash(words, W, KMERAX_HASH_SEED_2);
        const uint32_t block = kmerax_block<W, kMinimizer>(
            words, k, h1, block_mask, m, log2_buckets) & local_mask;
        int32_t* trow = table + (size_t)block * 128;
        for (int i = 0; i < d; ++i)
            atomicAdd(trow + ((h2 >> (7 * i)) & 127u), 1);
    }
    if (pending == nullptr) return;          // block-uniform
    __syncthreads();
    // 5. the valid rows' words, consecutive from pending row off + tile_off
    uint32_t* out = pending + (off + tile_off) * W;
    for (uint32_t e = threadIdx.x; e < total * W; e += kThreads)
        out[e] = rows[(base + idx[e / W]) * W + e % W];
}

cudaError_t smem_bytes(int L, size_t* smem) {
    *smem = (size_t)kWarps * (3 * ((L + 31) / 32) + 1) * sizeof(uint32_t);
    return *smem > 48 * 1024 ? cudaErrorInvalidValue : cudaSuccess;
}

// K1's and K2's dynamic shared memory: smem_bytes(L) and, under the
// minimizer scheme, each warp's staged m-mer hashes (10.5 KB a block at L =
// 160, m = 11); above 48 KB the launch opts in to more, up to the card's
// limit a block (227 KB on an H100: reads up to ~3,400 bases)
size_t staged_smem_bytes(int L, int m) {
    return (size_t)kWarps
           * (3 * ((L + 31) / 32) + 1 + (m ? 2 * mmer_stride(L, m) : 0))
           * sizeof(uint32_t);
}

}  // namespace

// p16 != 0: the table is p16 words (CounterP16), else int32 counters
extern "C" int kmerax_bloom_insert(int32_t* table, const int8_t* bases,
                                   int B, int L, int k, uint32_t block_mask,
                                   int d, int m, int log2_buckets, int p16,
                                   int32_t* pending, int64_t off,
                                   int64_t* n_valid, cudaStream_t stream) {
    if (B <= 0) return (int)cudaGetLastError();
    size_t smem;
    if (smem_bytes(L, &smem) != cudaSuccess) return (int)cudaErrorInvalidValue;
    smem = staged_smem_bytes(L, m);
    uint32_t* pend = reinterpret_cast<uint32_t*>(pending);
    auto* nv = reinterpret_cast<unsigned long long*>(n_valid);
    const unsigned grid = (unsigned)((B + kWarps - 1) / kWarps);
    return (int)kmerax_dispatch_layout(k, m, p16, [&](auto w, auto mz,
                                                      auto layout) {
        auto kernel = bloom_insert_kernel<decltype(w)::value,
                                          decltype(mz)::value,
                                          decltype(layout)>;
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return e;
        }
        kernel<<<grid, kThreads, smem, stream>>>(table, bases, B, L, k,
                                                 block_mask, d, m,
                                                 log2_buckets, pend, off, nv);
        return cudaGetLastError();
    });
}

extern "C" int kmerax_bloom_query_solid(const int32_t* table,
                                        const int32_t* bases, int B, int L,
                                        int k, const int32_t* last_j,
                                        uint32_t block_mask, int d, int m,
                                        int log2_buckets, int p16, int t,
                                        uint8_t* out, cudaStream_t stream) {
    if (B <= 0) return (int)cudaGetLastError();
    size_t smem;
    if (smem_bytes(L, &smem) != cudaSuccess) return (int)cudaErrorInvalidValue;
    smem = staged_smem_bytes(L, m);
    const unsigned grid = (unsigned)((B + kWarps - 1) / kWarps);
    return (int)kmerax_dispatch_layout(k, m, p16, [&](auto w, auto mz,
                                                      auto layout) {
        auto kernel = bloom_query_solid_kernel<decltype(w)::value,
                                               decltype(mz)::value,
                                               decltype(layout)>;
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return e;
        }
        kernel<<<grid, kThreads, smem, stream>>>(table, bases, B, L, k,
                                                 last_j, block_mask, d, m,
                                                 log2_buckets, t, out);
        return cudaGetLastError();
    });
}

extern "C" int kmerax_bloom_insert_rows(int32_t* table, const int32_t* rows,
                                        const uint8_t* rvalid, int64_t N,
                                        int k, uint32_t block_mask,
                                        uint32_t local_mask, int d, int m,
                                        int log2_buckets, int32_t* pending,
                                        int64_t off, int64_t* status,
                                        uint32_t epoch, int spt,
                                        int64_t* n_valid,
                                        cudaStream_t stream) {
    if (N <= 0) return (int)cudaGetLastError();
    if (spt < 1 || spt > kMaxSlotsPerThread || (spt & (spt - 1)))
        return (int)cudaErrorInvalidValue;
    const auto* r = reinterpret_cast<const uint32_t*>(rows);
    uint32_t* pend = reinterpret_cast<uint32_t*>(pending);
    auto* st = reinterpret_cast<uint64_t*>(status);
    const int64_t tile = (int64_t)kThreads * spt;
    const unsigned grid = (unsigned)((N + tile - 1) / tile);
    return (int)kmerax_dispatch(k, m, [&](auto w, auto mz) {
        bloom_insert_rows_kernel<decltype(w)::value, decltype(mz)::value>
            <<<grid, kThreads, 0, stream>>>(table, r, rvalid, N, k,
                                            block_mask, local_mask, d, m,
                                            log2_buckets, pend, off, st,
                                            epoch, spt, n_valid);
        return cudaGetLastError();
    });
}

extern "C" const char* kmerax_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
