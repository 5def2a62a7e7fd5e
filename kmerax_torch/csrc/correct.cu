// Fused correction scoring (K3) for Hopper.
//
// kmerax_correct_eval_scores replaces the Pallas kernel
//   kmerax/ops/pallas_correct.py::_prep_kernel (via eval_entries_fused),
// with the solidity probe of kmerax/spectrum/pallas_bloom.py::_query_kernel
// fused in. Its plain version is kmerax_torch/ops/correct.py::_eval_scores.
//
// One entry is a (read, candidate position ic) pair (DESIGN.md §8 v2). For
// each of the 4 center substitutions v and each of the k windows j that
// cover ic, the k-mer bases[ic-(k-1)+j .. ic+j] with base v at ic is built,
// canonicalized, hashed with murmur3 and probed against the counter table;
// scores[q][v] counts the solid (v, j) k-mers. Positions outside
// [0, length) read as base 4 (invalid); the center is always valid; window
// j counts only when its start lies in [0, last_j] of the read.
//
// Layout: one thread block per entry and one thread per (v, j): 4k <= 252
// threads for k <= 63. The 2k-1 bases of the entry's window are loaded once
// into shared memory; the four per-variant sums reduce in shared memory.
// The TPU kernel's 128-lane constraints do not apply: there is no LP=256
// row cap (any read length the config allows), no nvar/nslab split for
// 4k > 128, and the probe is fused instead of a second pass over a
// (Q, 128) lane plane in device memory.
//
// What bounds it on an H100: each thread makes one random 512-byte-row
// probe (d lanes) into a table far above L2 size, so the kernel is bound by
// the latency of 4kQ scattered sector reads; the k-mer build, canonical
// form and hash are a few hundred integer operations per thread, well under
// the SM's issue rate at that memory parallelism.

#include "kmerax.cuh"

namespace {

__global__ void correct_eval_scores_kernel(
    const int32_t* __restrict__ bases, int L,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ last_j,
    const int32_t* __restrict__ ent_r, const int32_t* __restrict__ ent_i,
    const int32_t* __restrict__ table, uint32_t block_mask, int d, int t,
    int k, int32_t* __restrict__ scores) {
    __shared__ int32_t wb[128];              // 2k-1 <= 125 window bases
    __shared__ int32_t sc[4];
    const int64_t q = blockIdx.x;
    const int tid = threadIdx.x;
    const int r = ent_r[q];
    const int ic = min(max(ent_i[q], 0), L - 1);
    // the batcher rejects reads longer than L; the min keeps a bad length
    // from reading into the next row
    const int len = min(lengths[r], L);
    const int c = ic - (k - 1);              // window start, may be < 0
    if (tid < 2 * k - 1) {
        const int p = c + tid;
        wb[tid] = (p >= 0 && p < len) ? bases[(int64_t)r * L + p] : 4;
    }
    if (tid < 4) sc[tid] = 0;
    __syncthreads();

    const int v = tid / k;
    const int j = tid - v * k;
    const int jg = c + j;                    // global window index
    if (v < 4 && jg >= 0 && jg <= last_j[r]) {
        // word wi folds window-relative positions [lo, hi), leftmost base
        // in the highest bits (kmerax_torch/core/kmers.py)
        const int W = (k + 15) / 16;
        uint32_t words[KMERAX_MAX_WORDS];
        bool ok = true;
        for (int wi = 0; wi < W; ++wi) {
            const int lo = max(k - 16 * (wi + 1), 0), hi = k - 16 * wi;
            uint32_t acc = 0;
            for (int i = lo; i < hi; ++i) {
                int b = (i == k - 1 - j) ? v : wb[j + i];
                ok = ok && b < 4;
                acc = (acc << 2) | (uint32_t)(b & 3);
            }
            words[wi] = acc;
        }
        if (ok) {
            kmerax_canonicalize(words, W, k);
            const uint32_t h1 = kmerax_kmer_hash(words, W, KMERAX_HASH_SEED_1);
            const uint32_t h2 = kmerax_kmer_hash(words, W, KMERAX_HASH_SEED_2);
            if (kmerax_probe_solid(table, h1 & block_mask, h2, d, t))
                atomicAdd(&sc[v], 1);
        }
    }
    __syncthreads();
    if (tid < 4) scores[q * 4 + tid] = sc[tid];
}

}  // namespace

extern "C" int kmerax_correct_eval_scores(
    const int32_t* bases, int L, const int32_t* lengths,
    const int32_t* last_j, const int32_t* ent_r, const int32_t* ent_i,
    int64_t Q, const int32_t* table, uint32_t block_mask, int d, int t, int k,
    int32_t* scores, cudaStream_t stream) {
    if (Q > 0)
        correct_eval_scores_kernel<<<(unsigned)Q, 4 * k, 0, stream>>>(
            bases, L, lengths, last_j, ent_r, ent_i, table, block_mask, d, t,
            k, scores);
    return (int)cudaGetLastError();
}
