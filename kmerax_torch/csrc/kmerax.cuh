// Shared device helpers of the port's kernels: the 2-bit codec, the
// canonical form and the murmur3 probe hash over native uint32 words, the
// block row under either bucket scheme, the two-round solidity probe of K2
// and K3, the packed-window layout K1-K3 build their k-mers from, and the
// host dispatch over the word count and the scheme.
// Bit-exact with kmerax_torch/core/{codec,hash,kmers,minimizer}.py
// (DESIGN.md §§2-5).
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#define KMERAX_HASH_SEED_1 0x9E3779B1u
#define KMERAX_HASH_SEED_2 0x85EBCA77u
#define KMERAX_MAX_WORDS 4          // k <= 63
#define KMERAX_FULL_MASK 0xFFFFFFFFu

static __device__ __forceinline__ uint32_t kmerax_mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

// reverse the sixteen 2-bit groups of a word
static __device__ __forceinline__ uint32_t kmerax_reverse_pairs(uint32_t w) {
    w = ((w & 0x33333333u) << 2) | ((w >> 2) & 0x33333333u);
    w = ((w & 0x0F0F0F0Fu) << 4) | ((w >> 4) & 0x0F0F0F0Fu);
    w = ((w & 0x00FF00FFu) << 8) | ((w >> 8) & 0x00FF00FFu);
    return (w << 16) | (w >> 16);
}

// words[0..W) little-endian forward k-mer -> canonical k-mer in place
static __device__ __forceinline__ void kmerax_canonicalize(uint32_t* words, int W,
                                                    int k) {
    uint32_t rx[KMERAX_MAX_WORDS], rc[KMERAX_MAX_WORDS];
    for (int i = 0; i < W; ++i)
        rx[i] = kmerax_reverse_pairs(~words[W - 1 - i]);
    const int s = 32 * W - 2 * k;   // 0 <= s < 32
    for (int i = 0; i < W; ++i) {
        uint32_t hi = (i + 1 < W && s) ? (rx[i + 1] << (32 - s)) : 0u;
        rc[i] = s ? ((rx[i] >> s) | hi) : rx[i];
    }
    // forward iff fwd <= rc, compared from the most significant word
    bool lt = false, eq = true;
    for (int i = W - 1; i >= 0; --i) {
        lt = lt || (eq && words[i] < rc[i]);
        eq = eq && words[i] == rc[i];
    }
    if (!(lt || eq))
        for (int i = 0; i < W; ++i) words[i] = rc[i];
}

static __device__ __forceinline__ uint32_t kmerax_kmer_hash(const uint32_t* words,
                                                     int W, uint32_t seed) {
    uint32_t h = kmerax_mix32(seed);
    for (int i = 0; i < W; ++i) h = kmerax_mix32(h ^ words[i]);
    return h;
}

// the 128-counter block row of a canonical k-mer (K1-K3). Hash scheme
// (DESIGN.md §5a): the low bits of h1 under block_mask. Minimizer scheme
// (DESIGN.md §4): the bucket, the minimizer (the least kmerax_mix32 over the
// k-m+1 m-mers of 2m bits, core/minimizer.py) modulo 2^log2_buckets, above
// the low log2(blocks) - log2_buckets bits of h1. The scheme is a template
// parameter, so the hash instantiation holds no minimizer code.
template <int W, bool kMinimizer>
static __device__ __forceinline__ uint32_t kmerax_block(
    const uint32_t* words, int k, uint32_t h1, uint32_t block_mask, int m,
    int log2_buckets) {
    if constexpr (!kMinimizer) {
        return h1 & block_mask;
    } else {
        const uint32_t mmask = (1u << (2 * m)) - 1u;   // 2m <= 30
        uint32_t best = KMERAX_FULL_MASK;
        for (int j = 0; j <= k - m; ++j) {
            const int p = 2 * (k - m - j);    // bit offset of the m-mer at j
            const int wi = p >> 5, sb = p & 31;
            uint32_t lo = 0, hi = 0;          // words wi and wi+1 (0 past W)
#pragma unroll
            for (int w = 0; w < W; ++w) {
                if (w == wi) lo = words[w];
                if (w == wi + 1) hi = words[w];
            }
            const uint32_t val = sb ? ((lo >> sb) | (hi << (32 - sb))) : lo;
            best = min(best, kmerax_mix32(val & mmask));
        }
        const int seg_bits = __popc(block_mask) - log2_buckets;
        const uint32_t bucket = best & ((1u << log2_buckets) - 1u);
        return (bucket << seg_bits) | (h1 & (block_mask >> log2_buckets));
    }
}

// host side: f(std::integral_constant<int, W>, std::bool_constant<kMinimizer>)
// for W = ceil(k/16) and the scheme (m > 0 selects the minimizer scheme)
template <typename F>
static cudaError_t kmerax_dispatch(int k, int m, F&& f) {
    using std::integral_constant;
    const bool mz = m > 0;
    switch ((k + 15) / 16) {
        case 1: return mz ? f(integral_constant<int, 1>{}, std::true_type{})
                          : f(integral_constant<int, 1>{}, std::false_type{});
        case 2: return mz ? f(integral_constant<int, 2>{}, std::true_type{})
                          : f(integral_constant<int, 2>{}, std::false_type{});
        case 3: return mz ? f(integral_constant<int, 3>{}, std::true_type{})
                          : f(integral_constant<int, 3>{}, std::false_type{});
        case 4: return mz ? f(integral_constant<int, 4>{}, std::true_type{})
                          : f(integral_constant<int, 4>{}, std::false_type{});
        default: return cudaErrorInvalidValue;
    }
}

// solidity of one k-mer against the int32 counter table (K2, K3): every one
// of the d <= 4 lanes of its 128-counter block row, lane i being bits
// 7i..7i+6 of its second hash h2, is >= t. Two rounds: lane 0 first, and
// the other d-1 together only if it passes, so a k-mer that is not solid
// reads one sector and a solid one waits on two trips to memory instead of
// d dependent ones.
static __device__ __forceinline__ bool kmerax_probe_two_rounds(
    const int32_t* table, uint32_t block, uint32_t h2, int d, int t) {
    const int32_t* row = table + (size_t)block * 128;
    if (__ldg(row + (h2 & 127u)) < t) return false;
    bool solid = true;
#pragma unroll
    for (int i = 1; i < 4; ++i)
        if (i < d) solid &= __ldg(row + ((h2 >> (7 * i)) & 127u)) >= t;
    return solid;
}

// ---- packed windows (K1, K2, K3) -----------------------------------------
//
// A warp packs a span of bases once into shared memory, 32 positions per
// chunk c: P[2c] and P[2c+1] hold the 2-bit codes of positions 32c..32c+15
// and 32c+16..32c+31, the leftmost base in the highest bits, so the span
// reads as one big-endian bit string; N[c] bit i is set where position
// 32c+i holds an invalid base. A k-mer window starting at position j is
// then W funnel shifts (O(W), not a loop over k bases) and a test of k
// bits of N.

// one chunk c, from each lane's (code, bad) at position 32c+lane; every
// lane of the warp calls it
static __device__ __forceinline__ void kmerax_pack_chunk(uint32_t* P,
                                                  uint32_t* N, int c,
                                                  int lane, uint32_t code,
                                                  bool bad) {
    const uint32_t bits = (code & 3u) << (30 - 2 * (lane & 15));
    const uint32_t lo = __reduce_or_sync(KMERAX_FULL_MASK, lane < 16 ? bits : 0u);
    const uint32_t hi = __reduce_or_sync(KMERAX_FULL_MASK, lane < 16 ? 0u : bits);
    const uint32_t nb = __ballot_sync(KMERAX_FULL_MASK, bad);
    if (lane == 0) {
        P[2 * c] = lo;
        P[2 * c + 1] = hi;
        N[c] = nb;
    }
}

// the W little-endian words of the k-mer starting at position j: word wi
// folds window positions [lo, hi) (core/kmers.py), read as the n = hi - lo
// bases from j + lo. P must hold one word past the last base read.
template <int W>
static __device__ __forceinline__ void kmerax_window_words(const uint32_t* P,
                                                    int j, int k,
                                                    uint32_t* words) {
#pragma unroll
    for (int wi = 0; wi < W; ++wi) {
        const int lo = max(k - 16 * (wi + 1), 0);
        const int n = k - 16 * wi - lo;              // 1..16 bases
        const int s = j + lo;
        const uint32_t x = __funnelshift_l(P[(s >> 4) + 1], P[s >> 4],
                                           2 * (s & 15));
        words[wi] = x >> (32 - 2 * n);
    }
}

// no invalid base among positions [j, j + k) of N (k <= 63: at most 3
// words)
static __device__ __forceinline__ bool kmerax_span_clear(const uint32_t* N,
                                                  int j, int k) {
    const int e = j + k;
    for (int w = j >> 5; w <= (e - 1) >> 5; ++w) {
        const int lo = max(j - 32 * w, 0), hi = min(e - 32 * w, 32);
        const uint32_t m = (hi - lo == 32) ? KMERAX_FULL_MASK
                                           : ((1u << (hi - lo)) - 1u) << lo;
        if (N[w] & m) return false;
    }
    return true;
}
