// Shared device helpers of the port's kernels: the 2-bit codec, the
// canonical form and the murmur3 probe hash over native uint32 words.
// Bit-exact with kmerax_torch/core/{codec,hash}.py (DESIGN.md §§2-3, 5).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define KMERAX_HASH_SEED_1 0x9E3779B1u
#define KMERAX_HASH_SEED_2 0x85EBCA77u
#define KMERAX_MAX_WORDS 4          // k <= 63

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

// solidity of one k-mer against the int32 counter table: every one of the
// d probed lanes of its 128-counter block is >= t (d >= 1, so "at least one
// lane probed" holds for every valid k-mer)
static __device__ __forceinline__ bool kmerax_probe_solid(const int32_t* table,
                                                   uint32_t block,
                                                   uint32_t lanepack, int d,
                                                   int t) {
    const int32_t* row = table + (size_t)block * 128;
    bool solid = true;
    for (int j = 0; j < d; ++j)
        solid = solid && __ldg(row + ((lanepack >> (7 * j)) & 127u)) >= t;
    return solid;
}
