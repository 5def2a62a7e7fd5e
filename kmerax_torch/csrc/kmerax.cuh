// Shared device helpers of the port's kernels: the 2-bit codec, the
// canonical form and the murmur3 probe hash over native uint32 words, the
// block row under either bucket scheme, the counter layouts (the insert of
// K1 and the two-round solidity probe of K2 and K3, on i32 or p16
// counters), the packed-window layout K1-K3 build their k-mers from, and
// the host dispatch over the word count, the scheme and the layout.
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

// words[0..W) little-endian forward k-mer -> canonical k-mer in place;
// true where the forward strand was kept (fwd <= its reverse complement;
// for odd k the two never tie)
static __device__ __forceinline__ bool kmerax_canonical_strand(
    uint32_t* words, int W, int k) {
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
    const bool fwd = lt || eq;
    if (!fwd)
        for (int i = 0; i < W; ++i) words[i] = rc[i];
    return fwd;
}

static __device__ __forceinline__ void kmerax_canonicalize(uint32_t* words, int W,
                                                    int k) {
    (void)kmerax_canonical_strand(words, W, k);
}

static __device__ __forceinline__ uint32_t kmerax_kmer_hash(const uint32_t* words,
                                                     int W, uint32_t seed) {
    uint32_t h = kmerax_mix32(seed);
    for (int i = 0; i < W; ++i) h = kmerax_mix32(h ^ words[i]);
    return h;
}

// the minimizer scheme's block row (DESIGN.md §4): the bucket, the
// minimizer modulo 2^log2_buckets, above the low log2(blocks) -
// log2_buckets bits of h1. The one place this bit layout is written.
static __device__ __forceinline__ uint32_t kmerax_bucket_block(
    uint32_t minimizer, uint32_t h1, uint32_t block_mask, int log2_buckets) {
    const int seg_bits = __popc(block_mask) - log2_buckets;
    const uint32_t bucket = minimizer & ((1u << log2_buckets) - 1u);
    return (bucket << seg_bits) | (h1 & (block_mask >> log2_buckets));
}

// the 128-counter block row of a canonical k-mer. Hash scheme (DESIGN.md
// §5a, K1-K3 and K1r): the low bits of h1 under block_mask. Minimizer
// scheme (K1r only): kmerax_bucket_block of the minimizer, the least
// kmerax_mix32 over the k-m+1 m-mers of 2m bits of the canonical words
// (core/minimizer.py), each extracted and mixed here: K1r's routed rows
// have no read to stage. K1, K2 and K3 take the minimizer from m-mer
// hashes staged once a read or entry instead (kmerax_mmer below). The
// scheme is a template parameter, so the hash instantiation holds no
// minimizer code.
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
        return kmerax_bucket_block(best, h1, block_mask, log2_buckets);
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

// ---- counter layouts (K1, K2, K3) ----------------------------------------
//
// A kernel takes its layout as a template parameter, one of these two
// types, so each layout is an instantiation of its own (its name in a
// profile ends in CounterI32 or CounterP16) and the i32 one holds no p16
// code. block is a 128-counter block row, h2 the second hash whose bits
// 7i..7i+6 are lane i.

// one int32 counter a lane: the table is (nrows * 128,) int32
struct CounterI32 {
    static constexpr bool kWarpAdd = false;   // add() a lane at a time
    // +1 at each of the d lanes (+2 for a repeated lane): one RED each
    static __device__ __forceinline__ void add(int32_t* table,
                                               uint32_t block, uint32_t h2,
                                               int d) {
        int32_t* row = table + (size_t)block * 128;
        for (int i = 0; i < d; ++i)
            atomicAdd(row + ((h2 >> (7 * i)) & 127u), 1);
    }
    static __device__ __forceinline__ bool solid(const int32_t* table,
                                                 uint32_t block, uint32_t h2,
                                                 int d, int t) {
        return kmerax_probe_two_rounds(table, block, h2, d, t);
    }
};

#define KMERAX_SAT16 0x7FFFu        // p16 counter saturation ceiling

// p16, the JAX package's pack16 layout (kmerax/spectrum/bloom.py:72-85):
// two saturating 16-bit counters a word; block b lives at word row b >> 1,
// halfword b & 1, so the table is (nrows * 64,) int32 words. Every half
// holds a value in [0, SAT16], so every word is in [0, 0x7FFF7FFF].
struct CounterP16 {
    static constexpr bool kWarpAdd = true;    // add() by the whole warp
    // Insert, called by all 32 lanes of a warp, `live` where the lane has a
    // k-mer, in three passes: (1) the words of its d probes are read, all
    // issued at once (__ldcg: from the L2, never a stale L1 line); (2)
    // grouping, before any atomic: the lanes whose k-mer has the same
    // block and probe lanes (so the same d counters: equal k-mers, as in a
    // low-complexity read) form a group (one 64-bit __match_any_sync)
    // whose first lane leads it with c = the group's size a probe, a
    // repeated probe lane folded into the first of its probes (+2c); (3)
    // the leader raises each of its halves from h to min(h + c, SAT16) by
    // CAS from the word it read, stopping where the half is at SAT16 (no
    // atomic): all its CASes are issued before it waits on any, then the
    // failed ones are issued again from the words they returned, until
    // none is left. So a window step waits on two trips to memory (the
    // reads, then the CASes) where one CAS loop a probe in turn waited on
    // d + 1. Counters that the grouping does not see as one (other k-mers
    // that share a word, or the two halves of one word) meet as CASes on
    // one word: one lands, the others fail and retry, as below.
    // Why the result is min(initial + n, SAT16) for n adds, whatever the
    // order: the successful CASes on a word are totally ordered, and each
    // one replaced exactly the word it read, so by induction each half
    // holds min(initial + adds applied so far, SAT16) after every success
    // (the other half is written back unchanged, and no half ever leaves
    // [0, SAT16], so nothing carries from one half into the other); a
    // leader that finds its half at SAT16 may stop, since a counter never
    // falls. The order in which CASes are issued or land plays no part.
    // This is the saturating sum `insert` computes a batch
    // (bloom.py:143-156, min(sum, SAT16)), and min(min(a + n1, S) + n2, S)
    // = min(a + n1 + n2, S), so batch splits and orders agree too.
    // Why not an atomicAdd of 1 << 16(b & 1), undone by an atomicSub where
    // the old half was already at SAT16: that is exact only while fewer
    // than 32,769 adds to one half are applied and not yet undone, else the
    // half wraps (the low one into the high one). When one k-mer fills a
    // batch (a poly-A read: every window, every read) the adds queue at one
    // L2 address by the hundred thousand, ahead of the undos, and nothing
    // bounds that. The CAS loop needs no bound. Its cost is contention: a
    // CAS succeeds once a round among the writers of one word, so the
    // groups fold a warp's equal counters (a low-complexity read's) into
    // one CAS, and a saturated counter takes no atomic at all.
    static __device__ __forceinline__ void add(int32_t* table,
                                               uint32_t block, uint32_t h2,
                                               int d, bool live) {
        unsigned int* const words = reinterpret_cast<unsigned int*>(table);
        const int me = threadIdx.x & 31;
        const int sh = 16 * (int)(block & 1u);
        // each probe's word index, the word read, its adds and the word
        // its CAS returned, all initialised (left uninitialised, prev went
        // to the stack and the add ran slower than the CAS loop a probe it
        // replaces: PERF.md)
        uint32_t word[4], old[4], c[4], prev[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            word[i] = (block >> 1) * 128u + ((h2 >> (7 * i)) & 127u);
            old[i] = live && i < d ? __ldcg(words + word[i]) : 0u;
            c[i] = 0;
            prev[i] = old[i];
        }
        // block < 2^24, so a live id is never all ones
        const unsigned long long id =
            live ? (unsigned long long)block << 32
                       | (h2 & ((1u << (7 * d)) - 1u))
                 : ~0ull;
        const unsigned peers = __match_any_sync(KMERAX_FULL_MASK, id);
        uint32_t todo = 0;                       // bit i: probe i pending
        if (live && __ffs(peers) - 1 == me) {
            const uint32_t n = __popc(peers);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (i >= d) continue;
                c[i] = n;
                todo |= 1u << i;
#pragma unroll
                for (int p = 0; p < i; ++p)      // a repeated lane: +2n
                    if ((todo >> p & 1u) && word[p] == word[i]) {
                        c[p] += n;
                        todo &= ~(1u << i);
                        break;
                    }
            }
        }
        // every pending CAS is issued from the word last seen before any
        // result is looked at; the failed ones go again
        while (todo) {
            uint32_t sent = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (!(todo >> i & 1u)) continue;
                const uint32_t h = (old[i] >> sh) & 0xFFFFu;
                if (h >= KMERAX_SAT16) continue;
                const uint32_t nh = min(h + c[i], KMERAX_SAT16);
                prev[i] = atomicCAS(words + word[i], old[i],
                                    old[i] + ((nh - h) << sh));
                sent |= 1u << i;
            }
            todo = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if ((sent >> i & 1u) && prev[i] != old[i]) {
                    old[i] = prev[i];
                    todo |= 1u << i;
                }
        }
    }
    // the two-round probe of kmerax_probe_two_rounds on the halfwords
    static __device__ __forceinline__ bool solid(const int32_t* table,
                                                 uint32_t block, uint32_t h2,
                                                 int d, int t) {
        const int32_t* row = table + (size_t)(block >> 1) * 128;
        const int sh = 16 * (int)(block & 1u);
        auto half = [&](uint32_t lane) {
            return (int)(((uint32_t)__ldg(row + lane) >> sh) & 0xFFFFu);
        };
        if (half(h2 & 127u) < t) return false;
        bool ok = true;
#pragma unroll
        for (int i = 1; i < 4; ++i)
            if (i < d) ok &= half((h2 >> (7 * i)) & 127u) >= t;
        return ok;
    }
};

// host side: f(std::integral_constant<int, W>, std::bool_constant<kMinimizer>,
// CounterI32 or CounterP16) for W = ceil(k/16), the scheme (m > 0) and the
// layout (p16 != 0)
template <typename F>
static cudaError_t kmerax_dispatch_layout(int k, int m, int p16, F&& f) {
    return kmerax_dispatch(k, m, [&](auto w, auto mz) {
        return p16 ? f(w, mz, CounterP16{}) : f(w, mz, CounterI32{});
    });
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

// ---- staged m-mer hashes (K1, K2, K3 under the minimizer scheme) ---------
//
// The minimizer of the canonical k-mer starting at span position j is the
// least F[j .. j+k-m] if the canonical form is the forward strand, else the
// least R[j .. j+k-m], where F[p] = mix32(forward m-mer at p) and R[p] =
// mix32(its reverse complement): the m-mers of revcomp(x) are the reverse
// complements of x's m-mers in reverse order, and a minimum ignores order.
// So F and R are computed once per position of a packed span and staged in
// shared memory, where kmerax_block recomputes all k-m+1 m-mers of every
// k-mer. An m-mer holding an N lies only in invalid windows: its F and R
// are garbage and never read.

// the 2m-bit m-mer at position p of a packed span, read big-endian as
// kmerax_window_words reads a word (P must hold one word past it)
static __device__ __forceinline__ uint32_t kmerax_mmer(const uint32_t* P,
                                                       int p, int m) {
    const uint32_t x = __funnelshift_l(P[(p >> 4) + 1], P[p >> 4],
                                       2 * (p & 15));
    return x >> (32 - 2 * m);
}

// the reverse complement of a 2m-bit m-mer
static __device__ __forceinline__ uint32_t kmerax_mmer_rc(uint32_t x, int m) {
    return kmerax_reverse_pairs(~x) >> (32 - 2 * m);
}
