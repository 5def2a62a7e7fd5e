// Fused correction scoring (K3), and the rest of the correct round: its
// candidates (K6) and its conflict-suppressed apply (K7), for Hopper.
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
// scores[q][v] counts the solid (v, j) k-mers. The block row follows
// either bucket scheme (a template parameter), as in K1 and K2: the hash
// scheme's kmerax_block, or the minimizer scheme's kmerax_bucket_block of
// the staged m-mer hashes (below); the TPU kernel's hash-scheme-only restriction is an artifact of
// its layout and does not carry over. The counter layout is a template
// parameter too (kmerax.cuh): i32, or p16, the halfword probe the Pallas
// kernel takes with its packed16 flag (pallas_correct.py:266-269). Positions outside
// [0, length) read as base 4 (invalid); the center is always valid; window
// j counts only when its start lies in [0, last_j] of the read. An entry
// with ic < 0 is a dead slot and scores zero: the correct step hands K3 its
// whole (B, kSlots) slot grid (K6's output, below), about two thirds of
// it dead on the main path, and a dead slot's warps leave the work before
// the span is loaded.
//
// What bounds it on an H100: 4k probes per entry, each into a random
// 512-byte row of a table far above the 50 MB L2, so the floor is the
// sectors the probes read: one for most substituted k-mers, which are not
// solid, up to d for solid ones. Around each probe sit ~130 int32
// operations of canonical form and hash, so at 16,384 entries the int32
// issue rate and the sector floor are of one size (chip_smoke.py prints
// both). What the design does about it:
// - Packing: the entry's 2k-1 bases are packed once into shared memory as
//   2-bit words and an N mask (kmerax.cuh), the center as code 0 and valid.
//   A (v, j) thread takes its k-mer's W words with funnel shifts and ORs v
//   into one word at the center's offset (word j/16, bit 2(j%16)): O(W)
//   work, where a loop over k bases with a per-base branch was ~170 of its
//   ~260 operations.
// - Probe in two rounds: lane 0 first; only if it is >= t are the other
//   d-1 lanes loaded, together. A non-solid k-mer reads one sector, and a
//   solid one waits on two trips to memory instead of d dependent ones.
// - Layout: one warp per (entry, variant) for k <= 32, two for k <= 63;
//   blocks of 256 threads hold 2 or 1 entries. score[v] is the popcount of
//   the variant's warp ballots: no shared-memory atomics.
// - Minimizer scheme: the entry's m-mer hashes are staged once (kmerax.cuh;
//   MinimizerStage below), so a (v, j) thread takes its minimizer from at
//   most 2 + m shared words where kmerax_block would extract and mix its
//   k-m+1 m-mers: 4k(k-m+1) mix32 an entry (13,356 at k=63, m=11) become
//   2(2k-m) + 8m (318).
// The TPU kernel's 128-lane layout (lane v*k+j, the nvar/nslab split, the
// LP=256 row cap) does not carry over.

#include "kmerax.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSpanChunks = 4;           // 2k-1 <= 125 bases: 4 chunks of 32

// The minimizer scheme's staging of one entry (kmerax.cuh: staged m-mer
// hashes), in dynamic shared memory. The span's windows j = 0..k-1 take
// their m-mers from span positions j..j+k-m; those at k-m..k-1 cover the
// center and differ by variant, the rest do not. So the window's minimum
// splits into three parts: the left positions j..k-m-1 (a suffix of
// [0, k-m): suffix minima sufL), the right positions k..j+k-m (a prefix of
// [k, 2k-m): prefix minima preR), both shared by the 4 variants, and the
// center positions max(j, k-m)..min(j+k-m, k-1), read from the variant's
// own m hashes (ctr). Strand s = 0 is F, 1 is R. The strands' arrays lie
// 64 words apart, ctr's [s] halves 16 apart, so lanes of one variant on
// either strand read distinct banks (or broadcast).
struct MinimizerStage {
    uint32_t sufL[2][64];                // k - m <= 62 positions
    uint32_t preR[2][64];
    uint32_t ctr[4][2][16];              // [variant][strand][i], m <= 15
};

// fill the entry's stage from its packed span P (center as code 0); warp
// `we` of the entry: 0 the left suffix minima, 1 the right prefix minima,
// 2 and 3 the 4m center hashes; every lane of those warps calls it
static __device__ __forceinline__ void stage_entry(MinimizerStage* st,
                                                   const uint32_t* P, int k,
                                                   int m, int we, int lane) {
    const int nl = k - m;                // left and right positions
    if (we == 0) {                       // suffix minima, last chunk first
        uint32_t cf = KMERAX_FULL_MASK, cr = KMERAX_FULL_MASK;
        for (int c0 = (nl - 1) / 32 * 32; c0 >= 0; c0 -= 32) {
            const int i = c0 + lane;
            uint32_t f = KMERAX_FULL_MASK, r = KMERAX_FULL_MASK;
            if (i < nl) {
                const uint32_t x = kmerax_mmer(P, i, m);
                f = kmerax_mix32(x);
                r = kmerax_mix32(kmerax_mmer_rc(x, m));
            }
            // past the last lane a shuffle returns the lane's own value
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                f = min(f, __shfl_down_sync(KMERAX_FULL_MASK, f, o));
                r = min(r, __shfl_down_sync(KMERAX_FULL_MASK, r, o));
            }
            f = min(f, cf);
            r = min(r, cr);
            cf = __shfl_sync(KMERAX_FULL_MASK, f, 0);
            cr = __shfl_sync(KMERAX_FULL_MASK, r, 0);
            if (i < nl) {
                st->sufL[0][i] = f;
                st->sufL[1][i] = r;
            }
        }
    } else if (we == 1) {                // prefix minima from position k
        uint32_t cf = KMERAX_FULL_MASK, cr = KMERAX_FULL_MASK;
        for (int c0 = 0; c0 < nl; c0 += 32) {
            const int i = c0 + lane;
            uint32_t f = KMERAX_FULL_MASK, r = KMERAX_FULL_MASK;
            if (i < nl) {
                const uint32_t x = kmerax_mmer(P, k + i, m);
                f = kmerax_mix32(x);
                r = kmerax_mix32(kmerax_mmer_rc(x, m));
            }
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                f = min(f, __shfl_up_sync(KMERAX_FULL_MASK, f, o));
                r = min(r, __shfl_up_sync(KMERAX_FULL_MASK, r, o));
            }
            f = min(f, cf);
            r = min(r, cr);
            cf = __shfl_sync(KMERAX_FULL_MASK, f, 31);
            cr = __shfl_sync(KMERAX_FULL_MASK, r, 31);
            if (i < nl) {
                st->preR[0][i] = f;
                st->preR[1][i] = r;
            }
        }
    } else if (we < 4) {                 // center m-mer i of variant v
        const int t = 32 * (we - 2) + lane;
        if (t < 4 * m) {
            const int v = t / m, i = t % m;
            // the center is base m-1-i of the m-mer at k-m+i: bits 2i
            const uint32_t x = kmerax_mmer(P, nl + i, m) | ((uint32_t)v << (2 * i));
            st->ctr[v][0][i] = kmerax_mix32(x);
            st->ctr[v][1][i] = kmerax_mix32(kmerax_mmer_rc(x, m));
        }
    }
}

// the minimizer of window j of variant v on strand s (0: forward kept)
static __device__ __forceinline__ uint32_t staged_minimizer(
    const MinimizerStage* st, int k, int m, int j, int v, int s) {
    uint32_t best = KMERAX_FULL_MASK;
    if (j < k - m) best = st->sufL[s][j];
    if (j >= m) best = min(best, st->preR[s][j - m]);
    const int hi = min(j, m - 1);
    for (int i = max(j - (k - m), 0); i <= hi; ++i)
        best = min(best, st->ctr[v][s][i]);
    return best;
}

// WPV warps per (entry, variant): 1 for k <= 32, 2 for k <= 63
template <int W, int WPV, bool kMinimizer, typename Counter>
__global__ void correct_eval_scores_kernel(
    const int32_t* __restrict__ bases, int L,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ last_j,
    const int32_t* __restrict__ ent_r, const int32_t* __restrict__ ent_i,
    int64_t Q, const int32_t* __restrict__ table, uint32_t block_mask, int d,
    int m, int log2_buckets, int t, int k, int32_t* __restrict__ scores) {
    constexpr int kWarpsPerEntry = 4 * WPV;
    constexpr int kEntries = kWarps / kWarpsPerEntry;
    __shared__ uint32_t sP[kEntries][2 * kSpanChunks + 1];
    __shared__ uint32_t sN[kEntries][kSpanChunks];
    __shared__ int sCount[kWarps];
    extern __shared__ MinimizerStage sMz[];  // kEntries, minimizer scheme
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int e = warp / kWarpsPerEntry;     // entry within the block
    const int we = warp % kWarpsPerEntry;    // warp within the entry
    const int v = we / WPV;                  // center substitution
    const int j = (we % WPV) * 32 + lane;    // window
    const int64_t q = (int64_t)blockIdx.x * kEntries + e;
    // warp-uniform; a dead slot (ent_i < 0) loads no span and probes
    // nothing: its warps only meet the barriers, and it scores zero
    const bool live = q < Q && ent_i[q] >= 0;

    int r = 0, c = 0, lj = -1;
    if (live) {
        r = ent_r[q];
        lj = last_j[r];                      // loaded before the barrier
        const int ic = min(max(ent_i[q], 0), L - 1);
        c = ic - (k - 1);                    // window start, may be < 0
        // the batcher rejects reads longer than L; the min keeps a bad
        // length from reading into the next row
        const int len = min(lengths[r], L);
        const int span = 2 * k - 1;
        if (we < (span + 31) / 32) {         // one warp per 32-base chunk
            const int i = 32 * we + lane;    // span-relative position
            const int p = c + i;
            int b = (p >= 0 && p < len) ? bases[(int64_t)r * L + p] : 4;
            bool bad = b >= 4 || i >= span;
            if (i == k - 1) { b = 0; bad = false; }   // the center
            kmerax_pack_chunk(sP[e], sN[e], we, lane, (uint32_t)b, bad);
            if (lane == 0 && we == (span + 31) / 32 - 1)
                sP[e][2 * we + 2] = 0;
        }
    }
    __syncthreads();
    if constexpr (kMinimizer) {
        if (live) stage_entry(&sMz[e], sP[e], k, m, we, lane);
        __syncthreads();
    }

    bool solid = false;
    if (live && j < k) {
        const int jg = c + j;                // global window index
        if (jg >= 0 && jg <= lj && kmerax_span_clear(sN[e], j, k)) {
            uint32_t words[W];
            kmerax_window_words<W>(sP[e], j, k, words);
            // the center sits at window position k-1-j: word j/16, bits
            // 2(j%16) (ops/correct.py::_center_layout)
#pragma unroll
            for (int wi = 0; wi < W; ++wi)
                if (wi == (j >> 4)) words[wi] |= (uint32_t)v << (2 * (j & 15));
            if constexpr (kMinimizer) {
                const bool fwd = kmerax_canonical_strand(words, W, k);
                const uint32_t h1 = kmerax_kmer_hash(words, W,
                                                     KMERAX_HASH_SEED_1);
                const uint32_t h2 = kmerax_kmer_hash(words, W,
                                                     KMERAX_HASH_SEED_2);
                solid = Counter::solid(
                    table,
                    kmerax_bucket_block(staged_minimizer(&sMz[e], k, m, j, v,
                                                         fwd ? 0 : 1),
                                        h1, block_mask, log2_buckets),
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
    }
    const int n = __popc(__ballot_sync(KMERAX_FULL_MASK, solid));
    if (lane == 0) sCount[warp] = n;
    __syncthreads();
    if (threadIdx.x < 4 * kEntries) {
        const int ee = threadIdx.x / 4, vv = threadIdx.x % 4;
        const int64_t qq = (int64_t)blockIdx.x * kEntries + ee;
        if (qq < Q) {
            int s = 0;
#pragma unroll
            for (int h = 0; h < WPV; ++h)
                s += sCount[ee * kWarpsPerEntry + vv * WPV + h];
            scores[qq * 4 + vv] = s;
        }
    }
}

// ---- K6 and K7: the rest of a correct round -------------------------------
//
// A round of kmerax_torch/ops/correct.py::correct_batch is K2 (the windows'
// solidity, csrc/bloom.cu), K6 (the candidates), K3 (their scores) and K7
// (accept, conflicts, edits). K6 and K7 replace no Pallas kernel: the JAX
// package leaves this glue to XLA's fusion (kmerax/ops/correct.py::
// _weak_run_candidates, the per-read cap, and _apply), and the port ran it
// as ~850 eager torch launches a round with two host syncs, while its
// kernels needed a few tens of microseconds. Their plain versions are
// ops/correct_kernels.py::round_candidates_plain and apply_slots_plain.
//
// What bounds them on an H100: bytes only. K6 reads the (B, nk) solidity
// (one byte a window: 532 KB at 4,096 x 130) and writes the (B, kSlots)
// slots; K7 reads the slots, their scores and the bases under them, and in
// the last round the round's (B, L) rows, and writes the output: at 3.35
// TB/s ~0.2 us and ~1.1 us on a 4,096 x 160 batch, well under a launch's
// own latency (chip_smoke.py phase 2 prints both). One warp a read: reads
// are independent, and the only sequential rules (a read's weak runs in
// order, its slots' conflicts in slot order) stay inside one read, where
// the warp keeps them in registers and ballots, with no shared memory and
// no atomics.

// A read's candidate slots a round: ops/correct.py::correct_batch's default
// max_cands (ops/correct_kernels.py::SLOTS).
constexpr int kSlots = 4;

// K6: per read, the round's done update (every existing window solid, or
// none) and the first kSlots distinct candidates of its first max_runs weak
// runs, in run order (DESIGN.md §8 v2). Keeping the first occurrence and
// then the first kSlots live ones equals stopping at the kSlots-th distinct
// candidate, so the scan stops there. Lane n holds the n-th kept candidate;
// a ballot tests a new one against those.
__global__ void correct_candidates_kernel(
    const uint8_t* __restrict__ solid, int64_t B, int nk,
    const int32_t* __restrict__ last_j, int32_t* __restrict__ done, int k,
    int max_runs, int32_t* __restrict__ cands) {
    const int lane = threadIdx.x & 31;
    const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (r >= B) return;                      // warp-uniform
    const int lj = last_j[r];
    // lane 0 alone reads done[r], which it alone writes at the end
    const bool was_done =
        __shfl_sync(KMERAX_FULL_MASK, lane == 0 ? done[r] : 0, 0) != 0;
    bool any_weak = false, any_solid = false;
    int kept = -1, n_kept = 0, n_runs = 0;
    auto push = [&](int c) {
        const bool dup = __ballot_sync(KMERAX_FULL_MASK,
                                       lane < n_kept && kept == c) != 0;
        if (!dup && n_kept < kSlots) {
            if (lane == n_kept) kept = c;
            ++n_kept;
        }
    };
    if (!was_done) {
        const uint8_t* row = solid + r * nk;
        uint32_t carry = 0;                  // window 32c - 1 was weak
        int j0 = 0;                          // the open run's first window
        // one window past nk, never weak, closes a run that reaches the end
        for (int c = 0; c <= nk / 32; ++c) {
            const int j = 32 * c + lane;
            const bool s = j < nk && row[j] != 0;
            const uint32_t sw = __ballot_sync(KMERAX_FULL_MASK, s);
            const uint32_t ww = __ballot_sync(KMERAX_FULL_MASK,
                                              j < nk && j <= lj && !s);
            any_solid |= sw != 0;
            any_weak |= ww != 0;
            const uint32_t before = (ww << 1) | carry;   // j - 1 weak
            carry = ww >> 31;
            const uint32_t starts = ww & ~before;
            uint32_t ev = starts | (~ww & before);       // starts and stops
            while (ev && n_runs < max_runs && n_kept < kSlots) {
                const int p = __ffs(ev) - 1;
                ev &= ev - 1;
                if ((starts >> p) & 1) {
                    j0 = 32 * c + p;
                    continue;
                }
                const int j1 = 32 * c + p - 1;   // the run is [j0, j1]
                ++n_runs;
                const bool left = j0 == 0, right = j1 == lj;
                if (left == right) {             // interior or whole read
                    push(left ? j1 : j0 + k - 1);
                    push(left ? j0 + k - 1 : j1);
                } else {                         // one edge: one candidate
                    push(left ? j1 : j0 + k - 1);
                }
            }
        }
    }
    const bool now_done = was_done || !any_weak || !any_solid;
    if (lane < kSlots)
        cands[r * kSlots + lane] = (!now_done && lane < n_kept) ? kept : -1;
    if (lane == 0) done[r] = now_done;
}

// K7: per read, over its kSlots slots in order, on the round's bases in
// place: the accept rule (ops/correct.py::_accept: the first best base
// beats the current base's score, scores at least 1, and differs from the
// current base), the conflict rule (an accepted slot within k-1 of an
// earlier applied slot of the read is suppressed), the edit, edits += the
// slots applied, and done |= nothing applied. In the last round (out not
// null) also the max_edits revert against orig, n_edits (0 where
// reverted), and the output row in the batch's type T.
template <typename T>
__global__ void correct_apply_kernel(
    int32_t* __restrict__ bases, int64_t B, int L,
    const int32_t* __restrict__ cands, const int32_t* __restrict__ scores, int32_t* __restrict__ edits,
    int32_t* __restrict__ done, int k, const T* __restrict__ orig,
    T* __restrict__ out, int32_t* __restrict__ n_edits, int max_edits) {
    const int lane = threadIdx.x & 31;
    const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (r >= B) return;                      // warp-uniform
    int32_t* row = bases + r * L;
    const int ic = lane < kSlots ? cands[r * kSlots + lane] : -1;
    bool accept = false;
    int best_b = 0;
    if (ic >= 0) {
        const int4 sc = *reinterpret_cast<const int4*>(
            scores + 4 * (r * kSlots + lane));
        int best = sc.x;                     // the first max wins
        if (sc.y > best) { best = sc.y; best_b = 1; }
        if (sc.z > best) { best = sc.z; best_b = 2; }
        if (sc.w > best) { best = sc.w; best_b = 3; }
        const int cur = row[ic];
        const int cur_s = cur == 0 ? sc.x : cur == 1 ? sc.y
                        : cur == 2 ? sc.z : cur == 3 ? sc.w : 0;
        accept = best_b != cur && best > cur_s && best >= 1;
    }
    uint32_t applied = 0;                    // warp-uniform, bit s: slot s
    for (int s = 0; s < kSlots; ++s) {
        if (!__shfl_sync(KMERAX_FULL_MASK, (int)accept, s)) continue;
        const int is = __shfl_sync(KMERAX_FULL_MASK, ic, s);
        const bool near = lane < s && ((applied >> lane) & 1)
                          && abs(ic - is) <= k - 1;
        if (!__ballot_sync(KMERAX_FULL_MASK, near)) applied |= 1u << s;
    }
    if ((applied >> lane) & 1) row[ic] = best_b;
    // lane 0 alone reads edits[r], which it alone writes next
    const int e = __shfl_sync(KMERAX_FULL_MASK, lane == 0 ? edits[r] : 0, 0)
                  + __popc(applied);
    if (lane == 0) {
        edits[r] = e;
        if (!applied) done[r] = 1;
    }
    if (out == nullptr) return;
    __syncwarp();                            // the edits above, then the row
    const bool revert = e > max_edits;
    const int64_t o = r * L;
    for (int i = lane; i < L; i += 32)
        out[o + i] = revert ? orig[o + i] : (T)row[i];
    if (lane == 0) n_edits[r] = revert ? 0 : e;
}

}  // namespace

extern "C" int kmerax_correct_eval_scores(
    const int32_t* bases, int L, const int32_t* lengths,
    const int32_t* last_j, const int32_t* ent_r, const int32_t* ent_i,
    int64_t Q, const int32_t* table, uint32_t block_mask, int d, int m,
    int log2_buckets, int p16, int t, int k, int32_t* scores,
    cudaStream_t stream) {
    if (Q <= 0) return (int)cudaGetLastError();
    return (int)kmerax_dispatch_layout(k, m, p16, [&](auto w, auto mz,
                                                      auto layout) {
        constexpr int W = decltype(w)::value;
        constexpr int WPV = W <= 2 ? 1 : 2;
        constexpr int kEntries = kWarps / (4 * WPV);
        const size_t smem = decltype(mz)::value
                            ? kEntries * sizeof(MinimizerStage) : 0;
        correct_eval_scores_kernel<W, WPV, decltype(mz)::value,
                                   decltype(layout)>
            <<<(unsigned)((Q + kEntries - 1) / kEntries), kThreads, smem,
               stream>>>(bases, L, lengths, last_j, ent_r, ent_i, Q, table,
                         block_mask, d, m, log2_buckets, t, k, scores);
        return cudaGetLastError();
    });
}

extern "C" int kmerax_correct_candidates(
    const uint8_t* solid, int64_t B, int nk, const int32_t* last_j,
    int32_t* done, int k, int max_runs, int32_t* cands, cudaStream_t stream) {
    if (B <= 0) return (int)cudaGetLastError();
    correct_candidates_kernel<<<(unsigned)((B + kWarps - 1) / kWarps),
                                kThreads, 0, stream>>>(
        solid, B, nk, last_j, done, k, max_runs, cands);
    return (int)cudaGetLastError();
}

// out_bytes: 0 in a round before the last (orig, out and n_edits unused),
// else the size of the batch's element, 1 (int8) or 4 (int32)
extern "C" int kmerax_correct_apply(
    int32_t* bases, int64_t B, int L, const int32_t* cands,
    const int32_t* scores, int32_t* edits, int32_t* done, int k,
    const void* orig, void* out, int out_bytes, int32_t* n_edits,
    int max_edits, cudaStream_t stream) {
    if (B <= 0) return (int)cudaGetLastError();
    const unsigned grid = (unsigned)((B + kWarps - 1) / kWarps);
    if (out_bytes == 1)
        correct_apply_kernel<int8_t><<<grid, kThreads, 0, stream>>>(
            bases, B, L, cands, scores, edits, done, k,
            (const int8_t*)orig, (int8_t*)out, n_edits, max_edits);
    else
        correct_apply_kernel<int32_t><<<grid, kThreads, 0, stream>>>(
            bases, B, L, cands, scores, edits, done, k,
            (const int32_t*)orig, out_bytes ? (int32_t*)out : nullptr,
            n_edits, max_edits);
    return (int)cudaGetLastError();
}
