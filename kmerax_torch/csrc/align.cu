// Banded global alignment scores (K4) for Hopper.
//
// kmerax_banded_align_scores replaces the Pallas kernel
//   kmerax/ops/pallas_align.py::_align_kernel (via banded_align_scores_pallas).
// Its plain version is
//   kmerax_torch/ops/align_kernels.py::banded_align_scores_plain.
//
// Scoring (DESIGN.md §10): match +2, mismatch -3 (a base >= 4 never matches),
// linear gap -4. The band is held in diagonal coordinates: band diagonal d
// of DP row i is cell (i, j = i + d - band), 0 <= d < W = 2*band+1. Each row
// is the max-plus recurrence of kmerax/ops/align.py, with the within-row gap
// dependency solved by a prefix max:
//   f[d]   = max(valid ? max(diag, up) : NEG_INF, col0) + 4*d
//   row[d] = max(NEG_INF, max_{d'<=d} f[d']) - 4*d, masked to NEG_INF
// in the same int32 arithmetic as the Pallas kernel (NEG_INF = -2^30; no
// clamp, no saturation: the row masks alone decide which cells are NEG_INF).
// The result is S[qlen][tlen], NEG_INF where |tlen - qlen| > band (the gate
// banded_align_scores_pallas applies after its kernel; here such a read's
// warp writes NEG_INF and runs no row).
//
// Layout: one warp per read. Lane l holds the P = ceil(W/32) diagonals
// d = l*P .. l*P+P-1 (P = 1 at the default band 15, 4 at band 63); lanes
// past W - 1 are outside the band and masked, as the Pallas kernel masks
// sublanes d >= W. The rows i = 1..qlen run in a loop inside the warp and
// stop at qlen, the only row that is read. Per row: `up` (diagonal d+1 of
// the previous row) comes from the neighbour lane with __shfl_down_sync,
// and the prefix max is a serial max over the lane's P values followed by a
// Hillis-Steele scan of the lane totals with __shfl_up_sync, NEG_INF below
// the shift.
//
// What bounds it on an H100: per read, qlen rows of about 5 + P*20 integer
// operations and log2(32) + 2 shuffles, all in registers; the query and
// target bases come from DRAM once (consecutive lanes read consecutive
// target bases, so each row's load is one coalesced, L1-resident segment).
// Like the Pallas kernel, it keeps the XLA path's (B, n+1, W) rows tensor
// out of device memory: only the (B,) scores are written.

#include "kmerax.cuh"

namespace {

constexpr int kMatch = 2, kMismatch = -3, kGap = -4;
constexpr int32_t kNegInf = -(1 << 30);
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarpsPerBlock = 4;

template <int P>
__global__ void banded_align_kernel(
    const int32_t* __restrict__ query, int n,
    const int32_t* __restrict__ target, int m,
    const int32_t* __restrict__ qlen, const int32_t* __restrict__ tlen,
    int64_t B, int band, int32_t* __restrict__ out) {
    const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
    if (r >= B) return;                      // whole warp: r is warp-uniform
    const int lane = threadIdx.x & 31;
    const int W = 2 * band + 1;
    const int ql = qlen[r], tl = tlen[r];
    if (abs(tl - ql) > band) {               // warp-uniform: outside the band
        if (lane == 0) out[r] = kNegInf;
        return;
    }
    const int32_t* q = query + r * n;
    const int32_t* t = target + r * m;

    // row 0: S[0][j] = GAP*j for 0 <= j <= min(band, tlen), else NEG_INF
    int32_t prev[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int d = lane * P + p, j = d - band;
        prev[p] = (d < W && j >= 0 && j <= tl) ? kGap * j : kNegInf;
    }

    // the final cell sits on diagonal dfin of row qlen
    const int dfin = min(max(tl - ql + band, 0), W - 1);
    const int lane_f = dfin / P, p_f = dfin - lane_f * P;
    auto harvest = [&](const int32_t (&row)[P]) {
        int32_t v = row[0];
#pragma unroll
        for (int p = 1; p < P; ++p)
            if (p == p_f) v = row[p];
        return __shfl_sync(kFull, v, lane_f);
    };
    int32_t score = ql == 0 ? harvest(prev) : kNegInf;

    const int last = min(ql, n);             // rows past qlen are never read
    for (int i = 1; i <= last; ++i) {
        const int qi = __ldg(q + i - 1);
        // diagonal d+1 of the previous row: the next lane's first value
        const int32_t nxt = __shfl_down_sync(kFull, prev[0], 1);
        int32_t f[P];
        bool keep[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int d = lane * P + p, j = i + d - band;
            const int tb = (j >= 1 && j <= m) ? __ldg(t + j - 1) : 4;
            const int32_t sub = (tb == qi && qi < 4) ? kMatch : kMismatch;
            const int32_t diag = prev[p] + sub;                 // S[i-1][j-1]
            const int32_t upn = p + 1 < P ? prev[(p + 1) % P] : nxt;
            const int32_t up = (d >= W - 1 ? kNegInf : upn) + kGap;  // S[i-1][j]
            const bool valid = j >= 1 && j <= tl && d < W;
            const bool edge = j == 0 && i <= band;
            const int32_t mv = valid ? max(diag, up) : kNegInf;
            const int32_t col0 = edge ? kGap * i : kNegInf;
            f[p] = max(mv, col0) - kGap * d;
            keep[p] = valid || edge;
        }
        // prefix max over d: within the lane, then across the lane totals
#pragma unroll
        for (int p = 1; p < P; ++p) f[p] = max(f[p], f[p - 1]);
        int32_t tot = f[P - 1];
#pragma unroll
        for (int s = 1; s < 32; s *= 2) {
            const int32_t v = __shfl_up_sync(kFull, tot, s);
            tot = max(tot, lane >= s ? v : kNegInf);
        }
        int32_t below = __shfl_up_sync(kFull, tot, 1);  // lanes < this one
        below = lane >= 1 ? below : kNegInf;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int d = lane * P + p;
            prev[p] = keep[p] ? max(f[p], below) + kGap * d : kNegInf;
        }
        if (i == ql) score = harvest(prev);
    }
    if (lane == 0) out[r] = score;
}

template <int P>
void launch(const int32_t* query, int n, const int32_t* target, int m,
            const int32_t* qlen, const int32_t* tlen, int64_t B, int band,
            int32_t* out, cudaStream_t stream) {
    const int64_t blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    banded_align_kernel<P><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                             stream>>>(query, n, target, m, qlen, tlen, B,
                                       band, out);
}

}  // namespace

// query (B, n), target (B, m), qlen, tlen (B,) int32, 0 <= band <= 63;
// out (B,) int32 = S[qlen][tlen], NEG_INF where |tlen - qlen| > band.
extern "C" int kmerax_banded_align_scores(
    const int32_t* query, int n, const int32_t* target, int m,
    const int32_t* qlen, const int32_t* tlen, int64_t B, int band,
    int32_t* out, cudaStream_t stream) {
    if (band < 0 || band > 63) return (int)cudaErrorInvalidValue;
    if (B > 0) {
        auto fn = &launch<4>;
        switch ((2 * band + 1 + 31) / 32) {     // diagonals per lane
            case 1: fn = &launch<1>; break;
            case 2: fn = &launch<2>; break;
            case 3: fn = &launch<3>; break;
        }
        fn(query, n, target, m, qlen, tlen, B, band, out, stream);
    }
    return (int)cudaGetLastError();
}
