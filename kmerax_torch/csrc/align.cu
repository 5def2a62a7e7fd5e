// Banded global alignment scores (K4) for Hopper.
//
// kmerax_banded_align_scores replaces the Pallas kernel
//   kmerax/ops/pallas_align.py::_align_kernel (via banded_align_scores_pallas).
// Its plain version is
//   kmerax_torch/ops/align_kernels.py::banded_align_scores_plain.
//
// Scoring (DESIGN.md §10): match +2, mismatch -3 (a base code outside 0..3
// never matches), linear gap -4. The band is held in diagonal coordinates:
// band diagonal d of DP row i is cell (i, j = i + d - band), 0 <= d < W =
// 2*band+1. Each row is the max-plus recurrence of kmerax/ops/align.py,
// with the within-row gap dependency solved by a prefix max:
//   f[d]   = max(valid ? max(diag, up) : NEG_INF, col0) + 4*d
//   row[d] = max_{d'<=d} f[d'] - 4*d, masked to NEG_INF outside the band
// in int32 (NEG_INF = -2^30). The kernel keeps row i as X[d] = row[d] +
// 4d + 8i: in these coordinates the prefix max needs no +-4d per cell and
// a valid cell is f = max(X'[d] + sub + 8, X'[d+1]) of the previous row X',
// one DPX add-max (__viaddmax_s32), and the new X is max(prefix, lanes
// before). Every valid cell is finite (its diagonal predecessor is valid,
// an edge cell or row 0), so the NEG_INF terms never win and a cell
// outside the band only has to stay far below every finite one: the
// kernel holds it at NEG_INF. The edge cell (j = 0) is 4*band in X, row
// 0's valid cells too, and the result is X[dfin] - 4*dfin - 8*qlen: equal
// to the plain version's bit for bit. It is S[qlen][tlen], NEG_INF where
// |tlen - qlen| > band (the gate banded_align_scores_pallas applies after
// its kernel; here such a read's lanes write NEG_INF and harvest nothing).
//
// What bounds it on an H100: integer issue, and at band 15 the latency of
// each row's chain (a warp holds 32/G reads; 4096 reads give 1-8 warps per
// scheduler). A cell is ~10 int32 operations of arithmetic (the bound
// chip_smoke.py counts); every instruction spent on indexing, masks, loads
// and the cross-lane exchange comes on top. With one lane per diagonal (a
// warp per read) each cell paid its row's index arithmetic, band masks, a
// global target load and a 5-step shuffle scan: 60-80 instructions at
// band 15. This layout moves that work off the cell:
// - G lanes per read (template, G in {4, 8, 16, 32}; a warp serves 32/G
//   reads), lane g holding the P consecutive diagonals d = gP .. gP+P-1 in
//   registers (P a power of two >= ceil(W/G); diagonals d >= W are padding
//   and stay NEG_INF). Within a lane the prefix max takes log2(P) steps for
//   P <= 8, else a serial max beside a tree for the lane total; across
//   lanes the max of the totals before g comes from width-G shuffles: for
//   G = 4 all three at once (independent, so the row waits on one
//   shuffle's latency; at G = 8 seven were slower than the scan), else a
//   log2(G)-step segmented scan (__shfl_up_sync with width G leaves the
//   segment's low lanes their own value) and one shuffle. `up` for the
//   lane's last diagonal is the next lane's first, by one
//   __shfl_down_sync with width G.
// - Row bounds are hoisted: cell (i, d) is valid iff i lies in
//   [band+1-d, tlen+band-d], and the edge cell iff i = band-d, so per row a
//   lane computes its first valid slot plo = band+1-i-gP and last
//   phi = tlen+band-i-gP once. Rows past `band` have plo <= 0 and no edge
//   cell, and until tlen-band every real diagonal is valid: those rows
//   (most of them) mask only the padding, with one min against a per-lane
//   cap a cell, in a loop unrolled P times for P <= 8 so that the target
//   window below rotates through its registers instead of shifting.
// - Bases are staged once per read in shared memory as bytes, the warp
//   copying 32 positions of each of its reads per step, four steps' loads
//   at once: the query codes, and the target padded by band+1 codes on the
//   left (tp[x] = target[x - band - 1]), so the lane's P target bases of
//   row i are tp[i + gP .. i + gP + P - 1]. They sit in a register window
//   that moves by one base a row; the one new base and the query base of
//   the next row are loaded a row ahead.
// The rows i = 1 .. max qlen of the warp's reads run in a loop (a read's
// lanes stop harvesting at its qlen; rows past it are never read). Only
// the (B,) scores are written.

#include <type_traits>

#include "kmerax.cuh"

namespace {

constexpr int kMatch = 2, kMismatch = -3, kGap = -4;
constexpr int32_t kNegInf = -(1 << 30);
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarpsPerBlock = 1;     // 2 measured 5-10 % slower at G = 4
constexpr uint8_t kQueryNone = 4, kTargetNone = 5;   // never equal

// bytes of one read's staging: n query codes, then n + G*P + 2 target
// codes (the last index read is n + 1 + G*P, the row-ahead load after row
// n), rounded up to an odd number of 4-byte words so that the reads of a
// warp start in different shared-memory banks
__host__ __device__ inline int stage_bytes(int n, int gp) {
    const int words = (2 * n + gp + 2 + 3) / 4;
    return 4 * (words | 1);
}

// the rows of a read: i <= band, where cells left of the band's start and
// the edge column occur (kTop); rows in which every real diagonal of the
// warp's reads is valid, so only the padding d >= W is masked, by a min
// with a per-lane cap (kMid); the rest, masked at d > tlen+band-i (kBottom)
enum RowKind { kTop, kMid, kBottom };

// one DP row over the lane's P diagonals, in place on X (row i-1 in, row
// i out); the lane's target code of slot p is tw[(p + U) % P], qi the
// query code; plo and phi bound the valid slots (kTop, kBottom)
template <int G, int P, RowKind kKind, int U>
__device__ __forceinline__ void row_step(int32_t (&X)[P], const int (&tw)[P],
                                         const int32_t (&cap)[P], int qi,
                                         int plo, int phi, int g,
                                         int32_t edge) {
    // diagonal gP+P of the previous row: the next lane's first (for the
    // group's last lane, its own first value; its last diagonal is padding)
    const int32_t nxt = __shfl_down_sync(kFull, X[0], 1, G);
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int32_t sub = tw[(p + U) % P] == qi ? kMatch - 2 * kGap
                                                 : kMismatch - 2 * kGap;
        const int32_t up = p + 1 < P ? X[(p + 1) % P] : nxt;
        int32_t f = __viaddmax_s32(X[p], sub, up);
        if (kKind == kTop)   // p < plo: j < 1, the edge column or left of it
            f = p >= plo ? f : (p == plo - 1 ? edge : kNegInf);
        X[p] = f;
    }
    int32_t tot;
    if constexpr (P <= 8) {
#pragma unroll
        for (int h = 1; h < P; h *= 2)
#pragma unroll
            for (int p = P - 1; p >= h; --p) X[p] = max(X[p], X[p - h]);
        tot = X[P - 1];
    } else {   // the log-step form ran 9x slower at P = 16, 32
        int32_t t[P];
#pragma unroll
        for (int p = 0; p < P; ++p) t[p] = X[p];
#pragma unroll
        for (int h = 1; h < P; h *= 2)
#pragma unroll
            for (int p = 0; p + h < P; p += 2 * h) t[p] = max(t[p], t[p + h]);
#pragma unroll
        for (int p = 1; p < P; ++p) X[p] = max(X[p], X[p - 1]);
        tot = t[0];
    }
    // the max over the lanes before g
    int32_t below = kNegInf;
    if constexpr (G == 4) {
#pragma unroll
        for (int s = 1; s < G; ++s) {
            const int32_t v = __shfl_up_sync(kFull, tot, s, G);
            below = g >= s ? max(below, v) : below;
        }
    } else {
#pragma unroll
        for (int s = 1; s < G; s *= 2)
            tot = max(tot, __shfl_up_sync(kFull, tot, s, G));
        const int32_t v = __shfl_up_sync(kFull, tot, 1, G);
        below = g ? v : kNegInf;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int32_t v = max(X[p], below);
        if (kKind == kMid) {
            X[p] = min(v, cap[p]);
        } else {
            const bool keep = (kKind == kBottom || p >= plo - 1) && p <= phi;
            X[p] = keep ? v : kNegInf;
        }
    }
}

// f(integral_constant<int, U>) for U = 0 .. N-1
template <int U, int N, class F>
__device__ __forceinline__ void for_rotations(F& f) {
    if constexpr (U < N) {
        f(std::integral_constant<int, U>{});
        for_rotations<U + 1, N>(f);
    }
}

template <int G, int P>
__global__ void banded_align_kernel(
    const int32_t* __restrict__ query, int n,
    const int32_t* __restrict__ target, int m,
    const int32_t* __restrict__ qlen, const int32_t* __restrict__ tlen,
    int64_t B, int band, int32_t* __restrict__ out) {
    constexpr int kReadsPerWarp = 32 / G;
    constexpr bool kRing = P <= 8;          // rotate the window, unrolled
    extern __shared__ uint8_t stage[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane % G, e = lane / G;           // lane in read, read
    const int W = 2 * band + 1, d0 = g * P;
    const int sb = stage_bytes(n, G * P), S = n + G * P + 2;
    const int64_t r0 = ((int64_t)blockIdx.x * kWarpsPerBlock + warp) *
                       kReadsPerWarp;
    const int64_t r = r0 + e;
    const bool live = r < B;
    const int ql = live ? qlen[r] : 0, tl = live ? tlen[r] : 0;
    // the row whose cell S[ql][tl] is harvested, -1 for none: outside the
    // band gate, or past the n rows the query has
    const int hv = live && abs(tl - ql) <= band && ql <= n ? ql : -1;
    if (live && hv < 0 && g == 0) out[r] = kNegInf;

    // stage the warp's reads: the whole warp copies 32 positions of all
    // its reads per step, four steps' loads issued together, so that it
    // waits on memory once per four steps, not once per step and read
    uint8_t* mine = stage + (warp * kReadsPerWarp) * sb;
    int treal[kReadsPerWarp];                        // real target bases
#pragma unroll
    for (int ee = 0; ee < kReadsPerWarp; ++ee)
        treal[ee] = r0 + ee < B
                        ? min(max(__shfl_sync(kFull, tl, ee * G), 0), m) : 0;
#pragma unroll 4
    for (int x = lane; x < n; x += 32) {
        int b[kReadsPerWarp];
#pragma unroll
        for (int ee = 0; ee < kReadsPerWarp; ++ee)
            b[ee] = r0 + ee < B ? __ldg(query + (r0 + ee) * n + x) : 4;
#pragma unroll
        for (int ee = 0; ee < kReadsPerWarp; ++ee)
            mine[ee * sb + x] = (unsigned)b[ee] < 4u ? (uint8_t)b[ee]
                                                     : kQueryNone;
    }
#pragma unroll 4
    for (int x = lane; x < S; x += 32) {
        const int y = x - band - 1;
        int b[kReadsPerWarp];
#pragma unroll
        for (int ee = 0; ee < kReadsPerWarp; ++ee)
            b[ee] = y >= 0 && y < treal[ee]
                        ? __ldg(target + (r0 + ee) * m + y) : 4;
#pragma unroll
        for (int ee = 0; ee < kReadsPerWarp; ++ee)
            mine[ee * sb + n + x] = (unsigned)b[ee] < 4u ? (uint8_t)b[ee]
                                                         : kTargetNone;
    }
    __syncwarp();
    const uint8_t* tq = mine + e * sb;
    const uint8_t* tp = tq + n;

    // row 0: S[0][j] = GAP*j for 0 <= j <= min(band, tlen), i.e. X = 4*band
    int32_t X[P], cap[P];                   // cap: NEG_INF for the padding
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int d = d0 + p, j = d - band;
        X[p] = (d < W && j >= 0 && j <= tl) ? 4 * band : kNegInf;
        cap[p] = d < W ? INT32_MAX : kNegInf;
    }
    // the final cell: diagonal dfin of row hv, slot pf of lane gf
    const int dfin = tl - ql + band;
    const int gf = dfin / P, pf = dfin % P;
    auto harvest = [&]() {
        int32_t v = X[0];
#pragma unroll
        for (int p = 1; p < P; ++p)
            if (p == pf) v = X[p];
        out[r] = v - 4 * dfin - 8 * hv;
    };
    if (hv == 0 && g == gf) harvest();

    const int rows = __reduce_max_sync(kFull, max(hv, 0));
    // rows past `band` up to mid_end have every real diagonal valid (j <=
    // i + band <= tlen) for each read of the warp up to the row it
    // harvests; a read's rows past that are never read
    const int mid_end = __reduce_min_sync(
        kFull, hv >= 0 && hv > tl - band ? tl - band : rows);
    const int hv_mine = g == gf ? hv : -1;       // the row this lane harvests
    // whether a read of the warp harvests in a middle row (most do not:
    // the middle rows end before tlen - band + 1)
    const bool mid_harvest = __any_sync(kFull, hv > band && hv <= mid_end);
    int tw[P];
#pragma unroll
    for (int p = 0; p < P; ++p) tw[p] = tp[1 + d0 + p];
    const int c1 = band + 1 - d0;                       // plo = c1 - i
    const int c2 = tl + band - d0;                      // phi = c2 - i ...
    const int pw = W - 1 - d0;                          // ... capped here
    int qn = tq[0], tn = tp[1 + d0 + P];                // row 1's, row 2's
    // row i of kind K with the window rotated by U (U = -1: no rotation,
    // the window shifts), then the harvest and the window's move
    auto run = [&](auto kind, auto rot, int i) {
        constexpr RowKind K = decltype(kind)::value;
        constexpr int U = decltype(rot)::value;
        const int qi = qn, tnew = tn;
        qn = tq[min(i, n - 1)];
        tn = tp[i + 1 + d0 + P];
        row_step<G, P, K, (U < 0 ? 0 : U)>(X, tw, cap, qi, c1 - i,
                                          min(c2 - i, pw), g, 4 * band);
        if ((K != kMid || mid_harvest) && i == hv_mine) harvest();
        if constexpr (U < 0) {
#pragma unroll
            for (int p = 0; p + 1 < P; ++p) tw[p] = tw[p + 1];
            tw[P - 1] = tnew;
        } else {
            tw[U] = tnew;        // logical slot P-1 of the next rotation
        }
    };
    using Shift = std::integral_constant<int, -1>;
    int i = 1;
    for (const int top = min(band, rows); i <= top; ++i)
        run(std::integral_constant<RowKind, kTop>{}, Shift{}, i);
    if constexpr (kRing) {
        for (; i + P - 1 <= mid_end; i += P) {
            auto one = [&](auto rot) {
                run(std::integral_constant<RowKind, kMid>{}, rot,
                    i + decltype(rot)::value);
            };
            for_rotations<0, P>(one);
        }
    }
    for (; i <= mid_end; ++i)
        run(std::integral_constant<RowKind, kMid>{}, Shift{}, i);
    for (; i <= rows; ++i)
        run(std::integral_constant<RowKind, kBottom>{}, Shift{}, i);
}

template <int G, int P>
cudaError_t launch(const int32_t* query, int n, const int32_t* target,
                   int m, const int32_t* qlen, const int32_t* tlen,
                   int64_t B, int band, int32_t* out, cudaStream_t stream) {
    constexpr int kReads = kWarpsPerBlock * 32 / G;
    const size_t smem = (size_t)kReads * stage_bytes(n, G * P);
    if (smem > 48 * 1024) return cudaErrorInvalidValue;
    const int64_t blocks = (B + kReads - 1) / kReads;
    banded_align_kernel<G, P><<<(unsigned)blocks, 32 * kWarpsPerBlock, smem,
                                stream>>>(query, n, target, m, qlen, tlen, B,
                                          band, out);
    return cudaGetLastError();
}

// P: the least power of two with G*P >= W (G*P > W then, W being odd)
template <int G>
cudaError_t launch_g(const int32_t* query, int n, const int32_t* target,
                     int m, const int32_t* qlen, const int32_t* tlen,
                     int64_t B, int band, int32_t* out, cudaStream_t stream) {
    const int need = (2 * band + 1 + G - 1) / G;
    if (need <= 1)
        return launch<G, 1>(query, n, target, m, qlen, tlen, B, band, out,
                            stream);
    if (need <= 2)
        return launch<G, 2>(query, n, target, m, qlen, tlen, B, band, out,
                            stream);
    if (need <= 4)
        return launch<G, 4>(query, n, target, m, qlen, tlen, B, band, out,
                            stream);
    if constexpr (G <= 16)
        if (need <= 8)
            return launch<G, 8>(query, n, target, m, qlen, tlen, B, band,
                                out, stream);
    if constexpr (G <= 8)
        if (need <= 16)
            return launch<G, 16>(query, n, target, m, qlen, tlen, B, band,
                                 out, stream);
    if constexpr (G <= 4)
        if (need <= 32)
            return launch<G, 32>(query, n, target, m, qlen, tlen, B, band,
                                 out, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// query (B, n), target (B, m), qlen, tlen (B,) int32 base codes 0..4,
// 0 <= band <= 63, n >= 1, G in {4, 8, 16, 32} lanes per read; out (B,)
// int32 = S[qlen][tlen], NEG_INF where |tlen - qlen| > band.
extern "C" int kmerax_banded_align_scores(
    const int32_t* query, int n, const int32_t* target, int m,
    const int32_t* qlen, const int32_t* tlen, int64_t B, int band, int G,
    int32_t* out, cudaStream_t stream) {
    if (band < 0 || band > 63 || n < 1) return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    switch (G) {
        case 4: return (int)launch_g<4>(query, n, target, m, qlen, tlen, B,
                                        band, out, stream);
        case 8: return (int)launch_g<8>(query, n, target, m, qlen, tlen, B,
                                        band, out, stream);
        case 16: return (int)launch_g<16>(query, n, target, m, qlen, tlen, B,
                                          band, out, stream);
        case 32: return (int)launch_g<32>(query, n, target, m, qlen, tlen, B,
                                          band, out, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
