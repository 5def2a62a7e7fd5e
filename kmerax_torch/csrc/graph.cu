// The graph's membership join and successor select (K5) for Hopper.
//
// kmerax_solid_join replaces no TPU kernel: the JAX package joins on the
// host, in numpy (kmerax/graph/partitioned.py::solid_edges_host: pack_rows,
// searchsorted_packed, the found test and the select). It was added because
// that host join was ~37 % of a two-pass k=31 -> 63 job's wall on the H100
// (four-word keys, ~0.77 M solid nodes), with the card idle. Its plain
// version is kmerax_torch/graph/join_kernels.py::solid_join_plain.
//
// Each solid node has 8 candidate extensions (orientation o in {+, -} x
// appended base b in 0..3), canonical, as graph/partitioned.py::_extensions
// leaves them on the card: cand (n, 2, 4, W) int64 words in [0, 2^32) and
// is_fwd (n, 2, 4) bool. For each, the kernel finds the lower bound among
// the C sorted solid keys ((C, W) uint32, DESIGN.md §6 order: little-endian
// words compared unsigned, most-significant word first); the candidate is
// an edge iff lb < C and keys[lb] == cand. Per (node, o): outdeg is the
// number of hits, and succ_v / succ_o are the target's row and 0 if its
// forward strand was kept (else 1) of the LAST hit in b order (DESIGN.md
// §9's select), both 0 where nothing hit. They are written into the (C, 2)
// int32 edge arrays at the partition's rows.
//
// What bounds it on an H100: the bytes of the candidates (8 W int64 words a
// node: 198 MB at W = 4 for 0.77 M nodes), the keys touched (each at most
// once, 12 MB there), is_fwd and the outputs, over 3.35 TB/s: ~70 us at
// that size. The search itself is latency-bound: ~log2(C) = 20 dependent
// loads a query, from keys that fit in the 50 MB L2. The design keeps many
// queries in flight:
// - one thread a candidate (8 a node), so a 0.77 M-node partition has
//   6.2 M independent searches; neighbouring lanes read neighbouring
//   candidates, so the candidates stream in coalesced;
// - a branch-free lower bound whose trip count (ceil(log2 C)) is the same
//   for every lane: the warp never diverges inside the search, and each
//   step is one key load (a 16-byte load at W = 4, 8 at W = 2);
// - the four bases of a (node, o) are four neighbouring lanes: one ballot
//   gives the group's hits, popc its outdeg, and the lane of the highest
//   hit writes the successor, so no lane loops over the other three.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int W>
struct Key {
    uint32_t w[W];
};

// a key row; 16- and 8-byte rows in one load
template <int W>
__device__ __forceinline__ Key<W> load_key(const uint32_t* __restrict__ keys,
                                           uint32_t i) {
    Key<W> k;
    const uint32_t* p = keys + (size_t)i * W;
    if constexpr (W == 4) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
        k.w[0] = v.x; k.w[1] = v.y; k.w[2] = v.z; k.w[3] = v.w;
    } else if constexpr (W == 2) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        k.w[0] = v.x; k.w[1] = v.y;
    } else {
#pragma unroll
        for (int j = 0; j < W; ++j) k.w[j] = __ldg(p + j);
    }
    return k;
}

// a < b, unsigned, most-significant word first
template <int W>
__device__ __forceinline__ bool less(const Key<W>& a, const Key<W>& b) {
    bool lt = false, eq = true;
#pragma unroll
    for (int j = W - 1; j >= 0; --j) {
        lt |= eq & (a.w[j] < b.w[j]);
        eq &= a.w[j] == b.w[j];
    }
    return lt;
}

template <int W>
__device__ __forceinline__ bool same(const Key<W>& a, const Key<W>& b) {
    bool eq = true;
#pragma unroll
    for (int j = 0; j < W; ++j) eq &= a.w[j] == b.w[j];
    return eq;
}

// the first i in [0, C] with keys[i] >= x (C >= 1): the answer lies in
// [base, base + n] throughout; each step halves n whatever the compare
template <int W>
__device__ __forceinline__ uint32_t lower_bound(
        const uint32_t* __restrict__ keys, uint32_t C, const Key<W>& x) {
    uint32_t base = 0, n = C;
    while (n > 1) {
        const uint32_t half = n >> 1;
        base = less<W>(load_key<W>(keys, base + half), x) ? base + half
                                                          : base;
        n -= half;
    }
    return base + (less<W>(load_key<W>(keys, base), x) ? 1u : 0u);
}

template <int W>
__global__ void __launch_bounds__(kThreads) solid_join_kernel(
        const uint32_t* __restrict__ keys, uint32_t C,
        const int64_t* __restrict__ cand, const uint8_t* __restrict__ is_fwd,
        int64_t n_queries, int32_t* __restrict__ outdeg,
        int32_t* __restrict__ succ_v, int32_t* __restrict__ succ_o,
        int64_t slot0) {
    const int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    const bool live = q < n_queries;
    bool hit = false;
    uint32_t lb = 0;
    if (live) {
        Key<W> x;
#pragma unroll
        for (int j = 0; j < W; ++j) x.w[j] = (uint32_t)cand[q * W + j];
        lb = lower_bound<W>(keys, C, x);
        hit = lb < C && same<W>(load_key<W>(keys, lb), x);
    }
    // lanes 4g .. 4g+3 are the bases 0..3 of one (node, o): q = 8 node +
    // 4 o + b, and a block starts at a multiple of 4
    const unsigned lane = threadIdx.x & 31u;
    const unsigned group = (__ballot_sync(kFull, hit) >> (lane & ~3u)) & 0xFu;
    if (!live) return;
    const int64_t slot = slot0 + (q >> 2);
    const unsigned b = lane & 3u;
    if (b == 0) outdeg[slot] = __popc(group);
    const unsigned last = group ? 31u - __clz(group) : 0u;
    if (b == last) {
        succ_v[slot] = hit ? (int32_t)lb : 0;
        succ_o[slot] = hit && !is_fwd[q] ? 1 : 0;
    }
}

template <int W>
cudaError_t launch(const uint32_t* keys, uint32_t C, const int64_t* cand,
                   const uint8_t* is_fwd, int64_t n_nodes, int32_t* outdeg,
                   int32_t* succ_v, int32_t* succ_o, int64_t row0,
                   cudaStream_t stream) {
    const int64_t n_queries = 8 * n_nodes;
    const int64_t blocks = (n_queries + kThreads - 1) / kThreads;
    solid_join_kernel<W><<<(unsigned)blocks, kThreads, 0, stream>>>(
        keys, C, cand, is_fwd, n_queries, outdeg, succ_v, succ_o, 2 * row0);
    return cudaGetLastError();
}

}  // namespace

// keys (C, W) uint32 sorted solid k-mers, 1 <= W <= 4, 1 <= C < 2^31;
// cand (n_nodes, 2, 4, W) int64 words and is_fwd (n_nodes, 2, 4) bool of
// the nodes row0 .. row0 + n_nodes - 1; outdeg, succ_v, succ_o (C, 2)
// int32, written at those rows only.
extern "C" int kmerax_solid_join(
    const uint32_t* keys, int64_t C, int W, const int64_t* cand,
    const uint8_t* is_fwd, int64_t n_nodes, int32_t* outdeg,
    int32_t* succ_v, int32_t* succ_o, int64_t row0, cudaStream_t stream) {
    if (C < 1 || C >= (int64_t(1) << 31) || n_nodes < 0 || row0 < 0
        || row0 + n_nodes > C)
        return (int)cudaErrorInvalidValue;
    if (n_nodes == 0) return (int)cudaGetLastError();
    const uint32_t c = (uint32_t)C;
    switch (W) {
        case 1: return (int)launch<1>(keys, c, cand, is_fwd, n_nodes, outdeg,
                                      succ_v, succ_o, row0, stream);
        case 2: return (int)launch<2>(keys, c, cand, is_fwd, n_nodes, outdeg,
                                      succ_v, succ_o, row0, stream);
        case 3: return (int)launch<3>(keys, c, cand, is_fwd, n_nodes, outdeg,
                                      succ_v, succ_o, row0, stream);
        case 4: return (int)launch<4>(keys, c, cand, is_fwd, n_nodes, outdeg,
                                      succ_v, succ_o, row0, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
