"""A numpy emulation of kernel K4's lane layout (csrc/align.cu): G lanes
per read, each holding P consecutive band diagonals; the in-lane serial
prefix max and the exchange of lane totals (three width-G shuffles at
once for G = 4, a log2(G)-step segmented shuffle scan above); `up` from the
next lane by a width-G shuffle; the target staged once with band+1 codes
of left padding and read through a register window that shifts by one
base a row; the row bounds hoisted into per-lane slots plo and phi, and
the three row kinds (the top band rows, the middle rows that cap only the
padding per warp, the bottom rows masked at p <= phi). Held against the port's
plain version and the JAX package's banded_align_scores at every G and at
bands 0 to 63, with qlen = 0, tlen = 0 and |tlen - qlen| > band rows. Three
mutations of the emulation (scan width, window shift, a row bound off by
one) must each change a score, so the inputs reach what they break. The
card is the only place the kernel runs: this checks its arithmetic before a
chip call. Exact: tolerance 0."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from kmerax.ops.align import banded_align_scores as j_banded
from kmerax_torch.ops.align_kernels import GAP, LANE_CHOICES, MATCH, \
    MISMATCH, NEG_INF, banded_align_scores_plain

from parity import n, t

BANDS = (0, 1, 3, 15, 31, 63)


def shfl_up(x, s, width):
    """__shfl_up_sync(x, s, width) across the G lanes (last axis) of each
    read: lanes whose source falls before their width-segment keep x."""
    G = x.shape[-1]
    g = np.arange(G)
    src = np.where(g % width >= s, g - s, g)
    return x[..., src]


def shfl_down(x, s, width):
    G = x.shape[-1]
    g = np.arange(G)
    src = np.where(g % width + s < width, g + s, g)
    return x[..., src]


def k4_lanes(query, target, qlen, tlen, band, G, mutate=None):
    """K4's scores (B,) int64 through its lane layout, for reads of int32
    codes 0..4, in warps of 32/G consecutive reads, each row held as
    X[d] = S[d] + 4d + 8i as the kernel holds it, cells outside the band
    at NEG_INF. `mutate` breaks one
    piece: "scan_width" (the lane exchange in segments of G/2),
    "window_shift" (the new target base one too far right), "row_bound"
    (the first valid slot plo one lower)."""
    B, nq = query.shape
    m = target.shape[1]
    W = 2 * band + 1
    need = -(-W // G)
    P = 1 << (need - 1).bit_length()
    GP = G * P
    assert GP > W
    # staging: query codes (4 = none), target padded by band+1 codes on
    # the left and past min(tlen, m) (5 = none)
    q = np.where((query >= 0) & (query < 4), query, 4).astype(np.int64)
    S = nq + GP + 2
    y = np.arange(S) - band - 1
    tn = np.clip(tlen, 0, m)
    tb = target[:, np.clip(y, 0, m - 1)]
    tp = np.where((y[None, :] >= 0) & (y[None, :] < tn[:, None])
                  & (tb >= 0) & (tb < 4), tb, 5).astype(np.int64)
    ql, tl = qlen.astype(np.int64), tlen.astype(np.int64)
    hv = np.where((np.abs(tl - ql) <= band) & (ql <= nq), ql, -1)
    out = np.full(B, NEG_INF, np.int64)
    # per warp: its last row, and the last row of the kind whose only mask
    # is the padding cap
    warp = np.arange(B) // (32 // G)
    rows_w = np.zeros(warp[-1] + 1, np.int64)
    np.maximum.at(rows_w, warp, np.maximum(hv, 0))
    mid_w = np.full_like(rows_w, np.iinfo(np.int64).max)
    np.minimum.at(mid_w, warp, np.where((hv >= 0) & (hv > tl - band),
                                        tl - band, rows_w[warp]))
    mid_end = mid_w[warp]

    p = np.arange(P)[None, None, :]                      # (1, 1, P)
    g = np.arange(G)
    d0 = (g * P)[None, :, None]                          # (1, G, 1)
    d = d0 + p                                           # (1, G, P)
    j0 = d - band
    # row 0: S = GAP*j on [0, tlen], X = 4*band
    X = np.where((d < W) & (j0 >= 0) & (j0 <= tl[:, None, None]),
                 4 * band, NEG_INF).astype(np.int64)     # (B, G, P)
    cap = np.where(d < W, np.iinfo(np.int32).max, NEG_INF)
    dfin = tl - ql + band
    gf, pf = dfin // P, dfin % P
    rows_b = np.arange(B)

    def harvest(i):
        at = hv == i
        out[at] = X[rows_b[at], gf[at], pf[at]] - 4 * dfin[at] - 8 * i

    harvest(0)
    tw = tp[:, 1 + d[0]]                                 # (B, G, P), row 1
    c1 = band + 1 - d0[..., 0] - (1 if mutate == "row_bound" else 0)
    c2 = tl[:, None] + band - d0[..., 0]                 # (B, G)
    pw = W - 1 - d0[..., 0]
    width = G // 2 if mutate == "scan_width" else G
    ahead = 1 if mutate == "window_shift" else 0
    for i in range(1, int(rows_w.max()) + 1):
        top = i <= band
        qi = q[:, i - 1][:, None, None]
        plo = (c1 - i)[..., None]                        # (1, G, 1)
        phi = np.minimum(c2 - i, pw)[..., None]          # (B, G, 1)
        nxt = shfl_down(X[..., 0], 1, G)
        up = np.concatenate([X[..., 1:], nxt[..., None]], axis=-1)
        sub = np.where(tw == qi, MATCH, MISMATCH) - 2 * GAP
        f = np.maximum(X + sub, up)
        if top:
            f = np.where(p >= plo, f,
                         np.where(p == plo - 1, 4 * band, NEG_INF))
        f = np.maximum.accumulate(f, axis=-1)
        tot = f[..., -1]                                 # (B, G)
        if G == 4:             # the three lane totals at once
            below = np.full_like(tot, NEG_INF)
            for s in range(1, G):
                below = np.where(g >= s, np.maximum(
                    below, shfl_up(tot, s, width)), below)
        else:                  # log2(G) steps and one shuffle
            s = 1
            while s < G:
                tot = np.maximum(tot, shfl_up(tot, s, width))
                s *= 2
            below = np.where(g >= 1, shfl_up(tot, 1, G), NEG_INF)
        v = np.maximum(f, below[..., None])
        if top:
            X = np.where((p >= plo - 1) & (p <= phi), v, NEG_INF)
        else:
            mid = (i <= mid_end)[:, None, None]
            X = np.where(mid, np.minimum(v, cap),
                         np.where(p <= phi, v, NEG_INF))
        harvest(i)
        tnew = tp[:, np.minimum(i + d0[0, :, 0] + P + ahead, S - 1)]
        tw = np.concatenate([tw[..., 1:], tnew[..., None]], axis=-1)
    return out


@functools.lru_cache(maxsize=None)
def case(band):
    """Reads of a shared sequence with gaps (copies shifted by up to 8, so
    gap runs cross lanes), 5 % substitutions and Ns, lengths near each
    other, and the edge rows: qlen = 0, tlen = 0, both full, and
    |tlen - qlen| > band."""
    L = max(24, 2 * band + 24)
    B = 48
    rng = np.random.default_rng(700 + band)
    src = rng.integers(0, 4, (B, L + 16))
    sh = rng.integers(-min(band, 8), min(band, 8) + 1, B)
    q = src[:, 8:8 + L]
    tg = src[np.arange(B)[:, None], 8 + sh[:, None] + np.arange(L)]
    tg = np.where(rng.random((B, L)) < 0.05, (tg + 1) % 4, tg)
    q = np.where(rng.random((B, L)) < 0.01, 4, q)
    qlen = rng.integers(L // 2, L + 1, B)
    tlen = np.clip(qlen + rng.integers(-band, band + 1, B), 0, L)
    qlen[0], tlen[1] = 0, 0
    qlen[2] = tlen[2] = L
    qlen[3], tlen[3] = L, max(0, L - band - 1)
    qlen[4], tlen[4] = min(band, L), 0
    ar = np.arange(L)[None, :]
    q = np.where(ar < qlen[:, None], q, 4).astype(np.int32)
    tg = np.where(ar < tlen[:, None], tg, 4).astype(np.int32)
    args = (q, tg, qlen.astype(np.int32), tlen.astype(np.int32))
    want = np.asarray(j_banded(*map(jnp.asarray, args), band))
    return args, want


@pytest.mark.parametrize("G", LANE_CHOICES)
@pytest.mark.parametrize("band", BANDS)
def test_k4_lane_layout_matches_plain_and_jax(band, G):
    args, want = case(band)
    plain = n(banded_align_scores_plain(*map(t, args), band))
    np.testing.assert_array_equal(plain, want)
    got = k4_lanes(*args, band, G)
    np.testing.assert_array_equal(got, want)
    assert got[0] == want[0] and got[3] == NEG_INF
    assert (got > 0).sum() > len(got) // 2


@pytest.mark.parametrize("mutate", ["scan_width", "window_shift",
                                    "row_bound"])
def test_k4_lane_mutations_are_caught(mutate):
    """Each broken emulation gives a wrong score on these inputs."""
    caught = []
    for band in (3, 15, 31):
        args, want = case(band)
        for G in (4, 8):
            caught.append(int((k4_lanes(*args, band, G, mutate)
                               != want).sum()))
    assert any(caught), caught
