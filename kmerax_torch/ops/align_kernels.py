"""Banded alignment kernel K4: the CUDA wrapper (source: csrc/align.cu) and
its plain PyTorch version.

K4 replaces kmerax/ops/pallas_align.py::_align_kernel; the plain version is
the port of the JAX package's XLA path, kmerax/ops/align.py::
banded_align_scores. Scoring (DESIGN.md §10): match +2, mismatch -3 (a base
>= 4 never matches), linear gap -4.

The band is held in diagonal coordinates, one DP row per step, with the
within-row gap dependency solved by the max-plus prefix-scan identity
(linear gap g = -4):

    S[i][j] = max_{j'<=j} ( M[i][j'] - 4*(j-j') )
            = cummax_j ( M[i][j] + 4*j ) - 4*j

Dispatch: CPU tensors take the plain version; CUDA tensors launch the kernel
or raise — there is no fallback.
"""

from __future__ import annotations

import torch

from kmerax_torch.utils import cuda

MATCH, MISMATCH, GAP = 2, -3, -4
NEG_INF = -(1 << 30)
MAX_BAND = 63                       # 2*band+1 <= 127


def banded_align_scores_plain(query, target, qlen, tlen, band: int):
    """Batched banded global alignment scores on any device.

    query (B, n) and target (B, m) int32 base codes (>= 4 never matches),
    qlen / tlen (B,) int32 true lengths (qlen <= n, tlen <= m), band the
    half-width: cells with |i-j| > band are unreachable. Returns (B,) int32
    S[qlen][tlen], NEG_INF when no in-band path reaches it.

    One Python step per DP row; the final cell is harvested at row qlen as
    the rows go, so the (B, n+1, W) rows tensor never exists.
    """
    B, n = query.shape
    m = target.shape[1]
    W = 2 * band + 1
    assert W <= 128, "band must fit 2*band+1 <= 128"
    dev = query.device
    d = torch.arange(W, dtype=torch.int32, device=dev)[None, :]  # j - i + band
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    ninf, match, mismatch = i32(NEG_INF), i32(MATCH), i32(MISMATCH)
    qlen = qlen.to(torch.int32)
    tl = tlen.to(torch.int32)[:, None]
    dfin = torch.clamp(tlen - qlen + band, 0, W - 1).to(torch.int64)[:, None]

    # row 0: S[0][j] = GAP*j for 0 <= j <= min(band, tlen), else -inf
    j0 = d - band
    row = torch.where((j0 >= 0) & (j0 <= tl), GAP * j0, ninf)
    score = torch.where(qlen == 0, row.gather(1, dfin)[:, 0], ninf)

    # tpad[:, i + d] == target[:, j-1] for j = i + d - band
    rpad = max(0, n + 2 * band + 1 - (band + 1 + m))
    tpad = torch.cat([torch.full((B, band + 1), 4, dtype=torch.int32,
                                 device=dev), target.to(torch.int32),
                      torch.full((B, rpad), 4, dtype=torch.int32,
                                 device=dev)], dim=1)
    query = query.to(torch.int32)
    fill = torch.full((B, 1), NEG_INF, dtype=torch.int32, device=dev)
    for i in range(1, n + 1):
        qi = query[:, i - 1:i]
        sub = torch.where((tpad[:, i:i + W] == qi) & (qi < 4), match,
                          mismatch)
        diag = row + sub                               # S[i-1][j-1]
        up = torch.cat([row[:, 1:], fill], dim=1) + GAP  # S[i-1][j]
        j = i + d - band
        valid = (j >= 1) & (j <= tl)
        Mv = torch.where(valid, torch.maximum(diag, up), ninf)
        edge = (j == 0) & (i <= band)
        col0 = torch.where(edge, GAP * i, ninf)
        f = torch.maximum(Mv, col0) - GAP * d
        row = torch.cummax(f, dim=1).values + GAP * d
        row = torch.where(valid | edge, row, ninf)
        score = torch.where(qlen == i, row.gather(1, dfin)[:, 0], score)
    return torch.where(torch.abs(tlen - qlen) <= band, score, ninf)


# K4's lanes per read (G): 4 was the fastest at band 15 and at band 63 in
# chip_smoke.py's timing of every choice (PERF.md §6)
LANE_CHOICES = (4, 8, 16, 32)
LANES = 4

_WARPS = 1                          # per K4 block (csrc/align.cu)
_SMEM_LIMIT = 48 * 1024


def _stage_bytes(n: int, band: int, lanes: int) -> int:
    """Shared memory of one K4 block (csrc/align.cu stage_bytes): per read
    n query codes and n + G*P + 2 target codes, in an odd number of words."""
    need = -(-(2 * band + 1) // lanes)
    P = 1 << (need - 1).bit_length()
    words = (2 * n + lanes * P + 2 + 3) // 4
    return _WARPS * 32 // lanes * 4 * (words | 1)


def banded_align_scores(query: torch.Tensor, target: torch.Tensor,
                        qlen: torch.Tensor, tlen: torch.Tensor,
                        band: int) -> torch.Tensor:
    """K4: (B,) int32 banded global alignment scores S[qlen][tlen] of int32
    query (B, n) against target (B, m), NEG_INF where |tlen - qlen| > band
    or no in-band path exists. Base codes are 0..4."""
    return banded_align_scores_lanes(query, target, qlen, tlen, band, LANES)


def banded_align_scores_lanes(query: torch.Tensor, target: torch.Tensor,
                              qlen: torch.Tensor, tlen: torch.Tensor,
                              band: int, lanes: int) -> torch.Tensor:
    """`banded_align_scores` with K4's lanes per read given (one of
    LANE_CHOICES), for timing every layout."""
    dev = query.device
    B, n = query.shape
    cuda.require(query, "query", torch.int32, dev, (B, n))
    cuda.require(target, "target", torch.int32, dev)
    if target.dim() != 2 or target.shape[0] != B:
        raise ValueError(f"target: shape {tuple(target.shape)}, expected "
                         f"({B}, m)")
    cuda.require(qlen, "qlen", torch.int32, dev, (B,))
    cuda.require(tlen, "tlen", torch.int32, dev, (B,))
    if not 0 <= band <= MAX_BAND:
        raise ValueError(f"band must be in [0, {MAX_BAND}], got {band}")
    if lanes not in LANE_CHOICES:
        raise ValueError(f"lanes must be one of {LANE_CHOICES}, got {lanes}")
    if n < 1 or _stage_bytes(n, band, lanes) > _SMEM_LIMIT:
        raise ValueError(f"query width {n} outside what K4 stages")
    if dev.type == "cpu":
        return banded_align_scores_plain(query, target, qlen, tlen, band)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    rc = cuda.lib().kmerax_banded_align_scores(
        query.data_ptr(), n, target.data_ptr(), target.shape[1],
        qlen.data_ptr(), tlen.data_ptr(), B, band, lanes, out.data_ptr(),
        cuda.stream())
    cuda.LAUNCHES["banded_align_scores"] += 1
    cuda.check(rc, "banded_align_scores")
    return out
