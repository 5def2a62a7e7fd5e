"""The graph's membership join and successor select, kernel K5
`solid_join`: the CUDA wrapper (source: csrc/graph.cu) and its plain
PyTorch version.

K5 replaces no TPU kernel: the JAX package joins on the host in numpy
(kmerax/graph/partitioned.py::solid_edges_host). For each partition of
solid nodes it takes their 8 candidate extensions as `_extensions` leaves
them on the device, finds each one's lower bound among the C sorted solid
keys (words compared unsigned, most-significant word first, DESIGN.md §6),
and writes per (node, orientation) the out-degree and the successor of the
last hit in base order (DESIGN.md §9) into (C, 2) int32 edge arrays on the
device. The rules are those of the numpy join it replaces, the clamp
`min(lb, C - 1)` included (it only ever matters on a miss).

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise — there is no fallback.
"""

from __future__ import annotations

import torch

from kmerax_torch.core.codec import M32, words_less
from kmerax_torch.utils import cuda, tracing

MAX_WORDS = 4                       # k <= 63


def lower_bound_plain(keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(N,) int64 lower bounds of the (N, W) int64 word rows `q` among the
    sorted (C, W) int64 word rows `keys`: ceil(log2(C + 1)) rounds of one
    gather and a word-wise compare each."""
    C = keys.shape[0]
    lo = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    hi = torch.full_like(lo, C)
    for _ in range(C.bit_length()):
        mid = (lo + hi) >> 1
        active = lo < hi
        less = words_less(keys[mid.clamp(max=C - 1)], q)
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


def solid_join_plain(keys, cand, is_fwd, outdeg, succ_v, succ_o,
                     row0: int) -> None:
    """Plain version of K5 on any device: the lower bounds, the found test
    and the select of the nodes row0 .. row0 + n - 1, written into the
    edge arrays in place."""
    n, _, _, W = cand.shape
    words = keys.to(torch.int64) & M32
    q = cand.reshape(-1, W)
    idx = lower_bound_plain(words, q).clamp(max=keys.shape[0] - 1)
    found = torch.all(words[idx] == q, dim=1).reshape(n, 2, 4)
    idx = idx.to(torch.int32).reshape(n, 2, 4)
    v = torch.zeros((n, 2), dtype=torch.int32, device=cand.device)
    o = torch.zeros_like(v)
    for b in range(4):              # a later hit overwrites
        hit = found[:, :, b]
        v = torch.where(hit, idx[:, :, b], v)
        o = torch.where(hit, (~is_fwd[:, :, b]).to(torch.int32), o)
    outdeg[row0:row0 + n] = found.sum(dim=2, dtype=torch.int32)
    succ_v[row0:row0 + n] = v
    succ_o[row0:row0 + n] = o


def _check(keys, cand, is_fwd, outdeg, succ_v, succ_o, row0: int) -> None:
    dev = keys.device
    if keys.dim() != 2 or not 1 <= keys.shape[1] <= MAX_WORDS:
        raise ValueError(f"keys: shape {tuple(keys.shape)}, expected (C, W) "
                         f"with 1 <= W <= {MAX_WORDS}")
    C, W = keys.shape
    if not 1 <= C < 1 << 31:
        raise ValueError(f"keys: {C} rows, expected 1 <= C < 2^31")
    cuda.require(keys, "keys", torch.int32, dev)
    if cand.dim() != 4:
        raise ValueError(f"cand: shape {tuple(cand.shape)}, expected "
                         f"(n, 2, 4, {W})")
    n = cand.shape[0]
    cuda.require(cand, "cand", torch.int64, dev, (n, 2, 4, W))
    cuda.require(is_fwd, "is_fwd", torch.bool, dev, (n, 2, 4))
    for name, t in (("outdeg", outdeg), ("succ_v", succ_v),
                    ("succ_o", succ_o)):
        cuda.require(t, name, torch.int32, dev, (C, 2))
    if not 0 <= row0 <= C - n:
        raise ValueError(f"rows {row0} .. {row0 + n} outside the {C} keys")


def solid_join(keys: torch.Tensor, cand: torch.Tensor, is_fwd: torch.Tensor,
               outdeg: torch.Tensor, succ_v: torch.Tensor,
               succ_o: torch.Tensor, row0: int) -> None:
    """K5: joins the candidates of nodes row0 .. row0 + n - 1 ((n, 2, 4, W)
    int64 words, (n, 2, 4) bool) against the (C, W) int32 solid keys and
    writes their rows of the (C, 2) int32 edge arrays."""
    if keys.device.type != "cpu":
        return solid_join_cuda(keys, cand, is_fwd, outdeg, succ_v, succ_o,
                               row0)
    _check(keys, cand, is_fwd, outdeg, succ_v, succ_o, row0)
    solid_join_plain(keys, cand, is_fwd, outdeg, succ_v, succ_o, row0)


def solid_join_cuda(keys, cand, is_fwd, outdeg, succ_v, succ_o,
                    row0: int) -> None:
    """The CUDA entry of K5: one launch on the current stream; adds
    8 n to the stage's counter `assemble.join_on_card`."""
    if keys.device.type != "cuda":
        raise ValueError(f"keys: on {keys.device}, expected a CUDA device")
    _check(keys, cand, is_fwd, outdeg, succ_v, succ_o, row0)
    C, W = keys.shape
    if keys.data_ptr() % (4 * W if W in (2, 4) else 4):
        raise ValueError("keys: rows not aligned for their vector loads")
    n = cand.shape[0]
    rc = cuda.lib().kmerax_solid_join(
        keys.data_ptr(), C, W, cand.data_ptr(), is_fwd.data_ptr(), n,
        outdeg.data_ptr(), succ_v.data_ptr(), succ_o.data_ptr(), row0,
        cuda.stream())
    cuda.LAUNCHES["solid_join"] += 1
    cuda.check(rc, "solid_join")
    tracing.count("assemble.join_on_card", 8 * n)
