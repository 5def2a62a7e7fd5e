"""A numpy emulation of K1's p16 add (csrc/kmerax.cuh: CounterP16::add,
called by bloom_insert_kernel once a window step) under many seeded random
interleavings of several warps on a small table, held to min(initial +
adds, SAT16) and to the JAX package's p16 `insert` of the same k-mers on
the CPU.

One warp a read; in window step j0 lane l holds window j0 + l and its d
probe slots. A call (1) reads the word of every live slot, (2) groups the
lanes whose k-mer has the same block and probe lanes (__match_any_sync)
and lets the first lane of a group lead it with c = the group's size a
probe, a repeated probe lane folded into the first of its probes, then
(3) has every leader CAS each half from the word it read up to
min(h + c, SAT16), all of a lane's CASes
issued before it looks at any result, the failed ones again from the words
they returned, until none is left; a half at SAT16 takes no CAS. Every
read and every CAS is one atomic event at a random point of one global
order over all warps, so reads go stale and CASes fail. 2^9 counters (4
block rows in 2 word rows) make a step meet both halves of one word and
k-mers with a repeated lane; a poly-A read makes a group of 32; start
values near SAT16 make counters saturate mid-call. Two mutations of the
protocol (no retry; a repeated probe lane counted once) must give a
wrong table. Exact: tolerance 0."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kmerax.core import canonical_words as j_canonical
from kmerax.core import extract_kmers as j_extract
from kmerax.spectrum import bloom as jbloom
from kmerax_torch.core.codec import canonical_words
from kmerax_torch.core.kmers import extract_kmers
from kmerax_torch.spectrum import bloom
from kmerax_torch.spectrum.bloom_kernels import blocks_lanepack

from parity import n, reads_with_ns, t

SAT16 = bloom.SAT16
FULL = -1                         # an off slot's key (all ones)
K, D, LW = 31, 4, 9               # 2^9 counters: 2^8 p16 words
INTERLEAVINGS = 6

_j_insert = jax.jit(jbloom.insert, static_argnums=0)


def batch(seed):
    """(B, L) reads: random reads with Ns from a shared genome, a poly-A
    read and a read of one repeated 7-base unit."""
    reads, _ = reads_with_ns(seed, 6, 90, K)
    low = np.tile(np.array([0, 1, 1, 3, 2, 0, 3], np.int32), 13)[:90]
    return np.concatenate([reads, np.zeros((1, 90), np.int32), low[None]])


def initial_counters(start, rng):
    """The table's counters before the batch (all in [0, SAT16])."""
    c = np.zeros(1 << LW, np.int64)
    if start in ("near_sat", "mixed"):
        near = rng.integers(SAT16 - 60, SAT16 + 1, 1 << LW)
        c = near if start == "near_sat" else np.where(
            rng.random(1 << LW) < 0.5, near, rng.integers(0, 100, 1 << LW))
    return c


def pack(counters):
    """pack16 as python ints: word r*128 + l = block 2r's | block 2r+1's
    << 16."""
    c = counters.reshape(-1, 2, 128)
    return [int(x) for x in (c[:, 0] | (c[:, 1] << 16)).reshape(-1)]


def warp_steps(block, lanepack, lanes, valid):
    """Per warp (read), its calls: (ids (32,): block << 32 | lanepack of
    lane l's k-mer, key (32, D): word << 1 | half of its probe i), FULL
    where off."""
    B, nk = valid.shape
    out = []
    for r in range(B):
        steps = []
        for j0 in range(0, nk, 32):
            ids = np.full(32, FULL, np.int64)
            key = np.full((32, D), FULL, np.int64)
            for lane in range(min(32, nk - j0)):
                j = j0 + lane
                if valid[r, j]:
                    b = int(block[r, j])
                    ids[lane] = (b << 32) | int(lanepack[r, j])
                    for i in range(D):
                        word = (b >> 1) * 128 + int(lanes[r, j, i])
                        key[lane, i] = (word << 1) | (b & 1)
            steps.append((ids, key))
        out.append(steps)
    return out


def group(ids, key, mutation):
    """The warp's leaders: [(lane, probe, key, c)]: the lanes whose k-mer
    has one id form a group led by its first lane, c = the group's size a
    probe, a repeated probe lane folded into the first of its probes."""
    leads = []
    for v in np.unique(ids[ids != FULL]):
        peers = np.nonzero(ids == v)[0]
        lane, n = int(peers[0]), len(peers)
        c = {}
        for i in range(D):
            first = next((p for p in c if key[lane, p] == key[lane, i]),
                         None)
            if first is None:
                c[i] = n
            elif mutation != "count_once":
                c[first] += n
        leads += [(lane, i, int(key[lane, i]), ci) for i, ci in c.items()]
    return leads


class Warp:
    """One warp's calls as events on the shared words: its reads, then its
    leaders' CAS rounds, lane by lane."""

    def __init__(self, steps, mutation):
        self.steps, self.mutation, self.step = steps, mutation, -1
        self.events = []
        self.next_step()

    def next_step(self):
        self.step += 1
        if self.step == len(self.steps):
            return
        key = self.steps[self.step][1]
        self.loaded = {}
        self.n_loads = int((key != FULL).sum())
        self.events = [("read", lane, q, int(key[lane, q]))
                       for lane, q in zip(*np.nonzero(key != FULL))]
        if self.n_loads == 0:
            self.events = []
            self.next_step()

    def after_reads(self):
        self.todo = {}                 # lane -> {slot: [key, c, old]}
        for lane, q, v, c in group(*self.steps[self.step], self.mutation):
            self.todo.setdefault(lane, {})[q] = [v, c,
                                                 self.loaded[(lane, q)]]
        self.round = {}
        for lane in list(self.todo):
            self.issue(lane)
        if not self.todo:
            self.next_step()

    def issue(self, lane):
        """Every pending CAS of the lane, from the words it last saw."""
        sent = []
        for q, (v, c, old) in self.todo[lane].items():
            sh = 16 * (v & 1)
            h = (old >> sh) & 0xFFFF
            if h >= SAT16:
                continue
            nh = min(h + c, SAT16)
            sent.append(q)
            self.events.append(("cas", lane, q, v, old,
                                old + ((nh - h) << sh)))
        self.round[lane] = {q: None for q in sent}
        if not sent:
            del self.todo[lane]

    def run(self, ev, words):
        """Apply event ev to the words atomically."""
        self.events.remove(ev)
        if ev[0] == "read":
            _, lane, q, v = ev
            self.loaded[(lane, q)] = words[v >> 1]
            if len(self.loaded) == self.n_loads:
                self.after_reads()
            return
        _, lane, q, v, old, new = ev
        prev = words[v >> 1]
        if prev == old:
            words[v >> 1] = new
        self.round[lane][q] = prev
        if any(p is None for p in self.round[lane].values()):
            return
        # the lane's round has landed: keep the failed CASes
        nxt = {}
        for q, prev in self.round[lane].items():
            vq, c, seen = self.todo[lane][q]
            if prev != seen and self.mutation != "no_retry":
                nxt[q] = [vq, c, prev]
        if nxt:
            self.todo[lane] = nxt
            self.issue(lane)
        else:
            del self.todo[lane]
        if not self.todo:
            self.next_step()


def emulate(steps, words, rng, mutation=None):
    """All warps' events in one random global order; returns the words."""
    words = list(words)
    warps = [Warp(s, mutation) for s in steps]
    while True:
        live = [w for w in warps if w.events]
        if not live:
            break
        w = live[rng.integers(len(live))]
        w.run(w.events[rng.integers(len(w.events))], words)
    assert all(w.step == len(w.steps) for w in warps)
    return words


def addressed(reads):
    """The port's K1 addressing of the batch at 2^LW p16 counters: block
    (B, nk), lanepack (B, nk), lanes (B, nk, D), valid (B, nk)."""
    p = bloom.BloomParams(K, LW, D, 11, 1, counter="p16")
    words, valid = extract_kmers(t(reads), K)
    block, lp = blocks_lanepack(p, canonical_words(words, K)[0])
    lanes = np.stack([(n(lp) >> (7 * i)) & 127 for i in range(D)], -1)
    return n(block), n(lp), lanes, n(valid)


def expected(counters, block, lanes, valid):
    """min(initial + adds, SAT16) of every counter."""
    flat = (block.astype(np.int64)[..., None] * 128 + lanes)[valid]
    adds = np.zeros_like(counters)
    np.add.at(adds, flat.reshape(-1), 1)
    return np.minimum(counters + adds, SAT16)


def j_reference(reads, counters):
    """The JAX package's p16 insert of the batch into the packed
    counters."""
    jw, jv = j_extract(jnp.asarray(reads), K)
    jc = j_canonical(jw, K)[0]
    jp = jbloom.BloomParams(K, LW, D, 11, 1, counter="p16")
    table = jnp.asarray(np.array(pack(counters), np.int64).astype(np.int32))
    return np.asarray(_j_insert(jp, table, jc, jv)).astype(np.int64) \
        & 0xFFFFFFFF


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("start", ["zero", "near_sat", "mixed"])
def test_p16_cas_protocol_matches_jax(start, seed):
    """Under every interleaving the words equal min(initial + adds, SAT16)
    and the JAX package's p16 insert of the same k-mers; the batch meets
    both halves of a word in one call, repeated lanes and groups of 32."""
    rng = np.random.default_rng(1000 + seed)
    reads = batch(seed)
    block, lp, lanes, valid = addressed(reads)
    counters = initial_counters(start, rng)
    want = pack(expected(counters, block, lanes, valid))
    np.testing.assert_array_equal(np.array(want),
                                  j_reference(reads, counters))
    steps = warp_steps(block, lp, lanes, valid)
    for _ in range(INTERLEAVINGS):
        got = emulate(steps, pack(counters), rng)
        np.testing.assert_array_equal(np.array(got), np.array(want))
    # the collisions the protocol must survive are in the batch
    calls = [call for w in steps for call in w]
    both = sum(len(set((x >> 1) for x in np.unique(key[key != FULL])))
               < len(np.unique(key[key != FULL])) for _, key in calls)
    assert both > 0                                  # halves of one word
    rep = (lanes[..., :, None] == lanes[..., None, :]).sum((-1, -2)) > D
    assert (rep & valid).any()                       # repeated lanes
    assert max(c for call in calls for *_, c in group(*call, None)) >= 32
    if start != "zero":
        assert (np.array(want) != np.array(pack(counters))).any()


@pytest.mark.parametrize("mutation", ["no_retry", "count_once"])
@pytest.mark.parametrize("seed", [2, 3])
def test_p16_cas_mutations_fail(seed, mutation):
    """The emulation sees a broken protocol: dropping the failed CASes, or
    counting a repeated probe lane once, leaves a table other than
    min(initial + adds, SAT16)."""
    rng = np.random.default_rng(7 + seed)
    reads = batch(seed)
    block, lp, lanes, valid = addressed(reads)
    counters = initial_counters("zero", rng)
    want = pack(expected(counters, block, lanes, valid))
    steps = warp_steps(block, lp, lanes, valid)
    wrong = [emulate(steps, pack(counters), rng, mutation) != want
             for _ in range(INTERLEAVINGS)]
    assert any(wrong)
    assert emulate(steps, pack(counters), rng) == want


def test_pack_matches_port():
    """The emulation's packing is the port's pack16."""
    c = np.random.default_rng(3).integers(0, SAT16 + 1, 1 << LW)
    np.testing.assert_array_equal(
        np.array(pack(c)),
        n(bloom.pack16(torch.as_tensor(c))).astype(np.int64) & 0xFFFFFFFF)
