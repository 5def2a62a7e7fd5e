"""Repeat-structured genomes for the assembly's branch rules (DESIGN.md §9),
made from a seed with numpy, and the reads of them.

A sample is a linear chromosome and a separate circular molecule. The
chromosome is random sequence with, in this order:

  - a 300 bp segment R, present three times far apart;
  - a 40 bp unit in 6 tandem copies;
  - an inverted repeat: a 200 bp segment and its reverse complement 500 bp
    apart;
  - a palindrome h + revcomp(h) of 2 x 40 bp, whose central (k-1)-mer is
    its own reverse complement for every odd k <= 81 (the hairpin: the
    k-mer before that (k-1)-mer has one out-edge, to its own reverse
    complement);
  - a homopolymer run of 40 A at the chromosome's end, so that the k-mer
    A^k has one out-edge, to itself (the self-edge guard).

The circular molecule is 500 bp of random sequence; its reads wrap round
its origin, so its k-mers close a cycle (the cycle-break rule).

`branch_rules` counts, on the oracle's graph (`oracle.assemble._DBG`),
the oriented nodes at each of those rules, so a test can show that the
fixture reaches them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sim import make_fastq, random_genome, revcomp_bases, simulate_reads

REPEAT_LEN = 300
UNIT_LEN, UNIT_COPIES = 40, 6
INVERTED_LEN, INVERTED_GAP = 200, 500
PALINDROME_ARM = 40
HOMOPOLYMER = 40
CIRCLE_LEN = 500
SPACER = 400


@dataclass
class Sample:
    chromosome: np.ndarray      # uint8 codes 0-3
    circle: np.ndarray
    features: dict              # name -> start(s) in the chromosome


def repeat_sample(seed: int) -> Sample:
    """The chromosome and the circular molecule of `seed` (module
    docstring); `features` gives where each engineered part starts."""
    rng = np.random.default_rng(seed)
    parts, features = [], {}
    at = 0

    def put(name, seq):
        nonlocal at
        if name:
            features.setdefault(name, []).append(at)
        parts.append(seq)
        at += len(seq)

    def spacer(n=SPACER):
        put(None, random_genome(rng, n))

    rep = random_genome(rng, REPEAT_LEN)
    unit = random_genome(rng, UNIT_LEN)
    arm = random_genome(rng, INVERTED_LEN)
    half = random_genome(rng, PALINDROME_ARM)
    spacer(300)
    put("repeat", rep)
    spacer(600)
    put("tandem", np.tile(unit, UNIT_COPIES))
    spacer()
    put("inverted", arm)
    spacer(INVERTED_GAP)
    put("inverted", revcomp_bases(arm))
    spacer()
    put("repeat", rep)
    spacer()
    put("palindrome", np.concatenate([half, revcomp_bases(half)]))
    spacer()
    put("repeat", rep)
    spacer(300)
    put("homopolymer", np.zeros(HOMOPOLYMER, np.uint8))
    return Sample(np.concatenate(parts), random_genome(rng, CIRCLE_LEN),
                  features)


def sample_reads(sample: Sample, coverage: int, read_len: int,
                 error_rate: float, seed: int) -> list:
    """Reads of both molecules at `coverage` (the circle's wrap round its
    origin), the chromosome's first; tests/sim.py's reads."""
    reads = []
    for i, (mol, circular) in enumerate(((sample.chromosome, False),
                                         (sample.circle, True))):
        n = len(mol) * coverage // read_len
        reads += simulate_reads(mol, n, read_len, error_rate, seed=seed + i,
                                circular=circular,
                                name_prefix=("CHR", "CIR")[i])
    return reads


def sample_fastq(sample: Sample, coverage: int, read_len: int,
                 error_rate: float, seed: int) -> tuple[bytes, list]:
    reads = sample_reads(sample, coverage, read_len, error_rate, seed)
    return make_fastq(reads), reads


def branch_rules(g) -> dict:
    """On the oracle's graph `g` (oracle.assemble._DBG), the oriented nodes
    (u, o) at each rule of DESIGN.md §9:

      branch        outdeg(u, o) >= 2;
      self_edge     one out-edge, to (u, o) itself: the guard v != u
                    stops it;
      hairpin       one out-edge, to (u, 1 - o), and outdeg(u, o) == 1 on
                    its far side, so only the guard v != u stops it;
      cycle_emitted, cycle_skipped
                    the succ-cycles whose minimal oriented node is (., +)
                    (emitted) or (., -) (its flipped twin, not emitted);
                    their member counts.
    """
    from oracle.assemble import _successors

    n = len(g.nodes)
    out = {"branch": 0, "self_edge": 0, "hairpin": 0}
    for u in range(n):
        for o in (0, 1):
            edges = g.out_edges(u, o)
            if len(edges) >= 2:
                out["branch"] += 1
            elif len(edges) == 1 and edges[0][0] == u:
                out["self_edge" if edges[0][1] == o else "hairpin"] += 1
    succ = _successors(g)
    has_pred = set(succ.values())
    seen = set()
    for u in range(n):
        for o in (0, 1):
            cur = (u, o)
            if cur in has_pred:
                continue
            while cur not in seen:
                seen.add(cur)
                if cur not in succ:
                    break
                cur = succ[cur]
    cycles = []
    for u in range(n):
        for o in (0, 1):
            if (u, o) in seen:
                continue
            cyc, cur = [], (u, o)
            while cur not in seen:
                seen.add(cur)
                cyc.append(cur)
                cur = succ[cur]
            cycles.append(cyc)
    out["cycle_emitted"] = [len(c) for c in cycles if min(c)[1] == 0]
    out["cycle_skipped"] = [len(c) for c in cycles if min(c)[1] == 1]
    return out
