"""The harness with the timed path broken underneath (on the CPU, with
the look for a card skipped) must come out not correct, once for each
fault a cell can have. The cells run on one chip: no exchange between
chips exists to leave out."""

import pytest
import torch

import bm_tiny

ECOLI, CHR21 = "ecoli50x.count_correct", "chr21_30x.assemble_validate"


def _step_changed(monkeypatch, change):
    """The correct step of every cell (the fused one, `make_correct_step`)
    with `change` applied to what it returns."""
    from kmerax_torch.pipeline import correct as mod

    orig = mod.make_correct_step

    def make(*a, **kw):
        step = orig(*a, **kw)
        return lambda bases, lengths: change(bases, *step(bases, lengths))
    monkeypatch.setattr(mod, "make_correct_step", make)


def _unchanged(monkeypatch):
    """The correct step returns the reads as they came in."""
    _step_changed(monkeypatch, lambda bases, fixed, ne: (
        bases.to(fixed.dtype), torch.zeros_like(ne)))


def _half_batch(monkeypatch):
    """The count inserts only the first half of each batch."""
    from kmerax_torch.pipeline import count as mod

    orig = mod.bloom_insert

    def insert(table, bases, params, pending=None, off=0):
        b = bases.clone()
        b[b.shape[0] // 2:] = 4
        return orig(table, b, params, pending, off)
    monkeypatch.setattr(mod, "bloom_insert", insert)


def _altered_read(monkeypatch):
    """The correct step alters one base of each batch's first read."""
    def alter(bases, fixed, ne):
        fixed = fixed.clone()
        fixed[0, 0] = (fixed[0, 0] + 1) % 4
        return fixed, ne
    _step_changed(monkeypatch, alter)


def _altered_unitig(monkeypatch):
    """The assembly alters one base of its first unitig."""
    from kmerax_torch.graph import partitioned as mod

    orig = mod.emit_unitigs

    def emit(*a, **kw):
        seqs = orig(*a, **kw)
        s = seqs[0]
        seqs[0] = ("C" if s[5] != "C" else "G").join((s[:5], s[6:]))
        return seqs
    monkeypatch.setattr(mod, "emit_unitigs", emit)


CASES = [(ECOLI, _unchanged, "fastq_diff"),
         (ECOLI, _half_batch, "spectrum_diff"),
         (ECOLI, _altered_read, "fastq_diff"),
         (CHR21, _unchanged, "fastq_diff"),
         (CHR21, _half_batch, "spectrum_diff"),
         (CHR21, _altered_read, "fastq_diff"),
         (CHR21, _altered_unitig, "fasta_diff")]


@pytest.mark.parametrize("cell,fault,number", CASES,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f, _ in CASES])
def test_fault_comes_out_not_correct(monkeypatch, cell, fault, number):
    fault(monkeypatch)
    r = bm_tiny.run(cell)
    assert r["correct"] is False
    assert r["checks"][number]["value"] > 0
