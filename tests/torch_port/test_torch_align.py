"""Align-validate: kmerax_torch's banded aligner (K4's plain version and
wrapper), contig index, cuckoo seed hash, validate_batch, run_align and the
CLIs on the CPU against the JAX package, with the oracle as a second
witness. Every output is an integer or bytes: tolerance 0."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmerax.cli import main as j_main
from kmerax.config import KmeraxConfig as JConfig
from kmerax.ops.align import banded_align_scores as j_banded
from kmerax.ops.align import build_contig_index as j_build_index
from kmerax.ops.align import validate_batch as j_validate
from kmerax.ops.align import validate_batch_phased as j_validate_phased
from kmerax.ops.pallas_align import banded_align_scores_pallas
from kmerax.ops.seed_hash import build_seed_hash as j_build_seed_hash
from kmerax.pipeline import run_pipeline as j_run_pipeline
from kmerax.pipeline.run import run_align as j_run_align
from kmerax_torch.cli import main
from kmerax_torch.config import KmeraxConfig
from kmerax_torch.io.fasta import read_fasta, write_fasta
from kmerax_torch.ops import align_kernels
from kmerax_torch.ops.align import build_contig_index, validate_batch
from kmerax_torch.ops.align_kernels import NEG_INF, banded_align_scores_plain
from kmerax_torch.ops.seed_hash import build_seed_hash, seed_hash_from_numpy
from kmerax_torch.pipeline.align import run_align
from kmerax_torch.pipeline.run import run_pipeline
from kmerax_torch.utils import cuda
from oracle.align import build_contig_index as oracle_index
from oracle.align import validate_read
from sim import ecoli_like, make_fastq

from parity import n, t

_ACGT = "ACGT"


def _dna(bases) -> str:
    return "".join(_ACGT[b] if b < 4 else "N" for b in bases)


# ------------------------------------------------------------ banded scores

def _align_case(band, L, B, seed):
    """tests/unit/test_pallas_align.py's inputs (N bases included) with the
    edge rows: empty query, empty target, both full length, and a length gap
    past the band (NEG_INF)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (B, L)).astype(np.int32)
    tg = np.where(rng.random((B, L)) < 0.05, rng.integers(0, 4, (B, L)),
                  q).astype(np.int32)
    qlen = rng.integers(0, L + 1, B).astype(np.int32)
    tlen = rng.integers(0, L + 1, B).astype(np.int32)
    qlen[0] = 0
    tlen[1] = 0
    qlen[2] = tlen[2] = L
    qlen[3], tlen[3] = L, max(0, L - band - 1)
    qlen[4:B // 2] = tlen[4:B // 2]          # mostly near-diagonal rows
    return q, tg, qlen, tlen


@pytest.mark.parametrize("band,L,B", [(15, 150, 48), (8, 64, 16),
                                      (31, 100, 8), (3, 24, 130),
                                      (63, 160, 40)])
def test_banded_scores_match_jax(band, L, B):
    args = _align_case(band, L, B, band * 1000 + L)
    want = np.asarray(j_banded(*map(jnp.asarray, args), band))
    pallas = np.asarray(banded_align_scores_pallas(
        *map(jnp.asarray, args), band, interpret=True))
    np.testing.assert_array_equal(pallas, want)
    got = n(banded_align_scores_plain(*map(t, args), band))
    np.testing.assert_array_equal(got, want)
    assert got[3] == NEG_INF and (got > 0).any()


def test_k4_wrapper_on_cpu_is_plain():
    """The wrapper takes the plain version for CPU tensors, counts no
    launch, and rejects what the kernel does not take."""
    q, tg, qlen, tlen = map(t, _align_case(15, 40, 12, 5))
    cuda.reset_launches()
    got = align_kernels.banded_align_scores(q, tg, qlen, tlen, 15)
    assert torch.equal(got, banded_align_scores_plain(q, tg, qlen, tlen, 15))
    assert got.dtype == torch.int32
    assert cuda.LAUNCHES["banded_align_scores"] == 0
    k4 = align_kernels.banded_align_scores
    with pytest.raises(TypeError):
        k4(q.to(torch.int64), tg, qlen, tlen, 15)
    with pytest.raises(ValueError):
        k4(q, tg, qlen[:-1], tlen, 15)
    with pytest.raises(ValueError):
        k4(q, tg[:-1], qlen, tlen, 15)
    with pytest.raises(ValueError):
        k4(q, tg.to("meta"), qlen, tlen, 15)
    with pytest.raises(ValueError):
        k4(q.t().contiguous().t(), tg, qlen, tlen, 15)
    for band in (-1, 64):
        with pytest.raises(ValueError, match="band"):
            k4(q, tg, qlen, tlen, band)


# ------------------------------------------------------------ contig index

def _contigs(seed: int):
    """Three contigs with Ns, one shorter than k, and repeats in both
    orientations, so the dedup keeps the smallest position and fwd varies."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, 700).astype(np.uint8)
    a[rng.random(700) < 0.01] = 4
    b = rng.integers(0, 4, 20).astype(np.uint8)
    rc = np.where(a[400:520] < 4, 3 - a[400:520], 4)[::-1]
    c = np.concatenate([a[100:260], rng.integers(0, 4, 90).astype(np.uint8),
                        rc.astype(np.uint8)])
    return [a, b, c]


@pytest.mark.parametrize("k", [25, 31, 63])
def test_contig_index_matches_jax(k):
    contigs = _contigs(k)
    for chunk in (97, 1 << 20):
        jcat, juniq, jpay = j_build_index(contigs, k, chunk=chunk)
        cat, uniq, pay = build_contig_index(contigs, k, chunk=chunk,
                                            device="cpu")
        np.testing.assert_array_equal(cat, jcat)
        assert uniq.dtype == np.uint32 and pay.dtype == np.int32
        np.testing.assert_array_equal(uniq, np.asarray(juniq))
        np.testing.assert_array_equal(pay, np.asarray(jpay))
        assert len(uniq) > 250


@pytest.mark.parametrize("contigs", [[], [np.zeros(10, np.uint8)],
                                     [np.full(80, 4, np.uint8)]],
                         ids=["none", "shorter_than_k", "all_n"])
def test_contig_index_degenerate_matches_jax(contigs):
    jcat, juniq, jpay = j_build_index(contigs, 31)
    cat, uniq, pay = build_contig_index(contigs, 31, device="cpu")
    np.testing.assert_array_equal(cat, jcat)
    np.testing.assert_array_equal(uniq, np.asarray(juniq))
    np.testing.assert_array_equal(pay, np.asarray(jpay))
    sh = build_seed_hash(uniq, pay, device="cpu")
    jsh = j_build_seed_hash(juniq, jpay)
    np.testing.assert_array_equal(n(sh.tab), np.asarray(jsh.tab))


@pytest.mark.parametrize("k", [31, 63])
def test_seed_hash_table_matches_jax(k):
    """Same keys hashed by core/hash.kmer_hash and the same seeded walk:
    table bytes, n_slots and attempt equal, sentinel padding ignored."""
    rng = np.random.default_rng(k + 1)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    _, uniq, pay = j_build_index([genome], k)
    uniq, pay = np.asarray(uniq), np.asarray(pay)
    jsh = j_build_seed_hash(uniq, pay)
    w = uniq.shape[1]
    padded = np.concatenate([uniq, np.full((9, w), 0xFFFFFFFF, np.uint32)])
    for rows, pays in ((uniq, pay),
                       (padded, np.concatenate([pay, np.zeros(9, np.int32)]))):
        sh = build_seed_hash(rows, pays, device="cpu")
        assert sh.tab.dtype == torch.int64
        np.testing.assert_array_equal(n(sh.tab).astype(np.uint32),
                                      np.asarray(jsh.tab))
        assert (sh.n_slots, sh.attempt) == (jsh.n_slots, jsh.attempt)


# ------------------------------------------------------------ validate_batch

@pytest.fixture(scope="module")
def world():
    """tests/golden/test_align_stage.py's world: two overlapping halves of
    a 3 kb genome as contigs, 15x reads of 100 bp."""
    genome, reads = ecoli_like(seed=55, genome_len=3000, coverage=15,
                               read_len=100, error_rate=0.01)
    return genome, [genome[:1600], genome[1500:]], reads


def _jax_index(contigs, k):
    cat, uniq, pay = j_build_index(contigs, k)
    sh = j_build_seed_hash(uniq, pay)
    return cat, uniq, pay, sh


def _validate_both(contigs, bases, lens, k, band):
    """(JAX full-width probe, JAX phased, port) results as numpy tuples, the
    port on the JAX-built index carried across."""
    cat, uniq, pay, sh = _jax_index(contigs, k)
    jidx = (sh.tab, sh.n_slots, sh.attempt)
    cat_dev = jnp.asarray(cat.astype(np.int8))
    jb, jl = jnp.asarray(bases), jnp.asarray(lens)
    want = jax.jit(lambda b, l: j_validate(
        cat_dev, uniq, pay, b, l, k, band, index_hash=jidx))(jb, jl)
    phased = jax.jit(lambda b, l: j_validate_phased(
        cat_dev, jidx, b, l, k, band))(jb, jl)
    index = seed_hash_from_numpy(np.asarray(sh.tab), sh.n_slots, sh.attempt,
                                 "cpu")
    got = validate_batch(torch.from_numpy(cat.astype(np.int8)), index,
                         t(bases.astype(np.int8)), t(lens), k, band)
    return ([np.asarray(x) for x in want], [np.asarray(x) for x in phased],
            [n(x) for x in got], cat)


def test_validate_batch_matches_jax_and_oracle(world):
    _, contigs, reads = world
    k, band, L = 31, 15, 100
    sub = reads[:96]
    bases = np.full((len(sub), L), 4, np.int32)
    lens = np.zeros(len(sub), np.int32)
    for i, r in enumerate(sub):
        bases[i, :len(r.bases)] = r.bases
        lens[i] = len(r.bases)
    # a short read, an unalignable random read, an all-N read and a read
    # shorter than k
    lens[3] = 20
    bases[3, 20:] = 4
    rng = np.random.default_rng(9)
    bases[5] = rng.integers(0, 4, L)
    bases[7] = 4
    lens[9] = 45
    bases[9, 45:] = 4
    want, phased, got, _ = _validate_both(contigs, bases, lens, k, band)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert bool(phased[4])
    for g, p in zip(got, phased[:4]):
        np.testing.assert_array_equal(g, p)

    cat_o, idx_o = oracle_index(contigs, k)
    found, strand, pos, score = got
    for i in range(len(sub)):
        assert (bool(found[i]), int(strand[i]), int(pos[i]),
                int(score[i])) == validate_read(bases[i, :lens[i]], cat_o,
                                                idx_o, k, band), i
    assert found.sum() > 80 and (strand[found] == 1).any()
    assert not found[3] and not found[7] and found[9]


def test_validate_batch_phased_overflow_matches_replay(world):
    """More than B/4 reads without a seed in the first 24 positions: the
    JAX phased probe raises its replay flag, and the port (always the full
    probe) equals the JAX full-width replay."""
    genome, contigs, _ = world
    k, band, B, L = 31, 8, 64, 100
    rng = np.random.default_rng(21)
    starts = rng.integers(0, len(genome) - L, B)
    bases = genome[starts[:, None] + np.arange(L)].astype(np.int32)
    bases[:40, :24 + k] = rng.integers(0, 4, (40, 24 + k))
    lens = np.full(B, L, np.int32)
    want, phased, got, _ = _validate_both(contigs, bases, lens, k, band)
    assert not bool(phased[4])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0][:40].sum() > 30


# ------------------------------------------------------------ stage and CLI

def _fastq(reads, rng) -> bytes:
    """FASTQ with Ns, a lower-case read and reads shorter than k."""
    out = []
    for i, r in enumerate(reads):
        seq = bytearray(r.seq.encode())
        for j in np.nonzero(rng.random(len(seq)) < 0.004)[0]:
            seq[j] = ord("N")
        if i % 9 == 4:
            seq = seq.lower()
        cut = 25 if i % 17 == 6 else len(seq)
        out.append(b"@%s\n%s\n+\n%s\n" % (r.name.encode(), seq[:cut],
                                         r.qual[:cut].encode()))
    return b"".join(out)


def test_run_align_matches_jax(world, tmp_path):
    """Two input files through several batches: the stats and the TSV
    bytes equal the JAX package's."""
    _, contigs, reads = world
    fa = str(tmp_path / "contigs.fasta")
    write_fasta(fa, [_dna(c) for c in contigs])
    assert [s for _, s in read_fasta(fa)] == [_dna(c) for c in contigs]
    rng = np.random.default_rng(31)
    paths = [tmp_path / "a.fastq", tmp_path / "b.fastq"]
    paths[0].write_bytes(_fastq(reads[:150], rng))
    paths[1].write_bytes(_fastq(reads[150:260], rng))
    paths = [str(p) for p in paths]
    kw = dict(k=31, batch_reads=64, max_read_len=100)
    want = j_run_align(JConfig(**kw), paths, fa, str(tmp_path / "j.tsv"))
    cuda.reset_launches()
    got = run_align(KmeraxConfig(**kw), paths, fa, str(tmp_path / "t.tsv"),
                    device="cpu")
    assert got == want
    assert cuda.LAUNCHES["banded_align_scores"] == 0
    tsv = (tmp_path / "t.tsv").read_bytes()
    assert tsv == (tmp_path / "j.tsv").read_bytes()
    assert tsv.count(b"\n") == 260 and 0.5 < want["aligned_frac"] < 1.0


@pytest.fixture(scope="module")
def golden_fastq(tmp_path_factory):
    _, reads = ecoli_like(seed=55, genome_len=1500, coverage=30,
                          read_len=100, error_rate=0.008)
    p = tmp_path_factory.mktemp("golden") / "reads.fastq"
    p.write_bytes(make_fastq(reads))
    return str(p)


def test_cli_validate_and_align_match_jax(golden_fastq, tmp_path, capsys):
    """`pipeline --validate` prints the same JSON, "validate" included,
    through both CLIs; `align --out` writes the same TSV bytes."""
    common = ["-k", "31", "--bloom-log2-width", "18", "--batch-reads", "128",
              "--max-read-len", "100", "--exact-capacity", str(1 << 17)]
    out = {}
    for tag, fn, extra in (("j", j_main, []),
                           ("t", main, ["--device", "cpu"])):
        assert fn(["pipeline", "--in", golden_fastq, "--out-fastq",
                   str(tmp_path / f"{tag}.fastq"), "--out-fasta",
                   str(tmp_path / f"{tag}.fa"), "--validate", "--metrics",
                   str(tmp_path / f"{tag}.jsonl"), *common, *extra]) == 0
        out[tag] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["t"] == out["j"]
    assert out["j"]["validate"]["reads"] == 450
    assert out["j"]["validate"]["aligned_frac"] > 0.99
    stages = [json.loads(ln)["stage"]
              for ln in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert stages == ["count", "correct", "count", "assemble", "align"]

    for tag, fn, extra in (("j", j_main, []),
                           ("t", main, ["--device", "cpu"])):
        assert fn(["align", "--in", str(tmp_path / f"{tag}.fastq"),
                   "--contigs", str(tmp_path / f"{tag}.fa"),
                   "--out", str(tmp_path / f"{tag}.tsv"), *common,
                   *extra]) == 0
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
            == out["j"]["validate"]
    assert (tmp_path / "t.tsv").read_bytes() == \
        (tmp_path / "j.tsv").read_bytes()


def test_validate_needs_out_fasta(golden_fastq, tmp_path):
    """Without out_fasta there is no assembly to validate against: both
    packages skip the align stage and return the same result."""
    kw = dict(k=31, bloom_log2_width=18, batch_reads=128, max_read_len=100,
              exact_capacity=1 << 17)
    want = j_run_pipeline(JConfig(**kw), [golden_fastq],
                          str(tmp_path / "j.fastq"), validate=True)
    got = run_pipeline(KmeraxConfig(**kw), [golden_fastq],
                       str(tmp_path / "t.fastq"),
                       metrics_path=str(tmp_path / "m.jsonl"), validate=True,
                       device="cpu")
    assert got == want and "validate" not in got
    stages = [json.loads(ln)["stage"]
              for ln in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert stages == ["count", "correct"]
