"""p16 counters (two saturating 16-bit counters in each int32 word) in
kmerax_torch against the JAX package on the CPU: the pack16 layout, K1's,
K2's and K3's plain p16 versions, saturation, run_pipeline under both
bucket schemes, checkpoints read across the packages (an "auto" manifest
over a packed table included), a two-pass crash and resume, and the
"auto" resolution. Exact: tolerance 0 (every output is an integer or a
byte)."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kmerax.config import KmeraxConfig as JConfig
from kmerax.core import canonical_words as j_canonical
from kmerax.core import extract_kmers as j_extract
from kmerax.ops.correct import _eval_entries as j_eval_entries
from kmerax.pipeline import run_pipeline as j_run_pipeline
from kmerax.pipeline.checkpoint import load_spectrum as j_load_spectrum
from kmerax.pipeline.checkpoint import save_spectrum as j_save_spectrum
from kmerax.spectrum import bloom as jbloom
from kmerax_torch.cli import main
from kmerax_torch.config import KmeraxConfig
from kmerax_torch.ops.correct import _accept
from kmerax_torch.ops.correct_kernels import correct_eval_scores
from kmerax_torch.pipeline import twopass
from kmerax_torch.pipeline.checkpoint import load_spectrum, \
    state_from_checkpoint
from kmerax_torch.pipeline.count import bloom_params, table_counter
from kmerax_torch.pipeline.run import run_pipeline
from kmerax_torch.spectrum import bloom
from kmerax_torch.spectrum.bloom_kernels import bloom_insert, \
    bloom_insert_plain, bloom_query_solid, insert_plain
from kmerax_torch.spectrum.sharded import ShardedParams
from kmerax_torch.utils import cuda
from sim import ecoli_like, make_fastq

from parity import n, reads_with_ns, run_clis, t

LW = 14                      # 2^14 counters, 2^13 p16 words
# the pipeline's config: 2^16 counters, the golden dataset's batches
CFG = dict(k=31, bloom_log2_width=16, batch_reads=128, max_read_len=100,
           exact_capacity=1 << 17)
ARGS = ["-k", "31", "--bloom-log2-width", "16", "--batch-reads", "128",
        "--max-read-len", "100", "--exact-capacity", str(1 << 17)]


def _jp(k, scheme="hash", counter="p16", lw=LW):
    return jbloom.BloomParams(k, lw, 4, 11, 5, scheme, counter=counter)


def _tp(k, scheme="hash", counter="p16", lw=LW):
    return bloom.BloomParams(k, lw, 4, 11, 5, scheme, counter)


_j_insert = jax.jit(jbloom.insert, static_argnums=0)


def _j_canon(reads, k):
    words, valid = j_extract(jnp.asarray(reads), k)
    return j_canonical(words, k)[0], valid


def test_pack16_roundtrip_matches_jax():
    """(a) pack16 / unpack16: a round trip, and word for word the JAX
    package's."""
    rng = np.random.default_rng(0)
    cnt = rng.integers(0, bloom.SAT16 + 1, 1 << 12).astype(np.int32)
    words = bloom.pack16(t(cnt))
    assert words.dtype == torch.int32 and words.shape == (1 << 11,)
    np.testing.assert_array_equal(n(words), np.asarray(jbloom.pack16(
        jnp.asarray(cnt))))
    np.testing.assert_array_equal(n(bloom.unpack16(words)), cnt)
    np.testing.assert_array_equal(
        n(bloom.unpack16(words)), np.asarray(jbloom.unpack16(
            jnp.asarray(n(words)))))
    assert bloom.SAT16 == jbloom.SAT16
    assert _tp(31).table_entries == _jp(31).table_entries == 1 << (LW - 1)


@pytest.mark.parametrize("scheme", ["hash", "minimizer"])
@pytest.mark.parametrize("k", [25, 31, 63])
def test_k1_plain_p16_matches_jax(k, scheme):
    """(b) K1's plain p16 version (through the wrapper, on CPU tensors:
    no launch) over two batches: the JAX package's `insert(P16, ...)`
    words, and unpacked, min(the i32 table, SAT16)."""
    reads, _ = reads_with_ns(k, 64, 100, k)
    jp, tp = _jp(k, scheme), _tp(k, scheme)
    canon, valid = _j_canon(reads, k)
    jt = _j_insert(jp, jbloom.make_table(jp), canon, valid)
    jt = _j_insert(jp, jt, canon, valid)
    table, t32 = bloom.make_table(tp, "cpu"), bloom.make_table(
        _tp(k, scheme, "i32"), "cpu")
    bases = t(reads).to(torch.int8)
    cuda.reset_launches()
    for _ in range(2):
        bloom_insert(table, bases, tp)
        bloom_insert_plain(t32, bases, _tp(k, scheme, "i32"))
    assert all(c == 0 for c in cuda.LAUNCHES.values())
    assert table.shape == (1 << (LW - 1),)
    np.testing.assert_array_equal(n(table), np.asarray(jt))
    np.testing.assert_array_equal(n(bloom.unpack16(table)),
                                  n(t32.clamp(max=bloom.SAT16)))
    assert int(t32.max()) >= 2


@pytest.mark.parametrize("t_solid", [1, 2, 5, bloom.SAT16, bloom.SAT16 + 1])
def test_p16_solidity_matches_jax(t_solid):
    """(c) K2's plain p16 version (the wrapper on CPU tensors) and the
    plain probe: the JAX package's `query(P16, ...) >= t`, window by
    window, on a table whose first block rows sit at SAT16."""
    k = 31
    reads, lengths = reads_with_ns(7, 64, 100, k)
    jp, tp = _jp(k), _tp(k)
    canon, valid = _j_canon(reads, k)
    jt = _j_insert(jp, jbloom.make_table(jp), canon, valid)
    jt = jt.at[:512].set(jbloom.SAT16 | (jbloom.SAT16 << 16))
    table = t(np.asarray(jt)).to(torch.int32)
    want = (np.asarray(jbloom.query(jp, jt, canon, valid)) >= t_solid) \
        & np.asarray(valid)
    last_j = t(np.full(64, 100 - k, np.int32))
    got = bloom_query_solid(table, t(reads).to(torch.int32), last_j, tp,
                            t_solid)
    np.testing.assert_array_equal(n(got), want)
    got = bloom.query_solid(tp, table, t_solid, t(np.asarray(canon)),
                            t(np.asarray(valid)))
    np.testing.assert_array_equal(n(got), want)
    assert (want.sum() > 0) == (t_solid <= bloom.SAT16)


def test_saturation_order_independent():
    """(d) min(sum, SAT16) whatever the batch split: one k-mer inserted
    40,000 times in three different splits, each equal to the JAX
    package's one-batch insert, and at SAT16."""
    k = 31
    reads, _ = reads_with_ns(3, 1, 40, k, n_rate=0.0)
    canon, valid = _j_canon(reads, k)
    one = canon[:, :1], valid[:, :1]
    jp, tp = _jp(k), _tp(k)
    total = 40000
    jt = jbloom.insert(jp, jbloom.make_table(jp),
                       jnp.repeat(one[0], total, axis=1),
                       jnp.repeat(one[1], total, axis=1))
    block, lp = bloom.blocks_lanepack(tp, t(np.asarray(one[0])))
    tabs = []
    for splits in ([total], [1000] * 40, [30000, 7000, 3000]):
        table = bloom.make_table(tp, "cpu")
        for m in splits:
            insert_plain(table, block.reshape(-1).repeat(m),
                         lp.reshape(-1).repeat(m),
                         torch.ones(m, dtype=torch.bool), 4, "p16")
        tabs.append(n(table))
    for tab in tabs:
        np.testing.assert_array_equal(tab, np.asarray(jt))
    assert int(n(bloom.unpack16(t(tabs[0]))).max()) == bloom.SAT16


@pytest.mark.parametrize("k", [25, 31, 63])
def test_k3_plain_p16_matches_jax(k):
    """(e) K3's plain p16 version (the wrapper on CPU tensors) scored on a
    JAX P16 table: the accept decisions and accepted bases of the JAX
    package's `_eval_entries` through a p16 query."""
    B, L, t_solid = 64, 100, 2
    reads, lengths, errs = reads_with_ns(
        20 + k, B, L, k, err_rate=0.01 if k == 63 else 0.03,
        with_errors=True)
    jp, tp = _jp(k), _tp(k)
    canon, valid = _j_canon(reads, k)
    jt = jbloom.insert(jp, jbloom.make_table(jp), canon, valid)
    rng = np.random.default_rng(k)
    er, ei = np.nonzero(errs)
    ent_r = np.concatenate([er[:100], rng.integers(0, B, 100)]).astype(
        np.int32)
    ent_i = np.concatenate([ei[:100], rng.integers(0, L, 100)]).astype(
        np.int32)
    ent_i[-10:] = -1
    jargs = (jnp.asarray(reads), jnp.asarray(lengths),
             jnp.asarray(lengths - k), jnp.asarray(ent_r), jnp.asarray(ent_i))
    ref_b, ref_a = jax.jit(lambda *a: j_eval_entries(
        *a, k, lambda cw, v: (jbloom.query(jp, jt, cw, v) >= t_solid) & v))(
        *jargs)
    targs = (t(reads).to(torch.int32), t(lengths), t(lengths - k))
    scores = correct_eval_scores(tp, t(np.asarray(jt)).to(torch.int32),
                                 t_solid, *targs, t(ent_r), t(ent_i))
    got_b, got_a = _accept(scores, targs[0], t(ent_r).long(),
                           t(ent_i).long())
    ref_a = np.asarray(ref_a)
    np.testing.assert_array_equal(n(got_a), ref_a)
    np.testing.assert_array_equal(n(got_b)[ref_a], np.asarray(ref_b)[ref_a])
    assert ref_a.sum() > 0


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden FASTQ, a p16 TOML, and the JAX package's p16 run_pipeline
    of them under each bucket scheme (the two JAX pipeline runs)."""
    _, reads = ecoli_like(seed=55, genome_len=1500, coverage=30,
                          read_len=100, error_rate=0.008)
    d = tmp_path_factory.mktemp("p16")
    fq = d / "reads.fastq"
    fq.write_bytes(make_fastq(reads))
    toml = d / "p16.toml"
    toml.write_text('bloom_counter = "p16"\n')
    out = {"fq": str(fq), "dir": d, "toml": str(toml)}
    for scheme in ("hash", "minimizer"):
        cfg = JConfig(**CFG, bucket_scheme=scheme, bloom_counter="p16")
        out[scheme] = j_run_pipeline(cfg, [str(fq)], str(d / f"j_{scheme}.fq"),
                                     str(d / f"j_{scheme}.fa"))
    return out


@pytest.mark.parametrize("scheme", ["hash", "minimizer"])
def test_run_pipeline_p16_matches_jax(golden, tmp_path, scheme):
    """(f) run_pipeline with p16 counters: the JAX package's p16 FASTQ and
    FASTA bytes, and the port's own i32 run's."""
    d = golden["dir"]
    res = {}
    for counter in ("p16", "i32"):
        cfg = KmeraxConfig(**CFG, bucket_scheme=scheme,
                           bloom_counter=counter)
        res[counter] = run_pipeline(cfg, [golden["fq"]],
                                    str(tmp_path / f"{counter}.fq"),
                                    str(tmp_path / f"{counter}.fa"),
                                    device="cpu")
    assert res["p16"] == res["i32"] == golden[scheme]
    for ext in ("fq", "fa"):
        want = (d / f"j_{scheme}.{ext}").read_bytes()
        assert (tmp_path / f"p16.{ext}").read_bytes() == want
        assert (tmp_path / f"i32.{ext}").read_bytes() == want


def test_checkpoints_cross_read(golden, tmp_path):
    """(g) `count` with the p16 TOML in both packages: equal manifests and
    arrays, a (2^16 / 2,) packed bloom_table; each package's `correct
    --spectrum` on the other's checkpoint writes the JAX package's p16
    bytes; and an "auto" manifest over the packed table (the JAX package's
    save_spectrum of a P16 table, as a TPU run under "auto" writes it) is
    read by the port as p16, with the CLI's default config, the same
    bytes."""
    fq, toml = golden["fq"], golden["toml"]
    want = (golden["dir"] / "j_hash.fq").read_bytes()
    jres, tres = run_clis(["count", "--in", fq, "--out",
                           str(tmp_path / "{pkg}_spec"), "--config", toml,
                           *ARGS])
    assert tres == jres
    jm, ja = j_load_spectrum(str(tmp_path / "j_spec"))
    tm, ta = load_spectrum(str(tmp_path / "t_spec"))
    assert tm == jm and tm["config"]["bloom_counter"] == "p16"
    assert sorted(ta) == sorted(ja)
    for name in ja:
        assert ta[name].dtype == ja[name].dtype, name
        np.testing.assert_array_equal(ta[name], ja[name], err_msg=name)
    assert ta["bloom_table"].shape == (1 << 15,)
    # the port reads the JAX package's checkpoint, and the JAX package the
    # port's
    main(["correct", "--in", fq, "--spectrum", str(tmp_path / "j_spec"),
          "--out", str(tmp_path / "t_from_j.fq"), "--config", toml, *ARGS,
          "--device", "cpu"])
    from kmerax.cli import main as j_main
    assert j_main(["correct", "--in", fq, "--spectrum",
                   str(tmp_path / "t_spec"), "--out",
                   str(tmp_path / "j_from_t.fq"), "--config", toml,
                   *ARGS]) == 0
    assert (tmp_path / "t_from_j.fq").read_bytes() == want
    assert (tmp_path / "j_from_t.fq").read_bytes() == want
    # an "auto" manifest over the packed table
    auto = tmp_path / "auto_spec"
    j_save_spectrum(str(auto), JConfig(**CFG),
                    bloom_table=jnp.asarray(ja["bloom_table"]),
                    exact=(ja["exact_uniq"], ja["exact_counts"],
                           ja["exact_n"]),
                    threshold=jm["threshold"], hist=ja["hist"],
                    extra={"n_reads": jm["n_reads"],
                           "n_kmers": jm["n_kmers"]})
    with open(auto / "manifest.json") as f:
        assert json.load(f)["config"]["bloom_counter"] == "auto"
    am, aa = load_spectrum(str(auto))
    state = state_from_checkpoint(KmeraxConfig(**am["config"]), am, aa,
                                  "cpu", host_form=False)
    assert state.counter == "p16"
    main(["correct", "--in", fq, "--spectrum", str(auto), "--out",
          str(tmp_path / "t_from_auto.fq"), *ARGS, "--device", "cpu"])
    assert (tmp_path / "t_from_auto.fq").read_bytes() == want
    # an explicit i32 over the packed table, and a length that is neither,
    # raise
    with pytest.raises(ValueError, match="the p16 layout"):
        state_from_checkpoint(KmeraxConfig(**CFG, bloom_counter="i32"), am,
                              aa, "cpu", host_form=False)
    bad = dict(aa, bloom_table=aa["bloom_table"][:1000])
    with pytest.raises(ValueError, match="neither"):
        state_from_checkpoint(KmeraxConfig(**CFG), am, bad, "cpu",
                              host_form=False)


@pytest.fixture(scope="module")
def spectra(golden):
    """The port's `count` checkpoints of the golden reads: "i32" counted
    under the CLI's default config ("auto", i32 off a TPU), "p16" under the
    p16 TOML; and an i32 TOML."""
    d = golden["dir"]
    i32_toml = d / "i32.toml"
    i32_toml.write_text('bloom_counter = "i32"\n')
    out = {"i32_toml": str(i32_toml)}
    for counter, extra in (("i32", []), ("p16", ["--config",
                                                 golden["toml"]])):
        out[counter] = str(d / f"spec_{counter}")
        main(["count", "--in", golden["fq"], "--out", out[counter], *extra,
              *ARGS, "--device", "cpu"])
    return out


@pytest.mark.parametrize("spec,toml,names", [
    ("i32", "toml", "the i32 layout.*bloom_counter='p16'"),
    ("p16", "i32_toml", "the p16 layout.*bloom_counter='i32'")])
def test_explicit_counter_against_spectrum_raises(golden, spectra, tmp_path,
                                                  spec, toml, names):
    """`correct --spectrum` and `assemble --spectrum` with a config that
    names the other counter layout than the saved table's raise, naming
    both (the JAX CLI would probe the words in the config's layout and
    write other bytes)."""
    conf = golden["toml"] if toml == "toml" else spectra[toml]
    for cmd, out in (("correct", "c.fq"), ("assemble", "a.fa")):
        with pytest.raises(ValueError, match=names):
            main([cmd, "--in", golden["fq"], "--spectrum", spectra[spec],
                  "--out", str(tmp_path / out), "--config", conf, *ARGS,
                  "--device", "cpu"])
    assert not (tmp_path / "c.fq").exists()


def test_auto_on_p16_spectrum_matches_explicit_p16(golden, spectra,
                                                   tmp_path):
    """`correct --spectrum` on a p16 checkpoint under the CLI's "auto"
    probes the p16 words: the bytes that both packages write with
    `--config p16.toml` on the same checkpoint (the golden p16 pipeline's),
    where the JAX CLI's "auto" (i32 off a TPU) would read the packed words
    as int32 counters."""
    want = (golden["dir"] / "j_hash.fq").read_bytes()
    jres, tres = run_clis(["correct", "--in", golden["fq"], "--spectrum",
                           spectra["p16"], "--out",
                           str(tmp_path / "{pkg}_p16.fq"), "--config",
                           golden["toml"], *ARGS])
    assert tres == jres
    main(["correct", "--in", golden["fq"], "--spectrum", spectra["p16"],
          "--out", str(tmp_path / "t_auto.fq"), *ARGS, "--device", "cpu"])
    for name in ("j_p16.fq", "t_p16.fq", "t_auto.fq"):
        assert (tmp_path / name).read_bytes() == want, name


def test_two_pass_p16_crash_resume(golden, tmp_path, monkeypatch):
    """(h) run_two_pass with p16 counters, crashed in assemble (after the
    count_k2 checkpoint) and resumed: the i32 run's FASTQ and FASTA bytes,
    and packed (width/2,) tables in both checkpoints."""
    fq = golden["fq"]
    cfg = dict(CFG, k2=63, bloom_log2_width=17)
    ref = twopass.run_two_pass(KmeraxConfig(**cfg), [fq],
                               str(tmp_path / "i32.fq"),
                               str(tmp_path / "i32.fa"), device="cpu")
    p16 = KmeraxConfig(**cfg, bloom_counter="p16")
    wd = tmp_path / "work"
    orig = twopass.assemble_to_fasta

    def boom(*a, **kw):
        raise RuntimeError("injected host failure")

    monkeypatch.setattr(twopass, "assemble_to_fasta", boom)
    with pytest.raises(RuntimeError, match="injected"):
        twopass.run_two_pass(p16, [fq], str(tmp_path / "p16.fq"),
                             str(tmp_path / "p16.fa"), workdir=str(wd),
                             device="cpu")
    monkeypatch.setattr(twopass, "assemble_to_fasta", orig)
    res = twopass.run_two_pass(p16, [fq], str(tmp_path / "p16.fq"),
                               str(tmp_path / "p16.fa"), workdir=str(wd),
                               device="cpu")
    keys = ("threshold_k1", "threshold_k2", "unitigs")
    assert res["resumed"] and {x: res[x] for x in keys} == \
        {x: ref[x] for x in keys}
    for ext in ("fq", "fa"):
        assert (tmp_path / f"p16.{ext}").read_bytes() == \
            (tmp_path / f"i32.{ext}").read_bytes()
    for stage in ("count_k1", "count_k2"):
        _, arrays = load_spectrum(str(wd / stage))
        assert arrays["bloom_table"].shape == (1 << 16,)


def test_auto_counter_resolution():
    """(i) "auto" resolves to i32 (the CPU half of the JAX package's
    test_auto_counter_resolution, and the port's rule on the card); an
    explicit layout wins; a mesh keeps i32 counters and refuses p16 with
    the JAX package's words; a table's length gives its layout."""
    for lw in (24, 25):
        assert bloom_params(KmeraxConfig(bloom_log2_width=lw),
                            31).counter == "i32"
    assert bloom_params(KmeraxConfig(bloom_log2_width=25,
                                     bloom_counter="p16"), 31).counter \
        == "p16"
    assert bloom_params(KmeraxConfig(bloom_counter="p16"), 31,
                        "i32").counter == "i32"
    mesh = KmeraxConfig(bloom_log2_width=25, mesh_data=2, mesh_bucket=4)
    assert bloom_params(mesh, 31).counter == "i32"
    ShardedParams(bloom_params(mesh, 31), 4)
    with pytest.raises(ValueError, match="sharded spectra keep i32 counters"):
        ShardedParams(bloom_params(mesh.replace(bloom_counter="p16"), 31), 4)
    cfg = KmeraxConfig(bloom_log2_width=20)
    assert table_counter(cfg, 1 << 20) == "i32"
    assert table_counter(cfg, 1 << 19) == "p16"
    assert table_counter(cfg.replace(bloom_counter="p16"), 1 << 19) == "p16"
    with pytest.raises(ValueError, match="the i32 layout"):
        table_counter(cfg.replace(bloom_counter="p16"), 1 << 20)
    with pytest.raises(ValueError, match="neither"):
        table_counter(cfg, 3 << 17)
    assert dataclasses.replace(_tp(31), counter="i32").table_entries \
        == 1 << LW
