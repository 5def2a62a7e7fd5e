"""The bucket-sharded spectrum of kmerax_torch (spectrum/sharded.py, kernel
K1r's plain version, dist/mesh.py) against the JAX package's
kmerax/spectrum/sharded.py and `insert(..., local_bits=)`. Exact:
tolerance 0, every output is an integer."""

import contextlib
import io
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from kmerax.config import KmeraxConfig as JConfig
from kmerax.core import canonical_words as j_canonical_words
from kmerax.core import extract_kmers as j_extract_kmers
from kmerax.dist.mesh import MeshSpec as JMeshSpec, make_mesh
from kmerax.pipeline.run import _bloom_params, \
    run_correct as j_run_correct, run_count as j_run_count
from kmerax.spectrum.bloom import BloomParams as JBloomParams, insert
from kmerax.spectrum.sharded import ShardedParams as JShardedParams, \
    _route, _shard_of
import kmerax_torch.bench.runners as t_runners
from kmerax_torch.bench.runners import e2e_stages, run_preset
from kmerax_torch.cli import main
from kmerax_torch.config import KmeraxConfig
from kmerax_torch.core.codec import canonical_words, to_u32_bits
from kmerax_torch.core.kmers import extract_kmers
from kmerax_torch.dist import mesh as dmesh
from kmerax_torch.pipeline.count import bloom_params, run_count
from kmerax_torch.spectrum.bloom import BloomParams
from kmerax_torch.spectrum.bloom_kernels import blocks_lanepack, \
    bloom_insert_rows, insert_plain
from kmerax_torch.spectrum.sharded import ShardedParams, recv_rows, \
    shard_of

from sim import ecoli_like, make_fastq

from parity import n, reads_with_ns, run_mesh

LW, M, LB = 16, 11, 8           # table, minimizer and bucket bits


@pytest.mark.parametrize("scheme", ["hash", "minimizer"])
@pytest.mark.parametrize("k", [25, 31, 63])
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_insert_rows_plain_matches_jax(S, k, scheme):
    """K1r's plain version on each shard's rows == the JAX package's
    insert(..., local_bits) on the same rows, bit for bit; the shards'
    slices, concatenated, == the whole table of the one-device insert
    (DESIGN.md §12); the port's shard of every k-mer == `_shard_of`."""
    reads, _ = reads_with_ns(7 * k + S, 96, 100, k)
    jp = JBloomParams(k, LW, 4, M, LB, scheme)
    tp = BloomParams(k, LW, 4, M, LB, scheme)
    jsp, tsp = JShardedParams(jp, S), ShardedParams(tp, S)
    jw, jv = j_extract_kmers(jnp.asarray(reads), k)
    jc, _ = j_canonical_words(jw, k)
    jc, jv = jc.reshape(-1, jc.shape[-1]), jv.reshape(-1)
    tw, tv = extract_kmers(torch.from_numpy(reads), k)
    tc, _ = canonical_words(tw, k)
    tc, tv = tc.reshape(-1, tc.shape[-1]), tv.reshape(-1)
    np.testing.assert_array_equal(n(tc), np.asarray(jc))
    jshard = np.asarray(_shard_of(jc, jsp))
    np.testing.assert_array_equal(n(shard_of(tc, tsp)), jshard)
    lb = tsp.local_bits
    # the JAX side takes every row, valid only where it is shard s's (one
    # compiled shape); the port's K1r takes shard s's rows alone, as the
    # all-to-all delivers them
    jins = jax.jit(insert, static_argnums=0, static_argnames="local_bits")
    slices = []
    for s in range(S):
        sel = jshard == s
        want = jins(jp, jnp.zeros(1 << lb, jnp.int32), jc, jv & sel,
                    local_bits=lb)
        got = torch.zeros(1 << lb, dtype=torch.int32)
        bloom_insert_rows(got, to_u32_bits(tc[torch.from_numpy(sel)]),
                          tv[torch.from_numpy(sel)], tp, lb)
        np.testing.assert_array_equal(n(got), np.asarray(want))
        slices.append(n(got))
    whole = np.asarray(jins(jp, jnp.zeros(1 << LW, jnp.int32), jc, jv))
    np.testing.assert_array_equal(np.concatenate(slices), whole)
    assert whole.sum() > 0


def test_insert_rows_writes_pending():
    """K1r's pending rows: the valid rows alone, in order, from row `off`,
    the buffer's other rows untouched; it returns their number; rows
    outside the buffer are refused (room for all N from `off`)."""
    p = BloomParams(31, LW)
    rows = torch.tensor([[5, 6], [7, 8], [9, 10]], dtype=torch.int32)
    valid = torch.tensor([True, False, True])
    pending = torch.full((6, 2), 3, dtype=torch.int32)
    count = bloom_insert_rows(torch.zeros(1 << 14, dtype=torch.int32), rows,
                              valid, p, 14, pending, 2)
    assert count.dtype == torch.int64 and count.dim() == 0
    assert int(count) == 2
    assert pending.tolist() == [[3, 3], [3, 3], [5, 6], [9, 10], [3, 3],
                                [3, 3]]
    with pytest.raises(ValueError, match="pending rows"):
        bloom_insert_rows(torch.zeros(1 << 14, dtype=torch.int32), rows,
                          valid, p, 14, pending, 4)
    with pytest.raises(ValueError, match="local_bits"):
        bloom_insert_rows(torch.zeros(1 << 7, dtype=torch.int32), rows,
                          valid, p, 7)


def _rvalid(pattern: str, n: int, rng) -> np.ndarray:
    """A valid mask of n routed slots: every slot, none, scattered slots,
    or runs of valid slots at random places (route_prep's masks are a
    valid prefix in each source's block)."""
    if pattern == "all":
        return np.ones(n, bool)
    if pattern == "none":
        return np.zeros(n, bool)
    if pattern == "scattered":
        return rng.random(n) < 0.3
    starts = rng.integers(0, n, 12)
    lens = rng.integers(1, 200, 12)
    mask = np.zeros(n, bool)
    for a, b in zip(starts, lens):
        mask[a:a + b] = True
    return mask


@pytest.mark.parametrize("scheme", ["hash", "minimizer"])
@pytest.mark.parametrize("pattern", ["all", "none", "scattered", "runs"])
def test_insert_rows_plain_any_rvalid(pattern, scheme):
    """K1r's plain version for any valid mask, not only route_prep's: its
    slice == insert_plain at the masked global addressing == the JAX
    package's insert(..., local_bits) on the same rows; pending from `off`
    == rows[rvalid] with the buffer's other rows untouched; the count ==
    rvalid's."""
    rng = np.random.default_rng(sum(map(ord, pattern + scheme)))
    k = 31
    tp = BloomParams(k, LW, 4, M, LB, scheme)
    jp = JBloomParams(k, LW, 4, M, LB, scheme)
    tsp = ShardedParams(tp, 4)
    lb = tsp.local_bits
    reads, _ = reads_with_ns(int(rng.integers(1 << 16)), 96, 100, k)
    tw, tv = extract_kmers(torch.from_numpy(reads), k)
    tc, _ = canonical_words(tw, k)
    tc, tv = tc.reshape(-1, tc.shape[-1]), tv.reshape(-1)
    # the k-mers routed to shard 1 of 4, as the all-to-all delivers them
    tc = tc[tv & (shard_of(tc, tsp) == 1)]
    rows = to_u32_bits(tc)
    rvalid = torch.from_numpy(_rvalid(pattern, rows.shape[0], rng))
    got = torch.zeros(1 << lb, dtype=torch.int32)
    off = 7
    pending = torch.full((off + rows.shape[0] + 3, rows.shape[1]), 3,
                         dtype=torch.int32)
    want_pend = pending.clone()
    count = bloom_insert_rows(got, rows, rvalid, tp, lb, pending, off)
    kept = rows[rvalid]
    want_pend[off:off + len(kept)] = kept
    assert torch.equal(pending, want_pend)
    assert int(count) == int(rvalid.sum())
    block, lp = blocks_lanepack(tp, tc)
    want = torch.zeros(1 << lb, dtype=torch.int32)
    insert_plain(want, block & ((1 << (lb - 7)) - 1), lp, rvalid,
                 tp.num_hashes)
    np.testing.assert_array_equal(n(got), n(want))
    jins = jax.jit(insert, static_argnums=0, static_argnames="local_bits")
    jwant = jins(jp, jnp.zeros(1 << lb, jnp.int32),
                 jnp.asarray(n(tc).astype(np.uint32)),
                 jnp.asarray(n(rvalid)), local_bits=lb)
    np.testing.assert_array_equal(n(got), np.asarray(jwant))
    assert (pattern == "none") == (int(n(got).sum()) == 0)


ROUTE_S, ROUTE_RANKS = 4, 4
ROUTE_CFG = dict(k=31, bloom_log2_width=LW)


@pytest.fixture(scope="module")
def routed(tmp_path_factory):
    """Each of 4 ranks' k-mers routed over a 1 x 4 gloo mesh at
    route_safety 1 (so the fair share overflows), and the JAX package's
    `_route` of the same rows on a (1, 4) mesh of its CPU devices."""
    tmp = tmp_path_factory.mktemp("route")
    k = ROUTE_CFG["k"]
    # each rank's 2,000 k-mers drawn from 24 distinct ones, 90 % valid: the
    # shards' loads are uneven, so some exceed the fair share
    reads, _ = reads_with_ns(40, 8, 31 + 23, k, n_rate=0)
    w, _ = extract_kmers(torch.from_numpy(reads[:1]), k)
    c, _ = canonical_words(w, k)
    pool = n(c.reshape(-1, c.shape[-1])).astype(np.uint32)
    rng = np.random.default_rng(41)
    canon = pool[rng.integers(0, len(pool), (ROUTE_RANKS, 2000))]
    valid = rng.random((ROUTE_RANKS, 2000)) < 0.9
    np.savez(tmp / "kmers.npz", canon=canon, valid=valid)
    run_mesh([((1, ROUTE_S), {
        "out": str(tmp), "steps": [{
            "kind": "route", "name": "route", "cfg": ROUTE_CFG,
            "route_safety": 1, "kmers": str(tmp / "kmers.npz")}]})], tmp)
    port = [dict(np.load(tmp / f"route_r{r}.npz"))
            for r in range(ROUTE_RANKS)]

    mesh = make_mesh(JMeshSpec(1, ROUTE_S))
    jsp = JShardedParams(_bloom_params(JConfig(**ROUTE_CFG), k), ROUTE_S,
                         route_safety=1)
    spec = P(("data", "bucket"))

    @jax.jit
    def jroute(c, v):
        def inner(cb, vb):
            recv, rvalid, ovf, _ = _route(cb, vb, jsp)
            return recv, rvalid, ovf[None]
        return shard_map(inner, mesh=mesh, in_specs=(spec, spec),
                         out_specs=(spec, spec, spec), check_vma=False)(c, v)

    sh = NamedSharding(mesh, spec)
    recv, rvalid, ovf = jroute(
        jax.device_put(jnp.asarray(canon.reshape(-1, canon.shape[-1])), sh),
        jax.device_put(jnp.asarray(valid.reshape(-1)), sh))
    per_rank = lambda a: np.split(np.asarray(a), ROUTE_RANKS)
    return port, canon, valid, list(zip(per_rank(recv), per_rank(rvalid),
                                        per_rank(ovf)))


def test_route_matches_jax(routed):
    """Each rank receives the JAX package's rows and valid flags, slot for
    slot, and counts its overflow as `_route` does."""
    port, _, _, jax_out = routed
    assert sum(int(p["overflow"]) for p in port) > 0
    for r, (p, (jrecv, jrvalid, jovf)) in enumerate(zip(port, jax_out)):
        assert int(p["overflow"]) == int(jovf[0]), r
        np.testing.assert_array_equal(p["rvalid"], jrvalid)
        np.testing.assert_array_equal(p["recv"], jrecv)
        assert len(p["recv"]) == recv_rows(
            ShardedParams(bloom_params(KmeraxConfig(**ROUTE_CFG), 31),
                          ROUTE_S, route_safety=1), len(p["sent"]))


def test_route_back_round_trip(routed):
    """route_back returns to each sender the value its k-mer's owner
    answered (here the k-mer's first word) for every k-mer that was routed,
    and 0 for a dropped or invalid one; the dropped ones are the
    overflow."""
    port, canon, valid, _ = routed
    for r, p in enumerate(port):
        sent = p["sent"]
        np.testing.assert_array_equal(
            p["back"], np.where(sent, canon[r][:, 0], 0))
        assert not (sent & ~valid[r]).any()
        assert int(sent.sum()) == int(valid[r].sum()) - int(p["overflow"])


def test_mesh_on_cuda_needs_its_devices(tmp_path):
    """A mesh on cuda with fewer cards than ranks raises the JAX package's
    message before any rank starts: it never falls back to gloo or the
    CPU; a mesh config outside a mesh process raises too."""
    have = torch.cuda.device_count()
    fq = tmp_path / "r.fastq"
    fq.write_bytes(b"@r\n" + b"ACGT" * 10 + b"\n+\n" + b"I" * 40 + b"\n")
    want = f"mesh 2x2 needs 4 devices, have {have}"
    if have >= 4:
        pytest.skip("four cards are present: the mesh runs there")
    with pytest.raises(ValueError, match=want):
        main(["pipeline", "--in", str(fq), "--out-fastq",
              str(tmp_path / "o.fastq"), "--device", "cuda", "--mesh-data",
              "2", "--mesh-bucket", "2"])
    with pytest.raises(ValueError, match=want):
        dmesh.launch(dmesh.MeshSpec(2, 2), "cuda", print)
    assert not (tmp_path / "o.fastq").exists()
    with pytest.raises(RuntimeError, match="not a rank of that mesh"):
        run_count(KmeraxConfig(mesh_data=2, mesh_bucket=2), [str(fq)],
                  device="cpu")


def test_bench_preset_on_mesh_not_ported(monkeypatch):
    """`bench --preset all` on a 1 x 2 mesh (ported now): count, correct
    and align time one device, e2e counts and corrects on two gloo ranks;
    the four JAX metric names in the JAX order, the e2e entry with rank
    0's stage walls and the ranks' start-up apart (`launch_s`)."""
    monkeypatch.setattr(t_runners.bench_e2e, "__defaults__", (640, 150))
    monkeypatch.setattr(dmesh, "LAUNCH_TIMEOUT", 300)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["bench", "--preset", "all", "--mesh-bucket", "2",
                     "--reads", "256", "--bloom-log2-width", "18",
                     "--batch-reads", "256", "--exact-capacity",
                     str(1 << 17), "--device", "cpu"]) == 0
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(res) == ["count", "correct", "align", "e2e"]
    assert [r["metric"] for r in res.values()] == [
        "kmers_per_s_per_chip_k31", "reads_per_s_per_chip_k31",
        "align_reads_per_s_per_chip_k31", "e2e_correct_reads_per_s_k31"]
    e2e = res["e2e"]
    assert e2e["launch_s"] > 0 and e2e["count_wall_s"] > 0
    assert e2e["value"] == 640 / e2e["correct_wall_s"]
    assert all("launch_s" not in res[p] for p in ("count", "correct",
                                                  "align"))


E2E_CFG = dict(k=31, bloom_log2_width=16, batch_reads=128,
               max_read_len=100, exact_capacity=1 << 16)


@pytest.fixture(scope="module")
def e2e_refs(tmp_path_factory):
    """A 600-read FASTQ and the JAX package's run_count + run_correct of it
    at 1 x 1, 1 x 2 and 2 x 1 (its 8 CPU devices): {mesh: bytes}."""
    d = tmp_path_factory.mktemp("e2e_mesh")
    _, reads = ecoli_like(seed=21, genome_len=3000, coverage=20,
                          read_len=100, error_rate=0.01)
    fq = d / "reads.fastq"
    fq.write_bytes(make_fastq(reads))
    refs = {}
    for mesh in ((1, 1), (1, 2), (2, 1)):
        cfg = JConfig(mesh_data=mesh[0], mesh_bucket=mesh[1], **E2E_CFG)
        out = d / f"j{mesh[0]}x{mesh[1]}.fastq"
        j_run_correct(cfg, [str(fq)], j_run_count(cfg, [str(fq)]), str(out))
        refs[mesh] = out.read_bytes()
    return fq, refs


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_bench_e2e_on_mesh_matches_jax(e2e_refs, tmp_path, monkeypatch,
                                       mesh):
    """The e2e preset's stages (`runners.e2e_stages`, what `bench_e2e`
    launches) on a D x S gloo mesh: the corrected FASTQ rank 0 wrote ==
    the JAX package's under the same mesh config == the port's 1 x 1 run
    (in process) == the JAX 1 x 1 run; edits were made. Exact."""
    monkeypatch.setattr(dmesh, "LAUNCH_TIMEOUT", 300)
    fq, refs = e2e_refs
    one = e2e_stages(KmeraxConfig(**E2E_CFG), str(fq),
                     str(tmp_path / "t1x1.fastq"), "cpu")
    cfg = KmeraxConfig(mesh_data=mesh[0], mesh_bucket=mesh[1], **E2E_CFG)
    walls = dmesh.launch(dmesh.MeshSpec(*mesh), "cpu", e2e_stages, cfg,
                         str(fq), str(tmp_path / "t.fastq"), "cpu")
    assert walls["count_wall_s"] > 0 and walls["correct_wall_s"] > 0
    assert one["count_wall_s"] > 0
    got = (tmp_path / "t.fastq").read_bytes()
    assert got == refs[mesh]
    assert got == (tmp_path / "t1x1.fastq").read_bytes()
    assert got == refs[(1, 1)]
    assert got != fq.read_bytes()


def test_bench_e2e_mesh_checks_cards_first():
    """`bench --preset all|e2e` on a mesh the cards cannot hold raises the
    JAX package's device-count error before any preset runs or any rank
    starts (never a fall-back to gloo or the CPU)."""
    have = torch.cuda.device_count()
    if have >= 2:
        pytest.skip("two cards are present: the mesh runs there")
    cfg = KmeraxConfig(mesh_bucket=2)
    for preset in ("all", "e2e"):
        with pytest.raises(ValueError,
                           match=f"mesh 1x2 needs 2 devices, have {have}"):
            run_preset(preset, cfg, device="cuda")
