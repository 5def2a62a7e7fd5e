"""The 2-bit wire of kmerax_torch (io/wire.py) against the JAX package's
kmerax/io/wire.py, and the pipeline's bytes on both wires. Exact:
tolerance 0 (every output is an integer code or a byte)."""

import numpy as np
import pytest
import torch

from kmerax.io import wire as jw
from kmerax_torch.io import wire as tw
from sim import ecoli_like, make_fastq

from parity import reads_with_ns, run_clis


@pytest.mark.parametrize("L", [150, 151, 160, 161])
def test_wire_functions_match_jax(L):
    """Seeded batches with Ns, ragged lengths and 4-padding: the same
    packed bytes, unpacked rows (padding rebuilt as 4 from the lengths)
    and host codes as the JAX package, at L % 4 = 0, 1, 2 and 3."""
    reads, lengths = reads_with_ns(L, 96, L, 25)
    nfree = np.where(reads == 4, 0, reads).astype(np.int32)
    for i in range(len(nfree)):
        nfree[i, lengths[i]:] = 4
    assert tw.packed_cols(L) == jw.packed_cols(L) == -(-L // 4)
    assert tw.batch_has_n(reads, lengths) == jw.batch_has_n(reads, lengths)
    assert tw.batch_has_n(reads, lengths)
    assert not tw.batch_has_n(nfree, lengths)
    assert not jw.batch_has_n(nfree, lengths)
    for r in (reads, nfree):
        pj, pt = jw.pack2_host(r), tw.pack2_host(r)
        assert pt.dtype == pj.dtype == np.uint8
        np.testing.assert_array_equal(pt, pj)
        lt = torch.from_numpy(lengths)
        uj = np.asarray(jw.unpack2_dev(pj, lengths, L))
        ut = tw.unpack2_dev(torch.from_numpy(pt), lt, L).numpy()
        assert ut.dtype == uj.dtype == np.int8
        np.testing.assert_array_equal(ut, uj)
        # the JAX package's unpack to all 4 * cols columns is the port's
        # unpack2_dev at that width
        np.testing.assert_array_equal(
            tw.unpack2_dev(torch.from_numpy(pt), lt, 4 * pt.shape[1]).numpy(),
            np.asarray(jw.unpack2_dev_all(pj, lengths)))
        np.testing.assert_array_equal(tw.unpack2_host(pt, L),
                                      jw.unpack2_host(pj, L))
        for dtype in (np.int8, np.int32):
            a = np.asarray(jw.pack2_dev(r.astype(dtype)))
            b = tw.pack2_dev(torch.from_numpy(r.astype(dtype))).numpy()
            assert b.dtype == a.dtype == np.uint8
            np.testing.assert_array_equal(b, a)
    # an N-free batch round-trips to the int8 wire's rows exactly
    ut = tw.unpack2_dev(torch.from_numpy(tw.pack2_host(nfree)),
                        torch.from_numpy(lengths), L).numpy()
    np.testing.assert_array_equal(ut, nfree.astype(np.int8))
    back = tw.unpack2_host(tw.pack2_dev(torch.from_numpy(nfree)).numpy(), L)
    for i in range(len(nfree)):
        np.testing.assert_array_equal(back[i, :lengths[i]],
                                      nfree[i, :lengths[i]])


def _fastq_with_ns_and_ragged(path):
    """The wire golden's reads (tests/golden/test_wire_pipeline.py) with Ns
    in reads 0-2 (so the first 128-read batch crosses as int8) and reads
    200-219 cut to ragged lengths (so padding sits inside N-free batches)."""
    _, reads = ecoli_like(seed=77, genome_len=1500, coverage=30,
                          read_len=100, error_rate=0.008)
    lines = make_fastq(reads).decode().split("\n")
    for r in (0, 1, 2):
        s = list(lines[4 * r + 1])
        s[3] = "N"
        lines[4 * r + 1] = "".join(s)
    for r in range(200, 220):
        cut = 60 + 2 * (r - 200)
        lines[4 * r + 1] = lines[4 * r + 1][:cut]
        lines[4 * r + 3] = lines[4 * r + 3][:cut]
    path.write_text("\n".join(lines))


def test_pipeline_bytes_equal_on_both_wires(tmp_path, monkeypatch):
    """`pipeline` through the port's CLI with and without `--no-wire-pack`
    writes FASTQ and FASTA bytes equal to each other and to the JAX
    package's; the default run sent N-free batches packed and the
    N-carrying one as int8, the other run none packed. L = 102, so the
    last packed byte of a row holds padding bits."""
    fq = tmp_path / "reads.fastq"
    _fastq_with_ns_and_ragged(fq)
    wires = []
    real = tw.to_device_batch

    def spy(batch, device, pack=False, rows=None):
        out = real(batch, device, pack, rows)
        wires.append(out[2])
        return out

    monkeypatch.setattr(tw, "to_device_batch", spy)
    common = ["-k", "31", "--bloom-log2-width", "18", "--batch-reads", "128",
              "--max-read-len", "102", "--exact-capacity", str(1 << 17)]
    out = {}
    for tag, extra in (("packed", []), ("int8", ["--no-wire-pack"])):
        wires.clear()
        jres, tres = run_clis([
            "pipeline", "--in", str(fq), "--out-fastq",
            str(tmp_path / f"{{pkg}}_{tag}.fastq"), "--out-fasta",
            str(tmp_path / f"{{pkg}}_{tag}.fasta"), *common, *extra])
        assert tres == jres and jres["edited_reads"] > 0
        assert jres["unitigs"] > 0
        out[tag] = list(wires)
    # 4 batches in count, in correct, then in the re-count of the corrected
    # reads (whose Ns the corrector may have replaced)
    assert len(out["packed"]) == 12 and len(out["int8"]) == 12
    assert out["packed"][:8] == [False, True, True, True] * 2
    assert all(out["packed"][9:]) and not any(out["int8"])
    for ext in ("fastq", "fasta"):
        want = (tmp_path / f"j_packed.{ext}").read_bytes()
        for name in ("j_int8", "t_packed", "t_int8"):
            assert (tmp_path / f"{name}.{ext}").read_bytes() == want, name
