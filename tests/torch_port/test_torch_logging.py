"""The port's log lines (utils/logging.py) against the JAX package's
(kmerax/utils/logging.py): `HH:MM:SS L [hostN] name: message`, N from
KMERAX_PROCESS_INDEX (default 0), and in a mesh rank the host of that
rank (dist/mesh.py::_worker sets it)."""

import io
import logging
import os
import re

import pytest

import kmerax.utils.logging as j_logging
import kmerax_torch.utils.logging as t_logging
from kmerax_torch.dist import mesh as dmesh

from parity import log_probe

LINE = re.compile(r"^\d\d:\d\d:\d\d I \[host(\d+)\] ([\w.]+): (.*)$")


def _line(get_logger, name: str, msg: str) -> str:
    """One INFO line of `get_logger(name)`, caught from its handler."""
    log = get_logger(name)
    buf = io.StringIO()
    old = log.handlers[0].setStream(buf)
    try:
        log.info(msg)
    finally:
        log.handlers[0].setStream(old)
    return buf.getvalue().rstrip("\n")


@pytest.mark.parametrize("index", [None, "3"])
def test_host_prefix_matches_jax(monkeypatch, index):
    """With KMERAX_PROCESS_INDEX=3 the line says [host3], without it
    [host0]; the format is the JAX package's, and a line of the JAX logger
    made under the same environment reads the same apart from its name."""
    if index is None:
        monkeypatch.delenv("KMERAX_PROCESS_INDEX", raising=False)
    else:
        monkeypatch.setenv("KMERAX_PROCESS_INDEX", index)
    assert t_logging._FMT == j_logging._FMT
    tag = index or "0"
    got = _line(t_logging.get_logger, f"kmerax_torch.t{tag}", "hello")
    want = _line(j_logging.get_logger, f"kmerax.t{tag}", "hello")
    m = LINE.match(got)
    assert m and m.groups() == (tag, f"kmerax_torch.t{tag}", "hello"), got
    assert LINE.match(want).groups() == (tag, f"kmerax.t{tag}", "hello")


def test_host_read_when_formatted(monkeypatch):
    """A logger made before KMERAX_PROCESS_INDEX is set (as a rank's
    modules make theirs at import) tags each line with the value at the
    time of the line."""
    monkeypatch.delenv("KMERAX_PROCESS_INDEX", raising=False)
    t_logging.get_logger("kmerax_torch.late")
    assert LINE.match(_line(t_logging.get_logger, "kmerax_torch.late",
                            "a")).group(1) == "0"
    monkeypatch.setenv("KMERAX_PROCESS_INDEX", "5")
    assert LINE.match(_line(t_logging.get_logger, "kmerax_torch.late",
                            "b")).group(1) == "5"
    assert logging.getLogger("kmerax_torch.late").propagate is False


def test_two_host_launch_tags_each_rank(tmp_path, monkeypatch):
    """Two emulated hosts of a 2 x 2 mesh started by one launch (host=None,
    so the parent's environment is the same for both): rank r's line says
    [host r // 2], and the parent's environment is left as it was."""
    monkeypatch.delenv("KMERAX_PROCESS_INDEX", raising=False)
    monkeypatch.setattr(dmesh, "LAUNCH_TIMEOUT", 300)
    first = dmesh.launch(dmesh.MeshSpec(2, 2), "cpu", log_probe,
                         str(tmp_path), n_hosts=2, host=None)
    lines = [(tmp_path / f"log{r}.txt").read_text().rstrip("\n")
             for r in range(4)]
    assert first.rstrip("\n") == lines[0]
    for r, line in enumerate(lines):
        m = LINE.match(line)
        assert m and m.groups() == (str(r // 2), "kmerax_torch.probe",
                                    f"rank {r}"), line
    assert "KMERAX_PROCESS_INDEX" not in os.environ
