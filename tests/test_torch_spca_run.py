"""Both launchers (``repro.launch.spca_run`` and its port) on the same
small corpus on the CPU print the same component lines, in the dense mode
and out of core (``--streaming``), where they also print the same pass
economics.

The ``gap=`` field is left out of the comparison: it is the KKT
certificate, which inverts a nearly singular float32 X (see the
conditioning caveat of ``repro.core.validate.kkt_gap``), so two LU
implementations give different gaps for the same X.
"""
import re
import sys

import pytest

from repro.launch import spca_run as jrun
from repro_torch.launch import spca_run as trun

ARGS = ["--docs", "2000", "--words", "3000", "--components", "2"]


def _pc_lines(text):
    lines = text.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if ln.startswith("PC"):
            out.append(re.sub(r" gap=\S+", "", ln))
            out.append(lines[i + 1])
    return out


def test_launchers_print_the_same_components(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["spca_run", *ARGS])
    jrun.main()
    want = _pc_lines(capsys.readouterr().out)
    trun.main([*ARGS, "--device", "cpu"])
    got = _pc_lines(capsys.readouterr().out)
    assert len(want) == 4
    assert got == want


@pytest.mark.parametrize("flag", [["--pass-deadline-s", "60"],
                                  ["--devices", "2"], ["--resume", "ckpt"],
                                  ["--export-port", "0"]])
def test_unported_launcher_flags_exit_with_roadmap_item(flag, capsys):
    with pytest.raises(SystemExit) as ei:
        trun.main([*ARGS, *flag])
    assert ei.value.code == 2
    assert "not ported yet: ROADMAP queue 1 item" in capsys.readouterr().err


def _ingest_lines(text):
    """The streaming mode's pass-economics lines, without timings/paths."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("corpus passes:"):
            out.append(ln)
        elif "out-of-core variance screen" in ln:
            out.append(re.sub(r"screen: \S+s", "screen:", ln))
        elif "wrote CSR store" in ln:
            out.append(ln.split(" MB at ")[0])
    return out


def test_streaming_launchers_agree(monkeypatch, capsys, tmp_path):
    """Several megabatches per pass and a ragged tail (chunk_nnz 2048 over
    ~175k nnz: 88 chunks, 11 launches a pass at megabatch 8)."""
    args = [*ARGS[:-1], "3", "--streaming", "--chunk-nnz", "2048"]
    monkeypatch.setattr(sys, "argv", ["spca_run", *args, "--store-dir",
                                      str(tmp_path / "ref")])
    jrun.main()
    jout = capsys.readouterr().out
    _, results, diag = trun.main([*args, "--device", "cpu", "--store-dir",
                                  str(tmp_path / "port")])
    tout = capsys.readouterr().out
    assert len(_pc_lines(jout)) == 6
    assert _pc_lines(tout) == _pc_lines(jout)
    assert _ingest_lines(tout) == _ingest_lines(jout)
    assert len(_ingest_lines(tout)) == 3
    assert diag["corpus_passes"] == 2
    ing = diag["ingest"]
    assert ing["screen_launches"] == ing["gram_launches"] == 11
    assert ing["chunks"] == 2 * 88
