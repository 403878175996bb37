"""Both launchers (``repro.launch.spca_run`` and its port) on the same
small corpus on the CPU print the same component lines.

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


@pytest.mark.parametrize("flag", [["--streaming"], ["--devices", "2"],
                                  ["--resume", "ckpt"],
                                  ["--export-port", "0"]])
def test_unported_launcher_flags_exit_with_roadmap_item(flag, capsys):
    with pytest.raises(SystemExit) as ei:
        trun.main([*ARGS, *flag])
    assert ei.value.code == 2
    assert "not ported yet: ROADMAP queue 1 item" in capsys.readouterr().err
