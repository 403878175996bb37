"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU:
for every architecture's ``--smoke`` config it prints the reference
launcher's two lines, ``generated (B, gen) in T s (R tok/s)`` and the
first 16 generated tokens of each sequence, as a (B, min(gen, 16)) array
of in-vocabulary ids.  The tokens themselves differ from the reference's
where the weights do (``torch.Generator`` seed 0 against
``PRNGKey(0)``)."""
import re
import sys

import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.device import DeviceUnavailable
from repro_torch.launch import serve as tserve

FIRST = re.compile(r"^generated \((\d+), (\d+)\) in \d+\.\d\ds "
                   r"\(\d+\.\d tok/s\)$")


def _shape(out):
    """(the first line's (B, gen), the token array's rows of ids)."""
    lines = out.strip().splitlines()
    m = FIRST.match(lines[0])
    assert m, lines[0]
    rows = [[int(t) for t in re.findall(r"\d+", ln)] for ln in lines[1:]]
    return (int(m.group(1)), int(m.group(2))), rows


def test_reference_line_shapes(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen2-0.5b",
                                      "--smoke", "--gen", "20"])
    jserve.main()
    (bg, rows) = _shape(capsys.readouterr().out)
    tserve.main(["--arch", "qwen2-0.5b", "--smoke", "--gen", "20",
                 "--device", "cpu"])
    (tbg, trows) = _shape(capsys.readouterr().out)
    assert bg == tbg == (4, 20)
    assert [len(r) for r in rows] == [len(r) for r in trows] == [16] * 4


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_port_launcher_smoke(arch, capsys):
    """The launcher's defaults: batch 4, prompt 16, 32 generated."""
    res = tserve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    (bg, rows) = _shape(capsys.readouterr().out)
    assert bg == (4, 32)
    assert res["tokens"].shape == (4, 32)
    assert np.array_equal(np.array(rows), res["tokens"][:, :16])
    vocab = get_smoke_config(arch).vocab_size
    assert res["tokens"].min() >= 0 and res["tokens"].max() < vocab
    assert res["decode_s"] > 0 and res["prefill_s"] > 0


def test_port_launcher_is_deterministic(capsys):
    args = ["--arch", "mamba2-130m", "--smoke", "--device", "cpu"]
    a = tserve.main(args)["tokens"]
    b = tserve.main(args)["tokens"]
    assert np.array_equal(a, b)


def test_port_launcher_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        tserve.main(["--arch", "qwen2-0.5b", "--smoke"])
