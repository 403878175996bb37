"""The LM serving record: what the reference's serve loop gives on two
smoke configs, and the port's run of the same loop.

``src/repro_torch/data/reference/lm_serve_smoke.npz`` holds, for
qwen2-0.5b and mamba2-130m at their ``SMOKE`` sizes in float32 dtypes:
the reference's ``PRNGKey(0)`` weights (``{arch}:params/<path>``, stacked
leaves with their leading ``n_periods`` axis), a prompt of ``BATCH`` x
``PROMPT`` tokens from ``np.random.default_rng(0)``, the logits of each
prompt step of the decode loop (``{arch}:logits``, (B, PROMPT, V); the
first is the first step's) and the ``GEN`` greedy tokens of the steps
that follow, as ``launch/serve.py`` collects them (``{arch}:tokens``),
with a float32 cache.  ``tests/test_torch_reference_record_lm.py``
regenerates it from the reference; `run_record` is the port's side, on
the CPU in the tests and on the card in ``chip_smoke.py``.
"""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from ..configs import get_smoke_config
from ..convert import lm_params_from_reference
from ..models import build_model
from ..train import make_serve_step

RECORD = (pathlib.Path(__file__).resolve().parents[1] / "data" / "reference"
          / "lm_serve_smoke.npz")
ARCHS = ("qwen2-0.5b", "mamba2-130m")
BATCH, PROMPT, GEN = 2, 8, 8
F32_DTYPES = ("float32", "float32")
# the port's float32 logits against the reference's, times max |logits|
LOGITS_TOL = 1e-4


def record_config(arch):
    return get_smoke_config(arch).scaled(dtypes=F32_DTYPES)


def record_prompt(cfg) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab_size, size=(BATCH, PROMPT)).astype(
        np.int32)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, a in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    return tree


def load_record(path=RECORD) -> dict:
    """{arch: {"params": tree, "prompt", "logits", "tokens"}}."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            arch, name = key.split(":", 1)
            out.setdefault(arch, {"flat": {}})
            if name.startswith("params/"):
                out[arch]["flat"][name.removeprefix("params/")] = z[key]
            else:
                out[arch][name] = z[key]
    for rec in out.values():
        rec["params"] = _unflatten(rec.pop("flat"))
    return out


def run_record(arch, params_tree, prompt, device):
    """The port's serve loop on the record's weights and prompt: the
    logits of each prompt step (B, PROMPT, V) and the GEN greedy tokens,
    as numpy arrays."""
    model = build_model(record_config(arch), device=device)
    lm_params_from_reference(model, params_tree)
    serve = make_serve_step(model)
    toks = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                           device=model.device)
    cache = model.init_cache(BATCH, PROMPT + GEN + 1, dtype=torch.float32)
    logits = []
    for t in range(PROMPT):
        lg, cache = model.decode_step(cache, toks[:, t:t + 1])
        logits.append(lg)
    tok = torch.argmax(logits[-1], dim=-1)[:, None]
    out = []
    for _ in range(GEN):        # as the launcher: the prompt's token is fed
        cache, tok = serve(cache, tok)
        out.append(tok)
    return (torch.stack(logits, 1).cpu().numpy(),
            torch.cat(out, 1).cpu().numpy())


def compare(rec, logits, tokens) -> dict:
    """The port's run against the record: the largest logit difference
    over max |logits| and whether the greedy tokens are equal."""
    want = rec["logits"]
    return {"logits_err_rel": float(np.abs(logits - want).max()
                                    / np.abs(want).max()),
            "tokens_equal": bool(np.array_equal(tokens, rec["tokens"]))}
