"""The LM training record: three reference train steps on the two smoke
configs of the serving record, and the port's run of the same steps.

``src/repro_torch/data/reference/lm_train_smoke.npz`` holds, for
qwen2-0.5b and mamba2-130m at their ``SMOKE`` sizes in float32 dtypes
(`lm_record.record_config`), starting from the serving record's
``PRNGKey(0)`` weights (``lm_serve_smoke.npz``, not stored again), what
``repro.train.make_train_step`` (default AdamW and schedule) gives over
``STEPS`` steps on ``TokenPipeline(vocab, BATCH, SEQ)``'s batches 0, 1,
2: each step's ``loss``, ``ce``, ``grad_norm`` and ``lr``
(``{arch}:loss`` etc., (STEPS,)), and the parameters and AdamW moments
after the last step in the reference's stacked layout
(``{arch}:params/<path>``, ``{arch}:mu/<path>``, ``{arch}:nu/<path>``).
``tests/test_torch_reference_record_lm_train.py`` regenerates it from the
reference; `run_record` is the port's side, on the CPU in the tests and
on the card in ``chip_smoke.py``.

Tolerances (`compare`): ``loss``, ``ce`` and ``grad_norm`` within
``METRIC_RTOL`` relative, ``lr`` equal, each first-moment leaf within
``MOMENT_TOL`` of its largest magnitude and each second-moment leaf
within ``NU_TOL`` (twice that: ``nu`` is ``(1 - b2) g^2``, and a square
doubles its gradient's relative error), the parameters within
``PARAM_ATOL`` absolute, except where Adam's step is decided by rounding:
an element whose first moment (the running mean of its gradient) is
under ``SMALL_GRAD`` of its leaf's largest may move by up to lr the wrong
way a step, so it may differ by up to ``2 * sum(lr)``; such elements are
counted.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import (_leaves, lm_params_from_reference,
                       train_state_to_reference)
from ..data import PipelineConfig, TokenPipeline
from ..models import build_model
from ..train import init_state, make_train_step
from . import lm_record
from .lm_record import ARCHS, record_config

RECORD = lm_record.RECORD.with_name("lm_train_smoke.npz")
STEPS, BATCH, SEQ = 3, 2, 16
METRICS = ("loss", "ce", "grad_norm", "lr")
METRIC_RTOL = 1e-5
MOMENT_TOL = 1e-5
NU_TOL = 2 * MOMENT_TOL
PARAM_ATOL = 1e-6
SMALL_GRAD = 1e-4


def record_batches(cfg) -> list[np.ndarray]:
    pipe = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                        batch=BATCH, seq_len=SEQ))
    return [pipe.batch_at(t) for t in range(STEPS)]


def flatten(tree):
    """``(path, array)`` of a nested dict, paths ``/``-joined."""
    for path, leaf in _leaves(tree):
        yield "/".join(map(str, path)), np.asarray(leaf)


def load_record(path=RECORD, serve_path=lm_record.RECORD) -> dict:
    """{arch: {"init": the serving record's weights (a tree), "loss",
    "ce", "grad_norm", "lr": (STEPS,), "params", "mu", "nu": {path:
    array}}}."""
    serve = lm_record.load_record(serve_path)
    out = {arch: {"init": serve[arch]["params"], "params": {}, "mu": {},
                  "nu": {}} for arch in ARCHS}
    with np.load(path) as z:
        for key in z.files:
            arch, name = key.split(":", 1)
            if name in METRICS:
                out[arch][name] = z[key]
            else:
                kind, leaf = name.split("/", 1)
                out[arch][kind][leaf] = z[key]
    return out


def run_record(arch, init_tree, device) -> dict:
    """The port's ``STEPS`` train steps from the record's weights: the
    metrics (STEPS,) and the final parameters and moments as {path:
    array} in the reference's layout."""
    cfg = record_config(arch)
    model = build_model(cfg, device=device)
    lm_params_from_reference(model, init_tree)
    state = init_state(model)
    step = make_train_step(model)
    rows = {k: [] for k in METRICS}
    for toks in record_batches(cfg):
        state, m = step(state, {"tokens": torch.as_tensor(toks)})
        for k in METRICS:
            rows[k].append(float(m[k]))
    ref = train_state_to_reference(state)
    return {**{k: np.asarray(v, np.float32) for k, v in rows.items()},
            "params": dict(flatten(ref.params)), "mu": dict(flatten(ref.opt.mu)),
            "nu": dict(flatten(ref.opt.nu))}


def compare(rec, got) -> dict:
    """The port's run against the record: the largest relative metric
    error, ``lr`` equal, the largest moment error over its leaf's largest
    magnitude, and the parameters' largest absolute error outside and
    inside the small-gradient exception, with the exception's count and
    bound."""
    out = {f"{k}_rel": float(np.max(np.abs(got[k] - rec[k])
                                    / np.abs(rec[k])))
           for k in ("loss", "ce", "grad_norm")}
    out["lr_equal"] = bool(np.array_equal(got["lr"], rec["lr"]))
    for kind in ("mu", "nu"):
        out[f"{kind}_rel"] = max(
            float(np.abs(got[kind][p] - a).max() / max(np.abs(a).max(), 1e-30))
            for p, a in rec[kind].items())
    bound = 2.0 * float(np.sum(rec["lr"].astype(np.float64)))
    worst = worst_small = 0.0
    n_small = 0
    for p, a in rec["params"].items():
        diff = np.abs(got["params"][p].astype(np.float64) - a)
        mu = np.abs(rec["mu"][p])
        small = mu < SMALL_GRAD * mu.max()
        n_small += int(np.count_nonzero(small & (diff > PARAM_ATOL)))
        worst = max(worst, float(diff[~small].max(initial=0.0)))
        worst_small = max(worst_small, float(diff[small].max(initial=0.0)))
    out.update(params_abs=worst, params_small_grad_abs=worst_small,
               small_grad_elements_over_atol=n_small, small_grad_bound=bound)
    return out


def passes(res) -> bool:
    return (all(res[f"{k}_rel"] < METRIC_RTOL
                for k in ("loss", "ce", "grad_norm"))
            and res["lr_equal"]
            and res["mu_rel"] < MOMENT_TOL and res["nu_rel"] < NU_TOL
            and res["params_abs"] < PARAM_ATOL
            and res["params_small_grad_abs"] <= res["small_grad_bound"])
