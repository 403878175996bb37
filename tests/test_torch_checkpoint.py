"""The port's checkpoint format (``repro_torch.checkpoint``): the cases of
the reference's ``tests/test_checkpoint.py`` (its trainer case,
``test_trainer_resume_exact``, and the trainer's checkpoints crossing
packages are in ``tests/test_torch_trainer.py``), and checkpoints saved by
one package restored by the other, both ways, with byte-identical
``manifest.json`` and the same npz members in the same order with equal
dtypes, shapes and values: nested dicts, lists and tuples, and a training
state (``TrainState(params, opt=OptState(mu, nu, count), step)``, whose
NamedTuple fields jax keys ``.params``, ``.opt/.count``).

The npz bytes themselves are not compared: ``np.savez`` stamps each zip
member with the current time, so two saves by the same package differ.
One difference from the reference: a stored shape that differs from the
expected one raises ValueError here (the reference asserts).
"""
import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro_torch.checkpoint import checkpoint as ck


def _tree():
    return {
        "a": torch.arange(12.0, dtype=torch.float64).reshape(3, 4),
        "nested": {"b": torch.ones((2,), dtype=torch.int32),
                   "c": torch.zeros((), dtype=torch.float64)},
    }


def _np_tree():
    """The same leaves as numpy arrays, in a tree with lists and tuples."""
    return {
        "z": np.arange(6, dtype=np.float32).reshape(2, 3),
        "m": [np.int64(3), (np.ones(4, np.uint8), np.full((1, 2), 0.5))],
        "a": {"y": np.asarray(7, np.int32), "x": np.linspace(0, 1, 5)},
    }


def test_roundtrip(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 5, t)
    assert ck.latest_step(str(tmp_path)) == 5
    r = ck.restore(str(tmp_path), 5, t)
    assert list(r) == list(t) and list(r["nested"]) == list(t["nested"])
    for a, b in ((t["a"], r["a"]), (t["nested"]["b"], r["nested"]["b"]),
                 (t["nested"]["c"], r["nested"]["c"])):
        assert b.dtype == a.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)


def test_restore_keeps_structure_and_places_on_device(tmp_path):
    t = _np_tree()
    ck.save(str(tmp_path), 1, t)
    r = ck.restore(str(tmp_path), 1, t, device="cpu")
    assert isinstance(r["m"], list) and isinstance(r["m"][1], tuple)
    np.testing.assert_array_equal(r["m"][1][1].numpy(), t["m"][1][1])
    assert r["a"]["y"].shape == () and r["a"]["y"].dtype == torch.int32


def test_atomicity_tmp_never_visible(tmp_path):
    ck.save(str(tmp_path), 1, _tree())
    # a stale .tmp dir must not be picked up as a checkpoint
    os.makedirs(tmp_path / "step_000000002.tmp")
    assert ck.latest_step(str(tmp_path)) == 1


def test_incomplete_manifest_ignored(tmp_path):
    ck.save(str(tmp_path), 1, _tree())
    d = tmp_path / "step_000000009"
    os.makedirs(d)
    with open(d / "manifest.json", "w") as f:
        json.dump({"step": 9, "complete": False, "leaves": {}}, f)
    assert ck.latest_step(str(tmp_path)) == 1


def test_prune_keeps_newest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, _tree())
    ck.prune(str(tmp_path), keep=2)
    assert ck.latest_step(str(tmp_path)) == 5
    assert not os.path.exists(tmp_path / "step_000000001")
    assert os.path.exists(tmp_path / "step_000000004")


def test_truncated_manifest_ignored_by_latest_step(tmp_path):
    ck.save(str(tmp_path), 1, _tree())
    ck.save(str(tmp_path), 2, _tree())
    mf = tmp_path / "step_000000002" / "manifest.json"
    raw = mf.read_bytes()
    mf.write_bytes(raw[: len(raw) // 2])
    assert ck.latest_step(str(tmp_path)) == 1


def test_missing_npz_ignored_by_latest_step(tmp_path):
    ck.save(str(tmp_path), 1, _tree())
    ck.save(str(tmp_path), 3, _tree())
    os.remove(tmp_path / "step_000000003" / ck.DATA_NAME)
    assert ck.latest_step(str(tmp_path)) == 1


def test_prune_survives_crash_debris(tmp_path):
    for s in (1, 2, 3):
        ck.save(str(tmp_path), s, _tree())
    os.makedirs(tmp_path / "step_000000004.tmp")
    os.makedirs(tmp_path / "step_garbage")
    (tmp_path / "step_").mkdir()
    (tmp_path / "notes.txt").write_text("x")
    ck.prune(str(tmp_path), keep=2)
    assert ck.latest_step(str(tmp_path)) == 3
    assert not os.path.exists(tmp_path / "step_000000001")
    assert os.path.exists(tmp_path / "step_000000002")
    assert os.path.exists(tmp_path / "step_garbage")
    assert os.path.exists(tmp_path / "step_000000004.tmp")


def test_restore_corrupt_step_raises_clear_error(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 1, t)
    npz = tmp_path / "step_000000001" / ck.DATA_NAME
    raw = npz.read_bytes()
    npz.write_bytes(raw[: len(raw) // 3])
    with pytest.raises(RuntimeError, match="corrupt or missing"):
        ck.restore(str(tmp_path), 1, t)
    with pytest.raises(RuntimeError, match="corrupt or missing"):
        ck.restore(str(tmp_path), 7, t)  # absent


def test_shape_mismatch_raises(tmp_path):
    ck.save(str(tmp_path), 1, {"a": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(str(tmp_path), 1, {"a": torch.empty(3)})


def _same_npz(dir_a, dir_b):
    with np.load(os.path.join(dir_a, ck.DATA_NAME)) as a, \
            np.load(os.path.join(dir_b, ck.DATA_NAME)) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_written_by_one_package_restores_in_the_other(tmp_path,
                                                                  writer):
    t = _np_tree()
    jt = jax.tree.map(jnp.asarray, t)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    d_ref = jck.save(ref_dir, 4, jt)
    d_port = ck.save(port_dir, 4, t)
    # byte-identical manifests, the same npz members in the same order
    assert (open(os.path.join(d_ref, "manifest.json")).read()
            == open(os.path.join(d_port, "manifest.json")).read())
    _same_npz(d_ref, d_port)
    if writer == "reference":
        assert ck.latest_step(ref_dir) == 4
        got = ck.restore(ref_dir, 4, t)
        pairs = zip(jax.tree.leaves(t), jax.tree.leaves(
            jax.tree.map(lambda x: x.numpy(), got)))
    else:
        assert jck.latest_step(port_dir) == 4
        got = jck.restore(port_dir, 4, jax.eval_shape(lambda: jt))
        pairs = zip(jax.tree.leaves(t), jax.tree.leaves(got))
    for want, have in pairs:
        have = np.asarray(have)
        assert have.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(have, want)


class _Pair(NamedTuple):
    b: object
    a: object


def test_namedtuple_fields_are_keyed_like_jax(tmp_path):
    t = {"x": _Pair(b=np.ones(2, np.float32), a=[np.zeros(3), (np.int32(4),)])}
    flat = ck._flatten(t)
    want, _ = jax.tree_util.tree_flatten_with_path(t)
    assert list(flat) == ["/".join(str(getattr(k, "key", getattr(
        k, "idx", k))) for k in path) for path, _ in want]
    assert list(flat) == ["x/.b", "x/.a/0", "x/.a/1/0"]
    ck.save(str(tmp_path), 1, t)
    r = ck.restore(str(tmp_path), 1, t)
    assert type(r["x"]) is _Pair and isinstance(r["x"].a, list)
    assert isinstance(r["x"].a[1], tuple) and r["x"].a[1][0].dtype == torch.int32
    np.testing.assert_array_equal(r["x"].b.numpy(), t["x"].b)


_TINY = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
             n_kv_heads=2, d_ff=64, vocab_size=128,
             dtypes=("float32", "float32"))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_train_state_written_by_one_package_restores_in_the_other(tmp_path,
                                                                  writer):
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import build_model as jbuild
    from repro.train import init_state as jinit, make_train_step
    from repro_torch.configs.base import ModelConfig
    from repro_torch.convert import (
        train_state_from_reference, train_state_to_reference,
    )
    from repro_torch.models import build_model

    jm = jbuild(JModelConfig(**_TINY))
    toks = np.random.default_rng(0).integers(0, 128, (2, 8)).astype(np.int32)
    state = jinit(jm, jax.random.PRNGKey(0))
    state, _ = jax.jit(make_train_step(jm))(state, {"tokens": jnp.asarray(toks)})
    jnp_state = jax.tree.map(np.asarray, state)
    model = build_model(ModelConfig(**_TINY), device="cpu")
    tstate = train_state_from_reference(model, jnp_state)
    assert int(tstate.step) == 1 and int(tstate.opt.count) == 1

    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    d_ref = jck.save(ref_dir, 1, state)
    d_port = ck.save(port_dir, 1, train_state_to_reference(tstate))
    manifest = open(os.path.join(d_ref, "manifest.json")).read()
    assert manifest == open(os.path.join(d_port, "manifest.json")).read()
    keys = list(json.loads(manifest)["leaves"])
    assert keys[0] == ".params/embed" and keys[-2:] == [".opt/.count", ".step"]
    assert ".opt/.mu/stacks/s0/b0/mixer_attn/wq" in keys
    _same_npz(d_ref, d_port)
    if writer == "reference":
        like = train_state_to_reference(tstate, like=True)
        got = train_state_from_reference(
            build_model(ModelConfig(**_TINY), device="cpu",
                        generator=torch.Generator().manual_seed(1)),
            ck.restore(ref_dir, 1, like))
        got = jax.tree.map(np.asarray, train_state_to_reference(got))
    else:
        got = jck.restore(port_dir, 1, jax.eval_shape(lambda: state))
    want = jax.tree_util.tree_leaves_with_path(jnp_state)
    have = jax.tree_util.tree_leaves_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in have] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (path, a), (_, b) in zip(have, want):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)
