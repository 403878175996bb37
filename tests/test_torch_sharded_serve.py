"""The port's partitioned serve steps (``make_serve_step(model, mesh)``,
``make_prefill_step(model, mesh)``: `distributed.partition.ServePlan`
and `GroupPlan.layout`) against the reference's ``make_serve_step`` and
``make_prefill_step`` on the same ``PRNGKey(0)`` weights, for every
architecture's ``SMOKE`` config in float32 on CPU lanes.

Each case: 8 rows, a prompt of 16 tokens (numpy seed 1), a cache of 24
positions (the run fills it, so every lane's positions are read).  The reference's prefill gives the next tokens; its decode step
takes the prompt a token at a time, then its serve step 8 greedy tokens.
The port's partitioned steps take the same tokens (teacher-forced on the
reference's greedy tokens) on ``(2, 2)`` (attention by heads where the KV
heads divide 2, Mamba2 by head), ``(1, 4)`` (the sequence form where the
KV heads do not divide 4: each lane holds 6 of the 24 positions) and
``(2, 1)``.

Bars:
- every step's logits within 1e-4 of the largest |logit| over the prompt
  and the 8 steps; the greedy tokens and the prefill's tokens equal;
- the cache after the run (put together from its shards) within 1e-5 of
  the reference's;
- ``(2, 1)`` equal bit for bit (logits, tokens, cache) to the one-device
  steps run on each group's rows alone, for the configs without MoE.  A
  MoE config's decode routes over the whole batch, as the reference's
  does (its routing group of 8 tokens spans both groups), so one device
  on half the rows is not its semantics: it is held to the reference;
- at rest each lane holds exactly its shards of the cache
  (`sharding.shard_slices`), and the sequence split is real (a lane holds
  a quarter of the positions at ``(1, 4)``).

Besides: B = 1 on gemma3 at ``(2, 2)`` and jamba at ``(2, 4)`` (one
group; the cache's positions over every lane), mamba2-130m's bfloat16
conv state widened to float32 under float32 compute, a MoE decode whose
capacity binds (phi3.5-moe, 32 rows, ``capacity_factor`` 0.1: slots are
dropped), and a lane whose positions all lie after ``pos`` or outside the
window contributing exactly nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_parity import few_threads  # noqa: F401 (autouse)

from repro.configs import ARCH_NAMES, get_smoke_config as jsmoke
from repro.models import build_model as jbuild
from repro.train import make_prefill_step as jprefill
from repro.train import make_serve_step as jserve
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.convert import lm_params_from_reference
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model, layers as tl, moe as tmoe
from repro_torch.train import make_prefill_step, make_serve_step

F32 = ("float32", "float32")
ROWS, PROMPT, GEN, MAX_LEN = 8, 16, 8, 24
LOGITS_REL, CACHE_ATOL = 1e-4, 1e-5
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "2x1": (2, 1)}


@pytest.fixture(autouse=True)
def eight_lanes(monkeypatch):
    monkeypatch.setenv(tmesh.FORCE_LANES_ENV, "8")


def _batch(cfg, rows):
    rng = np.random.default_rng(1)
    b = {"tokens": rng.integers(0, cfg.vocab_size,
                                (rows, PROMPT)).astype(np.int32)}
    if cfg.num_patches:
        b["image_embeds"] = rng.normal(
            size=(rows, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        b["enc_frames"] = rng.normal(
            size=(rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _tb(b, rows=slice(None)):
    return {k: torch.from_numpy(v[rows]).long() if k == "tokens"
            else torch.from_numpy(v[rows]) for k, v in b.items()}


class _Ref:
    """The reference's run of one config: its weights, the prefill's
    tokens, every decode step's logits, the tokens fed at each step (the
    prompt, then its greedy tokens) and its cache after the run."""

    def __init__(self, arch, rows=ROWS, cache_dtype=F32[0], **over):
        self.arch, self.over, self.cache_dtype = arch, over, cache_dtype
        jm = jbuild(jsmoke(arch).scaled(dtypes=F32, **over))
        params = jm.init(jax.random.PRNGKey(0))
        self.tree = jax.tree.map(np.asarray, params)
        self.batch = _batch(jm.cfg, rows)
        jb = {k: jnp.asarray(v) for k, v in self.batch.items()}
        self.prefill = np.asarray(jax.jit(jprefill(jm))(params, jb))
        dt = jnp.dtype(cache_dtype)
        if jm.cfg.is_encoder_decoder:
            cache = jm.init_cache(params, jb, MAX_LEN, dtype=dt)
        else:
            cache = jm.init_cache(params, rows, MAX_LEN, dtype=dt)
        step, serve = jax.jit(jm.decode_step), jax.jit(jserve(jm))
        feed, logits = [], []
        toks = self.batch["tokens"]
        for t in range(PROMPT):
            feed.append(toks[:, t:t + 1])
            lg, cache = step(params, cache, jnp.asarray(feed[-1]))
            logits.append(np.asarray(lg))
        nxt = np.asarray(jnp.argmax(lg, -1).astype(jnp.int32))[:, None]
        greedy = []
        for _ in range(GEN):
            feed.append(nxt)
            lg, _ = step(params, cache, jnp.asarray(nxt))
            logits.append(np.asarray(lg))
            cache, nxt = serve(params, cache, jnp.asarray(nxt))
            nxt = np.asarray(nxt)
            greedy.append(nxt)
        self.feed, self.logits = feed, np.stack(logits, 1)
        self.greedy = np.concatenate(greedy, 1)
        self.cache = jax.tree.map(np.asarray, cache)

    def port(self):
        m = build_model(tsmoke(self.arch).scaled(dtypes=F32, **self.over),
                        device="cpu")
        return lm_params_from_reference(m, self.tree)


@pytest.fixture(scope="module")
def refs():
    return {}


def _ref(refs, arch, **kw):
    key = (arch, tuple(sorted(kw.items())))
    if key not in refs:
        refs[key] = _Ref(arch, **kw)
    return refs[key]


def _run(ref, mesh=None, rows=slice(None)):
    """The port's prefill tokens, each step's logits and greedy tokens
    (teacher-forced on the reference's feed), and its cache, for rows
    ``rows``; partitioned over ``mesh`` if given."""
    m = ref.port()
    batch = _tb(ref.batch, rows)
    B = batch["tokens"].shape[0]
    dt = getattr(torch, ref.cache_dtype)
    cache = (m.init_cache(batch, MAX_LEN, dtype=dt)
             if m.cfg.is_encoder_decoder
             else m.init_cache(B, MAX_LEN, dtype=dt))
    if mesh is None:
        pre = make_prefill_step(m)(batch)

        def step(c, t):
            lg, c = m.decode_step(c, t)
            return c, torch.argmax(lg, -1)[:, None], lg
    else:
        pre = make_prefill_step(m, mesh)(batch)
        serve = make_serve_step(m, mesh)

        def step(c, t):
            return serve(c, t, logits=True)
    logits, greedy = [], []
    for t, tok in enumerate(ref.feed):
        cache, nxt, lg = step(cache, torch.tensor(tok[rows]).long())
        logits.append(lg)
        if t >= PROMPT:
            greedy.append(nxt)
    return pre, torch.stack(logits, 1), torch.cat(greedy, 1), cache


def _cache_leaves(port, ref, path=()):
    """``(path, port leaf as numpy, reference leaf)`` of every cache
    tensor: the port's per-period list against the reference's leaf
    stacked along its periods."""
    if isinstance(port, dict):
        for k, v in port.items():
            if k != "pos":
                yield from _cache_leaves(v, ref[k], path + (k,))
    elif isinstance(port, list):
        for n, period in enumerate(port):
            yield from _cache_leaves(period, jax.tree.map(
                lambda a, n=n: a[n], ref), path + (str(n),))
    else:
        yield "/".join(path), sh.whole(port).numpy(), np.asarray(ref)


def _against_reference(ref, got):
    pre, logits, greedy, cache = got
    assert np.array_equal(pre.numpy(), ref.prefill)
    scale = float(np.abs(ref.logits).max())
    err = float(np.abs(logits.numpy() - ref.logits).max())
    assert err <= LOGITS_REL * scale, (err, scale)
    assert np.array_equal(greedy.numpy(), ref.greedy)
    assert cache["pos"] == PROMPT + GEN
    worst = max(float(np.abs(a - b).max())
                for _, a, b in _cache_leaves(cache, ref.cache))
    assert worst <= CACHE_ATOL, worst


def _mesh(shape):
    return tmesh.make_dev_mesh(shape, ("data", "model"), device="cpu")


@pytest.mark.parametrize("shape", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_partitioned_serve_matches_reference(refs, arch, shape):
    ref = _ref(refs, arch)
    mesh = _mesh(MESHES[shape])
    got = _run(ref, mesh)
    _against_reference(ref, got)
    # the cache at rest: each lane exactly its shards
    for _, leaf in _sharded(got[3]):
        for i, t in enumerate(leaf.shards):
            assert tuple(t.shape) == sh.shard_shape(leaf.shape, mesh,
                                                    leaf.spec)
            want = sh.whole(leaf)[sh.shard_slices(leaf.shape, mesh,
                                                  leaf.spec, i)]
            assert torch.equal(t, want)
    if shape == "1x4" and tsmoke(arch).n_kv_heads % 4 and not \
            tsmoke(arch).is_encoder_decoder:
        ks = [leaf for path, leaf in _sharded(got[3])
              if path.endswith("mixer/k")]
        assert ks and all(tuple(k.shards[0].shape)[1] == MAX_LEN // 4
                          for k in ks)


def _sharded(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _sharded(v, path + (k,))
    elif isinstance(tree, list):
        for n, v in enumerate(tree):
            yield from _sharded(v, path + (str(n),))
    elif isinstance(tree, sh.Sharded):
        yield "/".join(path), tree


NO_MOE = [a for a in ARCH_NAMES if not tsmoke(a).n_experts]


@pytest.mark.parametrize("arch", NO_MOE)
def test_data_mesh_serve_equals_one_device_on_each_group(refs, arch):
    """``(2, 1)``: each group's rows through the one-device steps alone,
    bit for bit (prefill tokens, logits, greedy tokens, cache)."""
    ref = _ref(refs, arch)
    got = _run(ref, _mesh((2, 1)))
    halves = [_run(ref, None, slice(0, ROWS // 2)),
              _run(ref, None, slice(ROWS // 2, ROWS))]
    assert torch.equal(got[0], torch.cat([h[0] for h in halves]))
    assert torch.equal(got[1], torch.cat([h[1] for h in halves]))
    assert torch.equal(got[2], torch.cat([h[2] for h in halves]))
    for (p, a, _), (_, b, _), (_, c, _) in zip(
            _cache_leaves(got[3], ref.cache),
            _cache_leaves(halves[0][3], ref.cache),
            _cache_leaves(halves[1][3], ref.cache)):
        assert np.array_equal(a, np.concatenate([b, c])), p


@pytest.mark.parametrize("arch,shape", [("gemma3-27b", (2, 2)),
                                        ("jamba-v0.1-52b", (2, 4))])
def test_batch_of_one_splits_the_cache_positions(refs, arch, shape):
    """B = 1: one group, the cache's positions over ``data`` (and over
    ``model`` too where the KV heads do not divide it): against the
    reference's B = 1 run."""
    ref = _ref(refs, arch, rows=1)
    mesh = _mesh(shape)
    got = _run(ref, mesh)
    _against_reference(ref, got)
    ks = [leaf for path, leaf in _sharded(got[3]) if path.endswith("mixer/k")]
    lanes = shape[0] * (shape[1] if tsmoke(arch).n_kv_heads % shape[1]
                        else 1)
    assert ks and all(k.shards[0].shape[1] == MAX_LEN // lanes for k in ks)


def test_bfloat16_conv_state_widens_under_float32_compute(refs):
    """mamba2-130m at ``(2, 2)``, float32 compute on a bfloat16 cache: a
    Mamba2 step's conv window takes the wider dtype, as the reference's
    new cache is its step's output, so after the first step every shard
    of the conv state is float32, and the run matches the reference's on
    the same bfloat16 cache."""
    ref = _ref(refs, "mamba2-130m", cache_dtype="bfloat16")
    got = _run(ref, _mesh((2, 2)))
    _against_reference(ref, got)
    convs = [leaf for path, leaf in _sharded(got[3])
             if path.endswith("mixer/conv")]
    assert convs and all(c.dtype == torch.float32 and all(
        t.dtype == torch.float32 for t in c.shards) for c in convs)


def test_moe_decode_with_binding_capacity(refs, monkeypatch):
    """phi3.5-moe, 32 rows, capacity factor 0.1 (8 slots an expert for 64
    choices): the decode's routing group of 32 tokens spans both data
    groups at ``(2, 2)``, its slots are assigned over the pooled group
    (some choices dropped), and the run matches the reference's."""
    ref = _ref(refs, "phi3.5-moe-42b-a6.6b", rows=32, capacity_factor=0.1)
    dropped = []
    slots = tmoe.slots

    def record(idx, cfg, C):
        out = slots(idx, cfg, C)
        dropped.append(int((~out[1]).sum()))
        return out

    monkeypatch.setattr(tmoe, "slots", record)
    _against_reference(ref, _run(ref, _mesh((2, 2))))
    assert dropped and max(dropped) > 0


def test_lane_without_valid_keys_adds_nothing():
    """A lane whose positions all lie after ``pos`` (and one whose
    positions lie outside the window) gives ``(-inf, 0, 0)``: finite, and
    the combine with it equals the combine without it, bit for bit."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 2, 2, 16, generator=g)
    k = torch.randn(2, 32, 2, 16, generator=g)
    v = torch.randn(2, 32, 2, 16, generator=g)
    pos = 12
    own = tl.decode_partial(q, k[:, 8:16], v[:, 8:16], s0=8, pos=pos)
    early = tl.decode_partial(q, k[:, :8], v[:, :8], s0=0, pos=pos)
    late = tl.decode_partial(q, k[:, 16:24], v[:, 16:24], s0=16, pos=pos)
    far = tl.decode_partial(q, k[:, :8], v[:, :8], s0=0, pos=pos, window=4)
    for m, l, acc in (late, far):
        assert torch.all(m == -torch.inf)
        assert torch.equal(l, torch.zeros_like(l))
        assert torch.equal(acc, torch.zeros_like(acc))
    whole = tl.combine_partials([early, own], torch.float32)
    assert torch.isfinite(whole).all()
    assert torch.equal(tl.combine_partials([early, own, late],
                                           torch.float32), whole)
    assert torch.equal(tl.combine_partials([late, early, own],
                                           torch.float32),
                       tl.combine_partials([early, own], torch.float32))
    windowed = tl.combine_partials(
        [far, tl.decode_partial(q, k[:, 8:16], v[:, 8:16], s0=8, pos=pos,
                                window=4)], torch.float32)
    assert torch.isfinite(windowed).all()
    # against the one-device softmax over the valid keys
    s = torch.einsum("bqkrd,bskd->bkrqs", q, k[:, :pos + 1]) * 16 ** -0.5
    want = torch.einsum("bkrqs,bskd->bqkrd", torch.softmax(s, -1),
                        v[:, :pos + 1])
    assert float((whole - want).abs().max()) < 1e-5
