"""Public model API (the port of ``repro.models.model``):
``build_model(cfg) -> LM | EncDec``, each a `nn.Module` that owns its
parameters.

  model             = build_model(cfg, device=..., generator=...)
  logits, aux       = model.forward(batch)           # train/prefill path
  loss, metrics     = model.loss(batch[, layout=])
  cache             = model.init_cache(batch_size | batch, max_len, dtype)
  logits, cache     = model.decode_step(cache, last_tokens[, layout=])

Batches are dicts: {"tokens"} (LM), +{"image_embeds"} (VLM, stub frontend),
{"tokens", "enc_frames"} (whisper, stub conv frontend).

The parameters are held in ``cfg.param_dtype``; the forward passes run on
a copy in ``cfg.compute_dtype`` (`cast_params`).  Without autograd that
copy is made once and kept with the model (`compute_params`), since the
eager forward would otherwise copy every weight at every decode step;
moving the model or loading weights drops it, and `refresh` drops it after
weights were changed in place.  With autograd on, the cast is made afresh
each call, so gradients reach the parameters.

A `Layout` says where a forward pass takes its weights from and how it
runs its embedding and loss: by default the model's own compute-dtype
copy on its device; the partitioned steps pass their own to `loss` and
`decode_step` (`distributed.partition`), so one forward and one decode
serve every step.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve
from .layers import (
    F32, embed, init_embed, init_rms_norm, normal, param_tree, rms_norm,
    unembed,
)
from .transformer import (
    ZERO_AUX, StackSpec, _acc_aux, init_stack, init_stack_cache, run_stack,
)

# the subtrees whose every leaf the reference stacks along n_periods
_STACKED = ("stacks", "enc_stack")


def cast_params(params, cfg):
    """float32 leaves -> compute dtype, by the reference's rule as it acts
    on the reference's tree: a float32 leaf of 2 or more dimensions is
    cast, others are kept.  The reference stacks every block parameter
    along a leading ``n_periods`` axis, so inside ``stacks`` and
    ``enc_stack`` every float32 leaf (norm scales, biases, ``A_log``,
    ``dt_bias``, ``ssm_D`` too) counts one dimension more and is cast;
    only the top-level 1-D leaves (``final_norm``, ``enc_norm``) stay
    float32."""
    def walk(node, stacked):
        if isinstance(node, dict):
            return {k: walk(v, stacked or k in _STACKED)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, stacked) for v in node]
        if node.dtype == F32 and node.ndim + int(stacked) >= 2:
            return node.to(cfg.compute_dtype)
        return node

    return walk(params, False)


def softmax_xent(logits, labels):
    """Mean next-token cross entropy in f32."""
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - ll)


def total_loss(cfg, ce, aux):
    """A decoder's loss: the cross entropy plus the weighted MoE
    load-balancing and router z losses of ``aux``."""
    return (ce + cfg.moe_aux_weight * aux["moe_lb_loss"]
            + cfg.moe_zloss_weight * aux["moe_z_loss"])


def param_count(params) -> int:
    """Parameters of a model (a `nn.Module`) or of a tree of tensors."""
    if isinstance(params, nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return int(math.prod(params.shape))


class Layout:
    """One forward pass's weights on the model's device: its
    compute-dtype copy (`_Model.compute_params`).  The partitioned train
    step's layout (`distributed.partition`) has the same members:

    ``device``; ``stack_kw``, `run_stack`'s keywords beyond the model's;
    ``leaf(name)``, a top-level leaf (``pos_embed``); ``stack(name,
    seq)``, the periods of stack ``name`` (``enc_stack`` or ``s{i}``) as
    `run_stack` takes them, ``seq`` its query length; ``embed(tokens)``;
    ``split(x)``, a stack's input ``(B, S, d)`` as the pass holds its
    hidden state between blocks (here: as it is; the partitioned step
    under ``cfg.seq_parallel``: row blocks on the lanes); ``norm(name,
    x)``, the RMS norm of a hidden state by the top-level scale ``name``
    (``final_norm``, ``enc_norm``); ``xent(xf, window, labels)``, the mean
    cross entropy of rows ``window`` of the head's logits of the normed
    hidden states ``xf``; ``logits(xf)``, the head's logits; ``last(xf)``,
    the last position of ``xf``."""

    stack_kw: dict = {}

    def __init__(self, model):
        self.cfg = model.cfg
        self.device = model.device
        self.p = model.compute_params()

    def leaf(self, name):
        return self.p[name]

    def stack(self, name, seq):
        return self.p[name] if name == "enc_stack" else self.p["stacks"][name]

    def embed(self, tokens):
        return embed(self.p["embed"], tokens, self.cfg)

    def logits(self, xf):
        cfg = self.cfg
        tied = cfg.tie_embeddings and not cfg.is_encoder_decoder
        return unembed(self.p["embed"] if tied else self.p["lm_head"], xf,
                       cfg, tied=tied)

    def split(self, x):
        return x

    def norm(self, name, x):
        return rms_norm(self.p[name], x, eps=self.cfg.norm_eps)

    def last(self, xf):
        return xf[:, -1:]

    def xent(self, xf, window, labels):
        return softmax_xent(self.logits(xf)[:, window[0]:window[1], :],
                            labels)


class _Model(nn.Module):
    """What `LM` and `EncDec` share: the parameter tree and its cached
    compute-dtype copy."""

    def _init_common(self, cfg, device, generator):
        self.cfg = cfg.validate()
        self._compute = None
        self._released = None
        meta = device is not None and torch.device(device).type == "meta"
        return (torch.device("meta") if meta else resolve(device),
                generator if generator is not None
                else torch.Generator().manual_seed(0))

    def params(self):
        """The parameters as the reference's nested dict (stacks as lists
        over periods)."""
        return param_tree(self)

    def compute_params(self):
        """The parameters in the compute dtype (`cast_params`): made once
        and kept while autograd is off, made afresh while it is on."""
        if torch.is_grad_enabled():
            return cast_params(self.params(), self.cfg)
        if self._compute is None:
            self._compute = cast_params(self.params(), self.cfg)
        return self._compute

    def refresh(self):
        """Drop the compute-dtype copy (after weights changed in place)."""
        self._compute = None

    def release(self):
        """Move the parameters to ``meta`` (shapes, no storage): the
        sharded train step holds them as shards on its lanes and calls
        this once it has sharded them, so no lane keeps a whole copy."""
        if self.device.type != "meta":
            self._released = self.device
            self.to("meta")

    def reclaim(self):
        """Undo `release`: storage (uninitialised) on the old device, for
        weights to be copied in (the trainer's restore)."""
        if self._released is not None:
            self.to_empty(device=self._released)
            self._released = None

    def _apply(self, fn, *args, **kwargs):
        self._compute = None
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._compute = None
        return super().load_state_dict(*args, **kwargs)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _decode(self, lay, cache, last_tokens):
        """One decode step through layout ``lay``: the normed hidden state
        (B, 1, d) and the new cache."""
        cfg = self.cfg
        x = lay.embed(last_tokens.to(lay.device))
        positions = torch.full((1, 1), cache["pos"], dtype=torch.int64,
                               device=lay.device)
        new_stacks = {}
        for i, st in enumerate(self.stack_specs):
            x, _, nc = run_stack(
                lay.stack(f"s{i}", 1), x, st, cfg, positions=positions,
                caches=cache["stacks"][f"s{i}"], decode=True, **lay.stack_kw,
            )
            new_stacks[f"s{i}"] = nc
        return (lay.norm("final_norm", x),
                {"stacks": new_stacks, "pos": cache["pos"] + 1})

    @torch.no_grad()
    def decode_step(self, cache, last_tokens, layout=Layout):
        """last_tokens: (B, 1) integers -> (logits (B, V), new cache); the
        attention caches are updated in place.  ``layout`` as in
        `loss`."""
        lay = layout(self)
        xf, cache = self._decode(lay, cache, last_tokens)
        return lay.logits(xf)[:, 0, :], cache


class LM(_Model):
    """Decoder-only LM (dense / MoE / SSM / hybrid / VLM backbone)."""

    def __init__(self, cfg, *, device=None, generator=None):
        super().__init__()
        dev, gen = self._init_common(cfg, device, generator)
        self.stack_specs = [StackSpec(cfg.period, cfg.periods)]
        if cfg.remainder:
            self.stack_specs.append(StackSpec(cfg.remainder, 1))
        self.embed = nn.Parameter(init_embed(gen, cfg, dev))
        self.stacks = nn.ModuleDict({
            f"s{i}": init_stack(gen, st, cfg, dev)
            for i, st in enumerate(self.stack_specs)
        })
        self.final_norm = nn.Parameter(
            init_rms_norm(cfg.d_model, cfg.param_dtype, dev))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(normal(
                gen, (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5,
                cfg.param_dtype, dev))

    # ---------------------------------------------------------- forward ---
    def _hidden(self, batch, lay):
        """The normed final hidden states and the auxiliary losses."""
        cfg = self.cfg
        tokens = batch["tokens"].to(lay.device)
        x = lay.embed(tokens)
        if cfg.num_patches:
            img = batch["image_embeds"].to(lay.device, cfg.compute_dtype)
            x = torch.cat([img, x], dim=1)
        S = x.shape[1]
        x = lay.split(x)
        positions = torch.arange(S, device=lay.device)[None, :]
        aux = ZERO_AUX(lay.device)
        for i, st in enumerate(self.stack_specs):
            x, a, _ = run_stack(lay.stack(f"s{i}", S), x, st, cfg,
                                positions=positions, **lay.stack_kw)
            aux = _acc_aux(aux, a)
        return lay.norm("final_norm", x), aux

    def forward(self, batch):
        lay = Layout(self)
        xf, aux = self._hidden(batch, lay)
        return lay.logits(xf), aux

    def loss(self, batch, layout=Layout):
        """Loss and metrics of ``batch``; ``layout`` makes the pass's
        `Layout` from the model."""
        cfg = self.cfg
        lay = layout(self)
        xf, aux = self._hidden(batch, lay)
        tokens = batch["tokens"].to(lay.device)
        if cfg.num_patches:
            P = cfg.num_patches
            window, labels = (P - 1, P + tokens.shape[1] - 1), tokens
        else:
            window, labels = (0, xf.shape[1] - 1), tokens[:, 1:]
        ce = lay.xent(xf, window, labels)
        return total_loss(cfg, ce, aux), {"ce": ce, **aux}

    # ------------------------------------------------------------ decode ---
    @torch.no_grad()
    def init_cache(self, batch_size: int, max_len: int, dtype=torch.bfloat16):
        cfg = self.cfg
        caches = {
            f"s{i}": init_stack_cache(st, cfg, batch_size, max_len, dtype,
                                      device=self.device)
            for i, st in enumerate(self.stack_specs)
        }
        return {"stacks": caches, "pos": 0}

    @torch.no_grad()
    def prefill(self, cache, batch):
        """Write a prompt into the cache by running decode steps (simple
        reference prefill; production would batch this).  Returns the
        cache and the last step's logits."""
        tokens = batch["tokens"]
        logits = None
        for t in range(tokens.shape[1]):
            logits, cache = self.decode_step(cache, tokens[:, t:t + 1])
        return cache, logits


class EncDec(_Model):
    """Encoder-decoder (whisper backbone; conv frontend is a stub — the
    batch carries precomputed frame embeddings)."""

    def __init__(self, cfg, *, device=None, generator=None):
        super().__init__()
        dev, gen = self._init_common(cfg, device, generator)
        self.enc_spec = StackSpec(
            cfg.encoder_period,
            cfg.n_encoder_layers // len(cfg.encoder_period),
        )
        self.stack_specs = [StackSpec(cfg.period, cfg.periods, has_cross=True)]
        if cfg.remainder:
            self.stack_specs.append(StackSpec(cfg.remainder, 1, has_cross=True))
        self.embed = nn.Parameter(init_embed(gen, cfg, dev))
        self.pos_embed = nn.Parameter(normal(
            gen, (cfg.encoder_seq, cfg.d_model), 0.02, cfg.param_dtype, dev))
        self.enc_stack = init_stack(gen, self.enc_spec, cfg, dev)
        self.enc_norm = nn.Parameter(
            init_rms_norm(cfg.d_model, cfg.param_dtype, dev))
        self.stacks = nn.ModuleDict({
            f"s{i}": init_stack(gen, st, cfg, dev)
            for i, st in enumerate(self.stack_specs)
        })
        self.final_norm = nn.Parameter(
            init_rms_norm(cfg.d_model, cfg.param_dtype, dev))
        self.lm_head = nn.Parameter(normal(
            gen, (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5,
            cfg.param_dtype, dev))

    def encode(self, lay, frames):
        cfg = self.cfg
        x = frames.to(lay.device, cfg.compute_dtype) \
            + lay.leaf("pos_embed").to(cfg.compute_dtype)[None]
        S = x.shape[1]
        positions = torch.arange(S, device=lay.device)[None, :]
        x, _, _ = run_stack(lay.stack("enc_stack", S), lay.split(x),
                            self.enc_spec, cfg, positions=positions,
                            **lay.stack_kw)
        return lay.norm("enc_norm", x)

    def _hidden(self, batch, lay):
        cfg = self.cfg
        enc_out = self.encode(lay, batch["enc_frames"])
        x = lay.split(lay.embed(batch["tokens"].to(lay.device)))
        positions = torch.arange(x.shape[1], device=lay.device)[None, :]
        aux = ZERO_AUX(lay.device)
        for i, st in enumerate(self.stack_specs):
            x, a, _ = run_stack(
                lay.stack(f"s{i}", x.shape[1]), x, st, cfg,
                positions=positions, enc_out=enc_out, **lay.stack_kw,
            )
            aux = _acc_aux(aux, a)
        return lay.norm("final_norm", x), aux

    def forward(self, batch):
        lay = Layout(self)
        xf, aux = self._hidden(batch, lay)
        return lay.logits(xf), aux

    def loss(self, batch, layout=Layout):
        lay = layout(self)
        xf, aux = self._hidden(batch, lay)
        tokens = batch["tokens"].to(lay.device)
        ce = lay.xent(xf, (0, xf.shape[1] - 1), tokens[:, 1:])
        return ce, {"ce": ce, **aux}

    @torch.no_grad()
    def init_cache(self, batch, max_len: int, dtype=torch.bfloat16):
        """Runs the encoder and precomputes static cross K/V."""
        cfg = self.cfg
        lay = Layout(self)
        enc_out = self.encode(lay, batch["enc_frames"])
        B = enc_out.shape[0]
        caches = {
            f"s{i}": init_stack_cache(
                st, cfg, B, max_len, dtype, enc_out=enc_out,
                params=lay.p["stacks"][f"s{i}"],
            )
            for i, st in enumerate(self.stack_specs)
        }
        return {"stacks": caches, "pos": 0}


def build_model(cfg, *, device=None, generator=None):
    """`EncDec` or `LM` for ``cfg`` on ``device`` (the card by default),
    its weights drawn from ``generator`` (a CPU `torch.Generator`, default
    seed 0, so one seed gives the same weights on every device; a CUDA
    generator draws them on its card).  ``device="meta"`` builds the
    shapes only: no weight is drawn and no storage allocated (parameter
    counts of configs that fit no host, `launch.analysis`)."""
    cls = EncDec if cfg.is_encoder_decoder else LM
    return cls(cfg, device=device, generator=generator)
