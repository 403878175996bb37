"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke --device cpu --steps 50 --batch 8 --seq 128 --ckpt-dir DIR

Runs on the card (``--device cuda``, the default); ``--device cpu`` runs
on the CPU, and asking for the card where there is none raises
`DeviceUnavailable`.  The weights come from
``torch.Generator().manual_seed(0)`` (the reference draws them from
``jax.random.PRNGKey(0)``), the batches from `TokenPipeline` (the
reference's tokens bit for bit).  Fault tolerance is the trainer's:
resume from the newest checkpoint in ``--ckpt-dir`` is automatic (it may
be one the reference wrote), SIGTERM checkpoints and stops, straggler
events are logged.  Output: one line per trainer event, printed as it
happens, then ``final step N``.

``--mesh DxM`` trains on a (data, model) grid of D x M lanes
(`launch.mesh.make_dev_mesh`): the sharded train step of
`train.train_step` under ``distributed.use_mesh``, which computes what
one device computes with ``--microbatches D`` (bit for bit).  The lanes
are forced onto the devices there are with ``REPRO_TORCH_FORCE_LANES``
(D x M lanes of one card, or of the CPU with ``--device cpu``); with too
few lanes the launcher raises, naming that variable.  ``--mesh 1x1`` (the
default) is the one-device step.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from ..configs import get_config, get_smoke_config
from ..data import PipelineConfig, TokenPipeline
from ..device import resolve
from ..distributed.sharding import use_mesh
from ..launch.mesh import make_dev_mesh
from ..models import build_model
from ..optim import AdamWConfig
from ..train import Trainer, TrainerConfig, init_state, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="1x1",
                    help="data x model, e.g. 2x2 (needs that many lanes: "
                         "REPRO_TORCH_FORCE_LANES lets them share a device)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the launcher; print its lines and return a dict with the final
    ``state`` and the ``trainer`` (its ``events``, its per-step
    ``history``, its ``train_step`` carrying the model)."""
    args = parse_args(argv)
    d, m = (int(x) for x in args.mesh.split("x"))
    device = resolve(args.device)
    mesh = (make_dev_mesh((d, m), ("data", "model"), device=device)
            if d * m > 1 else None)
    if mesh is not None:
        device = mesh.lanes[0].device
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=device)

    pipe = TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, batch=args.batch, seq_len=args.seq))

    def make_batch(toks):
        b = {"tokens": torch.as_tensor(toks, device=device).long()}
        if cfg.num_patches:
            b["image_embeds"] = torch.zeros(
                (toks.shape[0], cfg.num_patches, cfg.d_model),
                dtype=torch.float32, device=device)
        if cfg.is_encoder_decoder:
            b["enc_frames"] = torch.zeros(
                (toks.shape[0], cfg.encoder_seq, cfg.d_model),
                dtype=torch.float32, device=device)
        return b

    with use_mesh(mesh):
        step = make_train_step(model, AdamWConfig(lr=args.lr),
                               microbatches=args.microbatches)
        trainer = Trainer(
            train_step=step, pipeline=pipe, make_batch=make_batch,
            cfg=TrainerConfig(total_steps=args.steps,
                              ckpt_every=args.ckpt_every,
                              ckpt_dir=args.ckpt_dir, log_every=10),
            on_event=lambda e: print(e, flush=True),
        )
        state = trainer.run(init_state(model))
    print(f"final step {int(state.step)}", flush=True)
    return {"state": state, "trainer": trainer}


if __name__ == "__main__":
    main(sys.argv[1:])
