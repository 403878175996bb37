"""Serving launcher: batched greedy decoding with a KV/SSM-state cache (the
port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
        --smoke --device cpu --batch 4 --prompt-len 16 --gen 32

Runs on the card (``--device cuda``, the default); ``--device cpu`` runs
on the CPU, and asking for the card where there is none raises
`DeviceUnavailable`.  The prompt is drawn from ``np.random.default_rng(0)``
as the reference draws it; the weights come from
``torch.Generator().manual_seed(0)``, where the reference draws them from
``jax.random.PRNGKey(0)``, so the two launchers print the same two lines
with different tokens.  The prompt is prefilled by stepping it through the
decode step, then ``--gen`` greedy steps follow; the time and tok/s cover
the greedy steps, each of which copies its tokens to the host.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..device import resolve
from ..models import build_model
from ..train import make_serve_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Run the launcher; print its two lines and return a dict with the
    generated tokens (B, gen), ``prefill_s`` (the prompt's decode steps),
    ``decode_s`` (the greedy steps) and ``setup_s`` (weights, the compute
    copy and the cache)."""
    args = parse_args(argv)
    device = resolve(args.device)
    t_setup = time.perf_counter()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=device)
    serve = make_serve_step(model)

    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(args.batch, args.prompt_len)),
        dtype=torch.int64, device=device,
    )
    max_len = args.prompt_len + args.gen + 1
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            batch = {"enc_frames": torch.zeros(
                (args.batch, cfg.encoder_seq, cfg.d_model),
                dtype=torch.float32, device=device)}
            cache = model.init_cache(batch, max_len)
        else:
            cache = model.init_cache(args.batch, max_len)
        model.compute_params()
        _sync(device)
        t0 = time.perf_counter()
        setup_s = t0 - t_setup

        # prefill by stepping the prompt (reference implementation)
        for t in range(args.prompt_len):
            cache, tok = serve(cache, prompt[:, t:t + 1])
        _sync(device)
        prefill_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        out = []
        for _ in range(args.gen):
            cache, tok = serve(cache, tok)
            out.append(tok.cpu().numpy())
        _sync(device)
        dt = time.perf_counter() - t0
    gen = np.concatenate(out, axis=1)
    print(f"generated {gen.shape} in {dt:.2f}s "
          f"({args.gen * args.batch / dt:.1f} tok/s)")
    print(gen[:, :16])
    return {"tokens": gen, "decode_s": dt, "prefill_s": prefill_s,
            "setup_s": setup_s}


if __name__ == "__main__":
    main(sys.argv[1:])
