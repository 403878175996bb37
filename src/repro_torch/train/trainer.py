"""Fault-tolerant training loop (port of ``repro.train.trainer``).

  - checkpoint every ``ckpt_every`` steps, at a SIGTERM and at the end,
    in the reference's format and tree (`convert.train_state_to_reference`:
    ``.params/...``, ``.opt/.mu/...``, ``.opt/.count``, ``.step``), so
    either package's trainer resumes the other's checkpoints;
  - resume from the newest complete checkpoint: the data pipeline is
    seekable (``batch_at(step)``), so a restart is exactly-once with no
    replay;
  - SIGTERM (preemption notice) checkpoints after the step it lands in,
    then stops; the previous handler is restored when `run` returns;
  - straggler watchdog: per-step wall time tracked as an EWMA; a step
    slower than ``straggler_factor x EWMA`` (after the first three steps
    of a run) adds a ``straggler`` event.

A step's time waits for the card (``torch.cuda.synchronize``) where the
reference waits with ``block_until_ready``; ``history`` keeps every
step's ``(step, loss, seconds)``, logged or not.  Events are dicts with the
reference's kinds (``resume``, ``straggler``, ``metrics``,
``checkpoint``, ``preempted``) and fields; ``on_event``, when given, is
called with each as it happens (the launcher prints them).
"""
from __future__ import annotations

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field

import torch

from ..checkpoint import checkpoint as ckpt_lib
from ..convert import train_state_from_reference, train_state_to_reference
from .train_step import TrainState


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1


@dataclass
class Trainer:
    train_step: object            # make_train_step(...): carries .model
    pipeline: object              # .batch_at(step) -> host batch
    cfg: TrainerConfig = field(default_factory=TrainerConfig)
    make_batch: object = None     # optional: (np tokens) -> batch dict
    events: list = field(default_factory=list)
    on_event: object = None       # optional: called with each event
    history: list = field(default_factory=list)   # (step, loss, seconds)

    def _emit(self, kind: str, **info):
        event = {"kind": kind, "time": time.time(), **info}
        self.events.append(event)
        if self.on_event is not None:
            self.on_event(event)

    def run(self, state: TrainState) -> TrainState:
        cfg = self.cfg
        start = 0
        last = ckpt_lib.latest_step(cfg.ckpt_dir)
        if last is not None:
            restored = ckpt_lib.restore(
                cfg.ckpt_dir, last, train_state_to_reference(state, like=True))
            model = self.train_step.model
            model.reclaim()     # storage, if a sharded step released it
            state = train_state_from_reference(model, restored)
            start = int(state.step)
            self._emit("resume", step=start)

        stop = {"now": False}

        def on_term(signum, frame):
            stop["now"] = True

        old = signal.signal(signal.SIGTERM, on_term)
        ewma = None
        try:
            for step in range(start, cfg.total_steps):
                toks = self.pipeline.batch_at(step)
                batch = self.make_batch(toks) if self.make_batch else {
                    "tokens": torch.as_tensor(toks)
                }
                t0 = time.perf_counter()
                state, metrics = self.train_step(state, batch)
                loss = metrics["loss"]
                if loss.is_cuda:
                    torch.cuda.synchronize(loss.device)
                dt = time.perf_counter() - t0
                self.history.append((step, float(loss), dt))

                if ewma is None:
                    ewma = dt
                elif dt > cfg.straggler_factor * ewma and step > start + 2:
                    self._emit("straggler", step=step, step_time=dt, ewma=ewma)
                ewma = (1 - cfg.ewma_alpha) * (ewma or dt) + cfg.ewma_alpha * dt

                if step % cfg.log_every == 0:
                    self._emit("metrics", step=step,
                               loss=self.history[-1][1], step_time=dt)
                done = step + 1 >= cfg.total_steps
                if (step + 1) % cfg.ckpt_every == 0 or stop["now"] or done:
                    ckpt_lib.save(cfg.ckpt_dir, step + 1,
                                  train_state_to_reference(state))
                    ckpt_lib.prune(cfg.ckpt_dir, cfg.keep)
                    self._emit("checkpoint", step=step + 1)
                if stop["now"]:
                    self._emit("preempted", step=step + 1)
                    break
        finally:
            signal.signal(signal.SIGTERM, old)
        return state
