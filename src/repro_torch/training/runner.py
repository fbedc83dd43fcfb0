"""Fault-tolerant training runner (counterpart of
``repro.training.runner``).

Wraps the train step with:
  * periodic async checkpointing (atomic, keep-N)
  * automatic restore-and-resume after a crash (the data pipeline is a pure
    function of the step, so replay is exact)
  * failure injection for tests (``fail_at`` raises inside the loop,
    ``run_with_restarts`` builds a new runner and training continues
    from the latest checkpoint)
  * straggler hooks: per-step wall time is recorded; steps slower than
    ``straggler_factor`` × median are counted and surfaced in the result
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.synthetic import DataConfig, SyntheticLM, torch_batch
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.training.step import TrainState, make_train_step


class FailureInjector:
    """Raises RuntimeError the first time step == fail_at."""

    def __init__(self, fail_at: Optional[int] = None):
        self.fail_at = fail_at
        self.fired = False

    def __call__(self, step: int):
        if self.fail_at is not None and step == self.fail_at and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected node failure at step {step}")


class TrainRunner:
    """Trains on ``device`` (the card unless the caller passes
    ``device="cpu"``) from float32 masters drawn by the port's seeded
    ``lm.init`` (seed ``tcfg.seed``)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 data_cfg: DataConfig, ckpt_dir: str, *,
                 ckpt_every: int = 10, keep: int = 2,
                 straggler_factor: float = 3.0, device=None):
        self.cfg, self.tcfg, self.data_cfg = cfg, tcfg, data_cfg
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(ckpt_dir, keep=keep)
        self.ckpt_every = ckpt_every
        self.step_fn = make_train_step(cfg, tcfg)
        self.data = SyntheticLM(data_cfg)
        self.straggler_factor = straggler_factor
        self.step_times: List[float] = []
        self.stragglers = 0

    def init_state(self) -> TrainState:
        params = lm.init(self.cfg, seed=self.tcfg.seed, device=self.device,
                         dtype=self.cfg.param_dtype)
        return TrainState(params, adamw.init_state(params))

    def run(self, n_steps: int, *, injector: Optional[FailureInjector] = None,
            resume: bool = True) -> Dict[str, Any]:
        state = self.init_state()
        start = 0
        if resume:
            restored_step, state = self.ckpt.restore_latest(state)
            if restored_step is not None:
                start = restored_step
        metrics_log = []
        for step in range(start, n_steps):
            if injector is not None:
                injector(step)
            batch = torch_batch(self.data.batch_at(step), self.device)
            t0 = time.time()
            state, metrics = self.step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits
            dt = time.time() - t0
            self.step_times.append(dt)
            med = float(np.median(self.step_times))
            if len(self.step_times) > 5 and dt > self.straggler_factor * med:
                self.stragglers += 1
            metrics_log.append(metrics)
            if (step + 1) % self.ckpt_every == 0 or step + 1 == n_steps:
                self.ckpt.save(step + 1, state)
        self.ckpt.wait()
        return {"state": state, "metrics": metrics_log,
                "final_step": n_steps, "stragglers": self.stragglers}


def run_with_restarts(make_runner: Callable[[], TrainRunner], n_steps: int,
                      injector: Optional[FailureInjector] = None,
                      max_restarts: int = 3) -> Dict[str, Any]:
    """The loop a cluster scheduler would run: restart on failure, resume
    from the latest intact checkpoint."""
    attempts = 0
    while True:
        runner = make_runner()
        try:
            return runner.run(n_steps, injector=injector)
        except RuntimeError:
            attempts += 1
            if attempts > max_restarts:
                raise
