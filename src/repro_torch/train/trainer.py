"""Training loop: init or resume, the train step, the JSONL metrics log
and a checkpoint every ``ckpt_every`` steps (the twin of
``repro/train/trainer.py``, as far as the reference defines it).

The reference's loop also wires a device mesh, shardings, a straggler
watchdog and a failure injector; their modules (``repro.dist.sharding``,
``repro.dist.fault``) are not in the JAX package, so its Trainer cannot
be imported (ROADMAP.md, reference gaps), and the port has none of them.
The Trainer runs on the card unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models.api import Model
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.train.step import make_train_step
from repro_torch.utils.spans import span

__all__ = ["Trainer"]


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        pipeline: DataPipeline,
        ckpt_dir: Optional[str],
        lr: float = 3e-4,
        warmup_steps: int = 20,
        total_steps: int = 1000,
        grad_accum: int = 1,
        clip_norm: float = 1.0,
        ckpt_every: int = 50,
        log_path: Optional[str] = None,
        seed: int = 0,
        device: str = "cuda",
    ):
        """``ckpt_dir`` None keeps no checkpoints (a full-width model's
        state is tens of GB)."""
        self.cfg = cfg
        self.model = Model(cfg, device=device)
        self.device = torch.device(device)
        self.pipeline = pipeline
        self.ckpt = Checkpointer(ckpt_dir) if ckpt_dir is not None else None
        self.ckpt_every = ckpt_every
        self.log_path = log_path
        self.seed = seed
        self.optimizer = make_optimizer(
            cfg.optimizer, warmup_cosine(lr, warmup_steps, total_steps)
        )
        self.train_step_fn = make_train_step(
            self.model, self.optimizer, grad_accum=grad_accum, clip_norm=clip_norm
        )
        self.step = 0
        self.params = None
        self.opt_state = None
        self.metrics_log: list[dict] = []

    # ------------------------------------------------------------------
    def initialize(self, resume: bool = True) -> None:
        """Fresh params from ``seed`` and a fresh optimizer state; then,
        with ``resume`` and a checkpoint in ``ckpt_dir``, the latest
        checkpoint written into them, with its step and data cursor."""
        self.params = self.model.init_params(seed=self.seed)
        self.opt_state = self.optimizer.init(self.params)
        self.step = 0
        if resume and self.ckpt is not None and latest_step(self.ckpt.directory) is not None:
            _, meta = self.ckpt.restore({"params": self.params, "opt": self.opt_state})
            self.step = int(meta["step"])
            self.pipeline.load_state_dict(meta["pipeline"])

    def _save(self):
        self.ckpt.save(
            self.step,
            {"params": self.params, "opt": self.opt_state},
            metadata={"step": self.step, "pipeline": self.pipeline.state_dict()},
        )

    def _log(self, record: dict):
        self.metrics_log.append(record)
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def _to_device(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.asarray(v))
            out[k] = (t.long() if not t.is_floating_point() else t).to(self.device)
        return out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def train(self, num_steps: int, resume: bool = True):
        """Run to step ``num_steps``; returns the metrics log."""
        if self.params is None:
            self.initialize(resume=resume)
        try:
            it = iter(self.pipeline)
            while self.step < num_steps:
                batch = self._to_device(next(it))
                self._sync()
                t0 = time.monotonic()
                with span("train.step"):
                    self.params, self.opt_state, metrics = self.train_step_fn(
                        self.params, self.opt_state, batch)
                    self._sync()
                dur = time.monotonic() - t0
                self.step += 1
                rec = {
                    "step": self.step,
                    "loss": float(metrics["loss"]),
                    "ce": float(metrics.get("ce", metrics["loss"])),
                    "grad_norm": float(metrics["grad_norm"]),
                    "step_time_s": dur,
                }
                self._log(rec)
                if self.ckpt is not None and (
                        self.step % self.ckpt_every == 0 or self.step == num_steps):
                    self._save()
            if self.ckpt is not None:
                self.ckpt.wait()
            return self.metrics_log
        finally:
            self.pipeline.stop()
