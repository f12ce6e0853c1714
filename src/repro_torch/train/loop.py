"""Training loop with checkpoint/restart, DACP-fed data and async saves —
the port of ``repro.train.loop``.

The state lives in the train-state tree (params, opt, err); the data
iterator is a DACP COOK stream (re-openable: an exhausted one is opened
again, an epoch wrap); checkpoints are atomic and validated, in the
reference's format; on construction the loop resumes from the newest valid
checkpoint, bfloat16 leaves included (read as bits, ``checkpoint.to_tensor``).
"""

from __future__ import annotations

import time

import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import to_tensor
from repro_torch.optim import AdamWConfig
from repro_torch.train.steps import make_train_state, make_train_step
from repro_torch.tree import tree_map

__all__ = ["Trainer"]


class Trainer:
    """``Trainer(cfg, data_iter_factory, ...)``: the reference's arguments,
    plus ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``; the
    weights are drawn there from a ``torch.Generator`` seeded with
    ``seed``).
    ``data_iter_factory()`` returns an iterator of {tokens, labels} batches
    on ``device``.  ``metrics_log`` gets the metrics as floats at step 1
    and every ``log_every``-th step, with ``wall_s`` taken after the
    device finished the step."""

    def __init__(
        self,
        cfg,
        data_iter_factory,
        optim_cfg: AdamWConfig | None = None,
        ckpt_dir: str | None = None,
        ckpt_every: int = 100,
        n_micro: int = 1,
        compress_grads: bool = False,
        seed: int = 0,
        log_every: int = 10,
        device=None,
    ):
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        self.optim_cfg = optim_cfg or AdamWConfig()
        self.data_iter_factory = data_iter_factory
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.step = 0
        self.metrics_log: list = []

        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = make_train_state(cfg, self.optim_cfg, gen, compress_grads, self.device)
        if self.ckpt is not None:
            restored, manifest = self.ckpt.restore_latest()
            if restored is not None:
                # restored host arrays onto the existing tree's types and devices
                self.state = tree_map(lambda cur, new: to_tensor(new, cur), self.state, restored)
                self.step = int(manifest["step"])
        self._train_step = make_train_step(cfg, self.optim_cfg, n_micro, compress_grads)

    def run(self, num_steps: int) -> dict:
        it = iter(self.data_iter_factory())
        t0 = time.time()
        last = None
        for _ in range(num_steps):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(self.data_iter_factory())  # epoch wrap
                batch = next(it)
            self.state, metrics = self._train_step(self.state, batch)
            self.step += 1
            if self.step % self.log_every == 0 or self.step == 1:
                last = {k: float(v) for k, v in metrics.items()}
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                last["step"] = self.step
                last["wall_s"] = time.time() - t0
                self.metrics_log.append(last)
            if self.ckpt is not None and self.step % self.ckpt_every == 0:
                self.ckpt.save_async(self.step, self.state)
        if self.ckpt is not None:
            self.ckpt.save(self.step, self.state)
            self.ckpt.wait()
        return last or {}
