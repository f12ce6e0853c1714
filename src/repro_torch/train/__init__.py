"""Training and serving steps and the training loop of the port, fed by
the DACP data plane (the port of ``repro.train``)."""

from repro_torch.train.loop import Trainer
from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_state, make_train_step, opt_axes

__all__ = ["Trainer", "make_decode_step", "make_prefill_step", "make_train_state", "make_train_step", "opt_axes"]
