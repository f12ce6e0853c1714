"""Optimizer substrate of the port: AdamW, schedules, accumulation,
gradient compression (the port of ``repro.optim``)."""

from repro_torch.optim.accumulate import accumulated_value_and_grad
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm, global_norm
from repro_torch.optim.grad_compress import compress_tensor, compress_tree, init_error_state
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = [
    "accumulated_value_and_grad",
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "compress_tensor",
    "compress_tree",
    "init_error_state",
    "constant",
    "warmup_cosine",
]
