"""Model zoo of the port: decoder-only dense attention LMs on the port's
attention kernels."""

from repro_torch.models.model_zoo import ModelApi, build

__all__ = ["ModelApi", "build"]
