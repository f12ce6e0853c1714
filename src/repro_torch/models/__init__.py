"""Model zoo of the port: decoder-only LMs — dense attention, zamba2
(Mamba2 + shared attention) and xLSTM — on the port's kernels."""

from repro_torch.models.model_zoo import ModelApi, build

__all__ = ["ModelApi", "build"]
