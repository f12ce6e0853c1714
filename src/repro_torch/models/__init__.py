"""Model zoo of the port: decoder-only LMs — dense and MoE attention,
zamba2 (Mamba2 + shared attention) and xLSTM — and the Whisper-style
encoder-decoder, on the port's kernels."""

from repro_torch.models.model_zoo import ModelApi, build, input_axes, input_specs

__all__ = ["ModelApi", "build", "input_axes", "input_specs"]
