"""Roofline analysis of the port's dry-run (traced flops and collectives +
the 3-term model on the H100)."""

from repro_torch.roofline.analysis import HW, collective_bytes, dominant_term, model_flops, roofline_terms

__all__ = ["HW", "collective_bytes", "dominant_term", "model_flops", "roofline_terms"]
