"""repro_torch — the DACP data plane ported to PyTorch and CUDA.

A second package beside ``repro`` (the JAX reference), with the same layout
and module names.  It imports ``torch`` and numpy, never ``jax`` and never
``repro``: the framework-neutral modules are copies of the reference's with
only the import prefix rewritten, and ``core.backend`` dispatches eligible
morsels to hand-written CUDA kernels (``repro_torch.kernels``) on an
explicit device — CUDA unless the caller asks for the CPU.
"""
