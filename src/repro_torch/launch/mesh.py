"""Production mesh construction — the port of ``repro.launch.mesh``.

FUNCTIONS, not module-level constants, so importing this module touches
no process group and no device.  Each builds a ``DeviceMesh`` over the
default process group, which the caller initialises with the mesh's world
size (``torch.distributed.init_process_group``; the dry-run gives it a fake
group of 256 or 512 ranks in one process).

Axes, with the reference's names so the port's dry-run records sit beside
the reference's:
    pod    — the slow boundary between pods (only data-parallel gradient
             traffic, which the int8 ``compressed_psum`` can ride)
    data   — DP/FSDP within a pod (batch + ZeRO parameter sharding)
    model  — TP/EP within a pod (heads, ffn, experts, vocab)
"""

from __future__ import annotations

__all__ = ["make_production_mesh", "make_smoke_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``, over a default process group of 256 or 512 ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_smoke_mesh(device_type: str = "cuda"):
    """(1, 1) mesh with the production axis names.  Without a default
    process group it starts one of world size 1 on an in-process store
    (NCCL for ``"cuda"``, gloo for ``"cpu"``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, (1, 1), mesh_dim_names=("data", "model"))
