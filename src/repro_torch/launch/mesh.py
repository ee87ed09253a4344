"""Production mesh builders, the counterparts of ``repro.launch.mesh``.

FUNCTIONS, not module-level constants: importing this module sets up no
process group. A mesh is a ``DeviceMesh`` over the default process group,
which the caller sets up first with as many ranks as the mesh has: the
dry-run a ``fake`` group on ``"cpu"`` (its stand-in for the JAX package's
512 host placeholder devices), a run on cards an NCCL group on ``"cuda"``.
"""
from __future__ import annotations

import torch.distributed as dist


def _make_mesh(shape, axes, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: set one up (torch.distributed."
            "init_process_group) with as many ranks as the mesh before "
            "making a mesh")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs a "
                           f"world of {n} ranks, not "
                           f"{dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 devices a pod; multi_pod adds a 2-pod outer axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, *,
                    multi_pod: bool = False, device_type: str = "cuda"):
    """Small mesh for CI-scale dry-run tests (8-16 ranks)."""
    if multi_pod:
        return _make_mesh((2, n_data, n_model), ("pod", "data", "model"),
                          device_type)
    return _make_mesh((n_data, n_model), ("data", "model"), device_type)
