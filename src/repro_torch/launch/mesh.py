"""Meshes over an initialized process group.

``init_distributed`` joins the group that ``torch.distributed.run`` (or
the caller's own environment) describes; the meshes are then built over
it with the JAX package's axis names.  The backend is always the
caller's: ``nccl`` for one rank per GPU, ``gloo`` on the CPU and for
ranks that share one GPU (NCCL refuses two ranks on a device).  Nothing
here switches backend after an error.
"""
from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def default_backend(device_type: str) -> str:
    """``nccl`` for CUDA, ``gloo`` otherwise (what a caller names when it
    has no reason to name another)."""
    return "nccl" if device_type == "cuda" else "gloo"


def init_distributed(backend: str, *, init_method: Optional[str] = None
                     ) -> tuple:
    """Join the process group of ``RANK`` / ``WORLD_SIZE`` (as
    ``torch.distributed.run`` sets them) over ``backend``;
    ``init_method`` defaults to ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``).  Returns (rank, world size)."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError("RANK and WORLD_SIZE are not set: start the ranks "
                           "with torch.distributed.run (or set them, with "
                           "an init_method every rank can reach)")
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
    return rank, world


def _mesh(shape: tuple, axes: tuple, device_type: str):
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 ranks ("data", "model"); 2 pods = 512 ranks ("pod",
    "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(n_data: int = 1, n_model: int = 1, *,
                   device_type: str = "cpu"):
    """An (n_data, n_model) mesh ("data", "model") over the initialized
    group, whose size must be n_data * n_model.  ``device_type`` is the
    mesh's device for torch's ``DeviceMesh``, which on ``"cuda"`` sets
    each rank's GPU to its ``LOCAL_RANK``: one GPU per rank, the NCCL
    layout.  Ranks that share a GPU over ``gloo`` take ``"cpu"`` (the
    port's collectives stage a gloo group's CUDA tensors through the
    host either way)."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)


def abstract_production_mesh(*, multi_pod: bool = False):
    """The production mesh's axes and sizes with no process group behind
    it (``sharding.AbstractMesh``): the dry-run runs rank 0's program over
    it on the ``meta`` device."""
    from repro_torch.distributed.sharding import AbstractMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)
