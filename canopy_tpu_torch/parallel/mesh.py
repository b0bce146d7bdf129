"""Device mesh construction for quantification workloads.

The workload's parallel axes (the JAX package's ``parallel/mesh.py``):

* ``data`` — the sample/trials axis (uncertainty trials, MC states):
  embarrassingly parallel, so it takes most of the mesh.
* ``model`` — row/block partition of gate-structure and cut-set matrices
  (the tensor-parallel analogue); partial sums meet in an ``all_reduce``.

A mesh here is a ``torch.distributed`` :class:`DeviceMesh` over the
initialized world (one process per rank, :func:`parallel.distributed.
initialize`); rank ``r`` sits at ``(r // model, r % model)``, so the
flattened ``("data", "model")`` index of a rank is its global rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..errors import LogicError

__all__ = ["make_mesh", "mesh_shape", "axis_size"]


def mesh_shape(n_devices: int, model_parallelism: int | None = None
               ) -> tuple[int, int]:
    """(data, model) factorization of the device count.

    Defaults to the largest power-of-two model axis not exceeding
    sqrt(n); sampling throughput dominates, so data gets the rest.
    """
    if model_parallelism is not None:
        if n_devices % model_parallelism:
            raise ValueError(
                f"model_parallelism {model_parallelism} does not divide "
                f"device count {n_devices}")
        return n_devices // model_parallelism, model_parallelism
    model = 1
    while model * 2 <= max(1, int(np.sqrt(n_devices))) and \
            n_devices % (model * 2) == 0:
        model *= 2
    return n_devices // model, model


def _world_mesh(device, shape: tuple[int, int],
                names: tuple[str, str]) -> DeviceMesh:
    if not dist.is_initialized():
        raise LogicError("no process group: call parallel.distributed."
                         "initialize() (or torch.distributed."
                         "init_process_group) on every rank first")
    if shape[0] * shape[1] != dist.get_world_size():
        raise LogicError(f"mesh {shape} does not cover the world of "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=names)


def make_mesh(device="cuda", model_parallelism: int | None = None
              ) -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the initialized world.

    Collective call: every rank makes it, in the same order as its other
    meshes.
    """
    return _world_mesh(device, mesh_shape(dist.get_world_size()
                                          if dist.is_initialized() else 1,
                                          model_parallelism),
                       ("data", "model"))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The extent of the mesh's dimension ``name``."""
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(name)])
