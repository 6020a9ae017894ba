"""Process groups and named meshes, port of ``flamingo_mini_tpu/parallel/mesh.py``.

JAX runs one program over every device of a pod: ``jax.distributed.initialize``
joins the hosts and a named ``Mesh`` lays the devices out. The port runs one
process per rank. ``distributed_init`` joins them in a ``torch.distributed``
process group over a ``tcp://`` rendezvous, and ``create_mesh`` lays the ranks
out as a named ``DeviceMesh``, row-major as JAX reshapes its device array: on
a ``("data", "model")`` mesh of shape ``(D, M)``, rank ``d * M + m``.

Two behaviours of the JAX module are not copied:

* a rendezvous that fails raises; JAX's swallows every ``ValueError`` and
  ``RuntimeError`` of ``jax.distributed.initialize``, so a failed one passes
  silently. Only a group that is already initialised is left as it is;
* a shape that does not cover the ranks raises; JAX's falls back to host CPU
  devices when the shape does not cover the accelerators.
"""
from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout: float = 300.0) -> None:
    """Join this process to the process group of ``num_processes`` ranks as
    rank ``process_id``, meeting at ``coordinator`` (``host:port``, or a
    ``tcp://`` URL). Missing arguments come from torchrun's environment
    (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as JAX
    infers them on a pod. ``backend``: ``nccl`` where CUDA is available,
    ``gloo`` otherwise, unless named; under ``nccl`` the rank takes the card
    ``LOCAL_RANK`` (or ``process_id``) modulo the cards it sees. With one
    process and no rendezvous it does nothing. An initialised group of the
    asked size and rank is left as it is; one of another size or rank
    raises ``RuntimeError`` (a ``create_mesh`` before this call, say, which
    starts a one-rank group). A rendezvous that does not complete within
    ``timeout`` seconds raises."""
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if dist.is_initialized():
        world, me = dist.get_world_size(), dist.get_rank()
        if num_processes not in (None, world) or process_id not in (None, me):
            raise RuntimeError(
                f"distributed_init: asked for rank {process_id} of {num_processes}, "
                f"but this process is already rank {me} of a group of {world} "
                "(create_mesh before distributed_init starts a one-rank group)")
        return
    if coordinator is None and (num_processes or 1) == 1:
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "distributed_init needs coordinator, num_processes and process_id "
            "(or torchrun's MASTER_ADDR, WORLD_SIZE and RANK)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout))


def create_mesh(shape: Optional[Tuple[int, ...]] = None,
                axis_names: Sequence[str] = ("data", "model"),
                device_type: Optional[str] = None) -> DeviceMesh:
    """A named ``DeviceMesh`` over every rank. Default: all ranks on the
    first axis (``data``), the others of size 1 (pure data parallelism, as
    in JAX). ``device_type``: ``cuda`` where CUDA is available, else
    ``cpu``. A single process with no group gets a one-rank group of its
    own (an in-memory store, no network), after which ``distributed_init``
    of more ranks raises. A shape that does not cover the ranks raises
    ``ValueError``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {tuple(axis_names)}")
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} does not cover {world} ranks")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of the mesh's axis ``name``; 1 where the mesh has none."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1
