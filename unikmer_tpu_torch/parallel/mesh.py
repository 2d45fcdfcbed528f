"""Device meshes (port of unikmer_tpu/parallel/mesh.py).

A JAX ``Mesh`` is single-controller: one process drives every device of
``jax.devices()``, and ``shard_map`` runs one program per shard.  The
port's counterpart is one process holding the shards' devices in shard
order; parallel/sharded.py runs each shard's step on its device in turn
and moves data between shards with tensor copies (a peer copy between
cards, a plain copy on one card).  A device may appear more than once,
so D shards can share one card, as the JAX tests put 8 shards on one
CPU.  ``jax.distributed``'s counterpart is a torch.distributed group
(pipeline/distributed.py): each rank holds a mesh of its local shards
(:func:`rank_mesh` by default, its own card) and the shards exchange
across the ranks by NCCL, or gloo on the CPU and for ranks that share
a card.
"""

from __future__ import annotations

import os

import torch

from .._device import get_device


class Mesh(tuple):
    """The shards' devices, in shard order (a device may repeat)."""


def device_count() -> int:
    """Devices a default mesh may take: torch.cuda.device_count() when
    the port's device is CUDA, 1 on the CPU (as jax.device_count()
    without the XLA flag that makes virtual CPU devices)."""
    if get_device().type == "cuda":
        return torch.cuda.device_count()
    return 1


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of the first ``n_devices`` of ``devices`` (default: every
    device, cuda:0 .. cuda:N-1 on CUDA, the CPU device_count() times on
    the CPU); raises ValueError when fewer than ``n_devices`` are there."""
    if devices is None:
        base = get_device()
        n = device_count()
        devices = ([torch.device("cuda", i) for i in range(n)]
                   if base.type == "cuda" else [base] * n)
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return Mesh(devices)


def as_mesh(mesh) -> Mesh:
    """A Mesh as it is, else make_mesh(mesh): the host entry points take
    either a Mesh or a device count (None: every device), where the JAX
    package's take ``n_devices``."""
    return mesh if isinstance(mesh, Mesh) else make_mesh(mesh)


def rank_mesh() -> Mesh:
    """A rank's default mesh: one shard on its own card,
    cuda:LOCAL_RANK (the launcher's local rank, 0 when unset), or on the
    CPU when the port's device is the CPU."""
    base = get_device()
    if base.type == "cuda":
        return Mesh([torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             "0")))])
    return Mesh([base])
