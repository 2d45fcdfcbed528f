"""Multi-process ingest over torch.distributed (port of
unikmer_tpu/pipeline/distributed.py).

  * every rank runs the same program under :func:`initialize`, one
    process a rank, the counterpart of ``jax.distributed.initialize``:
    NCCL between cards, gloo on the CPU (and for ranks that share one
    card, which NCCL refuses).
  * ingest is rank-sharded: each rank reads only its slice of the input
    file list (:func:`partition_files`) and packs it whole.
  * the rank cuts its bases into halo rows, one a local shard, and the
    sharded build of parallel/sharded.py encodes and sorts them on its
    card and swaps code ranges with every other rank in one
    ``all_to_all_single`` a plane (the JAX package's ``all_to_all``).
  * results stay range-partitioned: shard g of D = W * L owns the g-th
    code range (parallel/sharded.partition_boundaries, the same ranges
    as a single-process D-shard mesh), so the shards' outputs in shard
    order concatenate into the globally sorted set, and each rank holds
    the shards of its own range.

Launch with ``torchrun --nproc-per-node N``, or give each process its
address, world size and rank.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch

from .._device import get_device
from ..utils.log import log

# how long a rank waits for the others, in init_process_group and in
# each collective, before it raises
TIMEOUT = timedelta(seconds=300)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None):
    """torch.distributed.init_process_group for this rank; a no-op
    returning None for a single process (no address given and none in
    the environment).  Otherwise returns the default group.

    Arguments default from torch's launcher environment, as the JAX
    package's from JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID: MASTER_ADDR and MASTER_PORT, WORLD_SIZE and RANK.
    LOCAL_RANK picks the rank's card.  ``backend`` defaults to nccl when
    the port's device (_device.get_device) is CUDA and gloo on the CPU;
    gloo on the card puts several ranks on one card.  Asking for nccl
    without CUDA raises."""
    import torch.distributed as dist

    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return None  # single-process
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    dev = get_device()
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise RuntimeError("the nccl backend needs the port's device to be "
                           f"CUDA, not {dev}")
    kw = {}
    if dev.type == "cuda":
        card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(card)
        if backend == "nccl":
            kw["device_id"] = card
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=TIMEOUT, **kw)
    log.info(f"distributed: process {process_id}/{num_processes} @ "
             f"{coordinator_address} ({backend})")
    return dist.group.WORLD


def partition_files(files: list[str], num_hosts: int,
                    host_id: int) -> list[str]:
    """Deterministic host-sharded ingest: host i reads files i, i+H, ..."""
    return files[host_id::num_hosts]


def partition_bases(bases: np.ndarray, num_hosts: int, host_id: int, k: int):
    """Split one large packed base array across hosts with a k-1 halo
    (same ownership rule as parallel.sharded.pack_host_shards)."""
    n = len(bases)
    per = -(-n // num_hosts)
    lo = host_id * per
    hi = min(lo + per + k - 1, n)
    own = min(per, max(n - lo, 0))
    return bases[lo:hi], own


def sharded_count_distinct(files: list[str], cfg, mesh=None,
                           circular: bool = False, group=None):
    """End-to-end sharded count over ``files``.

    Without a group (the JAX function's single-process branch): this
    process packs every file and runs the sharded build over ``mesh`` (a
    Mesh or a device count; None: every device).  With a
    torch.distributed group of W ranks: this rank reads
    ``partition_files(files, W, rank)``, packs them whole, cuts them
    into L halo rows for the L shards of its ``mesh`` (default
    parallel/mesh.rank_mesh, its own card), and the sharded build
    exchanges the code ranges of the D = W * L shards between the ranks.
    Every rank must call it, a rank with no file included.

    Returns this rank's shards in shard order as (global shard index,
    codes, n): codes[:n] the shard's sorted codes kept by cfg.mode, on
    its device.  The rows carry the halos of parallel/sharded.shard_halos
    (a minimizer's window ahead and behind), where the JAX function
    packs every configuration with a k-1 halo and so drops minimizers at
    the rows' edges.  Buckets are sized exactly from each shard's split,
    so the JAX function's ``capacity``, ``row_len`` and ``dropped`` (TPU
    static shapes) are not ported."""
    from ..io.fastx import pack_files
    from ..parallel.mesh import as_mesh, rank_mesh
    from ..parallel.sharded import (
        build_sharded_distinct, group_shards, pack_host_shards, shard_halos,
    )

    if group is None:
        mesh, n_ranks, rank = as_mesh(mesh), 1, 0
    else:
        import torch.distributed as dist

        mesh = rank_mesh() if mesh is None else as_mesh(mesh)
        n_ranks, rank = dist.get_world_size(group), dist.get_rank(group)
    packed = pack_files(partition_files(files, n_ranks, rank), cfg.k,
                        circular)
    front, back = shard_halos(cfg)
    rows = pack_host_shards(packed.bases, len(mesh), cfg.k, front, back)
    del packed
    (res,) = build_sharded_distinct(rows, cfg, mesh, group)
    first = group_shards(mesh, group)[1]
    return [(first + i, codes, n) for i, (codes, n) in enumerate(res)]
