"""Device mesh setup.

The distributed model (SURVEY.md §2c): the graph / bubble-chain index /
allele-path tables are small and replicated per host; GAF read batches are
the data-parallel axis; chains are the task-parallel axis.  XLA inserts
the collectives from shardings (NCCL between GPUs); the only explicit
collective is the min-merge of per-shard projection key tables.

Axes:
- "data":  alignment (read) sharding for projection/scoring partials
- "chain": chain batches for the threading DP and scoring

Multi-host: call ``initialize_distributed()`` once per process
(jax.distributed), then ``make_mesh`` over the global device list.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
CHAIN_AXIS = "chain"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize from args or env (no-op single-process).

    On a GPU host each process drives one card, chosen by its process id
    (``local_device_ids``); without it every process would claim every
    card of the host."""
    if num_processes is None:
        num_processes = int(os.environ.get("AHSOKA_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ.get("AHSOKA_PROCESS_ID", "0"))
    # CPU clients need an explicit cross-process collectives
    # implementation (the multi-process CPU simulation, SURVEY.md §4);
    # GPU clients use NCCL over NVLink and ignore it.  local_device_ids
    # only sets the visible CUDA/ROCm devices.
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator
        or os.environ.get("AHSOKA_COORDINATOR", "localhost:12345"),
        num_processes=num_processes, process_id=process_id,
        local_device_ids=[process_id])


def put_global(x, mesh: Mesh, spec) -> jax.Array:
    """Host array -> global device array with the given PartitionSpec.

    Single-process: a plain sharded device_put.  Multi-process: every
    process holds the full host array (graph tables and alignment batches
    are replicated per host, SURVEY.md §2c), so each process contributes
    its addressable shards via make_array_from_callback — the
    construction a plain ``jnp.asarray`` cannot do once the mesh spans
    non-addressable devices."""
    sharding = NamedSharding(mesh, spec)
    x = np.asarray(x)
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])


def fetch_global(arr) -> np.ndarray:
    """Global device array -> full host np array on every process.

    Fully-replicated arrays convert directly; sharded arrays gather
    across processes first (multihost_utils.process_allgather)."""
    if jax.process_count() == 1 or arr.is_fully_replicated:
        return np.asarray(arr)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def make_mesh(data: Optional[int] = None, chain: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        data = n // chain
    if data * chain != n:
        raise ValueError(f"mesh {data}x{chain} != {n} devices")
    dev_array = np.asarray(devices).reshape(data, chain)
    return Mesh(dev_array, (DATA_AXIS, CHAIN_AXIS))


def data_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(DATA_AXIS))


def chain_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(CHAIN_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
