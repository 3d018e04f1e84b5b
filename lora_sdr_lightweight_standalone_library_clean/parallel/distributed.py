"""Multi-host execution: jax.distributed wiring + ('host','dp','sp') meshes.

The reference is a single-threaded, single-process library (SURVEY §2.9);
scaling it out is this build's job (SURVEY §5.8, §7.8).  The workload's
parallel dimensions map onto a 3-axis global mesh:

 * ``host``  — process/DCN boundary.  Channels (independent radio
   streams / packet batches) shard here FIRST: the per-channel pipeline
   has **zero** cross-channel communication, so the only traffic crossing
   DCN is tiny metric reductions — the layout that makes >=80 % linear
   scaling (BASELINE.md) a bandwidth non-issue.
 * ``dp``    — within-host data parallelism over channels/packets (intra-host links).
 * ``sp``    — within-host sequence parallelism over stream time-blocks:
   the overlap-save halo exchange (one symbol via ``ppermute``,
   parallel/streaming.py) stays within a host by construction because ``sp``
   never spans processes.

Device placement: ``jax.devices()`` sorted by (process_index, id) and
reshaped to (hosts, dp, sp), so the host axis is exactly the process
boundary and every collective over 'dp'/'sp' stays within a host.

Correctness is provable without a multi-host cluster: the multi-process CPU test
(tests/test_distributed.py) launches two processes x four virtual CPU
devices each, initializes the cluster, and runs the full sharded pipeline
plus the streaming receiver against single-process ground truth.
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["init_distributed", "global_mesh", "channel_sharding",
           "stream_sharding", "make_global_array", "allgather",
           "process_count", "CHANNEL_AXES"]

# the packets/channels batch axis shards over both cross-host and
# within-host data parallelism
CHANNEL_AXES = ("host", "dp")


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize jax.distributed for multi-process execution.

    Arguments default to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID); on clusters JAX can detect,
    all three may be None.  Returns True when a multi-process
    cluster was initialized, False for single-process runs (no-op).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def process_count() -> int:
    return jax.process_count()


def global_mesh(dp: int | None = None, sp: int = 1,
                devices=None) -> Mesh:
    """('host', 'dp', 'sp') mesh over all global devices.

    The host axis equals the process boundary (DCN); dp and sp partition
    each host's local devices.  ``dp`` defaults to
    local_devices // sp.
    """
    if devices is None:
        devices = jax.devices()
    devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    hosts = max(jax.process_count(), 1)
    per_host = len(devices) // hosts
    if dp is None:
        dp = per_host // sp
    if hosts * dp * sp != len(devices):
        raise ValueError(
            f"hosts*dp*sp ({hosts}*{dp}*{sp}) != devices ({len(devices)})")
    arr = np.asarray(devices, dtype=object).reshape(hosts, dp, sp)
    return Mesh(arr, axis_names=("host", "dp", "sp"))


def channel_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading packets/channels axis over host x dp; the sample
    axis (and any trailing axes) replicate."""
    return NamedSharding(mesh, P(CHANNEL_AXES))


def stream_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a 1-D sample stream's time axis over 'sp' (within-host)."""
    return NamedSharding(mesh, P("sp"))


def make_global_array(global_data: np.ndarray, sharding: NamedSharding):
    """Build a global jax.Array from host-replicated numpy data: every
    process computes the full array, each contributes its addressable
    shards.  For data each host computes identically (test fixtures,
    deterministic payload generators)."""
    return jax.make_array_from_callback(
        global_data.shape, sharding, lambda idx: global_data[idx])


def allgather(x):
    """Gather a sharded global array to host numpy on every process."""
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
