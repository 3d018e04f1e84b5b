"""Device-mesh helpers: data-parallel packet sharding over device meshes.

The reference is single-threaded C (SURVEY §2.9); the parallel dimensions
latent in the workload are packets/channels (embarrassingly parallel) and
time blocks of a stream (sequential with overlap).  This module owns the
first: a ``Mesh`` with a ``dp`` (packets/channels) axis and optionally an
``sp`` (stream-block) axis, plus sharding constructors so the batched modem
ops shard across devices with zero collectives on the hot path.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "packet_sharding", "shard_packets", "replicated"]


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              sp: int = 1, devices=None) -> Mesh:
    """Build a ('dp', 'sp') mesh.  With sp=1 this is pure data parallel."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if dp is None:
        dp = n_devices // sp
    if dp * sp != n_devices:
        raise ValueError(f"dp*sp ({dp}*{sp}) != n_devices ({n_devices})")
    arr = np.asarray(devices).reshape(dp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))


def packet_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading packets/channels axis over 'dp', replicate the
    sample axis."""
    return NamedSharding(mesh, P("dp"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_packets(x, mesh: Mesh):
    """Place a (batch, ...) array with its batch axis sharded over 'dp'."""
    return jax.device_put(x, packet_sharding(mesh))
