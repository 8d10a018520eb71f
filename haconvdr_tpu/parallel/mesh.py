"""Device-mesh utilities.

The reference's multi-device surface is torch DataParallel + faiss GPU
sharding + filesystem pickle gathers (SURVEY.md SS2.3/SS2.4).  Here all of
it maps onto one jax.sharding.Mesh:

  * ``dp`` axis — batch/data parallelism (encoding, training);
  * ``tp`` axis — optional tensor parallelism inside the encoder;
  * index sharding reuses the flattened mesh as a single ``d`` axis over
    the passage dimension (parallel/sharded_search.py).

Collectives are inserted by XLA (psum/all_gather from GSPMD); there is
no filesystem-based data movement on the compute path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    dp: Optional[int] = None,
    tp: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Create a (dp, tp) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if dp is None:
        assert n % tp == 0, f"{n} devices not divisible by tp={tp}"
        dp = n // tp
    assert dp * tp == n, f"dp*tp = {dp * tp} != device count {n}"
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, ("dp", "tp"))


def replicate(mesh: Mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P()))


def shard_batch(mesh: Mesh, x, axis: str = "dp"):
    """Shard the leading (batch) dimension over ``axis``."""
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m
