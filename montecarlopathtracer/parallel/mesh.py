"""Device mesh construction for sharded rendering.

The reference is strictly single-device (``cudaSetDevice(0)``,
CUTracer.cu:222). This framework scales over a 2-D logical mesh:

- axis ``"rays"`` — the film's row axis is sharded; each device owns a
  horizontal band of the image (the SIMT-over-pixels analog, SURVEY.md
  §2.3);
- axis ``"spp"`` — sample batches are sharded; per-band partial films
  are combined by ``psum`` over this axis (the progressive-accumulation
  axis generalized across chips, SURVEY.md §5 long-context analog).

The scene/BVH is replicated on every chip (BASELINE.json north star).
On a multi-host pod slice the same mesh spans all processes via
``jax.distributed.initialize`` + ``jax.devices()``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh

RAYS_AXIS = "rays"
SPP_AXIS = "spp"


def make_mesh(
    n_rays_shards: Optional[int] = None,
    n_spp_shards: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (rays × spp) mesh over the given devices.

    Defaults: all devices on the rays axis. The product of the two
    shard counts must equal the device count.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_rays_shards is None and n_spp_shards is None:
        n_rays_shards, n_spp_shards = n, 1
    elif n_rays_shards is None:
        n_rays_shards = n // n_spp_shards
    elif n_spp_shards is None:
        n_spp_shards = n // n_rays_shards
    if n_rays_shards * n_spp_shards != n:
        raise ValueError(
            f"mesh {n_rays_shards}x{n_spp_shards} != {n} devices"
        )
    arr = np.asarray(devices).reshape(n_rays_shards, n_spp_shards)
    return Mesh(arr, (RAYS_AXIS, SPP_AXIS))
