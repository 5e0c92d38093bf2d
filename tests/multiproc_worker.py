"""Worker for the two-process `jax.distributed` test (not a pytest
module — spawned by tests/test_distributed_multiprocess.py).

argv: <coordinator_port> <process_id> <out_npz>

Each of the 2 processes contributes 2 virtual CPU devices → a global
4-device mesh. Runs `ensure_initialized` (the real multi-process path,
never executed in round 1 — VERDICT missing #7), then one sharded
progressive pass on the global mesh and dumps the all-gathered film.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

port, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from montecarlopathtracer.parallel import distributed  # noqa: E402

called = distributed.ensure_initialized(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
)
assert called, "ensure_initialized must take the multi-process path"
info = distributed.process_info()
assert info["process_count"] == 2, info
assert info["process_index"] == pid, info
assert info["local_devices"] == 2, info
assert info["global_devices"] == 4, info

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

from montecarlopathtracer.models import cornell  # noqa: E402
from montecarlopathtracer.parallel.mesh import make_mesh  # noqa: E402
from montecarlopathtracer.parallel.sharded import (  # noqa: E402
    film_sharding,
    make_progressive_step,
)
from montecarlopathtracer.render.film import Film  # noqa: E402
from montecarlopathtracer.render.integrator import TraceConfig  # noqa: E402

scene, camera = cornell.cornell_box(width=16, height=16)
mesh = make_mesh(4, 1)  # all 4 global devices on the rays axis
cfg = TraceConfig(mode="fixed", max_depth=2, ray_chunk=0)
step = make_progressive_step(mesh, width=16, height=16, spp=2, config=cfg)

# Build a *global* film: full-zero host array distributed band-wise.
z = Film.zeros(16, 16)
film = Film(
    color=jax.device_put(np.asarray(z.color), film_sharding(mesh)),
    weight=jax.device_put(np.asarray(z.weight), NamedSharding(mesh, P())),
    m2=jax.device_put(np.asarray(z.m2), NamedSharding(mesh, P())),
)
film = step(scene, camera, film, jax.random.key(0))
gathered = multihost_utils.process_allgather(film.color, tiled=True)
if pid == 0:
    np.savez(out, color=np.asarray(gathered), weight=float(film.weight))
print(f"worker {pid} ok", file=sys.stderr)
