"""Two-process `jax.distributed` exercise (VERDICT r1 missing #7).

Spawns two real OS processes, each contributing 2 virtual CPU devices,
wires them with `distributed.ensure_initialized` (coordinator on
localhost), runs one sharded progressive pass on the global 4-device
mesh, and asserts the all-gathered film equals the single-process
result on the same logical mesh — the multi-host path the reference
never had (SURVEY.md §2.3 distributed-init row).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_film_matches_single_process(tmp_path):
    port = _free_port()
    out = tmp_path / "film0.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "multiproc_worker.py")

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(i), str(out)],
            env=env,
            cwd=root,
            stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err.decode(errors="replace"))
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
    assert out.exists()
    with np.load(out) as z:
        multi_color = z["color"]
        weight = float(z["weight"])
    assert weight == 2.0

    # Single-process reference on the same logical mesh (4 of the
    # conftest's 8 virtual devices): identical per-device keys → the
    # same estimator, so the films must match.
    import jax
    from montecarlopathtracer.models import cornell
    from montecarlopathtracer.parallel.mesh import make_mesh
    from montecarlopathtracer.parallel.sharded import (
        make_progressive_step,
    )
    from montecarlopathtracer.render.film import Film
    from montecarlopathtracer.render.integrator import TraceConfig

    scene, camera = cornell.cornell_box(width=16, height=16)
    mesh = make_mesh(4, 1, devices=jax.devices()[:4])
    cfg = TraceConfig(mode="fixed", max_depth=2, ray_chunk=0)
    step = make_progressive_step(mesh, width=16, height=16, spp=2, config=cfg)
    film = step(scene, camera, Film.zeros(16, 16), jax.random.key(0))
    np.testing.assert_allclose(
        multi_color, np.asarray(film.color), rtol=1e-6, atol=1e-6
    )
