"""End-to-end CLI test: the batch entry point (the reference's
main.cpp analog) driven as a subprocess — render, PNG output,
checkpoint write, and resume."""

import json
import os
import subprocess
import sys

import numpy as np


def _run(args, cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "montecarlopathtracer.cli", *args],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=300,
    )


def test_cli_render_checkpoint_resume(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "r.png"
    ck = tmp_path / "ck.npz"
    common = [
        "--scene", "cornell", "--width", "16", "--height", "16",
        "--spp-per-pass", "1", "--max-depth", "2", "--ray-chunk", "0",
        "--out", str(out), "--checkpoint", str(ck),
    ]
    r1 = _run(common + ["--passes", "2"], root)
    assert r1.returncode == 0, r1.stderr[-2000:]
    assert out.exists() and ck.exists()
    lines = [json.loads(ln) for ln in r1.stderr.splitlines()
             if ln.startswith("{")]
    assert lines and lines[-1]["pass_idx"] == 2
    with np.load(ck) as z:
        assert int(z["pass_idx"]) == 2

    # Resume: the second run must continue at pass 3, not restart.
    r2 = _run(common + ["--passes", "1"], root)
    assert r2.returncode == 0, r2.stderr[-2000:]
    lines2 = [json.loads(ln) for ln in r2.stderr.splitlines()
              if ln.startswith("{")]
    assert lines2 and lines2[-1]["pass_idx"] == 3
    assert lines2[-1]["total_spp"] == 3.0


def test_cli_kdtree_fence_message(tmp_path):
    """The kdtree intersector (host KD build + lax stackless walk)
    wires up end to end through the CLI."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "kd.png"
    r = _run(
        ["--scene", "cornell", "--width", "8", "--height", "8",
         "--spp-per-pass", "1", "--passes", "1", "--max-depth", "2",
         "--intersector", "kdtree", "--ray-chunk", "0",
         "--out", str(out)],
        root,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists()
