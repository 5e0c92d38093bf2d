"""Native (C++) host-runtime parity tests.

The C++ OBJ parser and KD-tree builder (native/mcpt_native.cpp) must
produce *identical* outputs to the pure-Python oracles in scene/objio.py
and accel/kdtree.py — same pools (including dummy index-0 entries), same
tree topology, same flat arrays.
"""

import textwrap

import numpy as np
import pytest

from montecarlopathtracer import native
from montecarlopathtracer.scene.objio import _read_obj_py, read_obj
from montecarlopathtracer.accel.kdtree import (
    build_kdtree,
    flatten_kdtree,
    build_flat_kdtree,
)
from montecarlopathtracer.models import cornell

pytestmark = pytest.mark.skipif(
    not native.available(),
    reason=f"native library unavailable: {native.build_error()}",
)

QUIRKY_MTL = textwrap.dedent(
    """\
    newmtl plain
    Kd 0.5 0.6 0.7
    newmtl spec_ks_only
    Ks 1.0 0.9 0.8
    newmtl spec_ks_then_ns
    Ks 1.0 1.0 1.0
    Ns 100
    newmtl glassy
    Tr 0.9
    Ni 1.5
    Ka 0.1 0.2 0.3
    """
)

QUIRKY_OBJ = textwrap.dedent(
    """\
    mtllib quirky.mtl
    v 0 0 0
    v 1 0 0
    v 1 1 0
    v 0 1 0
    v 0 0 1
    vn 0 0 1
    vn 0 1 0
    vt 0.5 0.5
    g quad
    usemtl plain
    f 1 2 3 4
    g mixed
    usemtl spec_ks_then_ns
    f 1//1 2//1 3//2
    f 1/1/1 2/1/2 5/1/1
    usemtl unknown_material_name
    f 1 \\
    2 5
    g quad
    usemtl glassy
    f 5 4 3 2 1
    """
)


@pytest.fixture
def quirky_obj(tmp_path):
    (tmp_path / "quirky.mtl").write_text(QUIRKY_MTL)
    p = tmp_path / "quirky.obj"
    p.write_text(QUIRKY_OBJ)
    return str(p)


def _assert_models_equal(a, b):
    assert a.vertices == b.vertices
    assert a.textures == b.textures
    assert a.normals == b.normals
    assert len(a.triangles) == len(b.triangles)
    for ta, tb in zip(a.triangles, b.triangles):
        assert (ta.v, ta.t, ta.n, ta.material) == (tb.v, tb.t, tb.n, tb.material)
    assert len(a.materials) == len(b.materials)
    for ma, mb in zip(a.materials, b.materials):
        assert ma == mb
    assert a.groups == b.groups


def test_parser_parity_quirks(quirky_obj):
    """Fan triangulation, v//n / v/t/n forms, backslash continuation,
    Ks⇒Ns=2 quirk, unknown-usemtl→slot-0, group re-open."""
    py = _read_obj_py(quirky_obj)
    nat = native.read_obj_native(quirky_obj)
    _assert_models_equal(py, nat)
    # sanity on the quirks themselves
    assert py.materials[2].name == "spec_ks_only" and py.materials[2].Ns == 2.0
    assert py.materials[3].Ns == 100.0
    # 5-gon fan → 3 tris; re-opened "quad" group accumulates 2 + 3
    assert len(py.groups["quad"]) == 5
    # unknown usemtl resolved to material 0
    assert py.triangles[py.groups["mixed"][2]].material == 0


@pytest.mark.skipif(
    not cornell.has_reference_scenes(), reason="reference scenes not mounted"
)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_parser_parity_reference_scenes(n):
    path = cornell.reference_scene_path(n)
    py = _read_obj_py(path)
    nat = native.read_obj_native(path)
    _assert_models_equal(py, nat)


def test_read_obj_auto_prefers_native(quirky_obj, monkeypatch):
    monkeypatch.delenv("MCPT_NATIVE", raising=False)
    auto = read_obj(quirky_obj)
    forced = read_obj(quirky_obj, backend="native")
    _assert_models_equal(auto, forced)
    monkeypatch.setenv("MCPT_NATIVE", "0")
    pyv = read_obj(quirky_obj)
    _assert_models_equal(auto, pyv)


def _random_soup(T, seed=0, spread=3.0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-spread, spread, (T, 3)).astype(np.float32)
    b = a + rng.uniform(-1.0, 1.0, (T, 3)).astype(np.float32)
    c = a + rng.uniform(-1.0, 1.0, (T, 3)).astype(np.float32)
    return a, b, c


def _assert_flat_equal(f_py, f_nat):
    np.testing.assert_array_equal(f_py.node_skip, f_nat.node_skip)
    np.testing.assert_array_equal(f_py.leaf_start, f_nat.leaf_start)
    np.testing.assert_array_equal(f_py.leaf_count, f_nat.leaf_count)
    np.testing.assert_array_equal(f_py.leaf_tris, f_nat.leaf_tris)
    np.testing.assert_array_equal(f_py.node_lo, f_nat.node_lo)
    np.testing.assert_array_equal(f_py.node_hi, f_nat.node_hi)


@pytest.mark.parametrize("T,seed", [(30, 0), (200, 1), (600, 2)])
def test_kdtree_parity_random(T, seed):
    a, b, c = _random_soup(T, seed=seed)
    f_py = flatten_kdtree(build_kdtree(a, b, c))
    f_nat = native.build_kdtree_native(a, b, c)
    _assert_flat_equal(f_py, f_nat)


def test_kdtree_parity_cornell():
    scene, _ = cornell.cornell_box(
        with_mirror_sphere=True, with_glass_sphere=True
    )
    a, b, c = (np.asarray(x) for x in scene.triangle_vertices())
    valid = np.asarray(scene.tri_valid)
    f_py = flatten_kdtree(build_kdtree(a, b, c, valid), pad_leaf_to=8)
    f_nat = native.build_kdtree_native(a, b, c, valid, pad_leaf_to=8)
    _assert_flat_equal(f_py, f_nat)


def test_build_flat_kdtree_dispatch(monkeypatch):
    a, b, c = _random_soup(50, seed=3)
    monkeypatch.delenv("MCPT_NATIVE", raising=False)
    f_auto = build_flat_kdtree(a, b, c)
    f_py = build_flat_kdtree(a, b, c, backend="python")
    f_nat = build_flat_kdtree(a, b, c, backend="native")
    _assert_flat_equal(f_py, f_auto)
    _assert_flat_equal(f_py, f_nat)
