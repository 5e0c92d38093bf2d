"""OBJ/MTL parser tests: reference-parity quirks + loading the
reference's committed scenes (SURVEY.md C4, C9)."""

import os
import textwrap

import numpy as np
import pytest

from montecarlopathtracer.scene.objio import read_obj
from montecarlopathtracer.scene.scene import scene_pack_from_model
from montecarlopathtracer.models import cornell


def _write(tmp_path, name, content):
    p = os.path.join(tmp_path, name)
    with open(p, "w") as f:
        f.write(textwrap.dedent(content))
    return p


def test_fan_triangulation_and_groups(tmp_path):
    p = _write(
        tmp_path,
        "quad.obj",
        """\
        g wall
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        f 1 2 3 4
        """,
    )
    m = read_obj(p)
    # dummy slot 0 + 4 real vertices
    assert len(m.vertices) == 5
    # quad fans into 2 triangles: (1,2,3) and (1,3,4)
    tris = [m.triangles[i] for i in m.groups["wall"]]
    assert [t.v for t in tris] == [(1, 2, 3), (1, 3, 4)]


def test_ks_forces_specular_until_ns_overrides(tmp_path):
    _write(
        tmp_path,
        "m.mtl",
        """\
        newmtl only_ks
        Ks 1 1 1
        newmtl ks_then_ns
        Ks 1 1 1
        Ns 50
        """,
    )
    p = _write(tmp_path, "s.obj", "mtllib m.mtl\n")
    m = read_obj(p)
    mats = {mat.name: mat for mat in m.materials}
    assert mats["only_ks"].Ns == 2.0  # ObjReader.cpp:225-233 quirk
    assert mats["ks_then_ns"].Ns == 50.0


def test_face_vertex_formats(tmp_path):
    p = _write(
        tmp_path,
        "f.obj",
        """\
        v 0 0 0
        v 1 0 0
        v 0 1 0
        vt 0 0
        vn 0 0 1
        f 1/1/1 2//1 3
        """,
    )
    m = read_obj(p)
    t = m.triangles[1]
    assert t.v == (1, 2, 3)
    assert t.t == (1, 0, 0)
    assert t.n == (1, 1, 0)


def test_line_continuation(tmp_path):
    p = _write(tmp_path, "c.obj", "v 0 0 \\\n0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    m = read_obj(p)
    assert len(m.vertices) == 4
    assert m.triangles[1].v == (1, 2, 3)


def test_unknown_material_resolves_to_default(tmp_path):
    p = _write(
        tmp_path,
        "u.obj",
        """\
        v 0 0 0
        v 1 0 0
        v 0 1 0
        usemtl nonexistent
        f 1 2 3
        """,
    )
    m = read_obj(p)
    assert m.triangles[1].material == 0
    # default material fields (ObjReader.hpp:22)
    assert m.materials[0].Ns == 1.0 and m.materials[0].Ni == 1.0


@pytest.mark.skipif(
    not cornell.has_reference_scenes(), reason="reference scenes not mounted"
)
def test_reference_scene_triangle_counts():
    """MC.docx counts 863 / 1733 triangles *including* the parser's
    dummy triangle 0 (ObjReader.hpp:50); the real face fans are
    862 / 1732."""
    m1 = read_obj(cornell.reference_scene_path(1))
    m2 = read_obj(cornell.reference_scene_path(2))
    n1 = sum(len(v) for v in m1.groups.values())
    n2 = sum(len(v) for v in m2.groups.values())
    assert n1 == 862
    assert n2 == 1732

    # scene01 material semantics (scene01.mtl)
    mats = {m.name: m for m in m1.materials}
    assert mats["sphere_mirror"].Ns == 1000.0
    assert mats["sphere_transparent"].Tr == pytest.approx(0.9)
    assert mats["sphere_transparent"].Ni == pytest.approx(1.5)
    assert mats["blinn2SG"].Ka == pytest.approx((0.78, 0.78, 0.78))


def test_scene_pack_padding_and_masks(tmp_path):
    p = _write(
        tmp_path,
        "t.obj",
        """\
        v 0 0 0
        v 1 0 0
        v 0 1 0
        f 1 2 3
        """,
    )
    pack = scene_pack_from_model(read_obj(p))
    assert pack.num_triangles % 128 == 0
    assert int(np.sum(np.asarray(pack.tri_valid))) == 1
