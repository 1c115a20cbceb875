"""The port's mesh loaders (scene/mesh.py) against the JAX package's.

Twins of tests/test_mesh_import.py's round trips (OBJ, binary and ASCII
STL, glTF with a data URI, GLB, the unknown extension) plus an ASCII PLY
with normals and a quad face: each writes its file to tmp_path, loads it
with the port's loader and with the JAX loader, and compares vertices,
normals and triangles exactly (both parse with numpy on the host), and
the triangle soup with the mesh that was written.
"""
import base64
import json
import struct

import numpy as np
import pytest

from montecarlo_pathtracing_tpu.scene import mesh as jmesh
from montecarlo_pathtracing_tpu_torch.scene import mesh as pmesh


def _soup(geom):
    """Canonical triangle soup: sorted [T, 9] corner rows."""
    v, t = geom.vertices, geom.triangles
    tri = np.concatenate([v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]], axis=1)
    tri = np.sort(tri.reshape(-1, 3, 3), axis=1).reshape(-1, 9)
    return tri[np.lexsort(tri.T[::-1])]


def _load_both(loader, path):
    """(port's geometry, JAX's geometry) of the same file, held equal."""
    got = getattr(pmesh, loader)(str(path))
    ref = getattr(jmesh, loader)(str(path))
    for name in ("vertices", "normals", "triangles"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    return got


@pytest.fixture
def ref_mesh():
    return pmesh.cube()


def test_cube_matches_reference():
    got, ref = pmesh.cube(), jmesh.cube()
    for name in ("vertices", "normals", "triangles"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))


def test_load_obj_matches_reference(tmp_path, ref_mesh):
    p = tmp_path / "m.obj"
    with open(p, "w") as f:
        for v in ref_mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in ref_mesh.triangles:
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")
    got = _load_both("load_obj", p)
    np.testing.assert_allclose(_soup(got), _soup(ref_mesh), atol=1e-6)


def test_load_stl_binary_matches_reference(tmp_path, ref_mesh):
    p = tmp_path / "m.stl"
    v, t = ref_mesh.vertices, ref_mesh.triangles
    with open(p, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(t)))
        for a, b, c in t:
            f.write(struct.pack("<3f", 0, 0, 0))
            for vi in (a, b, c):
                f.write(struct.pack("<3f", *v[vi]))
            f.write(struct.pack("<H", 0))
    got = _load_both("load_stl", p)
    np.testing.assert_allclose(_soup(got), _soup(ref_mesh), atol=1e-6)
    assert got.vertices.shape[0] == 8      # welded back to the cube's 8


def test_load_stl_ascii_matches_reference(tmp_path, ref_mesh):
    p = tmp_path / "m.stl"
    v, t = ref_mesh.vertices, ref_mesh.triangles
    with open(p, "w") as f:
        f.write("solid cube\n")
        for a, b, c in t:
            f.write(" facet normal 0 0 0\n  outer loop\n")
            for vi in (a, b, c):
                f.write(f"   vertex {v[vi][0]} {v[vi][1]} {v[vi][2]}\n")
            f.write("  endloop\n endfacet\n")
        f.write("endsolid cube\n")
    got = _load_both("load_stl", p)
    np.testing.assert_allclose(_soup(got), _soup(ref_mesh), atol=1e-6)


def _gltf_dict(ref_mesh, scale):
    v = ref_mesh.vertices.astype(np.float32)
    idx = ref_mesh.triangles.astype(np.uint32).reshape(-1)
    raw = v.tobytes() + idx.tobytes()
    return {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "scale": [scale] * 3}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0}, "indices": 1}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(v),
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5125, "count": len(idx),
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": v.nbytes},
            {"buffer": 0, "byteOffset": v.nbytes,
             "byteLength": idx.nbytes},
        ],
        "buffers": [{"byteLength": len(raw)}],
    }, raw


def test_load_gltf_data_uri_matches_reference(tmp_path, ref_mesh):
    doc, raw = _gltf_dict(ref_mesh, scale=2.0)
    doc["buffers"][0]["uri"] = (
        "data:application/octet-stream;base64,"
        + base64.b64encode(raw).decode())
    p = tmp_path / "m.gltf"
    with open(p, "w") as f:
        json.dump(doc, f)
    got = _load_both("load_gltf", p)
    scaled = pmesh.MeshGeometry(ref_mesh.vertices * 2.0, ref_mesh.normals,
                                ref_mesh.triangles)
    np.testing.assert_allclose(_soup(got), _soup(scaled), atol=1e-5)


def test_load_glb_matches_reference(tmp_path, ref_mesh):
    doc, raw = _gltf_dict(ref_mesh, scale=1.0)
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    raw += b"\0" * (-len(raw) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(raw), 0x004E4942) + raw)
    p = tmp_path / "m.glb"
    with open(p, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)))
        f.write(body)
    got = _load_both("load_mesh", p)
    np.testing.assert_allclose(_soup(got), _soup(ref_mesh), atol=1e-6)


def test_load_ply_ascii_matches_reference(tmp_path, ref_mesh):
    """An ASCII PLY with normals and a quad face (fan-triangulated), and
    one without normals (recomputed)."""
    v, n, t = ref_mesh.vertices, ref_mesh.normals, ref_mesh.triangles
    for with_normals in (True, False):
        p = tmp_path / f"m{int(with_normals)}.ply"
        with open(p, "w") as f:
            f.write("ply\nformat ascii 1.0\ncomment written by a test\n")
            f.write(f"element vertex {len(v)}\n")
            for c in "xyz":
                f.write(f"property float {c}\n")
            if with_normals:
                for c in ("nx", "ny", "nz"):
                    f.write(f"property float {c}\n")
            f.write(f"element face {len(t) + 1}\n")
            f.write("property list uchar int vertex_indices\nend_header\n")
            for i, x in enumerate(v):
                row = list(x) + (list(n[i]) if with_normals else [])
                f.write(" ".join(repr(float(c)) for c in row) + "\n")
            for a, b, c in t:
                f.write(f"3 {a} {b} {c}\n")
            f.write(f"4 {t[0][0]} {t[0][1]} {t[0][2]} {t[1][2]}\n")
        got = _load_both("load_ply", p)
        assert got.triangles.shape == (len(t) + 2, 3)
        np.testing.assert_allclose(got.vertices, v, atol=1e-6)
        if with_normals:
            np.testing.assert_allclose(got.normals, n, atol=1e-6)
        # the dispatcher takes the same parser
        _load_both("load_mesh", p)


def test_load_mesh_dispatch_unknown(tmp_path):
    for mod in (pmesh, jmesh):
        with pytest.raises(ValueError):
            mod.load_mesh(str(tmp_path / "m.xyz"))
