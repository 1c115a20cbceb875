"""Procedural triangle meshes + OBJ import.

Covers the reference's Mesh library (easycppogl/mesh.cpp): procedural
Cube (:252), Grid (:322), Wave (:356), Sphere as a lat-long grid (:431),
Cylinder (:387), ClosedCylinder (:468), ClosedCone (:551), Tore (:602),
area-weighted vertex normals (:125-141), and arbitrary-file import with
smooth normals (:646-750 via Assimp — here a dependency-free OBJ parser).

Geometry here is plain numpy (flat arrays), not a translation of the
reference's vertex layouts; it is the host side of the PyTorch port and
matches montecarlo_pathtracing_tpu/scene/mesh.py array for array.
"""
from __future__ import annotations

import numpy as np

from .scene import MeshGeometry

F32 = np.float32


def compute_vertex_normals(vertices: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (mesh.cpp:125-141 semantics:
    accumulate un-normalized face cross products, then normalize)."""
    v = vertices.astype(np.float64)
    t = triangles
    fn = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
    normals = np.zeros_like(v)
    for k in range(3):
        np.add.at(normals, t[:, k], fn)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    lens[lens == 0] = 1.0
    return (normals / lens).astype(F32)


def _mesh(vertices, triangles, normals=None) -> MeshGeometry:
    vertices = np.asarray(vertices, F32)
    triangles = np.asarray(triangles, np.int32)
    if normals is None:
        normals = compute_vertex_normals(vertices, triangles)
    return MeshGeometry(vertices, normals.astype(F32), triangles)


def cube() -> MeshGeometry:
    """Unit cube [-1,1]^3, 12 triangles, smooth normals."""
    corners = np.array(
        [[x, y, z] for z in (-1, 1) for y in (-1, 1) for x in (-1, 1)], F32
    )
    quads = [
        (0, 2, 3, 1),  # z = -1
        (4, 5, 7, 6),  # z = +1
        (0, 1, 5, 4),  # y = -1
        (2, 6, 7, 3),  # y = +1
        (0, 4, 6, 2),  # x = -1
        (1, 3, 7, 5),  # x = +1
    ]
    tris = []
    for a, b, c, d in quads:
        tris += [(a, b, c), (a, c, d)]
    return _mesh(corners, tris)


def grid(m: int = 8, n: int = 8) -> MeshGeometry:
    """Flat [-1,1]^2 grid at z=0 (mesh.cpp:322)."""
    xs = np.linspace(-1, 1, m + 1, dtype=F32)
    ys = np.linspace(-1, 1, n + 1, dtype=F32)
    vv = np.array([[x, y, 0.0] for y in ys for x in xs], F32)
    tris = []
    for j in range(n):
        for i in range(m):
            a = j * (m + 1) + i
            b, c, d = a + 1, a + m + 2, a + m + 1
            tris += [(a, b, c), (a, c, d)]
    return _mesh(vv, tris)


def wave(m: int = 32) -> MeshGeometry:
    """Grid displaced by a radial cosine wave (mesh.cpp:356)."""
    g = grid(m, m)
    v = g.vertices.copy()
    r = np.sqrt(v[:, 0] ** 2 + v[:, 1] ** 2)
    v[:, 2] = 0.2 * np.cos(6.0 * r) / (1.0 + 2.0 * r)
    return _mesh(v, g.triangles)


def sphere(res: int = 24) -> MeshGeometry:
    """Unit lat-long sphere (mesh.cpp:431)."""
    verts = [(0.0, 0.0, -1.0)]
    for j in range(1, res):
        theta = np.pi * j / res - np.pi / 2
        for i in range(res * 2):
            phi = 2 * np.pi * i / (res * 2)
            verts.append(
                (np.cos(theta) * np.cos(phi), np.cos(theta) * np.sin(phi),
                 np.sin(theta))
            )
    verts.append((0.0, 0.0, 1.0))
    verts = np.array(verts, F32)
    W = res * 2
    tris = []
    for i in range(W):
        tris.append((0, 1 + (i + 1) % W, 1 + i))
    for j in range(res - 2):
        r0 = 1 + j * W
        r1 = r0 + W
        for i in range(W):
            a, b = r0 + i, r0 + (i + 1) % W
            c, d = r1 + (i + 1) % W, r1 + i
            tris += [(a, b, c), (a, c, d)]
    top = len(verts) - 1
    rl = 1 + (res - 2) * W
    for i in range(W):
        tris.append((top, rl + i, rl + (i + 1) % W))
    return _mesh(verts, tris)


def _ring(radius, z, n):
    ang = 2 * np.pi * np.arange(n) / n
    return np.stack(
        [radius * np.cos(ang), radius * np.sin(ang), np.full(n, z)], axis=1
    ).astype(F32)


def cylinder(sides: int = 32, closed: bool = True) -> MeshGeometry:
    """Unit z-cylinder, optionally capped (mesh.cpp:387,468)."""
    bot = _ring(1.0, -1.0, sides)
    top = _ring(1.0, 1.0, sides)
    verts = [bot, top]
    tris = []
    for i in range(sides):
        a, b = i, (i + 1) % sides
        c, d = sides + (i + 1) % sides, sides + i
        tris += [(a, b, c), (a, c, d)]
    if closed:
        nb = 2 * sides
        verts += [np.array([[0, 0, -1.0]], F32), np.array([[0, 0, 1.0]], F32)]
        for i in range(sides):
            tris.append((nb, (i + 1) % sides, i))
            tris.append((nb + 1, sides + i, sides + (i + 1) % sides))
    return _mesh(np.concatenate(verts), tris)


def cone(sides: int = 32, closed: bool = True) -> MeshGeometry:
    """Unit cone: base ring at z=-1, apex at z=+1 (mesh.cpp:551)."""
    base = _ring(1.0, -1.0, sides)
    verts = [base, np.array([[0, 0, 1.0]], F32)]
    apex = sides
    tris = [(i, (i + 1) % sides, apex) for i in range(sides)]
    if closed:
        verts.append(np.array([[0, 0, -1.0]], F32))
        cbot = sides + 1
        tris += [(cbot, (i + 1) % sides, i) for i in range(sides)]
    return _mesh(np.concatenate(verts), tris)


def torus(major: float = 1.0, minor: float = 0.35, n1: int = 32,
          n2: int = 16) -> MeshGeometry:
    """Torus in the xy-plane (mesh.cpp:602)."""
    verts = []
    for i in range(n1):
        a = 2 * np.pi * i / n1
        cx, cy = major * np.cos(a), major * np.sin(a)
        for j in range(n2):
            b = 2 * np.pi * j / n2
            r = major + minor * np.cos(b)
            verts.append((r * np.cos(a), r * np.sin(a), minor * np.sin(b)))
    verts = np.array(verts, F32)
    tris = []
    for i in range(n1):
        for j in range(n2):
            a = i * n2 + j
            b = i * n2 + (j + 1) % n2
            c = ((i + 1) % n1) * n2 + (j + 1) % n2
            d = ((i + 1) % n1) * n2 + j
            tris += [(a, b, c), (a, c, d)]
    return _mesh(verts, tris)


def load_obj(path: str) -> MeshGeometry:
    """Minimal OBJ parser: v/vn/f records, polygons fan-triangulated,
    normals recomputed area-weighted when absent (mesh.cpp:646-750 analog)."""
    verts, norms, faces = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    return _mesh(np.array(verts, F32), np.array(faces, np.int32))


def load_ply(path: str) -> MeshGeometry:
    """Minimal ASCII PLY parser (vertex x y z [nx ny nz], face lists),
    polygons fan-triangulated; normals recomputed when absent."""
    with open(path) as f:
        line = f.readline().strip()
        if line != "ply":
            raise ValueError(f"not a ply file: {path}")
        fmt = f.readline().strip()
        if "ascii" not in fmt:
            raise ValueError(f"only ascii ply is supported: {path}")
        n_verts = n_faces = 0
        props = []
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line.startswith("comment"):
                continue
            if line.startswith("element vertex"):
                n_verts = int(line.split()[-1])
                in_vertex = True
            elif line.startswith("element face"):
                n_faces = int(line.split()[-1])
                in_vertex = False
            elif line.startswith("property") and in_vertex:
                props.append(line.split()[-1])
            elif line == "end_header":
                break
        xi, yi, zi = props.index("x"), props.index("y"), props.index("z")
        has_n = "nx" in props
        if has_n:
            nxi, nyi, nzi = (props.index("nx"), props.index("ny"),
                             props.index("nz"))
        verts, norms = [], []
        for _ in range(n_verts):
            vals = [float(v) for v in f.readline().split()]
            verts.append((vals[xi], vals[yi], vals[zi]))
            if has_n:
                norms.append((vals[nxi], vals[nyi], vals[nzi]))
        faces = []
        for _ in range(n_faces):
            vals = [int(v) for v in f.readline().split()]
            idx = vals[1:1 + vals[0]]
            for k in range(1, len(idx) - 1):
                faces.append((idx[0], idx[k], idx[k + 1]))
    return _mesh(np.array(verts, F32), np.array(faces, np.int32),
                 np.array(norms, F32) if norms else None)


def load_stl(path: str) -> MeshGeometry:
    """STL importer, binary and ASCII. STL is triangle soup, so vertices
    are welded (exact-coordinate dedup) before computing area-weighted
    smooth normals — matching the reference's Assimp import with
    aiProcess_GenSmoothNormals + JoinIdenticalVertices
    (mesh.cpp:682-684 analog)."""
    import struct

    with open(path, "rb") as f:
        head = f.read(80)
        rest = f.read()
    is_ascii = head[:5] == b"solid"
    if is_ascii:
        # a binary file may still start with "solid": check the size math
        if len(rest) >= 4:
            (n,) = struct.unpack("<I", rest[:4])
            if len(rest) == 4 + 50 * n:
                is_ascii = False
    soup = []
    if is_ascii:
        for line in (head + rest).decode("ascii", "replace").splitlines():
            parts = line.split()
            if parts and parts[0] == "vertex":
                soup.append([float(x) for x in parts[1:4]])
        soup = np.array(soup, F32)
    else:
        (n,) = struct.unpack("<I", rest[:4])
        rec = np.frombuffer(rest[4:4 + 50 * n], dtype=np.uint8)
        rec = rec.reshape(n, 50)[:, 12:48].copy()   # skip normal, attr
        soup = rec.view("<f4").reshape(n * 3, 3).astype(F32)
    if soup.size == 0:
        raise ValueError(f"no triangles in {path}")
    verts, inverse = np.unique(soup, axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3).astype(np.int32)
    # drop degenerate triangles produced by welding
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return _mesh(verts.astype(F32), faces[ok])


def load_gltf(path: str) -> MeshGeometry:
    """glTF 2.0 importer (.gltf JSON + external/data-URI buffers, and
    binary .glb). Reads POSITION/NORMAL/indices of every triangle
    primitive of every node, applying the node's world transform — the
    same flatten-the-scene-graph behavior as the reference's Assimp path
    (mesh.cpp:698-750 walks all aiMesh es into one vertex/index pool)."""
    import base64
    import json
    import os
    import struct

    if path.lower().endswith(".glb"):
        with open(path, "rb") as f:
            magic, _ver, _len = struct.unpack("<III", f.read(12))
            if magic != 0x46546C67:
                raise ValueError(f"not a glb file: {path}")
            gltf = None
            bin_chunk = b""
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                clen, ctype = struct.unpack("<II", hdr)
                data = f.read(clen)
                if ctype == 0x4E4F534A:        # 'JSON'
                    gltf = json.loads(data)
                elif ctype == 0x004E4942:      # 'BIN\0'
                    bin_chunk = data
        buffers = [bin_chunk]
    else:
        with open(path) as f:
            gltf = json.load(f)
        buffers = []
        for buf in gltf.get("buffers", []):
            uri = buf.get("uri", "")
            if uri.startswith("data:"):
                buffers.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                with open(os.path.join(os.path.dirname(path), uri),
                          "rb") as bf:
                    buffers.append(bf.read())

    comp_dtype = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
                  5123: np.uint16, 5125: np.uint32, 5126: np.float32}
    comp_n = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}

    def read_accessor(ai):
        acc = gltf["accessors"][ai]
        bv = gltf["bufferViews"][acc["bufferView"]]
        dt = np.dtype(comp_dtype[acc["componentType"]])
        n = comp_n[acc["type"]]
        count = acc["count"]
        off = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride") or dt.itemsize * n
        raw = buffers[bv["buffer"]]
        out = np.empty((count, n), dt)
        if stride == dt.itemsize * n:
            out[:] = np.frombuffer(
                raw, dt, count * n, off).reshape(count, n)
        else:
            for i in range(count):
                out[i] = np.frombuffer(raw, dt, n, off + i * stride)
        return out

    def node_matrix(node):
        if "matrix" in node:
            return np.array(node["matrix"], np.float64).reshape(4, 4).T
        m = np.eye(4)
        if "translation" in node:
            m[:3, 3] = node["translation"]
        if "rotation" in node:
            x, y, z, w = node["rotation"]
            r = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w),
                 1 - 2 * (x * x + y * y)]])
            m[:3, :3] = m[:3, :3] @ r
        if "scale" in node:
            m[:3, :3] = m[:3, :3] @ np.diag(node["scale"])
        return m

    verts_l, norms_l, faces_l = [], [], []
    base = 0
    have_all_normals = True

    def visit(ni, parent):
        nonlocal base, have_all_normals
        node = gltf["nodes"][ni]
        world = parent @ node_matrix(node)
        if "mesh" in node:
            for prim in gltf["meshes"][node["mesh"]]["primitives"]:
                if prim.get("mode", 4) != 4:        # triangles only
                    continue
                pos = read_accessor(
                    prim["attributes"]["POSITION"]).astype(np.float64)
                pos = pos @ world[:3, :3].T + world[:3, 3]
                if "indices" in prim:
                    idx = read_accessor(prim["indices"]).reshape(-1)
                else:
                    idx = np.arange(len(pos))
                faces_l.append(idx.reshape(-1, 3).astype(np.int64) + base)
                verts_l.append(pos)
                if "NORMAL" in prim["attributes"]:
                    nrm = read_accessor(
                        prim["attributes"]["NORMAL"]).astype(np.float64)
                    it = np.linalg.inv(world[:3, :3]).T
                    nrm = nrm @ it.T
                    ln = np.linalg.norm(nrm, axis=1, keepdims=True)
                    ln[ln == 0] = 1.0
                    norms_l.append(nrm / ln)
                else:
                    have_all_normals = False
                base += len(pos)
        for ci in node.get("children", []):
            visit(ci, world)

    scene_idx = gltf.get("scene", 0)
    roots = gltf["scenes"][scene_idx]["nodes"] if "scenes" in gltf else \
        list(range(len(gltf.get("nodes", []))))
    for ni in roots:
        visit(ni, np.eye(4))
    if not verts_l:
        raise ValueError(f"no triangle primitives in {path}")
    verts = np.concatenate(verts_l).astype(F32)
    faces = np.concatenate(faces_l).astype(np.int32)
    norms = (np.concatenate(norms_l).astype(F32)
             if have_all_normals and norms_l else None)
    return _mesh(verts, faces, norms)


def load_mesh(path: str) -> MeshGeometry:
    """Format-dispatching loader (Mesh::load analog, mesh.cpp:646-750:
    the reference delegates to Assimp; here dependency-free OBJ, PLY,
    STL and glTF/GLB parsers)."""
    lower = path.lower()
    if lower.endswith(".obj"):
        return load_obj(path)
    if lower.endswith(".ply"):
        return load_ply(path)
    if lower.endswith(".stl"):
        return load_stl(path)
    if lower.endswith(".gltf") or lower.endswith(".glb"):
        return load_gltf(path)
    raise ValueError(f"unsupported mesh format: {path}")
