"""Triangle meshes as padded device tensors + Wavefront OBJ loading.

Replaces the reference's ``dbot/object_model.h`` + ``ObjectModelLoader`` +
``SimpleWavefrontObjectModelLoader`` (mesh → Eigen vectors) and the VBO upload
in ``dbot/gpu/object_rasterizer.cpp``. Instead of an OO model + GL buffers, a
mesh is a frozen pytree of padded arrays plus **precomputed object-frame
Möller–Trumbore constants** that turn per-(particle, pixel, triangle) ray
intersection into batched matmuls (see ops/raycast.py).

Derivation of the intersection constants (camera at origin, ray ``t·d``):
for triangle ``(A, B, C)``, ``e1 = B−A``, ``e2 = C−A``:

    det   = d · g_det,   g_det = e2 × e1
    u_num = d · g_u,     g_u   = A × e2
    v_num = d · g_v,     g_v   = e1 × A
    t_num = A · g_det                       (independent of d!)

Hit iff (with s = sign(det), |det| > eps):
``s·u_num ≥ 0``, ``s·v_num ≥ 0``, ``s·(u_num+v_num) ≤ |det|``, ``s·t_num > 0``;
then ``t = t_num / det``. With z=1 pixel rays, ``t`` **is** the z-depth.

Under a rigid transform ``x ↦ R x + τ`` the constants update affinely:

    g_det' = R g_det
    g_u'   = R g_u + τ × (R e2)
    g_v'   = R g_v − τ × (R e1)
    t_num' = t_num + τ · (R g_det)

so the per-particle setup is a handful of small matmuls over triangles
(matmul-friendly), not a re-render.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TriangleMesh:
    """A single rigid object's triangle mesh, triangle count padded to a
    multiple of ``pad_to`` (static shapes across meshes of similar size).

    Padding triangles are fully degenerate (all vertices 0) → ``g_det = 0`` →
    ``det = 0`` for every ray → never a hit; no masks needed downstream.

    Attributes:
      vertices: (V, 3) float32, re-centered so the centroid is the origin
        (reference: ``ObjectModel::center_object``); V padded.
      faces: (T, 3) int32 vertex indices; T padded to ``pad_to``.
      tri_a / tri_e1 / tri_e2: (T, 3) triangle origin + edge vectors.
      g_u / g_v / g_det: (T, 3) object-frame intersection constants.
      t_num: (T,) object-frame scalar numerator of the ray parameter.
      center: (3,) the original centroid that was subtracted (world offset),
        used for the center↔model coordinate transforms in the tracker.
      num_triangles / num_vertices: true (unpadded) counts, static.
    """

    vertices: jax.Array
    faces: jax.Array
    tri_a: jax.Array
    tri_e1: jax.Array
    tri_e2: jax.Array
    g_u: jax.Array
    g_v: jax.Array
    g_det: jax.Array
    t_num: jax.Array
    center: jax.Array
    num_triangles: int = dataclasses.field(metadata=dict(static=True))
    num_vertices: int = dataclasses.field(metadata=dict(static=True))

    @property
    def padded_triangles(self) -> int:
        return self.faces.shape[0]


def make_mesh(vertices, faces, center: bool = True,
              pad_to: int = 128) -> TriangleMesh:
    """Build a TriangleMesh from raw arrays (host-side, NumPy)."""
    v = np.asarray(vertices, np.float64).reshape(-1, 3)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    nv, nt = len(v), len(f)
    if nt and (f.min() < 0 or f.max() >= nv):
        raise ValueError(
            f"mesh faces reference vertices outside [0, {nv}): "
            f"range [{f.min()}, {f.max()}]")
    c = v.mean(axis=0) if center else np.zeros(3)
    v = v - c

    a = v[f[:, 0]]
    e1 = v[f[:, 1]] - a
    e2 = v[f[:, 2]] - a
    g_det = np.cross(e2, e1)
    g_u = np.cross(a, e2)
    g_v = np.cross(e1, a)
    t_num = np.einsum("td,td->t", a, g_det)

    # nt + 1 guarantees at least one fully-degenerate padding row, which
    # downstream code uses as the safe "no triangle" target (candidate id
    # -1 → last row) for indexed/DMA access.
    tp = _round_up(max(nt, 1) + 1, pad_to)
    vp = _round_up(max(nv, 1), 8)

    def padt(x):
        out = np.zeros((tp,) + x.shape[1:], np.float32)
        out[:nt] = x
        return jnp.asarray(out)

    vpad = np.zeros((vp, 3), np.float32)
    vpad[:nv] = v
    fpad = np.zeros((tp, 3), np.int32)
    fpad[:nt] = f

    return TriangleMesh(
        vertices=jnp.asarray(vpad),
        faces=jnp.asarray(fpad),
        tri_a=padt(a), tri_e1=padt(e1), tri_e2=padt(e2),
        g_u=padt(g_u), g_v=padt(g_v), g_det=padt(g_det),
        t_num=padt(t_num[:, None])[:, 0],
        center=jnp.asarray(c, jnp.float32),
        num_triangles=nt,
        num_vertices=nv,
    )


# ---------------------------------------------------------------------------
# Wavefront OBJ parsing (host-side; reference: SimpleWavefrontObjectModelLoader)
# ---------------------------------------------------------------------------

def parse_obj(text: str):
    """Parse OBJ text → (vertices (V,3) f64, faces (T,3) i64).

    Supports ``v`` and ``f`` records; polygon faces are fan-triangulated;
    ``f v/vt/vn`` index forms and negative (relative) indices are handled.
    Everything else (normals, texcoords, materials, groups) is ignored, as in
    the reference loader.
    """
    verts: list = []
    faces: list = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if line.startswith("v "):
            parts = line.split()
            if len(parts) < 4:
                raise ValueError(
                    f"OBJ line {lineno}: vertex needs 3 coordinates: {line!r}")
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif line.startswith("f "):
            idx = []
            for tok in line.split()[1:]:
                i = int(tok.split("/")[0])
                idx.append(i - 1 if i > 0 else len(verts) + i)
            for k in range(1, len(idx) - 1):  # fan triangulation
                faces.append([idx[0], idx[k], idx[k + 1]])
    return np.array(verts, np.float64), np.array(faces, np.int64)


def load_obj(path, center: bool = True, scale: float = 1.0,
             pad_to: int = 128) -> TriangleMesh:
    """Load a Wavefront .obj file into a TriangleMesh.

    Prefers the native C++ parser (dbot_ros_tpu/native) when built; falls
    back to the pure-Python parser.
    """
    from dbot_ros_tpu.native import try_parse_obj_native

    result = try_parse_obj_native(str(path))
    if result is None:
        with open(path, "r") as fh:
            v, f = parse_obj(fh.read())
    else:
        v, f = result
    return make_mesh(v * scale, f, center=center, pad_to=pad_to)


# ---------------------------------------------------------------------------
# Procedural test meshes (the reference ships .obj assets; we generate)
# ---------------------------------------------------------------------------

def box_mesh(sx=0.1, sy=0.1, sz=0.1, center: bool = True,
             pad_to: int = 128) -> TriangleMesh:
    """Axis-aligned box of the given side lengths, 12 triangles.

    Faces wound counter-clockwise viewed from outside.
    """
    hx, hy, hz = sx / 2, sy / 2, sz / 2
    v = np.array([[x, y, z] for z in (-hz, hz) for y in (-hy, hy)
                  for x in (-hx, hx)], np.float64)
    # vertex index = x + 2y + 4z (bit order)
    f = np.array([
        [0, 2, 1], [1, 2, 3],  # z = -hz (normal -z)
        [4, 5, 6], [5, 7, 6],  # z = +hz (normal +z)
        [0, 1, 4], [1, 5, 4],  # y = -hy
        [2, 6, 3], [3, 6, 7],  # y = +hy
        [0, 4, 2], [2, 4, 6],  # x = -hx
        [1, 3, 5], [3, 7, 5],  # x = +hx
    ], np.int64)
    return make_mesh(v, f, center=center, pad_to=pad_to)


def l_shape_mesh(center: bool = True, pad_to: int = 128,
                 scale: float = 1.0) -> TriangleMesh:
    """Asymmetric L-shaped compound (two boxes): a fully pose-observable
    test object — a plain box has near-symmetries that make some pose
    directions unidentifiable from depth alone."""
    m1 = box_mesh(0.12 * scale, 0.04 * scale, 0.06 * scale, center=False)
    m2 = box_mesh(0.04 * scale, 0.08 * scale, 0.06 * scale, center=False)
    v1 = np.asarray(m1.vertices[: m1.num_vertices], np.float64)
    f1 = np.asarray(m1.faces[: m1.num_triangles], np.int64)
    v2 = np.asarray(m2.vertices[: m2.num_vertices], np.float64) + np.array(
        [-0.04, 0.06, 0.0]) * scale
    v = np.concatenate([v1, v2])
    f = np.concatenate([f1, f1 + len(v1)])
    return make_mesh(v, f, center=center, pad_to=pad_to)


def tagged_l_mesh(center: bool = True, pad_to: int = 128,
                  scale: float = 1.0) -> TriangleMesh:
    """L-shape with a corner tag (three boxes): breaks the plain L's
    REMAINING near-symmetry. The two-box L is asymmetric on paper, but
    a π rotation about its in-plane diagonal swaps the 12 cm and 8 cm
    legs into a silhouette only ~9 nats distinguishable from the true
    pose at 0.55 m / 80×60 (measured) — identical to the
    box's symmetry-quotient situation but APPROXIMATE, so neither the
    exact quotient metric nor a likelihood race can treat it cleanly.
    The tag box on the long leg's top face makes every π-twin cost
    hundreds of nats; use this mesh for recovery/flip certification
    scenarios."""
    s = scale
    m1 = box_mesh(0.12 * s, 0.04 * s, 0.06 * s, center=False)
    m2 = box_mesh(0.04 * s, 0.08 * s, 0.06 * s, center=False)
    m3 = box_mesh(0.035 * s, 0.035 * s, 0.05 * s, center=False)
    v1 = np.asarray(m1.vertices[: m1.num_vertices], np.float64)
    f1 = np.asarray(m1.faces[: m1.num_triangles], np.int64)
    v2 = np.asarray(m2.vertices[: m2.num_vertices], np.float64) + np.array(
        [-0.04, 0.06, 0.0]) * s
    v3 = np.asarray(m3.vertices[: m3.num_vertices], np.float64) + np.array(
        [0.085, 0.005, 0.055]) * s
    v = np.concatenate([v1, v2, v3])
    f = np.concatenate([f1, f1 + len(v1), f1 + len(v1) + len(v2)])
    return make_mesh(v, f, center=center, pad_to=pad_to)


def icosphere_mesh(radius=0.05, subdivisions=2, center: bool = True,
                   pad_to: int = 128) -> TriangleMesh:
    """Icosphere (20 · 4^s triangles) for curvature-bearing test scenes."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdivisions):
        cache: dict = {}
        verts = list(map(tuple, v))
        newf = []

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = (np.array(verts[i]) + np.array(verts[j])) / 2.0
                m /= np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(tuple(m))
            return cache[key]

        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            newf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.array(verts, np.float64)
        f = np.array(newf, np.int64)
    return make_mesh(v * radius, f, center=center, pad_to=pad_to)
