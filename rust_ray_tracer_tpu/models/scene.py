"""Scene description and its compilation to device-resident structure-of-arrays.

The reference stores the scene as an ``Arc<dyn Hittable>`` pointer tree with
virtual dispatch per primitive (``/root/reference/src/geometry/mod.rs:45-62``)
and instancing via ray-transforming wrapper nodes (``geometry/transform.rs``).
None of that maps to a vector machine. Here:

  * a small host-side object API (Sphere, Triangle, XYRect, Cuboid, Translate,
    RotateY, FlipFace, ConstantMedium, the five materials, four textures)
    mirrors the reference's construction surface so scenes read the same, but
  * :func:`compile_scene` flattens everything into ``SceneData`` — flat JAX
    arrays grouped by primitive kind — and **bakes all instance transforms
    into the primitives** at compile time (a Translate/RotateY of a sphere or
    rect is exactly representable as a moved sphere / parallelogram quad, so
    this loses nothing), and
  * axis-aligned rects and cuboid faces lower to parallelogram *quads*
    (one primitive kind instead of three), preserving the reference's
    both-sides-hittable, normal-faces-the-ray semantics
    (``geometry/aarect.rs:38-67``).

``SceneData`` is a pytree: ``jax.grad`` w.r.t. its float leaves gives material
/ camera / vertex / emission gradients directly. Use :func:`partition` /
:func:`combine` to separate differentiable leaves from integer metadata.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import jax
import jax.numpy as jnp

from rust_ray_tracer_tpu.ops.camera import CameraData

# ---------------------------------------------------------------------------
# Enums (stable ABI for the kernels — never renumber)
# ---------------------------------------------------------------------------

MAT_LAMBERTIAN = 0   # material/mod.rs:47-84
MAT_METAL = 1        # material/mod.rs:86-108
MAT_DIELECTRIC = 2   # material/mod.rs:110-148
MAT_LIGHT = 3        # material/mod.rs:171-194
MAT_ISOTROPIC = 4    # material/mod.rs:196-216

TEX_SOLID = 0        # material/texture.rs:15-29
TEX_CHECKER = 1      # material/texture.rs:31-58
TEX_NOISE = 2        # material/texture.rs:60-82 (marble)
TEX_IMAGE = 3        # material/texture.rs:84-131

LIGHT_SPHERE = 0     # sphere.rs:101-119 (solid angle pdf + cone sampling)
LIGHT_QUAD = 1       # aarect.rs:123-143 (XZRect area pdf + uniform sampling)
LIGHT_NULL = 2       # Hittable defaults: pdf=0, random=(1,0,0)
                     # (geometry/mod.rs:56-61 — XYRect/YZRect/FlipFace lights)

PERLIN_N = 256       # perlin.rs:6 (const generic N)

MED_SPHERE = 0       # constant-medium boundary kinds (SceneData.med_kind)
MED_POLY = 1
MED_MESH = 2

CLUSTER = 128        # min triangles per culling cluster
MAX_CLUSTERS = 512   # cap on cluster count K — see compile_scene


# ---------------------------------------------------------------------------
# Device-side scene (structure of arrays)
# ---------------------------------------------------------------------------

class SceneData(NamedTuple):
    """Flat, static-shaped scene arrays. All float32 / int32 / bool.

    Zero-count primitive kinds are represented by 0-length arrays; kernels
    skip them with *static* Python branches (shapes are trace-time constants).
    """

    # Triangles: v0 + edge vectors (Möller–Trumbore precompute,
    # triangle.rs:17-18). double_sided is per-tri (constructor default false,
    # triangle.rs:27).
    tri_v0: jnp.ndarray       # [T,3]
    tri_e1: jnp.ndarray       # [T,3]
    tri_e2: jnp.ndarray       # [T,3]
    tri_mat: jnp.ndarray      # [T] int32
    tri_double: jnp.ndarray   # [T] bool
    tri_flip: jnp.ndarray     # [T] bool

    # Spheres — static and moving unified: center(t) lerps c0->c1 over
    # [t0, t1] (sphere.rs:145-148); static spheres use c1 == c0.
    sph_c0: jnp.ndarray       # [S,3]
    sph_c1: jnp.ndarray       # [S,3]
    sph_t0: jnp.ndarray       # [S]
    sph_t1: jnp.ndarray       # [S]
    sph_r: jnp.ndarray        # [S]
    sph_mat: jnp.ndarray      # [S] int32
    sph_flip: jnp.ndarray     # [S] bool

    # Parallelogram quads: point q, edges u, v. Covers XYRect/XZRect/YZRect
    # and arbitrarily rotated/translated cuboid faces.
    quad_q: jnp.ndarray       # [Q,3]
    quad_u: jnp.ndarray       # [Q,3]
    quad_v: jnp.ndarray       # [Q,3]
    quad_mat: jnp.ndarray     # [Q] int32
    quad_flip: jnp.ndarray    # [Q] bool

    # Triangle clusters: tris are Morton-ordered at compile time so each
    # consecutive group of tris (the cluster width, T/K) is spatially
    # compact; per-cluster AABBs let the GPU search skip whole clusters
    # for a block of rays (ops/tri_search.py) — one flat level standing
    # in for BVH traversal — and bound auto_compact's probe on big
    # meshes. Empty (all-pad) clusters carry inverted boxes (min > max).
    tri_cluster_min: jnp.ndarray  # [K,3]
    tri_cluster_max: jnp.ndarray  # [K,3]

    # Constant media (constant_medium.rs:46-80). The reference wraps any
    # ``Arc<dyn Hittable>``; here a boundary is either a sphere
    # (med_kind == MED_SPHERE: med_c/med_r) or a convex polytope
    # (med_kind == MED_POLY: med_pl_n/med_pl_d half-spaces n·p <= d —
    # covers Cuboid, incl. Translate/RotateY-wrapped, which is every
    # solid the reference could wrap besides spheres; flat rects yield
    # no second boundary hit in the reference and so no medium at all).
    med_c: jnp.ndarray        # [M,3]
    med_r: jnp.ndarray        # [M]
    med_neg_inv_d: jnp.ndarray  # [M]  = -1/density
    med_mat: jnp.ndarray      # [M] int32 (an Isotropic material)
    med_kind: jnp.ndarray     # [M] int32 (MED_SPHERE | MED_POLY)
    med_pl_n: jnp.ndarray     # [M,P,3] half-space normals (pad: 0)
    med_pl_d: jnp.ndarray     # [M,P]   half-space offsets (pad: 1)
    med_tri: jnp.ndarray      # [M,Tm,10] mesh-boundary triangles
                              # (v0|e1|e2|double flag; pad: zero edges)

    # Materials: union of the five reference materials.
    mat_kind: jnp.ndarray     # [K] int32
    mat_tex: jnp.ndarray      # [K] int32 (albedo or emission texture)
    mat_fuzz: jnp.ndarray     # [K] (metal fuzziness)
    mat_ior: jnp.ndarray      # [K] (dielectric index of refraction)

    # Textures (one level of checker indirection: even/odd point at leaves).
    tex_kind: jnp.ndarray     # [X] int32
    tex_color: jnp.ndarray    # [X,3] (solid color)
    tex_scale: jnp.ndarray    # [X] (noise scale)
    tex_even: jnp.ndarray     # [X] int32 (checker even leaf)
    tex_odd: jnp.ndarray      # [X] int32 (checker odd leaf)
    tex_image: jnp.ndarray    # [X] int32 (image atlas slot)

    # Image atlas (padded to a common size; nearest-neighbour lookup,
    # texture.rs:109-127).
    img_data: jnp.ndarray     # [I,Hm,Wm,3]
    img_size: jnp.ndarray     # [I,2] int32 (h, w)

    # Perlin tables (perlin.rs:6-31) — seeded here, unlike the reference.
    perlin_vec: jnp.ndarray   # [256,3]
    perlin_px: jnp.ndarray    # [256] int32
    perlin_py: jnp.ndarray    # [256] int32
    perlin_pz: jnp.ndarray    # [256] int32

    # Light-importance-sampling list (the `lights` Hittables in ray_color,
    # ray.rs:102-110).
    light_kind: jnp.ndarray   # [L] int32
    light_c: jnp.ndarray      # [L,3] sphere centers
    light_r: jnp.ndarray      # [L]   sphere radii
    light_q: jnp.ndarray      # [L,3] quad corner
    light_u: jnp.ndarray      # [L,3] quad edge 1
    light_v: jnp.ndarray      # [L,3] quad edge 2

    camera: CameraData
    background: jnp.ndarray   # [3]

    # ---- static counts (trace-time) ----
    @property
    def n_tris(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def n_spheres(self) -> int:
        return self.sph_c0.shape[0]

    @property
    def n_quads(self) -> int:
        return self.quad_q.shape[0]

    @property
    def n_media(self) -> int:
        return self.med_c.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_kind.shape[0]


def partition(scene: SceneData):
    """Split into (differentiable, static) pytrees with None placeholders."""
    def is_diff(x):
        return jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)

    diff = jax.tree.map(lambda x: x if is_diff(x) else None, scene)
    static = jax.tree.map(lambda x: None if is_diff(x) else x, scene)
    return diff, static


def combine(diff, static) -> SceneData:
    return jax.tree.map(lambda d, s: d if s is None else s, diff, static,
                        is_leaf=lambda x: x is None)


# ---------------------------------------------------------------------------
# Host-side construction API (mirrors the reference's types)
# ---------------------------------------------------------------------------

Vec = Union[Sequence[float], np.ndarray]


def _v(x) -> np.ndarray:
    return np.asarray(x, np.float32).reshape(3)


# ---- textures -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SolidColor:
    color: Vec


@dataclasses.dataclass(frozen=True)
class Checker:
    even: "Texture"
    odd: "Texture"

    @staticmethod
    def from_colors(c1: Vec, c2: Vec) -> "Checker":
        return Checker(SolidColor(c1), SolidColor(c2))


@dataclasses.dataclass(frozen=True)
class Noise:
    scale: float


@dataclasses.dataclass(frozen=True)
class ImageTexture:
    """Image texture from a file path or an array.

    Missing/undecodable files degrade to solid yellow, matching the
    reference (texture.rs:102-107,129).
    """
    path: Optional[str] = None
    data: Optional[np.ndarray] = dataclasses.field(default=None, hash=False,
                                                   compare=False)

    def load(self) -> Optional[np.ndarray]:
        if self.data is not None:
            return np.asarray(self.data, np.float32)
        if self.path is None:
            return None
        try:
            from PIL import Image  # optional dependency
            img = np.asarray(Image.open(self.path).convert("RGB"),
                             np.float32) / 255.0
            return img
        except Exception:
            pass
        try:  # self-contained PNG/JPEG/BMP/GIF/TIFF fallback (utils/image.py)
            from rust_ray_tracer_tpu.utils.image import decode_image
            with open(self.path, "rb") as f:
                raw = f.read()
            return np.asarray(decode_image(raw), np.float32) / 255.0
        except Exception:
            return None


Texture = Union[SolidColor, Checker, Noise, ImageTexture]


def _as_texture(x) -> Texture:
    if isinstance(x, (SolidColor, Checker, Noise, ImageTexture)):
        return x
    return SolidColor(_v(x))


# ---- materials ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Lambertian:
    albedo: Texture

    @staticmethod
    def from_color(c: Vec) -> "Lambertian":
        return Lambertian(SolidColor(c))

    @staticmethod
    def from_rgb(r, g, b) -> "Lambertian":
        return Lambertian(SolidColor((r, g, b)))


@dataclasses.dataclass(frozen=True)
class Metal:
    albedo: Vec
    fuzziness: float = 0.0


@dataclasses.dataclass(frozen=True)
class Dielectric:
    ir: float


@dataclasses.dataclass(frozen=True)
class DiffuseLight:
    emit: Texture

    @staticmethod
    def from_color(c: Vec) -> "DiffuseLight":
        return DiffuseLight(SolidColor(c))


@dataclasses.dataclass(frozen=True)
class Isotropic:
    albedo: Texture

    @staticmethod
    def from_color(c: Vec) -> "Isotropic":
        return Isotropic(SolidColor(c))


Material = Union[Lambertian, Metal, Dielectric, DiffuseLight, Isotropic]


# ---- objects ----------------------------------------------------------------

@dataclasses.dataclass
class Sphere:
    center: Vec
    radius: float
    material: Material


@dataclasses.dataclass
class MovingSphere:
    center0: Vec
    center1: Vec
    time0: float
    time1: float
    radius: float
    material: Material


@dataclasses.dataclass
class Triangle:
    v0: Vec
    v1: Vec
    v2: Vec
    material: Material
    double_sided: bool = False  # constructor always false (triangle.rs:27)


@dataclasses.dataclass
class Quad:
    """Parallelogram {q + a*u + b*v : a,b in [0,1]}."""
    q: Vec
    u: Vec
    v: Vec
    material: Material


def XYRect(x0, x1, y0, y1, k, material) -> Quad:
    return Quad((x0, y0, k), (x1 - x0, 0, 0), (0, y1 - y0, 0), material)


def XZRect(x0, x1, z0, z1, k, material) -> Quad:
    q = Quad((x0, k, z0), (x1 - x0, 0, 0), (0, 0, z1 - z0), material)
    q._is_xzrect = True  # only XZRect has light sampling (aarect.rs:123-143)
    return q


def YZRect(y0, y1, z0, z1, k, material) -> Quad:
    return Quad((k, y0, z0), (0, y1 - y0, 0), (0, 0, z1 - z0), material)


@dataclasses.dataclass
class Cuboid:
    """Axis-aligned box as 6 rects (cuboid.rs:23-76)."""
    minimum: Vec
    maximum: Vec
    material: Material

    def sides(self):
        mn, mx, m = _v(self.minimum), _v(self.maximum), self.material
        return [
            XYRect(mn[0], mx[0], mn[1], mx[1], mx[2], m),
            XYRect(mn[0], mx[0], mn[1], mx[1], mn[2], m),
            XZRect(mn[0], mx[0], mn[2], mx[2], mx[1], m),
            XZRect(mn[0], mx[0], mn[2], mx[2], mn[1], m),
            YZRect(mn[1], mx[1], mn[2], mx[2], mx[0], m),
            YZRect(mn[1], mx[1], mn[2], mx[2], mn[0], m),
        ]


@dataclasses.dataclass
class Mesh:
    """Triangle soup: a world object AND a valid ConstantMedium
    boundary — the reference's boundary is any ``Arc<dyn Hittable>``
    (geometry/constant_medium.rs:16), so a mesh volume must work too.

    ``triangles``: sequence of (v0, v1, v2) vertex triples. Boundary
    meshes should be closed and ``double_sided=True``: the reference's
    exit query (constant_medium.rs:48) hits the inside of the far face,
    which single-sided triangles backface-cull (triangle.rs) — a
    single-sided boundary yields no medium there and here alike.
    """
    triangles: Sequence
    material: Material | None = None
    double_sided: bool = True


@dataclasses.dataclass
class Translate:
    base: object
    offset: Vec


@dataclasses.dataclass
class RotateY:
    base: object
    angle_deg: float


@dataclasses.dataclass
class FlipFace:
    """Post-hit normal.y = -|normal.y| (geometry/mod.rs:222-234 — the
    reference's y-only 'flip' quirk, replicated for Cornell parity)."""
    base: object


@dataclasses.dataclass
class ConstantMedium:
    boundary: object          # must resolve to a Sphere
    density: float
    texture: Texture

    @staticmethod
    def from_color(boundary, density, color: Vec) -> "ConstantMedium":
        return ConstantMedium(boundary, density, SolidColor(color))


@dataclasses.dataclass
class Scene:
    """Host-side scene mirroring ``scene.rs:25-30``."""
    camera: CameraData
    world: list
    lights: list
    background: Vec


# ---------------------------------------------------------------------------
# Compilation: object graph -> SceneData
# ---------------------------------------------------------------------------

def _rot_y(deg: float) -> np.ndarray:
    """Object-to-world rotation matching RotateY's hit back-transform
    (transform.rs:112-121): p_world = [c*x + s*z, y, -s*x + c*z]."""
    r = np.deg2rad(deg)
    c, s = np.cos(r, dtype=np.float32), np.sin(r, dtype=np.float32)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _affine(rot=None, trans=None) -> np.ndarray:
    a = np.eye(3, 4, dtype=np.float32)
    if rot is not None:
        a[:, :3] = rot
    if trans is not None:
        a[:, 3] = _v(trans)
    return a


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a ∘ b (apply b first)."""
    out = np.empty((3, 4), np.float32)
    out[:, :3] = a[:, :3] @ b[:, :3]
    out[:, 3] = a[:, :3] @ b[:, 3] + a[:, 3]
    return out


def _apply_p(a: np.ndarray, p: np.ndarray) -> np.ndarray:
    return a[:, :3] @ _v(p) + a[:, 3]


def _apply_d(a: np.ndarray, d: np.ndarray) -> np.ndarray:
    return a[:, :3] @ _v(d)


class _Builder:
    def __init__(self):
        self.tris = []     # (v0, e1, e2, mat, double, flip)
        self.sphs = []     # (c0, c1, t0, t1, r, mat, flip)
        self.quads = []    # (q, u, v, mat, flip)
        self.media = []    # (c, r, neg_inv_d, mat)
        self.materials = []  # material rows
        self.textures = []   # texture rows
        self.images = []     # raw arrays
        self._mat_ids = {}
        self._tex_ids = {}

    # -- tables ---------------------------------------------------------
    def texture_id(self, tex: Texture) -> int:
        key = id(tex)
        if key in self._tex_ids:
            return self._tex_ids[key]
        if isinstance(tex, SolidColor):
            row = dict(kind=TEX_SOLID, color=_v(tex.color))
        elif isinstance(tex, Noise):
            row = dict(kind=TEX_NOISE, scale=float(tex.scale))
        elif isinstance(tex, ImageTexture):
            data = tex.load()
            if data is None:
                # missing file -> solid yellow (texture.rs:129)
                row = dict(kind=TEX_SOLID, color=_v((1.0, 1.0, 0.0)))
            else:
                img_id = len(self.images)
                self.images.append(np.asarray(data, np.float32))
                row = dict(kind=TEX_IMAGE, image=img_id)
        elif isinstance(tex, Checker):
            even = self.texture_id(_as_texture(tex.even))
            odd = self.texture_id(_as_texture(tex.odd))
            row = dict(kind=TEX_CHECKER, even=even, odd=odd)
        else:
            raise TypeError(f"unknown texture {tex!r}")
        tid = len(self.textures)
        self.textures.append(row)
        self._tex_ids[key] = tid
        return tid

    def material_id(self, mat: Material) -> int:
        key = id(mat)
        if key in self._mat_ids:
            return self._mat_ids[key]
        if isinstance(mat, Lambertian):
            row = dict(kind=MAT_LAMBERTIAN,
                       tex=self.texture_id(_as_texture(mat.albedo)))
        elif isinstance(mat, Metal):
            row = dict(kind=MAT_METAL,
                       tex=self.texture_id(SolidColor(mat.albedo)),
                       fuzz=float(mat.fuzziness))
        elif isinstance(mat, Dielectric):
            row = dict(kind=MAT_DIELECTRIC,
                       tex=self.texture_id(SolidColor((1.0, 1.0, 1.0))),
                       ior=float(mat.ir))
        elif isinstance(mat, DiffuseLight):
            row = dict(kind=MAT_LIGHT,
                       tex=self.texture_id(_as_texture(mat.emit)))
        elif isinstance(mat, Isotropic):
            row = dict(kind=MAT_ISOTROPIC,
                       tex=self.texture_id(_as_texture(mat.albedo)))
        else:
            raise TypeError(f"unknown material {mat!r}")
        mid = len(self.materials)
        self.materials.append(row)
        self._mat_ids[key] = mid
        return mid

    # -- object walk ------------------------------------------------------
    def add(self, obj, affine: np.ndarray, flip: bool):
        if isinstance(obj, (list, tuple)):
            for o in obj:
                self.add(o, affine, flip)
        elif isinstance(obj, Translate):
            # outer affine applies last: world = affine ∘ translate
            self.add(obj.base,
                     _compose(affine, _affine(trans=obj.offset)), flip)
        elif isinstance(obj, RotateY):
            self.add(obj.base,
                     _compose(affine, _affine(rot=_rot_y(obj.angle_deg))),
                     flip)
        elif isinstance(obj, FlipFace):
            self.add(obj.base, affine, True)
        elif isinstance(obj, Cuboid):
            for side in obj.sides():
                self.add(side, affine, flip)
        elif isinstance(obj, Sphere):
            c = _apply_p(affine, obj.center)
            self.sphs.append((c, c, 0.0, 1.0, float(obj.radius),
                              self.material_id(obj.material), flip))
        elif isinstance(obj, MovingSphere):
            c0 = _apply_p(affine, obj.center0)
            c1 = _apply_p(affine, obj.center1)
            self.sphs.append((c0, c1, float(obj.time0), float(obj.time1),
                              float(obj.radius),
                              self.material_id(obj.material), flip))
        elif isinstance(obj, Triangle):
            v0 = _apply_p(affine, obj.v0)
            v1 = _apply_p(affine, obj.v1)
            v2 = _apply_p(affine, obj.v2)
            self.tris.append((v0, v1 - v0, v2 - v0,
                              self.material_id(obj.material),
                              bool(obj.double_sided), flip))
        elif isinstance(obj, Quad):
            q = _apply_p(affine, obj.q)
            u = _apply_d(affine, obj.u)
            v = _apply_d(affine, obj.v)
            self.quads.append((q, u, v, self.material_id(obj.material), flip))
        elif isinstance(obj, Mesh):
            if obj.material is None:
                raise ValueError("a world-object Mesh needs a material "
                                 "(only ConstantMedium boundaries may "
                                 "omit it)")
            for (v0, v1, v2) in obj.triangles:
                self.add(Triangle(v0, v1, v2, obj.material,
                                  double_sided=obj.double_sided),
                         affine, flip)
        elif isinstance(obj, ConstantMedium):
            b = obj.boundary
            # unwrap transforms around the boundary
            a2 = affine
            while isinstance(b, (Translate, RotateY)):
                if isinstance(b, Translate):
                    a2 = _compose(a2, _affine(trans=b.offset))
                else:
                    a2 = _compose(a2, _affine(rot=_rot_y(b.angle_deg)))
                b = b.base
            iso = Isotropic(obj.texture)
            nid = -1.0 / float(obj.density)
            mat = self.material_id(iso)
            no_tris = np.zeros((0, 10), np.float32)
            if isinstance(b, Sphere):
                self.media.append((_apply_p(a2, b.center), float(b.radius),
                                   nid, mat, MED_SPHERE, [], no_tris))
            elif isinstance(b, Cuboid):
                # convex polytope boundary: one outward half-space per
                # face (n·p <= d inside). Matches the reference's
                # entry/exit pair hit1 ∈ (-inf,inf), hit2 ∈ (hit1.t, inf)
                # (constant_medium.rs:47-56) — for a convex solid those
                # are exactly the slab interval endpoints. Exact under
                # affine Translate/RotateY (planes transform with the
                # faces).
                center = _apply_p(a2, (_v(b.minimum) + _v(b.maximum)) * 0.5)
                planes = []
                for side in b.sides():
                    q = _apply_p(a2, side.q)
                    n = np.cross(_apply_d(a2, side.u), _apply_d(a2, side.v))
                    ln = float(np.linalg.norm(n))
                    if ln <= 0:
                        continue   # degenerate face: no constraint
                    n = n / ln
                    if float(np.dot(n, center - q)) > 0:
                        n = -n     # orient outward
                    planes.append((n.astype(np.float32),
                                   float(np.dot(n, q))))
                self.media.append((np.zeros(3, np.float32), 0.0,
                                   nid, mat, MED_POLY, planes, no_tris))
            elif isinstance(b, Mesh):
                # arbitrary triangle-mesh boundary: the reference's
                # entry/exit pair is two closest-hit queries over the
                # SAME hittable (constant_medium.rs:47-49) — replicated
                # per ray in ops/intersect._med_t over this table
                dbl = 1.0 if b.double_sided else 0.0
                rows = []
                for (v0, v1, v2) in b.triangles:
                    p0 = _apply_p(a2, _v(v0))
                    p1 = _apply_p(a2, _v(v1))
                    p2 = _apply_p(a2, _v(v2))
                    rows.append(np.concatenate(
                        [p0, p1 - p0, p2 - p0, [dbl]]).astype(np.float32))
                if not rows:
                    raise ValueError("empty Mesh boundary")
                self.media.append((np.zeros(3, np.float32), 0.0,
                                   nid, mat, MED_MESH, [],
                                   np.asarray(rows, np.float32)))
            else:
                raise NotImplementedError(
                    "ConstantMedium boundaries: Sphere, Cuboid or Mesh "
                    "(optionally Translate/RotateY-wrapped). A flat "
                    "rect boundary has no exit hit and yields no medium "
                    "in the reference either (constant_medium.rs:47-49)")
        else:
            raise TypeError(f"unknown scene object {obj!r}")


def _stack(rows, pick, shape, dtype=np.float32):
    if not rows:
        return np.zeros((0,) + shape, dtype)
    return np.asarray([pick(r) for r in rows], dtype).reshape(
        (len(rows),) + shape)


def _pad_rows(arrs: dict, multiple: int, pad_values: dict) -> dict:
    n = next(iter(arrs.values())).shape[0]
    if n == 0 or multiple <= 1:
        return arrs
    target = -(-n // multiple) * multiple
    if target == n:
        return arrs
    out = {}
    for k, a in arrs.items():
        pad = np.broadcast_to(
            np.asarray(pad_values.get(k, 0), a.dtype), (target - n,) + a.shape[1:]
        )
        out[k] = np.concatenate([a, pad], axis=0)
    return out


def _morton_codes_np(centroids: np.ndarray) -> np.ndarray:
    """[N] uint32 Morton codes, bit-identical to the native path
    (rrt_native.cpp morton_codes): all quantization arithmetic in f32
    with C truncation-toward-zero, so the primitive order — and hence
    the compiled scene, argmin tie-breaks and the exact rendered image —
    does not depend on whether librrt_native.so built (bitwise-
    determinism invariant across environments)."""
    c = np.asarray(centroids, np.float32)
    mn, mx = c.min(0), c.max(0)
    inv = np.where(mx > mn, np.float32(1.0) / (mx - mn).astype(np.float32),
                   np.float32(0.0)).astype(np.float32)
    f = ((c - mn) * inv).astype(np.float32)
    f = np.clip(f, np.float32(0.0), np.float32(1.0))
    q = (f * np.float32(1023.0)).astype(np.uint32).astype(np.uint64)

    def expand(v):
        v = (v * 0x00010001) & 0xFF0000FF
        v = (v * 0x00000101) & 0x0F00F00F
        v = (v * 0x00000011) & 0xC30C30C3
        v = (v * 0x00000005) & 0x49249249
        return v

    code = (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(q[:, 2])
    return code.astype(np.uint32)


def _morton_argsort(centroids: np.ndarray) -> np.ndarray:
    """Morton-curve ordering of [N,3] points (native C++ when available,
    vectorized NumPy otherwise — verified identical, tests/test_native.py)."""
    try:
        from rust_ray_tracer_tpu.native import morton_sort_native
        return morton_sort_native(centroids)
    except Exception:
        code = _morton_codes_np(centroids)
        return np.argsort(code, kind="stable").astype(np.int32)


def compile_scene(scene: Scene, seed: int = 0,
                  tri_pad: int | None = None, pad: int = 8) -> SceneData:
    """Flatten a host Scene into device arrays.

    Triangles are Morton-sorted (so cluster-sized index ranges are
    spatially compact) and padded to a multiple of ``tri_pad`` with
    degenerate zero-edge triangles (det == 0, can never hit); per-cluster
    AABBs are emitted for the GPU search's culling. Other kinds pad to
    ``pad`` with radius-0 spheres / zero-edge quads.

    ``tri_pad`` (= triangles per culling cluster) scales with the mesh:
    CLUSTER (128) up to 64k triangles, then doubling so the cluster
    count K stays <= MAX_CLUSTERS. The GPU search walks the K boxes per
    block of rays, so K bounds its per-block cull work; a wider cluster
    trades cull granularity (1/512 of the Morton curve per cluster —
    still spatially tight) for that bound. The search derives the
    cluster width from the compiled shapes, so no constant threads
    through the call chain.
    """
    b = _Builder()
    b.add(scene.world, _affine(), False)

    if tri_pad is None:
        tri_pad = CLUSTER
        while len(b.tris) > MAX_CLUSTERS * tri_pad:
            tri_pad *= 2

    # --- lights: only bare Sphere / XZRect have sampling (see LIGHT_* docs)
    l_kind, l_c, l_r, l_q, l_u, l_v = [], [], [], [], [], []
    for lt in scene.lights:
        if isinstance(lt, Sphere):
            l_kind.append(LIGHT_SPHERE)
            l_c.append(_v(lt.center))
            l_r.append(float(lt.radius))
            l_q.append(np.zeros(3, np.float32))
            l_u.append(np.zeros(3, np.float32))
            l_v.append(np.zeros(3, np.float32))
        elif isinstance(lt, Quad) and getattr(lt, "_is_xzrect", False):
            l_kind.append(LIGHT_QUAD)
            l_c.append(np.zeros(3, np.float32))
            l_r.append(0.0)
            l_q.append(_v(lt.q))
            l_u.append(_v(lt.u))
            l_v.append(_v(lt.v))
        else:
            l_kind.append(LIGHT_NULL)
            l_c.append(np.zeros(3, np.float32))
            l_r.append(0.0)
            l_q.append(np.zeros(3, np.float32))
            l_u.append(np.zeros(3, np.float32))
            l_v.append(np.zeros(3, np.float32))

    # --- pack + pad primitive tables
    tris = dict(
        v0=_stack(b.tris, lambda r: r[0], (3,)),
        e1=_stack(b.tris, lambda r: r[1], (3,)),
        e2=_stack(b.tris, lambda r: r[2], (3,)),
        mat=_stack(b.tris, lambda r: r[3], (), np.int32),
        double=_stack(b.tris, lambda r: r[4], (), bool),
        flip=_stack(b.tris, lambda r: r[5], (), bool),
    )
    if len(b.tris) > 1:
        perm = _morton_argsort(tris["v0"] + (tris["e1"] + tris["e2"]) / 3.0)
        tris = {k: a[perm] for k, a in tris.items()}
    tris = _pad_rows(tris, tri_pad, {})

    # per-cluster AABBs (padded tris: v0=0 e=0 -> point boxes at the
    # origin; give them inverted boxes instead so they can't enlarge a
    # cluster)
    tn = tris["v0"].shape[0]
    n_real = len(b.tris)
    if tn:
        corners = np.stack([tris["v0"], tris["v0"] + tris["e1"],
                            tris["v0"] + tris["e2"]], 1)  # [T,3corners,3]
        lo = corners.min(1)
        hi = corners.max(1)
        lo[n_real:] = np.inf
        hi[n_real:] = -np.inf
        k = tn // tri_pad
        cl_min = lo.reshape(k, tri_pad, 3).min(1)
        cl_max = hi.reshape(k, tri_pad, 3).max(1)
        # empty clusters (all-pad) keep inverted boxes (min > max)
    else:
        cl_min = np.zeros((0, 3), np.float32)
        cl_max = np.zeros((0, 3), np.float32)

    sphs = dict(
        c0=_stack(b.sphs, lambda r: r[0], (3,)),
        c1=_stack(b.sphs, lambda r: r[1], (3,)),
        t0=_stack(b.sphs, lambda r: r[2], ()),
        t1=_stack(b.sphs, lambda r: r[3], ()),
        r=_stack(b.sphs, lambda r: r[4], ()),
        mat=_stack(b.sphs, lambda r: r[5], (), np.int32),
        flip=_stack(b.sphs, lambda r: r[6], (), bool),
    )
    if len(b.sphs) > 1:
        sperm = _morton_argsort((sphs["c0"] + sphs["c1"]) * 0.5)
        sphs = {k: a[sperm] for k, a in sphs.items()}
    sphs = _pad_rows(sphs, pad, {"t1": 1.0})

    quads = dict(
        q=_stack(b.quads, lambda r: r[0], (3,)),
        u=_stack(b.quads, lambda r: r[1], (3,)),
        v=_stack(b.quads, lambda r: r[2], (3,)),
        mat=_stack(b.quads, lambda r: r[3], (), np.int32),
        flip=_stack(b.quads, lambda r: r[4], (), bool),
    )
    if len(b.quads) > 1:
        qperm = _morton_argsort(
            quads["q"] + 0.5 * (quads["u"] + quads["v"]))
        quads = {k: a[qperm] for k, a in quads.items()}
    quads = _pad_rows(quads, pad, {})

    meds = dict(
        c=_stack(b.media, lambda r: r[0], (3,)),
        r=_stack(b.media, lambda r: r[1], ()),
        nid=_stack(b.media, lambda r: r[2], ()),
        mat=_stack(b.media, lambda r: r[3], (), np.int32),
        kind=_stack(b.media, lambda r: r[4], (), np.int32),
    )
    # polytope boundary planes, padded to the max face count with
    # no-constraint half-spaces (n=0, d=1: 0 <= 1 everywhere)
    n_pl = max([len(r[5]) for r in b.media], default=0)
    med_pl_n = np.zeros((len(b.media), n_pl, 3), np.float32)
    med_pl_d = np.ones((len(b.media), n_pl), np.float32)
    for i, row in enumerate(b.media):
        for p, (nrm, off) in enumerate(row[5]):
            med_pl_n[i, p] = nrm
            med_pl_d[i, p] = off
    # mesh boundary triangles, padded with zero-edge rows (n = 0 ->
    # det 0 -> never valid, same convention as the main tri tables)
    n_mt = max([r[6].shape[0] for r in b.media], default=0)
    med_tri = np.zeros((len(b.media), n_mt, 10), np.float32)
    for i, row in enumerate(b.media):
        med_tri[i, :row[6].shape[0]] = row[6]

    # --- material / texture tables (at least one row so gathers are valid)
    mats = b.materials or [dict(kind=MAT_LAMBERTIAN, tex=0)]
    texs = b.textures or [dict(kind=TEX_SOLID, color=np.zeros(3, np.float32))]

    def mfield(name, default, dtype=np.float32):
        return np.asarray([m.get(name, default) for m in mats], dtype)

    def tfield(name, default, dtype=np.float32):
        return np.asarray([t.get(name, default) for t in texs], dtype)

    # Feature-presence is encoded in table *shapes* (static under jit) so the
    # kernels can skip dead texture work at trace time:
    #   no checkers  -> tex_even/tex_odd are length 0
    #   no noise     -> perlin tables are length 0
    #   no images    -> atlas is length 0
    has_checker = any(t.get("kind") == TEX_CHECKER for t in texs)
    has_noise = any(t.get("kind") == TEX_NOISE for t in texs)

    # --- image atlas
    if b.images:
        hm = max(i.shape[0] for i in b.images)
        wm = max(i.shape[1] for i in b.images)
        atlas = np.zeros((len(b.images), hm, wm, 3), np.float32)
        sizes = np.zeros((len(b.images), 2), np.int32)
        for i, img in enumerate(b.images):
            atlas[i, : img.shape[0], : img.shape[1]] = img[..., :3]
            sizes[i] = (img.shape[0], img.shape[1])
    else:
        atlas = np.zeros((0, 1, 1, 3), np.float32)
        sizes = np.ones((0, 2), np.int32)

    # --- perlin tables (seeded; reference uses unseeded thread_rng,
    #     perlin.rs:14-30 — seeding is a deliberate reproducibility fix)
    if has_noise:
        prng = np.random.default_rng(seed)
        perlin_vec = prng.uniform(-1.0, 1.0, (PERLIN_N, 3)).astype(np.float32)
        perms = [prng.permutation(PERLIN_N).astype(np.int32)
                 for _ in range(3)]
    else:
        perlin_vec = np.zeros((0, 3), np.float32)
        perms = [np.zeros((0,), np.int32) for _ in range(3)]

    j = jnp.asarray
    return SceneData(
        tri_v0=j(tris["v0"]), tri_e1=j(tris["e1"]), tri_e2=j(tris["e2"]),
        tri_mat=j(tris["mat"]), tri_double=j(tris["double"]),
        tri_flip=j(tris["flip"]),
        tri_cluster_min=j(cl_min.astype(np.float32)),
        tri_cluster_max=j(cl_max.astype(np.float32)),
        sph_c0=j(sphs["c0"]), sph_c1=j(sphs["c1"]), sph_t0=j(sphs["t0"]),
        sph_t1=j(sphs["t1"]), sph_r=j(sphs["r"]), sph_mat=j(sphs["mat"]),
        sph_flip=j(sphs["flip"]),
        quad_q=j(quads["q"]), quad_u=j(quads["u"]), quad_v=j(quads["v"]),
        quad_mat=j(quads["mat"]), quad_flip=j(quads["flip"]),
        med_c=j(meds["c"]), med_r=j(meds["r"]), med_neg_inv_d=j(meds["nid"]),
        med_mat=j(meds["mat"]), med_kind=j(meds["kind"]),
        med_pl_n=j(med_pl_n), med_pl_d=j(med_pl_d), med_tri=j(med_tri),
        mat_kind=j(mfield("kind", 0, np.int32)),
        mat_tex=j(mfield("tex", 0, np.int32)),
        mat_fuzz=j(mfield("fuzz", 0.0)),
        mat_ior=j(mfield("ior", 1.0)),
        tex_kind=j(tfield("kind", 0, np.int32)),
        tex_color=j(np.stack([np.asarray(t.get("color",
                                                np.zeros(3, np.float32)))
                              for t in texs]).astype(np.float32)),
        tex_scale=j(tfield("scale", 1.0)),
        tex_even=j(tfield("even", 0, np.int32) if has_checker
                   else np.zeros((0,), np.int32)),
        tex_odd=j(tfield("odd", 0, np.int32) if has_checker
                  else np.zeros((0,), np.int32)),
        tex_image=j(tfield("image", 0, np.int32)),
        img_data=j(atlas), img_size=j(sizes),
        perlin_vec=j(perlin_vec),
        perlin_px=j(perms[0]), perlin_py=j(perms[1]), perlin_pz=j(perms[2]),
        light_kind=j(np.asarray(l_kind, np.int32)),
        light_c=j(np.asarray(l_c, np.float32).reshape(len(l_kind), 3)),
        light_r=j(np.asarray(l_r, np.float32)),
        light_q=j(np.asarray(l_q, np.float32).reshape(len(l_kind), 3)),
        light_u=j(np.asarray(l_u, np.float32).reshape(len(l_kind), 3)),
        light_v=j(np.asarray(l_v, np.float32).reshape(len(l_kind), 3)),
        camera=scene.camera,
        background=j(_v(scene.background)),
    )
