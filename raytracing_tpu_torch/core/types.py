"""Scene and ray types: small frozen dataclasses of tensors (SoA), the
counterparts of ``raytracing_tpu.core.types``.

Each type has ``.to(device)``. Vectors are ``(..., 3)`` float32 tensors;
material ids are int32 and masks bool, as in the JAX package.
``scene_to_numpy`` / ``scene_from_numpy`` carry a scene, its mesh
instances and its prepared grids across the two packages as a dict of
numpy arrays, so both render the same inputs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

INF = math.inf
F32 = torch.float32


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def map_tensors(obj, fn):
    """Copy of a dataclass with ``fn`` applied to every tensor field, nested
    dataclasses and tuples included, in field order; other fields kept."""
    def walk(v):
        if isinstance(v, torch.Tensor):
            return fn(v)
        if dataclasses.is_dataclass(v):
            return map_tensors(v, fn)
        if isinstance(v, tuple):
            return tuple(walk(x) for x in v)
        return v
    return dataclasses.replace(obj, **{f.name: walk(getattr(obj, f.name))
                                       for f in dataclasses.fields(obj)})


class _OnDevice:
    """``.to(device)`` for the frozen dataclasses of tensors below."""

    def to(self, device):
        return map_tensors(self, lambda t: t.to(device))


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a.x*b.x + a.y*b.y + a.z*b.z over the last axis, in that order (the
    kernels' summation order)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi): a minimum of a maximum, whose cotangent splits
    at a bound as JAX's does (torch.clamp passes it whole there)."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def at_least(x: torch.Tensor, lo: float) -> torch.Tensor:
    """jnp.maximum(x, lo), its cotangent split at the tie as JAX's."""
    return torch.maximum(x, torch.full_like(x, lo))


def ray_window(x: torch.Tensor, offset: int, n: int, dim: int = 0
               ) -> torch.Tensor:
    """Entries ``[offset, offset + n)`` of ``x`` along ``dim`` (the ray
    axis), ``x`` zero-padded by ``n`` first, as JAX's sharded pass slices
    its draws: a ray shard padded past the film's last ray (a ray count the
    shards do not divide) keeps its window, its padding rows reading
    zeros. ``x`` itself when the window is the whole axis."""
    if offset == 0 and n == x.shape[dim]:
        return x
    pad = list(x.shape)
    pad[dim] = n
    x = torch.cat([x, x.new_zeros(pad)], dim)
    return x.narrow(dim, offset, n)


def safe_normalize(v: torch.Tensor) -> torch.Tensor:
    """Normalize over the last axis, guarding the squared norm before rsqrt
    (a zero vector stays zero)."""
    n2 = dot3(v, v)
    return v * torch.rsqrt(torch.where(n2 > 0.0, n2, 1.0))[..., None]


def tangent_frame(normal: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, B) for a normal by the min-|component| trick, ties toward x
    (raytracing_tpu.core.types.tangent_frame). Works on (..., 3)."""
    a = normal.abs()
    mn = torch.minimum(a[..., 0], torch.minimum(a[..., 1], a[..., 2]))
    fx = a[..., 0] == mn
    fy = (a[..., 1] == mn) & ~fx
    fz = (a[..., 2] == mn) & ~fx & ~fy
    v = torch.stack([torch.where(fx, 1.0, normal[..., 0]),
                     torch.where(fy, 1.0, normal[..., 1]),
                     torch.where(fz, 1.0, normal[..., 2])], -1)
    v = safe_normalize(v)
    t = safe_normalize(cross3(v, normal))
    b = safe_normalize(cross3(normal, t))
    return t, b


@dataclasses.dataclass(frozen=True)
class Rays(_OnDevice):
    """A batch of rays; ``mint == maxt`` marks a dead ray."""
    o: torch.Tensor      # (N, 3)
    d: torch.Tensor      # (N, 3)
    mint: torch.Tensor   # (N,)
    maxt: torch.Tensor   # (N,)

    @property
    def n(self) -> int:
        return self.o.shape[0]

    @property
    def alive(self) -> torch.Tensor:
        return self.mint != self.maxt

    def at(self, t: torch.Tensor) -> torch.Tensor:
        """Point along each ray: o + t * d."""
        return self.o + t[..., None] * self.d


@dataclasses.dataclass(frozen=True)
class Hits(_OnDevice):
    """Per-ray hit record and path throughput; ``mat_id < 0`` marks no
    hit."""
    p: torch.Tensor           # (N, 3) hit point
    n: torch.Tensor           # (N, 3) shading normal
    throughput: torch.Tensor  # (N, 3)
    mat_id: torch.Tensor      # (N,) int32, -1 = no hit
    t: torch.Tensor           # (N,) hit distance

    @property
    def valid(self) -> torch.Tensor:
        return self.mat_id >= 0

    @staticmethod
    def none(n: int, device=None) -> "Hits":
        """No hits, unit throughput."""
        z3 = torch.zeros((n, 3), device=device)
        return Hits(p=z3, n=z3, throughput=torch.ones((n, 3), device=device),
                    mat_id=torch.full((n,), -1, dtype=torch.int32,
                                      device=device),
                    t=torch.full((n,), INF, device=device))


@dataclasses.dataclass(frozen=True)
class AABB(_OnDevice):
    pmin: torch.Tensor  # (3,)
    pmax: torch.Tensor  # (3,)

    @staticmethod
    def empty(device=None) -> "AABB":
        return AABB(pmin=torch.full((3,), INF, device=device),
                    pmax=torch.full((3,), -INF, device=device))

    def merge(self, other: "AABB") -> "AABB":
        return AABB(pmin=torch.minimum(self.pmin, other.pmin),
                    pmax=torch.maximum(self.pmax, other.pmax))

    @property
    def center(self) -> torch.Tensor:
        return 0.5 * (self.pmin + self.pmax)

    @property
    def diagonal(self) -> torch.Tensor:
        return torch.linalg.norm(self.pmax - self.pmin)

    def inflate_degenerate(self, eps: float = 0.1) -> "AABB":
        """Inflate zero-extent axes (axis-aligned walls)."""
        degen = self.pmin == self.pmax
        return AABB(pmin=torch.where(degen, self.pmin - eps, self.pmin),
                    pmax=torch.where(degen, self.pmax + eps, self.pmax))


@dataclasses.dataclass(frozen=True)
class Spheres(_OnDevice):
    center: torch.Tensor  # (S, 3)
    radius: torch.Tensor  # (S,)
    mat_id: torch.Tensor  # (S,) int32
    mask: torch.Tensor    # (S,) bool; False rows are padding

    @property
    def count(self) -> int:
        return self.center.shape[0]

    def bounds(self) -> AABB:
        r = self.radius[:, None]
        m = self.mask[:, None]
        lo = torch.where(m, self.center - r, INF).amin(0)
        hi = torch.where(m, self.center + r, -INF).amax(0)
        return AABB(pmin=lo, pmax=hi)

    @staticmethod
    def empty(device=None) -> "Spheres":
        return Spheres(center=torch.zeros((0, 3), device=device),
                       radius=torch.zeros((0,), device=device),
                       mat_id=torch.zeros((0,), dtype=torch.int32,
                                          device=device),
                       mask=torch.zeros((0,), dtype=torch.bool, device=device))


@dataclasses.dataclass(frozen=True)
class Triangles(_OnDevice):
    v: torch.Tensor       # (T, 3, 3) vertices p0, p1, p2
    vn: torch.Tensor      # (T, 3, 3) vertex normals
    mat_id: torch.Tensor  # (T,) int32
    mask: torch.Tensor    # (T,) bool

    @property
    def count(self) -> int:
        return self.v.shape[0]

    def bounds(self) -> AABB:
        m = self.mask[:, None, None]
        lo = torch.where(m, self.v, INF).reshape(-1, 3).amin(0)
        hi = torch.where(m, self.v, -INF).reshape(-1, 3).amax(0)
        return AABB(pmin=lo, pmax=hi)

    @staticmethod
    def empty(device=None) -> "Triangles":
        return Triangles(v=torch.zeros((0, 3, 3), device=device),
                         vn=torch.zeros((0, 3, 3), device=device),
                         mat_id=torch.zeros((0,), dtype=torch.int32,
                                            device=device),
                         mask=torch.zeros((0,), dtype=torch.bool,
                                          device=device))


@dataclasses.dataclass(frozen=True)
class Lights(_OnDevice):
    """Disk area lights."""
    position: torch.Tensor    # (L, 3)
    normal: torch.Tensor      # (L, 3) unit
    irradiance: torch.Tensor  # (L, 3)
    radius: torch.Tensor      # (L,)

    @property
    def count(self) -> int:
        return self.position.shape[0]

    @property
    def area(self) -> torch.Tensor:
        return math.pi * self.radius ** 2

    def frames(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(T, B) of each light's disk, (L, 3) each."""
        return tangent_frame(self.normal)

    @staticmethod
    def make(position, normal, irradiance, radius, device=None) -> "Lights":
        position = torch.as_tensor(np.asarray(position, np.float32),
                                   device=device).reshape(-1, 3)
        normal = torch.as_tensor(np.asarray(normal, np.float32),
                                 device=device).reshape(-1, 3)
        normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
        irradiance = torch.as_tensor(np.asarray(irradiance, np.float32),
                                     device=device).reshape(-1, 3)
        radius = torch.as_tensor(np.asarray(radius, np.float32),
                                 device=device).reshape(-1)
        return Lights(position, normal, irradiance, radius)

    @staticmethod
    def empty(device=None) -> "Lights":
        z = torch.zeros((0, 3), device=device)
        return Lights(position=z, normal=z, irradiance=z,
                      radius=torch.zeros((0,), device=device))


@dataclasses.dataclass(frozen=True)
class Camera(_OnDevice):
    """Pinhole / thin-lens camera; W points backwards (eye - lookAt) and the
    film plane sits at -W."""
    eye: torch.Tensor     # (3,)
    u: torch.Tensor       # (3,)
    v: torch.Tensor       # (3,)
    w: torch.Tensor       # (3,)
    width: torch.Tensor   # () film width in scene units
    height: torch.Tensor  # () film height in scene units
    cols: int = 320
    rows: int = 240

    @staticmethod
    def look_at(eye, lookat, vup, fov_deg, cols: int, rows: int,
                device=None) -> "Camera":
        """height = 2 tan(fov/2); width = height * aspect."""
        def vec(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)
        eye, lookat, vup = vec(eye), vec(lookat), vec(vup)
        aspect = cols / rows
        fov = torch.tensor(fov_deg, dtype=F32, device=device)
        height = 2.0 * torch.tan(0.5 * torch.deg2rad(fov))
        width = height * aspect
        w = eye - lookat
        w = w / torch.linalg.norm(w)
        u = torch.linalg.cross(vup, w)
        u = u / torch.linalg.norm(u)
        v = torch.linalg.cross(w, u)
        return Camera(eye=eye, u=u, v=v, w=w, width=width, height=height,
                      cols=cols, rows=rows)

    @staticmethod
    def auto_frame(bounds: AABB, cols: int, rows: int,
                   fov_deg: float = 60.0) -> "Camera":
        """Eye on +z at distance = scene diagonal, axis-aligned basis."""
        dev = bounds.pmin.device
        eye = bounds.center + torch.tensor([0.0, 0.0, 1.0], device=dev) \
            * bounds.diagonal
        fov = torch.tensor(fov_deg, dtype=F32, device=dev)
        height = 2.0 * torch.tan(0.5 * torch.deg2rad(fov))
        width = height * (cols / rows)
        return Camera(eye=eye,
                      u=torch.tensor([1.0, 0.0, 0.0], device=dev),
                      v=torch.tensor([0.0, 1.0, 0.0], device=dev),
                      w=torch.tensor([0.0, 0.0, 1.0], device=dev),
                      width=width, height=height, cols=cols, rows=rows)

    def orbit(self, bounds: AABB, angle_deg) -> "Camera":
        """The eye orbited around the bounds' centre in the xz plane at the
        bounds' diagonal, looking at the centre (the JAX package's
        ``Camera.orbit``; the reference's Camera.rotate)."""
        center, diag = bounds.center, bounds.diagonal
        rad = torch.deg2rad(torch.full((), float(angle_deg), dtype=F32,
                                       device=center.device))
        eye = center + diag * torch.stack([torch.sin(rad),
                                           torch.zeros_like(rad),
                                           torch.cos(rad)])
        w = eye - center
        w = w / torch.linalg.norm(w)
        u = torch.linalg.cross(self.v, w)
        u = u / torch.linalg.norm(u)
        return replace(self, eye=eye, w=w, u=u)


@dataclasses.dataclass(frozen=True, eq=False)
class MeshInstance(_OnDevice):
    """A triangle mesh with its own grid resolution ``nslabs`` (the
    reference's Mesh, Assign10 code.js:94-170); its material ids are baked
    into its triangles."""
    tris: Triangles
    bounds_min: torch.Tensor   # (3,)
    bounds_max: torch.Tensor
    grid: object = None        # accel.grid.Grid, built by prepare_grids
    nslabs: int = 1

    @property
    def bounds(self) -> AABB:
        return AABB(pmin=self.bounds_min, pmax=self.bounds_max)


@dataclasses.dataclass(frozen=True, eq=False)
class Scene(_OnDevice):
    """Geometry, lights, materials, camera and bounds. The grid fields are
    filled by ``accel.prepare_grids``: ``sphere_grid`` and
    ``triangle_grid`` over the sphere and scene-triangle batches (the stage
    route's grid mode, with each mesh's own ``grid``), ``folded_tri_grid``
    kernel 1's triangle grids (one per mesh of more than 64 triangles, item
    ids absolute into ``render.stages._all_triangles``' fold, or one over
    the whole fold) and ``mega_sph_grid`` kernel 1's sphere grid (built past
    the resident sphere budget)."""
    camera: Camera
    spheres: Spheres
    triangles: Triangles
    lights: Lights
    materials: torch.Tensor          # (M, 4) rgba diffuse albedo
    bounds_min: torch.Tensor         # (3,) merged scene bounds
    bounds_max: torch.Tensor
    sphere_bounds_min: torch.Tensor
    sphere_bounds_max: torch.Tensor
    triangle_bounds_min: torch.Tensor
    triangle_bounds_max: torch.Tensor
    focal_length: torch.Tensor       # ()
    lens_radius: torch.Tensor        # () lens_diameter / 2
    meshes: tuple = ()               # MeshInstance, ...
    sphere_grid: object = None
    triangle_grid: object = None
    folded_tri_grid: tuple | None = None
    mega_sph_grid: object = None

    @property
    def bounds(self) -> AABB:
        return AABB(pmin=self.bounds_min, pmax=self.bounds_max)

    @property
    def device(self) -> torch.device:
        return self.materials.device


def build_scene(camera: Camera, spheres: Spheres | None = None,
                triangles: Triangles | None = None,
                lights: Lights | None = None, materials=None,
                focal_length: float = 1.0,
                lens_diameter: float = 0.0, meshes: tuple = ()) -> Scene:
    """Assemble a Scene with merged bounds (the meshes' bounds merged in),
    inflating degenerate triangle AABB axes by 0.1
    (raytracing_tpu.core.types.build_scene)."""
    dev = camera.eye.device
    spheres = spheres if spheres is not None else Spheres.empty(dev)
    triangles = triangles if triangles is not None else Triangles.empty(dev)
    lights = lights if lights is not None else Lights.empty(dev)
    if materials is None:
        materials = torch.ones((1, 4), device=dev)
    materials = torch.as_tensor(np.asarray(materials, np.float32)
                                if not isinstance(materials, torch.Tensor)
                                else materials, dtype=F32,
                                device=dev).reshape(-1, 4)
    sb = spheres.bounds() if spheres.count else AABB.empty(dev)
    tb = triangles.bounds() if triangles.count else AABB.empty(dev)
    if triangles.count:
        tb = tb.inflate_degenerate(0.1)
    merged = sb.merge(tb)
    for m in meshes:
        merged = merged.merge(m.bounds)
    return Scene(camera=camera, spheres=spheres, triangles=triangles,
                 meshes=tuple(meshes), lights=lights, materials=materials,
                 bounds_min=merged.pmin, bounds_max=merged.pmax,
                 sphere_bounds_min=sb.pmin, sphere_bounds_max=sb.pmax,
                 triangle_bounds_min=tb.pmin, triangle_bounds_max=tb.pmax,
                 focal_length=torch.tensor(focal_length, dtype=F32,
                                           device=dev),
                 lens_radius=torch.tensor(lens_diameter, dtype=F32,
                                          device=dev) / 2.0)


def make_spheres(centers, radii, mat_ids=None, pad_to: int | None = None,
                 device=None) -> Spheres:
    centers = np.asarray(centers, np.float32).reshape(-1, 3)
    radii = np.asarray(radii, np.float32).reshape(-1)
    n = centers.shape[0]
    mat_ids = (np.zeros((n,), np.int32) if mat_ids is None
               else np.asarray(mat_ids, np.int32).reshape(-1))
    mask = np.ones((n,), bool)
    if pad_to is not None and pad_to > n:
        p = pad_to - n
        centers = np.concatenate([centers, np.zeros((p, 3), np.float32)])
        radii = np.concatenate([radii, np.zeros((p,), np.float32)])
        mat_ids = np.concatenate([mat_ids, np.full((p,), -1, np.int32)])
        mask = np.concatenate([mask, np.zeros((p,), bool)])
    return Spheres(center=torch.as_tensor(centers, device=device),
                   radius=torch.as_tensor(radii, device=device),
                   mat_id=torch.as_tensor(mat_ids, device=device),
                   mask=torch.as_tensor(mask, device=device))


def make_triangles(vertices, normals=None, mat_ids=None,
                   pad_to: int | None = None, device=None) -> Triangles:
    v = torch.as_tensor(np.asarray(vertices, np.float32),
                        device=device).reshape(-1, 3, 3)
    n = v.shape[0]
    if normals is None:
        # geometric normal replicated to the vertices
        gn = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        gn = gn / torch.clamp(torch.linalg.norm(gn, dim=-1, keepdim=True),
                              min=1e-20)
        vn = gn[:, None, :].expand(v.shape).contiguous()
    else:
        vn = torch.as_tensor(np.asarray(normals, np.float32),
                             device=device).reshape(-1, 3, 3)
    mat = (torch.zeros((n,), dtype=torch.int32, device=device)
           if mat_ids is None else
           torch.as_tensor(np.asarray(mat_ids, np.int32),
                           device=device).reshape(-1))
    mask = torch.ones((n,), dtype=torch.bool, device=device)
    if pad_to is not None and pad_to > n:
        p = pad_to - n
        v = torch.cat([v, torch.zeros((p, 3, 3), device=device)])
        vn = torch.cat([vn, torch.zeros((p, 3, 3), device=device)])
        mat = torch.cat([mat, torch.full((p,), -1, dtype=torch.int32,
                                         device=device)])
        mask = torch.cat([mask, torch.zeros((p,), dtype=torch.bool,
                                            device=device)])
    return Triangles(v=v, vn=vn, mat_id=mat, mask=mask)


# ---------------------------------------------------------------------------
# carrying a scene across packages
# ---------------------------------------------------------------------------

_LEAVES = {
    "camera": ("eye", "u", "v", "w", "width", "height"),
    "spheres": ("center", "radius", "mat_id", "mask"),
    "triangles": ("v", "vn", "mat_id", "mask"),
    "lights": ("position", "normal", "irradiance", "radius"),
}
_SCENE_LEAVES = ("materials", "bounds_min", "bounds_max",
                 "sphere_bounds_min", "sphere_bounds_max",
                 "triangle_bounds_min", "triangle_bounds_max",
                 "focal_length", "lens_radius")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _grid_csr(g) -> tuple[np.ndarray, np.ndarray]:
    """(offsets, payload) of a grid in cell order. The JAX package's
    kernel grids are stored front to back from the camera
    (``mega_order_grid``, which keeps each cell's list and records the
    cell centres in visit order): their cells are put back in order, each
    centre naming its cell."""
    off, pay = _np(g.cell_offsets), _np(g.item_indices)
    cen = getattr(g, "cell_centers", None)
    if cen is None:
        return off, pay
    n = np.asarray(tuple(g.n))
    pmin = _np(g.pmin).astype(np.float64)
    width = (_np(g.pmax) - _np(g.pmin)) / n
    width = np.where(width <= 0, 1e-30, width)
    ijk = np.clip(np.floor((_np(cen) - pmin) / width), 0, n - 1) \
        .astype(np.int64)
    cell = (ijk[:, 2] * n[1] + ijk[:, 1]) * n[0] + ijk[:, 0]
    if not np.array_equal(np.sort(cell), np.arange(cell.shape[0])):
        raise ValueError("the grid's cell centres do not name its cells")
    visit = np.argsort(cell)           # visit slot of each cell in order
    counts = np.diff(off)[visit]
    new_off = np.zeros_like(off)
    np.cumsum(counts, out=new_off[1:])
    new_pay = (np.concatenate([pay[off[k]:off[k + 1]] for k in visit])
               if pay.size else pay)
    return new_off, new_pay


def _grid_to_numpy(d: dict, key: str, g) -> None:
    off, pay = _grid_csr(g)
    d[f"{key}.offsets"], d[f"{key}.payload"] = off, pay
    d[f"{key}.pmin"], d[f"{key}.pmax"] = _np(g.pmin), _np(g.pmax)
    d[f"{key}.n"] = np.asarray(tuple(g.n))
    d[f"{key}.start"] = np.asarray(int(getattr(g, "start", 0)))


def _grid_from_numpy(d: dict, key: str, device):
    if f"{key}.offsets" not in d:
        return None
    from ..accel.grid import grid_from_csr
    return grid_from_csr(d[f"{key}.offsets"], d[f"{key}.payload"],
                         d[f"{key}.pmin"], d[f"{key}.pmax"],
                         tuple(int(x) for x in d[f"{key}.n"]),
                         start=int(d[f"{key}.start"]), device=device)


_GRIDS = ("sphere_grid", "triangle_grid", "mega_sph_grid")


def scene_to_numpy(scene) -> dict:
    """Leaves of a scene as numpy arrays, keyed ``"group.field"``, with its
    mesh instances (``meshes.<i>.*``) and prepared grids as CSR arrays
    (``<grid>.offsets``, ``.payload``, ``.pmin``, ``.pmax``, ``.n``,
    ``.start``). Reads attributes only, so it takes this package's Scene
    and the JAX package's alike."""
    d = {}
    for group, names in _LEAVES.items():
        obj = getattr(scene, group)
        for name in names:
            d[f"{group}.{name}"] = _np(getattr(obj, name))
    d["camera.cols"] = np.asarray(scene.camera.cols)
    d["camera.rows"] = np.asarray(scene.camera.rows)
    for name in _SCENE_LEAVES:
        d[name] = _np(getattr(scene, name))
    meshes = tuple(getattr(scene, "meshes", ()))
    d["meshes.count"] = np.asarray(len(meshes))
    for i, m in enumerate(meshes):
        for name in _LEAVES["triangles"]:
            d[f"meshes.{i}.tris.{name}"] = _np(getattr(m.tris, name))
        d[f"meshes.{i}.bounds_min"] = _np(m.bounds_min)
        d[f"meshes.{i}.bounds_max"] = _np(m.bounds_max)
        d[f"meshes.{i}.nslabs"] = np.asarray(m.nslabs)
        if m.grid is not None:
            _grid_to_numpy(d, f"meshes.{i}.grid", m.grid)
    for key in _GRIDS:
        if getattr(scene, key, None) is not None:
            _grid_to_numpy(d, key, getattr(scene, key))
    folded = getattr(scene, "folded_tri_grid", None)
    if folded is not None:
        d["folded_tri_grid.count"] = np.asarray(len(folded))
        for k, g in enumerate(folded):
            _grid_to_numpy(d, f"folded_tri_grid.{k}", g)
    return d


def scene_from_numpy(d: dict, device=None) -> Scene:
    """Inverse of ``scene_to_numpy``: this package's Scene on ``device``."""
    def t(key):
        return torch.as_tensor(np.array(d[key]), device=device)

    def tris(prefix):
        return Triangles(**{n: t(f"{prefix}.{n}")
                            for n in _LEAVES["triangles"]})
    cam = Camera(**{n: t(f"camera.{n}") for n in _LEAVES["camera"]},
                 cols=int(d["camera.cols"]), rows=int(d["camera.rows"]))
    sph = Spheres(**{n: t(f"spheres.{n}") for n in _LEAVES["spheres"]})
    lig = Lights(**{n: t(f"lights.{n}") for n in _LEAVES["lights"]})
    meshes = tuple(
        MeshInstance(tris=tris(f"meshes.{i}.tris"),
                     bounds_min=t(f"meshes.{i}.bounds_min"),
                     bounds_max=t(f"meshes.{i}.bounds_max"),
                     grid=_grid_from_numpy(d, f"meshes.{i}.grid", device),
                     nslabs=int(d[f"meshes.{i}.nslabs"]))
        for i in range(int(d.get("meshes.count", 0))))
    folded = None
    if "folded_tri_grid.count" in d:
        folded = tuple(_grid_from_numpy(d, f"folded_tri_grid.{k}", device)
                       for k in range(int(d["folded_tri_grid.count"])))
    return Scene(camera=cam, spheres=sph, triangles=tris("triangles"),
                 lights=lig, meshes=meshes, folded_tri_grid=folded,
                 **{k: _grid_from_numpy(d, k, device) for k in _GRIDS},
                 **{n: t(n) for n in _SCENE_LEAVES})
