"""Scene and ray types: small frozen dataclasses of tensors (SoA), the
counterparts of ``raytracing_tpu.core.types``.

Each type has ``.to(device)``. Vectors are ``(..., 3)`` float32 tensors;
material ids are int32 and masks bool, as in the JAX package.
``scene_to_numpy`` / ``scene_from_numpy`` carry a scene across the two
packages as a dict of numpy arrays, so both render the same inputs.
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


def _to(obj, device):
    """Copy of a dataclass with every tensor (and nested dataclass) field
    moved to ``device``."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            kw[f.name] = _to(v, device)
    return dataclasses.replace(obj, **kw)


class _OnDevice:
    """``.to(device)`` for the frozen dataclasses of tensors below."""

    def to(self, device):
        return _to(self, device)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a.x*b.x + a.y*b.y + a.z*b.z over the last axis, in that order (the
    kernels' summation order)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


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


@dataclasses.dataclass(frozen=True)
class Scene(_OnDevice):
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
                lens_diameter: float = 0.0) -> Scene:
    """Assemble a Scene with merged bounds, inflating degenerate triangle
    AABB axes by 0.1 (raytracing_tpu.core.types.build_scene)."""
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
    return Scene(camera=camera, spheres=spheres, triangles=triangles,
                 lights=lights, materials=materials,
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


def scene_to_numpy(scene) -> dict:
    """Leaves of a scene as numpy arrays, keyed ``"group.field"``. Reads
    attributes only, so it takes this package's Scene and the JAX package's
    alike. Mesh instances and prepared grids are not ported yet (ROADMAP
    Queue 1 items 11 and 15) and raise."""
    if getattr(scene, "meshes", ()):
        raise NotImplementedError(
            "mesh instances are not ported yet (ROADMAP Queue 1 item 15)")
    for g in ("sphere_grid", "triangle_grid", "folded_tri_grid",
              "mega_sph_grid"):
        if getattr(scene, g, None) is not None:
            raise NotImplementedError(
                "uniform grids are not ported yet (ROADMAP Queue 1 item 11)")
    d = {}
    for group, names in _LEAVES.items():
        obj = getattr(scene, group)
        for name in names:
            d[f"{group}.{name}"] = _np(getattr(obj, name))
    d["camera.cols"] = np.asarray(scene.camera.cols)
    d["camera.rows"] = np.asarray(scene.camera.rows)
    for name in _SCENE_LEAVES:
        d[name] = _np(getattr(scene, name))
    return d


def scene_from_numpy(d: dict, device=None) -> Scene:
    """Inverse of ``scene_to_numpy``: this package's Scene on ``device``."""
    def t(key):
        return torch.as_tensor(np.array(d[key]), device=device)
    cam = Camera(**{n: t(f"camera.{n}") for n in _LEAVES["camera"]},
                 cols=int(d["camera.cols"]), rows=int(d["camera.rows"]))
    sph = Spheres(**{n: t(f"spheres.{n}") for n in _LEAVES["spheres"]})
    tri = Triangles(**{n: t(f"triangles.{n}") for n in _LEAVES["triangles"]})
    lig = Lights(**{n: t(f"lights.{n}") for n in _LEAVES["lights"]})
    return Scene(camera=cam, spheres=sph, triangles=tri, lights=lig,
                 **{n: t(n) for n in _SCENE_LEAVES})
