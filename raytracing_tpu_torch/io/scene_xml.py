"""XML scene loader (``raytracing_tpu.io.scene_xml``, the reference's
declarative scene schema):

  <scene>
    <camera> eye/lookAt/vup (x,y,z), fov, focal_length, lens_diameter
    <light>  position/normal/irradiance (x,y,z), radius          (0..n)
    <material> id (name), color (r,g,b,a)                        (0..n)
    <sphere> center, radius, matId(name)
    <triangle> p0..p2, n0..n2, matId(name)
    <mesh>   file, nslabs, normalize(yes/no), scale, translate, matId

Gives a ``Scene`` (``core.types.build_scene``) with merged bounds and one
``MeshInstance`` per mesh, each with its own grid resolution ``nslabs``,
on ``device`` (``None``: ``default_device()``, the card). It is built on
the CPU and moved once, as ``models.scenes.cornell_box`` is, so that the
camera's film size (a ``tan``) has the same bits on every device.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from ..core.types import (Camera, Lights, MeshInstance, Scene, Spheres,
                          Triangles, build_scene, make_spheres,
                          make_triangles)
from . import mesh_json as MJ


def _vec3(elem: ET.Element, name: str, default=None) -> np.ndarray:
    e = elem.find(name)
    if e is None:
        if default is None:
            raise KeyError(f"missing <{name}>")
        return np.asarray(default, np.float32)
    return np.array([float(e.find("x").text),
                     float(e.find("y").text),
                     float(e.find("z").text)], np.float32)


def _num(elem: ET.Element, name: str, default=None) -> float:
    e = elem.find(name)
    if e is None:
        if default is None:
            raise KeyError(f"missing <{name}>")
        return default
    return float(e.text)


def _str(elem: ET.Element, name: str) -> str:
    return elem.find(name).text.strip()


def load_scene(path: str, cols: int = 320, rows: int = 240,
               device=None) -> Scene:
    """Parse an XML scene file; ``cols``/``rows`` are the film size the
    camera is made for."""
    if device is None:
        from .. import default_device
        device = default_device()
    root = ET.parse(path).getroot()
    base_dir = os.path.dirname(os.path.abspath(path))

    xc = root.find("camera")
    cam = Camera.look_at(_vec3(xc, "eye"), _vec3(xc, "lookAt"),
                         _vec3(xc, "vup"), _num(xc, "fov"), cols, rows)
    focal_length = _num(xc, "focal_length", 1.0)
    lens_diameter = _num(xc, "lens_diameter", 0.0)

    # disk lights; point lights (only <position>) take the defaults of
    # normal, irradiance and radius
    lpos, lnrm, lirr, lrad = [], [], [], []
    for xl in root.findall("light"):
        lpos.append(_vec3(xl, "position"))
        lnrm.append(_vec3(xl, "normal", [0.0, -1.0, 0.0]))
        lirr.append(_vec3(xl, "irradiance", [1.0, 1.0, 1.0]))
        lrad.append(_num(xl, "radius", 0.0))
    lights = (Lights.make(np.stack(lpos), np.stack(lnrm), np.stack(lirr),
                          np.array(lrad, np.float32))
              if lpos else Lights.empty())

    # materials, name -> index
    mats, lookup = [], {}
    for xm in root.findall("material"):
        col = xm.find("color")
        lookup[_str(xm, "id")] = len(mats)
        mats.append([float(col.find(k).text) for k in ("r", "g", "b", "a")])
    materials = (np.asarray(mats, np.float32).reshape(-1, 4) if mats
                 else np.ones((1, 4), np.float32))

    sc, sr, sm = [], [], []
    for xs in root.findall("sphere"):
        sc.append(_vec3(xs, "center"))
        sr.append(_num(xs, "radius"))
        sm.append(lookup[_str(xs, "matId")])
    spheres = (make_spheres(np.stack(sc), np.array(sr, np.float32),
                            np.array(sm, np.int32))
               if sc else Spheres.empty())

    tv, tn, tm = [], [], []
    for xt in root.findall("triangle"):
        tv.append(np.stack([_vec3(xt, f"p{i}") for i in range(3)]))
        tn.append(np.stack([_vec3(xt, f"n{i}") for i in range(3)]))
        tm.append(lookup[_str(xt, "matId")])
    triangles = (make_triangles(np.stack(tv), np.stack(tn),
                                np.array(tm, np.int32))
                 if tv else Triangles.empty())

    meshes = []
    for xm in root.findall("mesh"):
        fname = _str(xm, "file")
        mat_id = lookup[_str(xm, "matId")]
        # the reference resolves "./tri/x.json" against the page's
        # directory, one level above scenes/
        candidates = [os.path.normpath(os.path.join(base_dir, fname)),
                      os.path.normpath(os.path.join(base_dir, "..", fname))]
        md = MJ.load_mesh_json(next(
            (c for c in candidates if os.path.exists(c)), candidates[0]))
        if _str(xm, "normalize") == "yes":
            md = MJ.normalize_unit_cube(md)
        md = MJ.scale(md, *_vec3(xm, "scale"))
        md = MJ.translate(md, *_vec3(xm, "translate"))
        tris = make_triangles(md.positions, md.normals,
                              np.full(md.n_triangles, mat_id, np.int32))
        meshes.append(MeshInstance(
            tris=tris, bounds_min=torch.as_tensor(md.bounds_min),
            bounds_max=torch.as_tensor(md.bounds_max),
            nslabs=int(_num(xm, "nslabs", 1))))

    return build_scene(camera=cam, spheres=spheres, triangles=triangles,
                       meshes=tuple(meshes), lights=lights,
                       materials=materials, focal_length=focal_length,
                       lens_diameter=lens_diameter).to(device)
