"""XML and mesh-JSON stand-ins of the reference's scene files (imported by
tests/test_torch_xml_scenes.py, tests/test_torch_viewer.py,
tests/test_torch_cuda.py and chip_smoke.py). The reference's teapot,
boxes and house meshes are not in the repository; these files take their
schema and their triangle counts from tests/torch_grid_scenes.py's torus.

Every float is written as the repr of its float32 value, so reading a
file back gives the same float32 numbers that were written. No JAX: the
cornell walls come from the port's own builder."""
import json
import os

import numpy as np

from torch_grid_scenes import torus_arrays

TEAPOT_SEGMENTS = (31, 16)    # 992 faces, as the reference's teapot.json
BOXES_SEGMENTS = (5, 2)       # 20 faces, as its boxes.json
HOUSE_SEGMENTS = (83, 32)     # 5,312 faces (house_of_parliament: 5,322)


def _f(x) -> str:
    return repr(float(np.float32(x)))


def write_mesh_json(path: str, v: np.ndarray, vn: np.ndarray,
                    rgba=(0.8, 0.8, 0.8, 1.0)) -> str:
    """An unindexed mesh of (T, 3, 3) positions and normals, one material."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    doc = {"meshes": [{
        "materialIndex": 0,
        "vertexPositions": [float(x) for x in
                            np.asarray(v, np.float32).reshape(-1)],
        "vertexNormals": [float(x) for x in
                          np.asarray(vn, np.float32).reshape(-1)]}],
        "materials": [{"diffuseReflectance": [float(np.float32(c))
                                              for c in rgba]}]}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _vec(tag: str, p) -> str:
    x, y, z = (_f(c) for c in p)
    return f"<{tag}><x>{x}</x><y>{y}</y><z>{z}</z></{tag}>"


def write_scene_xml(path: str, *, eye, lookat, vup, fov, focal_length,
                    lens_diameter, lights, materials, spheres=(),
                    triangles=(), meshes=()) -> str:
    """The reference's XML schema. ``lights``: dicts with "position" and,
    for disk lights, "normal", "irradiance" and "radius"; ``materials``:
    (name, rgba) pairs; ``spheres``: (center, radius, name); ``triangles``:
    (p (3, 3), n (3, 3), name); ``meshes``: dicts with "file", "nslabs",
    "normalize" ("yes"/"no"), "scale", "translate" and "mat"."""
    out = ["<scene>", "<camera>", _vec("eye", eye), _vec("lookAt", lookat),
           _vec("vup", vup), f"<fov>{_f(fov)}</fov>",
           f"<focal_length>{_f(focal_length)}</focal_length>",
           f"<lens_diameter>{_f(lens_diameter)}</lens_diameter>",
           "</camera>"]
    for li in lights:
        out.append("<light>" + _vec("position", li["position"]))
        if "normal" in li:
            out += [_vec("normal", li["normal"]),
                    _vec("irradiance", li["irradiance"]),
                    f"<radius>{_f(li['radius'])}</radius>"]
        out.append("</light>")
    for name, rgba in materials:
        r, g, b, a = (_f(c) for c in rgba)
        out.append(f"<material><id>{name}</id><color><r>{r}</r><g>{g}</g>"
                   f"<b>{b}</b><a>{a}</a></color></material>")
    for center, radius, name in spheres:
        out.append(f"<sphere>{_vec('center', center)}<radius>{_f(radius)}"
                   f"</radius><matId>{name}</matId></sphere>")
    for p, n, name in triangles:
        out.append("<triangle>" + "".join(_vec(f"p{i}", p[i])
                                          for i in range(3))
                   + "".join(_vec(f"n{i}", n[i]) for i in range(3))
                   + f"<matId>{name}</matId></triangle>")
    for m in meshes:
        out.append(f"<mesh><file>{m['file']}</file><nslabs>{m['nslabs']}"
                   f"</nslabs><normalize>{m['normalize']}</normalize>"
                   + _vec("scale", m["scale"])
                   + _vec("translate", m["translate"])
                   + f"<matId>{m['mat']}</matId></mesh>")
    out.append("</scene>")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path


def cornell_arrays():
    """cornell_box's walls (wound), spheres, light and materials as numpy,
    read from the port's builder on the CPU."""
    from raytracing_tpu_torch.models.scenes import cornell_box
    s = cornell_box()
    return {k: np.asarray(v.detach().cpu()) for k, v in (
        ("v", s.triangles.v), ("vn", s.triangles.vn),
        ("tri_mat", s.triangles.mat_id), ("sph_c", s.spheres.center),
        ("sph_r", s.spheres.radius), ("sph_m", s.spheres.mat_id),
        ("materials", s.materials), ("lpos", s.lights.position),
        ("lnrm", s.lights.normal), ("lirr", s.lights.irradiance),
        ("lrad", s.lights.radius))}


def cornell_torus_xml(root: str, n_major: int = 16,
                      n_minor: int = 4) -> str:
    """torch_grid_scenes.cornell_torus written as files: scenes/torus.xml
    (cornell's camera, light, materials m0..m4, walls and spheres) and
    tri/torus.json (the torus, material m4, normalize no, scale 1, no
    translation). Returns the XML's path."""
    c = cornell_arrays()
    write_mesh_json(os.path.join(root, "tri", "torus.json"),
                    *torus_arrays(n_major, n_minor))
    names = [f"m{i}" for i in range(c["materials"].shape[0])]
    return write_scene_xml(
        os.path.join(root, "scenes", "torus.xml"),
        eye=(0.0, 0.0, 2.6), lookat=(0.0, -0.1, 0.0), vup=(0.0, 1.0, 0.0),
        fov=60.0, focal_length=2.8, lens_diameter=0.0,
        lights=[{"position": c["lpos"][0], "normal": c["lnrm"][0],
                 "irradiance": c["lirr"][0], "radius": c["lrad"][0]}],
        materials=list(zip(names, c["materials"])),
        spheres=[(c["sph_c"][i], c["sph_r"][i], names[c["sph_m"][i]])
                 for i in range(c["sph_c"].shape[0])],
        triangles=[(c["v"][i], c["vn"][i], names[c["tri_mat"][i]])
                   for i in range(c["v"].shape[0])],
        meshes=[{"file": "./tri/torus.json", "nslabs": 1, "normalize": "no",
                 "scale": (1.0, 1.0, 1.0), "translate": (0.0, 0.0, 0.0),
                 "mat": "m4"}])


CORNELL_TEAPOT_MATERIALS = (
    ("white", (0.9, 0.9, 0.9, 1.0)), ("red", (0.9, 0.2, 0.2, 1.0)),
    ("green", (0.2, 0.9, 0.2, 1.0)), ("blue", (0.255, 0.412, 0.882, 1.0)),
    ("yellow", (0.9, 0.9, 0.1, 1.0)), ("teapot", (0.85, 0.6, 0.3, 1.0)),
    ("boxes", (0.7, 0.7, 0.75, 1.0)), ("light", (1.0, 1.0, 1.0, 1.0)))


def cornell_teapot_xml(root: str) -> str:
    """A stand-in of the reference's cornell_teapot.xml with its schema:
    eight named materials, one sphere, cornell's 10 walls, one disk light
    at (0, 0.75, 0), focal length 2.0 and lens diameter 0.01, and two
    meshes: tri/teapot.json (the TEAPOT_SEGMENTS torus, 992 faces, nslabs
    10, normalised and scaled by 0.7) and tri/boxes.json (the
    BOXES_SEGMENTS torus, 20 faces, nslabs 5). The XML sits in scenes/, so
    the meshes' "./tri/" paths resolve through its parent. Returns the
    XML's path."""
    c = cornell_arrays()
    write_mesh_json(os.path.join(root, "tri", "teapot.json"),
                    *torus_arrays(*TEAPOT_SEGMENTS))
    write_mesh_json(os.path.join(root, "tri", "boxes.json"),
                    *torus_arrays(*BOXES_SEGMENTS))
    wall = ("white", "white", "white", "white", "white", "white", "red",
            "red", "green", "green")
    return write_scene_xml(
        os.path.join(root, "scenes", "cornell_teapot.xml"),
        eye=(0.0, 0.0, 2.6), lookat=(0.0, -0.1, 0.0), vup=(0.0, 1.0, 0.0),
        fov=60.0, focal_length=2.0, lens_diameter=0.01,
        lights=[{"position": (0.0, 0.75, 0.0), "normal": (0.0, -1.0, 0.0),
                 "irradiance": (5.0, 5.0, 5.0), "radius": 0.25}],
        materials=CORNELL_TEAPOT_MATERIALS,
        spheres=[((0.45, -0.65, -0.3), 0.3, "blue")],
        triangles=[(c["v"][i], c["vn"][i], wall[i]) for i in range(10)],
        meshes=[{"file": "./tri/teapot.json", "nslabs": 10,
                 "normalize": "yes", "scale": (0.7, 0.7, 0.7),
                 "translate": (-0.25, -0.6, 0.0), "mat": "teapot"},
                {"file": "./tri/boxes.json", "nslabs": 5,
                 "normalize": "yes", "scale": (0.3, 0.3, 0.3),
                 "translate": (0.4, -0.7, 0.4), "mat": "boxes"}])


def house_reference_dir(root: str) -> str:
    """A reference directory holding
    Assign07-3D_uniform_grid_acceleration/tri/house_of_parliament.json,
    the HOUSE_SEGMENTS torus standing in for the reference's house (which
    big_mesh_scene normalises). Returns ``root``."""
    write_mesh_json(os.path.join(
        root, "Assign07-3D_uniform_grid_acceleration", "tri",
        "house_of_parliament.json"), *torus_arrays(*HOUSE_SEGMENTS))
    return root

