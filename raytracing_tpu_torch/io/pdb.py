"""PDB molecule parser -> sphere scene data (the port's copy of
``raytracing_tpu.io.pdb``, which it does not import).

Reproduces the semantics of the reference's parser
(ref mol/pdbParserV1.js:2-85, any assignment copy):
  * ATOM / HETATM records, fixed-column format; altLoc filter (' ' or 'A')
  * per-element van der Waals radii (Bondi 1964) and CPK hex colors
  * element fallback to the atom-name column when column 77-78 is blank
  * per-molecule bounds grown by each atom's radius

Output is SoA numpy arrays ready to become device buffers — the analog of the
reference's {atomData, colorData, radiusData, bounds} flat arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# CPK-style element colors (ref pdbParserV1.js:3-5)
ELEMENT_COLORS = {
    "H": 0xCCCCCC, "C": 0xAAAAAA, "O": 0xCC0000, "N": 0x0000CC,
    "S": 0xCCCC00, "P": 0x6622CC, "F": 0x00CC00, "CL": 0x00CC00,
    "BR": 0x882200, "I": 0x6600AA, "FE": 0xCC6600, "CA": 0x8888AA,
}

# Bondi 1964 van der Waals radii (ref pdbParserV1.js:7-9)
VDW_RADII = {
    "H": 1.2, "Li": 1.82, "Na": 2.27, "K": 2.75, "C": 1.7, "N": 1.55,
    "O": 1.52, "F": 1.47, "P": 1.80, "S": 1.80, "CL": 1.75, "BR": 1.85,
    "SE": 1.90, "ZN": 1.39, "CU": 1.4, "NI": 1.63,
}

DEFAULT_RADIUS = 1.5
DEFAULT_COLOR = 0xFF00FF


def _hex2rgb(h: int) -> tuple[float, float, float]:
    return ((h >> 16 & 255) / 255.0, (h >> 8 & 255) / 255.0, (h & 255) / 255.0)


@dataclasses.dataclass
class Molecule:
    size: int
    centers: np.ndarray       # (n, 3) float32
    radii: np.ndarray         # (n,) float32 — vdW radius per atom
    color_ids: np.ndarray     # (n,) int32 index into colors
    colors: np.ndarray        # (n_elements, 4) float32 rgba
    element_radii: np.ndarray # (n_elements,) float32 — per-unique-element radius
    bounds_min: np.ndarray    # (3,)
    bounds_max: np.ndarray    # (3,)
    bonds: list | None = None # list[(i, j)] from CONECT records (0-based)


def parse_pdb(text: str) -> Molecule:
    centers, elems = [], []
    serial_to_idx: dict[int, int] = {}
    bonds: list[tuple[int, int]] = []
    pending_bonds: list[tuple[int, int]] = []
    for raw in text.split("\n"):
        line = raw.lstrip()
        rec = line[0:6]
        if rec == "CONECT":
            # ref pdbParserV1.js:37-46: from-serial + up to 4 to-serials
            try:
                frm = int(line[6:11])
            except ValueError:
                continue
            for lo in (11, 16, 21, 26):
                try:
                    to = int(line[lo:lo + 5])
                except ValueError:
                    continue
                pending_bonds.append((frm, to))
            continue
        if rec in ("ATOM  ", "HETATM"):
            alt_loc = line[16:17]
            if alt_loc not in (" ", "A", ""):
                continue
            try:
                x = float(line[30:38])
                y = float(line[38:46])
                z = float(line[46:54])
            except ValueError:
                continue
            elem = line[76:78].replace(" ", "")
            if not elem:  # fallback for incomplete PDB files (ref js:30-32)
                elem = line[12:16].replace(" ", "")
            try:
                serial = int(line[6:11])
                serial_to_idx[serial] = len(centers)
            except ValueError:
                pass
            centers.append((x, y, z))
            elems.append(elem)

    for frm, to in pending_bonds:
        if frm in serial_to_idx and to in serial_to_idx:
            bonds.append((serial_to_idx[frm], serial_to_idx[to]))

    n = len(centers)
    used: dict[str, int] = {}
    colors, elem_radii = [], []
    color_ids = np.zeros(n, np.int32)
    radii = np.zeros(n, np.float32)
    for i, e in enumerate(elems):
        if e not in used:
            used[e] = len(colors)
            colors.append(_hex2rgb(ELEMENT_COLORS.get(e, DEFAULT_COLOR)) + (1.0,))
            elem_radii.append(VDW_RADII.get(e, DEFAULT_RADIUS))
        color_ids[i] = used[e]
        radii[i] = elem_radii[used[e]]

    c = np.asarray(centers, np.float32).reshape(n, 3)
    if n:
        lo = (c - radii[:, None]).min(0)
        hi = (c + radii[:, None]).max(0)
    else:
        lo = np.full(3, np.inf, np.float32)
        hi = np.full(3, -np.inf, np.float32)
    return Molecule(size=n, centers=c, radii=radii, color_ids=color_ids,
                    colors=np.asarray(colors, np.float32).reshape(-1, 4),
                    element_radii=np.asarray(elem_radii, np.float32),
                    bounds_min=lo, bounds_max=hi, bonds=bonds)


def load_pdb(path: str) -> Molecule:
    with open(path, "r", errors="replace") as f:
        return parse_pdb(f.read())
