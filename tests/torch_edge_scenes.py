"""Table-level scenes for the edge-aware tests: cornell's packed tables with
its walls split into more triangles and a few spheres added, so that the
soft program's two-level composite (more than 64 hypotheses, at most 64 of
each type) runs. Pure numpy: the same arrays go into the JAX package and
the port."""
import numpy as np

# wall triangles split 3 x 3 (9 each) and 2 x 2 (4 each): 4 * 9 + 6 * 4 = 60
SPLIT = (3, 3, 3, 3, 2, 2, 2, 2, 2, 2)
EXTRA_SPHERES = 4


def tri_row(p0, p1, p2, n0, n1, n2, mat_id):
    """One packed triangle row [n_geo, c1, c2, e1, e2, k, mat, mask, vn0,
    vn1, vn2, pad5], the constants of ``ops.intersect.tri_constants``."""
    e1, e2 = p1 - p0, p2 - p0
    ng = np.cross(e2, e1)
    row = np.zeros(32, np.float32)
    row[0:3], row[3:6], row[6:9] = ng, np.cross(e1, p0), np.cross(e2, p0)
    row[9:12], row[12:15], row[15] = e1, e2, np.dot(p0, ng)
    row[16], row[17] = mat_id, 1.0
    row[18:21], row[21:24], row[24:27] = n0, n1, n2
    return row


def split_tables(tables, verts, normals, seed: int = 0):
    """(par, sph, tri, mat, lig) numpy tables: ``tables`` (cornell's) with
    triangle t (vertices ``verts`` (T, 3, 3), vertex normals ``normals``)
    split into SPLIT[t] ** 2 coplanar triangles of the same orientation,
    and EXTRA_SPHERES small spheres from ``seed`` inside the box."""
    par, sph, tri, mat, lig = (np.asarray(t, np.float32) for t in tables)
    rows = []
    for t, k in enumerate(SPLIT):
        p0, p1, p2 = verts[t].astype(np.float64)
        n0, n1, n2 = normals[t].astype(np.float64)

        def at(a, b):
            return (p0 + (p1 - p0) * (a / k) + (p2 - p0) * (b / k),
                    n0 + (n1 - n0) * (a / k) + (n2 - n0) * (b / k))

        for a in range(k):
            for b in range(k - a):
                quads = [(at(a, b), at(a + 1, b), at(a, b + 1))]
                if a + b < k - 1:
                    quads.append((at(a + 1, b), at(a + 1, b + 1),
                                  at(a, b + 1)))
                for q in quads:
                    rows.append(tri_row(*(x[0] for x in q),
                                         *(x[1] for x in q), tri[t, 16]))
    rng = np.random.default_rng(seed)
    lo, hi = par[18:21], par[21:24]
    extra = np.zeros((EXTRA_SPHERES, 8), np.float32)
    extra[:, 0:3] = lo + (hi - lo) * rng.uniform(0.25, 0.75,
                                                 (EXTRA_SPHERES, 3))
    extra[:, 3] = 0.06 * np.linalg.norm(hi - lo)
    extra[:, 4] = sph[0, 4]
    extra[:, 5] = 1.0
    return (par, np.concatenate([sph, extra]),
            np.asarray(rows, np.float32), mat, lig)
