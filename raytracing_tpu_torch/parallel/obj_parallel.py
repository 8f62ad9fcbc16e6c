"""Object-parallel closest hit (``raytracing_tpu.parallel.obj_parallel``):
the ray-tracing analog of tensor parallelism.

Rays are replicated over the 'obj' mesh axis while the spheres are split
into one contiguous shard per rank; each rank finds its shard's champions
(kernel 4 on the card: the brute loop or its box tree by the shard's size),
the ranks all-gather the (t, global index) pairs, and the least t wins,
ties to the lower shard: the argmin over shards in shard order, as JAX's.
Within a shard the search keeps the lower index, so an exact tie goes to
the lower global index, as the unsharded search gives it. The pairs are the
searches' own t (each (ray, sphere) t is the same whichever table holds the
sphere), so the result is the unsharded ``closest_hit_spheres``'s exactly;
its t is then recomputed differentiably from the champion's row.

Use it where the scene is too large to replicate, or with 'rays' in a 2-D
mesh. For replicable scenes plain ray sharding (``mesh.py``) needs no
communication and is preferred.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core.types import Rays, Spheres
from ..ops.closest_hit import Champion, _miss, _sphere_search, \
    sphere_champion
from .mesh import all_gather


def closest_hit_spheres_objsharded(rays: Rays, spheres: Spheres,
                                   mesh: DeviceMesh,
                                   axis: str = "obj") -> Champion:
    """``closest_hit_spheres(rays, spheres, use_pallas=True)`` with the
    spheres split over ``axis`` of ``mesh``: this rank searches rows
    ``[i * S / n, (i + 1) * S / n)``. The sphere count must divide by the
    axis size (pad with mask=False rows)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    i = mesh.get_local_rank(axis)
    count = spheres.count
    if count % n:
        raise ValueError(f"pad the sphere count {count} to a multiple of "
                         f"{n} (mask=False rows)")
    if not count:
        return _miss(rays)
    size = count // n
    lo = i * size
    local = Spheres(*(getattr(spheres, f)[lo:lo + size]
                      for f in ("center", "radius", "mat_id", "mask")))
    best_t, best_i = _sphere_search(rays, local, 2048, True, None)
    gidx = torch.where(torch.isfinite(best_t), best_i + lo, -1)
    # one all-gather of each shard's (t bits, global index) pairs
    pairs = torch.stack(all_gather(torch.stack(
        [best_t.view(torch.int32), gidx.to(torch.int32)]),
        mesh.get_group(axis)))                        # (n, 2, R)
    ts, ids = pairs[:, 0].contiguous().view(torch.float32), pairs[:, 1]
    win = torch.argmin(ts, 0)     # the first least t: the lower shard
    col = torch.arange(ts.shape[1], device=ts.device)
    return sphere_champion(rays, spheres, ts[win, col], ids[win, col])
