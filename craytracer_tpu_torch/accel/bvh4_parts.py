"""The partitioned fat-row BVH4 for tables past the part budget
(counterpart of craytracer_tpu/accel/bvh4_parts.py: `PART_BUDGET_BYTES`
:41, `_subtree_sizes` :44, `partition_bvh4` :60, `parts_closest_hit`
:128, `parts_any_hit` :144, `pallas_parts_any_hit` :154, `_part_entry`
:172, `pallas_parts_closest_hit` :203).

A table larger than PART_BUDGET_BYTES is cut into an antichain of
subtrees: part 0 is the top of the tree (every node above the cut, its
cut children set to -1, its shallow leaf triangles still inline), parts
1..K the cut subtrees with their rows renumbered inside the part (part
root first). Every triangle lives in exactly one part. The kernel route
walks the parts one after another: the closest hit through K3 `_init`,
carrying the best (t, tri) from part to part so that an earlier part's
hit prunes a later part's walk; the any hit through K4, a lane already
occluded by an earlier part carrying max_dist 0. With more than two
parts the closest-hit rays are grouped first by the part they enter
first (a stable argsort of (first << 27) | (ray_key >> 5)) and the
results scatter back to lane order.

The monolithic table stays beside the parts (Scene.tri_bvh): the plain
route walks it, as the JAX package's XLA path does. Within one part the
walk visits rows in the monolithic walk's order, but a carried best hit
changes which boxes are entered, so on an exact tie of t a lane may keep
another triangle than the monolithic walk (t is the same).
"""

from __future__ import annotations

import numpy as np
import torch

from craytracer_tpu_torch.accel import bvh4_kernel
from craytracer_tpu_torch.accel.bvh4 import (WIDTH, bvh4_any_hit,
                                             bvh4_closest_hit,
                                             stack_bound_children)
from craytracer_tpu_torch.constants import TMAX
from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.ops.raysort import ray_key
from craytracer_tpu_torch.scene.types import BVH4Arrays

# the JAX package's budget: one part per TPU VMEM residency (120 MiB of
# the 128 MiB VMEM). Kept as it is: whether another budget pays on the
# H100 is a measurement (PERF.md), not a port decision.
PART_BUDGET_BYTES = 120 * 1024 * 1024
PART_SORT_MIN_PARTS = 3  # the part sort runs for more than two parts


def _subtree_sizes(child: np.ndarray) -> np.ndarray:
    """Row counts of every subtree. Children carry larger ids than their
    parent (breadth-first rows), so the sizes settle bottom-up in depth
    passes."""
    m = child.shape[0]
    valid = child >= 0
    cidx = np.maximum(child, 0)
    size = np.ones(m, np.int64)
    for _ in range(256):
        new = 1 + np.where(valid, size[cidx], 0).sum(axis=1)
        if np.array_equal(new, size):
            return size
        size = new
    raise ValueError("BVH4 deeper than 256 levels (cycle?)")


def partition_bvh4(bvh: BVH4Arrays, budget_bytes: int = PART_BUDGET_BYTES):
    """Cut `bvh` into parts of at most `budget_bytes` of fat rows each:
    (top, cut subtrees...), built on the host in numpy and placed on the
    table's device. A table under budget returns (bvh,)."""
    fat = bvh.fat.detach().cpu().numpy()
    m, w = fat.shape
    budget_rows = max(1, budget_bytes // (w * 4))
    if m <= budget_rows:
        return (bvh,)

    child = fat[:, 24:28].astype(np.int64)
    size = _subtree_sizes(child)

    # a node that fits becomes a part root; one that does not joins the
    # top part and exposes its children
    part_roots, top_rows = [], []
    stack = [0]
    while stack:
        nd = stack.pop()
        if size[nd] <= budget_rows:
            part_roots.append(nd)
        else:
            top_rows.append(nd)
            stack.extend(int(c) for c in child[nd] if c >= 0)
    part_roots.sort()
    top_rows.sort()

    # label every row with its part (0: top, k + 1: subtree of root k),
    # children inheriting their parent's label unless they are roots
    part_of = np.full(m, -1, np.int64)
    part_of[np.asarray(top_rows, np.int64)] = 0
    part_of[np.asarray(part_roots, np.int64)] = np.arange(
        1, len(part_roots) + 1)
    valid = child >= 0
    cidx = np.maximum(child, 0)
    root_set = np.zeros(m, bool)
    root_set[np.asarray(part_roots, np.int64)] = True
    target = cidx[valid]
    for _ in range(256):
        src = np.broadcast_to(part_of[:, None], child.shape)[valid]
        take = (part_of[target] < 0) & (src >= 0) & ~root_set[target]
        if not take.any():
            break
        part_of[target[take]] = src[take]
    if (part_of < 0).any():
        raise ValueError("orphan rows after the part labels settled")

    parts = []
    for k in range(len(part_roots) + 1):
        rows = np.flatnonzero(part_of == k)  # ascending: part root first
        new_id = np.full(m, -1, np.int64)
        new_id[rows] = np.arange(rows.size)
        pf = fat[rows]
        ch = child[rows]
        # children outside the part (the top part's cut children) -> -1
        remap = np.where(ch >= 0, new_id[np.maximum(ch, 0)], -1)
        pf[:, 24:28] = remap.astype(np.float32)
        parts.append(BVH4Arrays(
            fat=torch.from_numpy(pf).to(bvh.fat.device), n_tris=bvh.n_tris,
            leaf_size=bvh.leaf_size, stack_size=stack_bound_children(remap)))
    return tuple(parts)


def parts_closest_hit(parts, o, d):
    """Plain closest hit across the parts: each part walked on its own
    from TMAX, the results min-combined (an earlier part keeps a tie)."""
    best_t = torch.full((o.shape[0],), TMAX, dtype=torch.float32,
                        device=o.device)
    best_tri = torch.full((o.shape[0],), -1, dtype=torch.int32,
                          device=o.device)
    for p in parts:
        t, tri = bvh4_closest_hit(p, o, d)
        better = t < best_t
        best_tri = torch.where(better, tri, best_tri)
        best_t = torch.where(better, t, best_t)
    return best_t, best_tri


def parts_any_hit(parts, o, d, max_dist):
    """Plain any hit across the parts: the minimum of each part's."""
    best_t = torch.full((o.shape[0],), TMAX, dtype=torch.float32,
                        device=o.device)
    for p in parts:
        best_t = torch.minimum(best_t, bvh4_any_hit(p, o, d, max_dist))
    return best_t


def _part_entry(p: BVH4Arrays, o, d):
    """Entry distance of each ray into part p's root child boxes (TMAX
    when it misses all four): the slab test of row 0."""
    row0 = p.fat[0]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    iv = 1.0 / vm._safe(d)
    ivx, ivy, ivz = iv[:, 0], iv[:, 1], iv[:, 2]
    best = torch.full((o.shape[0],), TMAX, dtype=torch.float32,
                      device=o.device)
    for c in range(WIDTH):
        t0x = (row0[c * 3 + 0] - ox) * ivx
        t1x = (row0[12 + c * 3 + 0] - ox) * ivx
        t0y = (row0[c * 3 + 1] - oy) * ivy
        t1y = (row0[12 + c * 3 + 1] - oy) * ivy
        t0z = (row0[c * 3 + 2] - oz) * ivz
        t1z = (row0[12 + c * 3 + 2] - oz) * ivz
        tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                         torch.minimum(t0y, t1y)),
                           torch.minimum(t0z, t1z))
        tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                         torch.maximum(t0y, t1y)),
                           torch.maximum(t0z, t1z))
        hit = (tn <= tf) & (tf > 0.0)
        best = torch.minimum(best, torch.where(hit, torch.clamp(tn, min=0.0),
                                               TMAX))
    return best


def part_sort(parts, o, d):
    """(key [N] int64, perm [N]): the part-sort key, the first part each
    ray enters (its least entry distance, the lower part on a tie) above
    the top bits of its ray_key, and the stable argsort of it."""
    entries = torch.stack([_part_entry(p, o, d) for p in parts])
    first = torch.argmin(entries, dim=0).to(torch.int64)
    key = (first << 27) | (ray_key(o, d) >> 5)
    return key, torch.argsort(key, stable=True)


def parts_closest_hit_kernel(parts, o, d):
    """Closest hit (t [N] f32, tri [N] int32) across the parts through K3
    `_init`, part after part with the best hit carried, behind the part
    sort for more than two parts. CPU tensors take the plain version of
    each step (accel/bvh4.py `bvh4_closest_hit_init`)."""
    n = o.shape[0]
    perm = None
    if len(parts) >= PART_SORT_MIN_PARTS:
        _, perm = part_sort(parts, o, d)
        o, d = o[perm].contiguous(), d[perm].contiguous()
    t = torch.full((n,), TMAX, dtype=torch.float32, device=o.device)
    tri = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    for p in parts:
        t, tri = bvh4_kernel.bvh4_closest_hit_init_kernel(p, o, d, t, tri)
    if perm is None:
        return t, tri
    t_out, tri_out = torch.empty_like(t), torch.empty_like(tri)
    t_out[perm], tri_out[perm] = t, tri
    return t_out, tri_out


def parts_any_hit_kernel(parts, o, d, max_dist):
    """Shadow any hit across the parts through K4 (t < max_dist when
    occluded, else TMAX): after each part, lanes it occluded carry
    max_dist 0 into the next. CPU tensors take the plain version."""
    best_t = torch.full((o.shape[0],), TMAX, dtype=torch.float32,
                        device=o.device)
    md = max_dist
    for p in parts:
        best_t = torch.minimum(
            best_t, bvh4_kernel.bvh4_any_hit_kernel(p, o, d, md))
        md = torch.where(best_t < max_dist, 0.0, max_dist)
    return best_t
