"""4-wide fat-row BVH: the build and the plain PyTorch traversal
(counterpart of craytracer_tpu/accel/bvh4.py: `_stack_bound` :79,
`stack_bound_children` :88, `build_bvh4` :210 on the native path,
`_traverse4` :262-410, `bvh4_closest_hit` :413, `bvh4_closest_hit_stats`
:417, `bvh4_any_hit` :425).

The traversal is the plain version of K3, K3 `_init` and K4
(accel/bvh4_kernel.py) and of K5 (accel/bvh4_split_kernel.py). A closest
hit may start from a carried best hit (t0, tri0) instead of TMAX / -1:
the per-part step of the partitioned tables (accel/bvh4_parts.py), which
pallas_bvh4.py:399 `pallas_bvh4_closest_hit_init` runs on the TPU.
Every lane walks the tree with its own stack of `stack_size` node ids and
follows `_traverse4`'s per-lane visit order exactly: pop the top node,
slab-test its four child boxes against min(best_t, max_dist) as it was
before this pop, test the row's inlined triangles in slot order (a later
slot replaces the best hit only when strictly closer), sort the entered
internal children far to near with the network
(0,1),(2,3),(0,2),(1,3),(1,2), and push them clamped to the stack's free
room, nearest on top. Any-hit keeps the same order, also requires
t < max_dist of a triangle, and retires a lane once best_t < max_dist.
Moller-Trumbore keeps the reference expression order and the 1e-12
divide guard of core/math.py `_safe` (the Pallas kernels use 1e-20; the
port uses 1e-12 in the plain version and in the kernels alike).

The four child boxes and the leaf slots are tested as [A, 4] and [A, 8]
tensors, element by element as `_traverse4` unrolls them; the slot fold
is a first-index min over the slots that pass, which picks the same
triangle as the sequential strict-< fold. Lanes whose stack has emptied
are dropped from the working set as they finish (a pure reorder: each
lane's walk depends on nothing but its own ray).
"""

from __future__ import annotations

import numpy as np
import torch

from craytracer_tpu_torch.constants import K_EPSILON, TMAX
from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.native import build_bvh4_fat_native
from craytracer_tpu_torch.scene.types import BVH4Arrays

WIDTH = 4
LEAF_SIZE = 2  # the JAX build's default for bvh4 (scene/build.py:523)
MAX_STACK = 128
TRI_COLS = 10
FAT_TRI0 = 28
FAT_COLS = 128  # rows padded to 128 columns (accel/bvh4.py `_pad128`)
_SORT_NET = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))


def stack_bound_children(child) -> int:
    """BFS depth of the 4-wide tree from its [M, 4] child ids (-1: none)
    -> the per-lane stack bound: a pop nets at most +3, so sp <= 3 * depth
    + 1; +4 margin, rounded up to a multiple of 8, at least 16 and at most
    MAX_STACK."""
    child = np.asarray(child, np.int64)
    frontier = np.array([0], np.int64)
    depth = 0
    while frontier.size and depth < 200:
        depth += 1
        nxt = child[frontier].reshape(-1)
        frontier = nxt[nxt >= 0]
    bound = 3 * depth + 4
    return int(min(MAX_STACK, max(16, ((bound + 7) // 8) * 8)))


def check_leaf_slots(fat, leaf_size: int = LEAF_SIZE) -> None:
    """Raise unless every internal child (child id >= 0) and every empty
    child (its box's min x > max x, the builder's sentinel) of every row
    of the fat table has empty slots (triangle ids < 0). K3, K3 `_init`,
    K4 and K5 skip such children's slots (csrc/bvh4_walk.cuh), which is
    exact only on such a table."""
    fat = np.asarray(fat)
    child = fat[:, 24:28]
    empty = fat[:, 0:12:3] > fat[:, 12:24:3]
    ids = fat[:, FAT_TRI0:FAT_TRI0 + WIDTH * leaf_size * TRI_COLS].reshape(
        -1, WIDTH, leaf_size, TRI_COLS)[..., TRI_COLS - 1]
    for kind, which in (("internal", child >= 0), ("empty", empty)):
        bad = which[:, :, None] & (ids >= 0)
        if bad.any():
            row, c, _ = np.argwhere(bad)[0]
            raise ValueError(f"fat row {row}: {kind} child {c} holds a "
                             "triangle in its slots")


def build_bvh4(v0, v1, v2, leaf_size: int = LEAF_SIZE) -> BVH4Arrays:
    """SAH-split 4-wide BVH over [T, 3] f32 triangle corners, built by the
    native runtime (the JAX builder's default with the library present,
    scene/build.py:523-533); rows padded to 128 columns."""
    t = np.asarray(v0).shape[0]
    if t == 0:
        raise ValueError("build_bvh4 needs at least one triangle")
    if t >= (1 << 24):
        raise ValueError("fat rows inline f32 triangle ids: fewer than 2^24 "
                         "triangles")
    fat = build_bvh4_fat_native(v0, v1, v2, leaf_size)
    check_leaf_slots(fat, leaf_size)
    bound = stack_bound_children(fat[:, 24:28])
    if fat.shape[1] < FAT_COLS:
        fat = np.pad(fat, ((0, 0), (0, FAT_COLS - fat.shape[1])))
    return BVH4Arrays(fat=torch.from_numpy(np.ascontiguousarray(fat)),
                      n_tris=t, leaf_size=leaf_size, stack_size=bound)


def _swap(key, val, i, j):
    """Order slots i, j so that key[i] >= key[j] (ties keep their order)."""
    do = key[i] < key[j]
    key[i], key[j] = (torch.where(do, key[j], key[i]),
                      torch.where(do, key[i], key[j]))
    val[i], val[j] = (torch.where(do, val[j], val[i]),
                      torch.where(do, val[i], val[j]))


def _tri_leaf(k_slots: int):
    """The fat rows' leaf test: every inlined triangle slot
    (Moller-Trumbore), as `walk`'s `leaf`."""

    def leaf(row, oo, dd, active, best_t, md, any_hit):
        ox, oy, oz = oo[:, 0:1], oo[:, 1:2], oo[:, 2:3]
        dx, dy, dz = dd[:, 0:1], dd[:, 1:2], dd[:, 2:3]
        tri = row[:, FAT_TRI0:FAT_TRI0 + k_slots * TRI_COLS].reshape(
            -1, k_slots, TRI_COLS)
        v0x, v0y, v0z = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
        e1x, e1y, e1z = tri[:, :, 3], tri[:, :, 4], tri[:, :, 5]
        e2x, e2y, e2z = tri[:, :, 6], tri[:, :, 7], tri[:, :, 8]
        tid = tri[:, :, 9].to(torch.int32)
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = 1.0 / vm._safe(det)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        beta = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        gamma = (dx * qx + dy * qy + dz * qz) * inv_det
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = (active[:, None] & (tid >= 0) & (beta >= 0.0) & (gamma >= 0.0)
              & (beta + gamma <= 1.0) & (tt > K_EPSILON))
        if any_hit:
            ok = ok & (tt < md[:, None])
        cand, k = torch.where(ok, tt, torch.inf).min(dim=1)
        return cand, tid.gather(1, k[:, None])[:, 0]

    return leaf


@torch.no_grad()
def walk(fat, stack_size: int, leaf, o, d, any_hit: bool, max_dist=None,
         visits=None, t0=None, id0=None):
    """The per-lane stack walk of a fat-row table (the module docstring's
    visit order) around `leaf(row [A, C], o, d, active, best_t, max_dist,
    any_hit) -> (t [A], id [A] int32)`, the row's closest accepted slot
    (first on a tie; t not below best_t where none). Returns (best_t [N]
    f32, best_id [N] int32, pops [N] int32), starting from the carried
    best hit (t0, id0) when given, else TMAX / -1; each pop adds one to
    its row's entry of `visits` ([M] int64) if given."""
    n = o.shape[0]
    dev = o.device
    m = fat.shape[0]
    S = int(stack_size)
    if t0 is None:
        out_t = torch.full((n,), TMAX, dtype=torch.float32, device=dev)
        out_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    else:
        out_t = t0.to(torch.float32).clone()
        out_id = id0.to(torch.int32).clone()
    out_pops = torch.zeros((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out_t, out_id, out_pops
    if max_dist is None:
        max_dist = torch.full((n,), TMAX, dtype=torch.float32, device=dev)

    # working set: the lanes still walking, in compacted form
    lane = torch.arange(n, device=dev)
    oo, dd, md = o, d, max_dist
    iv = 1.0 / vm._safe(d)
    stack = torch.zeros((n, S), dtype=torch.int64, device=dev)  # root = 0
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    best_t, best_id, pops = out_t.clone(), out_id.clone(), out_pops.clone()

    while lane.numel():
        active = sp > 0
        pops = pops + active.to(torch.int32)
        top = sp - 1
        node = stack.gather(1, top.clamp(min=0)[:, None])[:, 0]
        sp = torch.where(active, top, sp)
        node = torch.where(active, node.clamp(0, m - 1), 0)
        if visits is not None:
            popped = node[active]
            visits.index_add_(0, popped, torch.ones_like(popped))
        row = fat[node]  # [A, 128]: the one gather per pop

        ox, oy, oz = oo[:, 0:1], oo[:, 1:2], oo[:, 2:3]
        ivx, ivy, ivz = iv[:, 0:1], iv[:, 1:2], iv[:, 2:3]

        # 4-box slab test (rayIntersectAABB4, accelerator/bvh4.h:23-97)
        t0x = (row[:, 0:12:3] - ox) * ivx
        t1x = (row[:, 12:24:3] - ox) * ivx
        t0y = (row[:, 1:12:3] - oy) * ivy
        t1y = (row[:, 13:24:3] - oy) * ivy
        t0z = (row[:, 2:12:3] - oz) * ivz
        t1z = (row[:, 14:24:3] - oz) * ivz
        tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                         torch.minimum(t0y, t1y)),
                           torch.minimum(t0z, t1z))
        tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                         torch.maximum(t0y, t1y)),
                           torch.maximum(t0z, t1z))
        tlimit = torch.minimum(best_t, md)[:, None]
        box_hit = active[:, None] & (tn <= tf) & (tf > 0.0) & (tn < tlimit)
        child = row[:, 24:28].to(torch.int64)

        # the row's inlined leaf slots, every one
        cand, cand_id = leaf(row, oo, dd, active, best_t, md, any_hit)
        better = cand < best_t
        best_id = torch.where(better, cand_id, best_id)
        best_t = torch.where(better, cand, best_t)

        # push the entered internal children far to near (nearest on top)
        is_int = (child >= 0) & box_hit
        key = list(torch.where(is_int, tn, -torch.inf).unbind(1))
        val = list(torch.where(is_int, child, -1).unbind(1))
        for i, j in _SORT_NET:
            _swap(key, val, i, j)
        npush = sum((v >= 0).to(torch.int64) for v in val)
        npush = torch.minimum(npush, S - sp)
        for r in range(WIDTH):
            pos = (sp + r).clamp(max=S - 1)[:, None]
            cur = stack.gather(1, pos)[:, 0]
            stack.scatter_(1, pos, torch.where(r < npush, val[r], cur)[:, None])
        sp = sp + npush
        if any_hit:
            sp = torch.where(best_t < md, 0, sp)

        done = sp == 0
        n_done = int(done.sum())
        if n_done and (n_done == lane.numel() or 8 * n_done >= lane.numel()):
            fin = lane[done]
            out_t[fin], out_id[fin], out_pops[fin] = (
                best_t[done], best_id[done], pops[done])
            keep = ~done
            lane, oo, dd, iv, md = (lane[keep], oo[keep], dd[keep], iv[keep],
                                    md[keep])
            stack, sp = stack[keep], sp[keep]
            best_t, best_id, pops = best_t[keep], best_id[keep], pops[keep]
    return out_t, out_id, out_pops


def _traverse4(bvh: BVH4Arrays, o, d, any_hit: bool, max_dist=None,
               visits=None, t0=None, tri0=None):
    """(best_t [N] f32, best_tri [N] int32, pops [N] int32) per lane over
    a triangle table (`walk` with the triangle leaf)."""
    return walk(bvh.fat, bvh.stack_size, _tri_leaf(WIDTH * bvh.leaf_size),
                o, d, any_hit, max_dist, visits, t0, tri0)


def bvh4_closest_hit(bvh: BVH4Arrays, o, d):
    """Closest hit: (t [N] f32, triangle id [N] int32); TMAX / -1 on a
    miss."""
    t, tri, _ = _traverse4(bvh, o, d, any_hit=False)
    return t, tri


def bvh4_closest_hit_stats(bvh: BVH4Arrays, o, d, visits=None):
    """(t, tri, pops [N] int32): the closest hit and each lane's node
    visits (the reference's per-object test counters, intersect.h:363).
    Each pop also adds one to its row's entry of `visits` ([M] int64) if
    given."""
    return _traverse4(bvh, o, d, any_hit=False, visits=visits)


def bvh4_closest_hit_init(bvh: BVH4Arrays, o, d, t0, tri0):
    """Closest hit carrying in a best hit: (t, tri) is (t0, tri0) unless
    the tree holds a triangle strictly closer than t0 (a box is entered
    only when its entry distance is below the running best). The plain
    version of K3 `_init` and K5."""
    t, tri, _ = _traverse4(bvh, o, d, any_hit=False, t0=t0, tri0=tri0)
    return t, tri


def bvh4_closest_hit_init_stats(bvh: BVH4Arrays, o, d, t0, tri0,
                                visits=None):
    """(t, tri, pops [N] int32) of `bvh4_closest_hit_init`, with each pop
    counted per row into `visits` ([M] int64) if given."""
    return _traverse4(bvh, o, d, any_hit=False, visits=visits, t0=t0,
                      tri0=tri0)


def bvh4_any_hit(bvh: BVH4Arrays, o, d, max_dist):
    """Shadow any-hit: t < max_dist when the ray is occluded, else TMAX."""
    t, _, _ = _traverse4(bvh, o, d, any_hit=True, max_dist=max_dist)
    return t


def bvh4_any_hit_stats(bvh: BVH4Arrays, o, d, max_dist, visits=None):
    """(t, pops [N] int32): the any hit and each lane's node visits, also
    counted per row into `visits` ([M] int64) if given."""
    t, _, pops = _traverse4(bvh, o, d, any_hit=True, max_dist=max_dist,
                            visits=visits)
    return t, pops
