"""4-wide fat-row BVH over spheres: the host build and the plain PyTorch
traversal (counterpart of craytracer_tpu/accel/bvh4_sphere.py:
`build_bvh4_spheres` :47-83, `_traverse_s` :86-217, `bvh4s_closest_hit`
:219, `bvh4s_any_hit` :223; and of the Python collapse of
craytracer_tpu/accel/bvh4.py `collapse4` :110-208).

The JAX builder indexes a scene's spheres with this table when it holds
256 or more of them and an accelerator was asked for
(craytracer_tpu/scene/build.py:578-590). Each sphere's box corners
(center -/+ radius, formed in f64 and rounded to f32 by the native
build) and its center go to the binary-BVH builder as a degenerate
"triangle" (it reads only their min, max and centroid), in the object
median split the JAX sphere build uses (native.build_bvh_native); the
binary tree is collapsed to 4-wide nodes level by level exactly as
`collapse4` does, and each row inlines its leaf spheres. A row holds
[0:12) four child mins, [12:24) four child maxs, [24:28) child ids (-1:
leaf or empty slot), then per slot LEAF_SIZE (2) spheres of 8 columns
(center, radius, phi, min_theta, max_theta, id; a pad has radius 0 and
id -1), assembled in f64, cast to f32 once and padded to 128 columns.

The traversal is `accel/bvh4.py` `walk` with the sphere leaf: the
partial-sphere quadratic of `_traverse_s` with both roots, phi =
atan2(x, z), and a REJECT on |cos theta| > 1 (the reference's
unclamped-acos quirk, shapes/sphere.cpp:33-86), in `_traverse_s`'s own
expression order rather than ops/intersect.py `sphere_ts`'s: the group
arg-min compares this t, and another expression tree could change which
group wins on a lane. It runs without autograd, as the JAX search runs
under stop_gradient (ops/intersect.py:540-545); the sphere fill
re-derives t from the id it returns. No Pallas kernel walks this table in
the JAX package, so none is written here: on the card it is torch ops.
"""

from __future__ import annotations

import numpy as np
import torch

from craytracer_tpu_torch.accel.bvh4 import (FAT_COLS, LEAF_SIZE, WIDTH,
                                             stack_bound_children, walk)
from craytracer_tpu_torch.constants import K_EPSILON, TMAX
from craytracer_tpu_torch.native import build_bvh_native
from craytracer_tpu_torch.scene.types import SphereBVH4

SPH_COLS = 8  # center 3, radius, phi, min_theta, max_theta, id
SPH0 = 28  # the first sphere column


def collapse4(bb_min, bb_max, center, leaf_size: int):
    """Median-split binary BVH over the boxes [bb_min, bb_max] (centroid
    `center`), collapsed into 4-wide nodes: (mins [M, 4, 3], maxs [M, 4,
    3] f32, child [M, 4], lf [M, 4], lc [M, 4] int64, order [P] int32).
    A slot holds a grandchild where its child is internal and the child
    itself where that is a leaf (lf, lc its first index into `order` and
    its count); -1 marks an empty slot, whose box is (1, 1, 1) to (-1,
    -1, -1). Rows are numbered in breadth-first visit order."""
    node_min, node_max, right, _, first, count, order = build_bvh_native(
        bb_min, bb_max, center, leaf_size)
    node_min = np.asarray(node_min, np.float64)
    node_max = np.asarray(node_max, np.float64)
    right, first, count = (np.asarray(a, np.int64)
                           for a in (right, first, count))
    is_leaf = count > 0

    if is_leaf[0]:
        # a single-leaf tree: one row whose first slot is the leaf
        mins = np.ones((1, WIDTH, 3), np.float32)
        maxs = -np.ones((1, WIDTH, 3), np.float32)
        child = np.full((1, WIDTH), -1, np.int64)
        lf = np.full((1, WIDTH), -1, np.int64)
        lc = np.zeros((1, WIDTH), np.int64)
        mins[0, 0], maxs[0, 0] = node_min[0], node_max[0]
        lf[0, 0], lc[0, 0] = first[0], count[0]
        return mins, maxs, child, lf, lc, order

    # each breadth-first wave of binary internal nodes becomes a wave of
    # 4-wide rows
    waves = []
    frontier = np.array([0], np.int64)
    while frontier.size:
        left, rgt = frontier + 1, right[frontier]
        leaf_l, leaf_r = is_leaf[left], is_leaf[rgt]
        slots = np.stack([np.where(leaf_l, left, left + 1),
                          np.where(leaf_l, -1, right[left]),
                          np.where(leaf_r, rgt, rgt + 1),
                          np.where(leaf_r, -1, right[rgt])], axis=1)
        waves.append(slots)
        flat = slots.reshape(-1)
        frontier = flat[(flat >= 0) & ~is_leaf[np.maximum(flat, 0)]]
    slots = np.concatenate(waves, axis=0)  # [M, 4] binary ids or -1
    # row id of each binary internal node: its breadth-first visit rank
    visit = slots.reshape(-1)
    internal = visit[(visit >= 0) & ~is_leaf[np.maximum(visit, 0)]]
    row_of = np.full(node_min.shape[0], -1, np.int64)
    row_of[0] = 0
    row_of[internal] = np.arange(1, 1 + internal.size)

    valid = slots >= 0
    sc = np.maximum(slots, 0)
    slot_leaf = valid & is_leaf[sc]
    slot_int = valid & ~is_leaf[sc]
    mins = np.where(valid[..., None], node_min[sc], 1.0).astype(np.float32)
    maxs = np.where(valid[..., None], node_max[sc], -1.0).astype(np.float32)
    child = np.where(slot_int, row_of[sc], -1)
    lf = np.where(slot_leaf, first[sc], -1)
    lc = np.where(slot_leaf, count[sc], 0)
    return mins, maxs, child, lf, lc, order


def build_bvh4_spheres(center, radius, phi, min_theta,
                       max_theta) -> SphereBVH4:
    """The sphere fat-row table over [P] spheres (the scene's f32 arrays),
    LEAF_SIZE (2) spheres to a leaf, rows padded to 128 columns,
    bit-equal with the JAX build's at that leaf size."""
    center = np.asarray(center, np.float64)
    radius = np.asarray(radius, np.float64)
    p = center.shape[0]
    if p == 0 or p >= (1 << 24):
        raise ValueError("the sphere BVH4 needs 1 to 2^24 - 1 spheres (ids "
                         "are inlined as f32)")
    mins, maxs, child, lf, lc, order = collapse4(
        center - radius[:, None], center + radius[:, None], center,
        LEAF_SIZE)
    m = mins.shape[0]
    rows = np.concatenate([
        center, radius[:, None],
        *(np.asarray(a, np.float64)[:, None]
          for a in (phi, min_theta, max_theta)),
        np.arange(p, dtype=np.float64)[:, None],
    ], axis=1)[order.astype(np.int64)]  # in leaf order
    k = np.arange(LEAF_SIZE)
    slots = lf[:, :, None] + k[None, None, :]
    ok = (lf[:, :, None] >= 0) & (k[None, None, :] < lc[:, :, None])
    pad = np.zeros(SPH_COLS, np.float64)
    pad[-1] = -1.0  # id -1; radius 0 never hits
    blocks = np.where(ok[..., None], rows[np.clip(slots, 0, p - 1)], pad)
    fat = np.concatenate([
        mins.reshape(m, 12), maxs.reshape(m, 12), child.astype(np.float64),
        blocks.reshape(m, WIDTH * LEAF_SIZE * SPH_COLS),
    ], axis=1).astype(np.float32)
    if fat.shape[1] < FAT_COLS:
        fat = np.pad(fat, ((0, 0), (0, FAT_COLS - fat.shape[1])))
    return SphereBVH4(fat=torch.from_numpy(np.ascontiguousarray(fat)),
                      n_prims=p, leaf_size=LEAF_SIZE,
                      stack_size=stack_bound_children(child))


def _sphere_leaf(k_slots: int):
    """The sphere rows' leaf test (bvh4_sphere.py:154-189), every slot at
    once as [A, k_slots] tensors, as `walk`'s `leaf`."""

    def leaf(row, oo, dd, active, best_t, md, any_hit):
        ox, oy, oz = oo[:, 0:1], oo[:, 1:2], oo[:, 2:3]
        dx, dy, dz = dd[:, 0:1], dd[:, 1:2], dd[:, 2:3]
        s = row[:, SPH0:SPH0 + k_slots * SPH_COLS].reshape(-1, k_slots,
                                                           SPH_COLS)
        pr, pphi, pth0, pth1 = s[:, :, 3], s[:, :, 4], s[:, :, 5], s[:, :, 6]
        pid = s[:, :, 7].to(torch.int32)
        ocx, ocy, ocz = ox - s[:, :, 0], oy - s[:, :, 1], oz - s[:, :, 2]
        b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
        c = ocx * ocx + ocy * ocy + ocz * ocz - pr * pr
        disc = b * b - 4.0 * c  # a == 1 for unit directions
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        base = active[:, None] & (disc > 0.0) & (pid >= 0)
        bt = best_t[:, None]

        def accept(tt):
            phi = torch.atan2(ocx + tt * dx, ocz + tt * dz)
            cos_raw = (ocy + tt * dy) / torch.clamp(pr, min=1e-12)
            theta = torch.acos(torch.clamp(cos_raw, -1.0, 1.0))
            ok = (base & (tt > K_EPSILON) & (torch.abs(phi) <= pphi)
                  & (theta >= pth0) & (theta <= pth1)
                  & (torch.abs(cos_raw) <= 1.0) & (tt < bt))
            if any_hit:
                ok = ok & (tt < md[:, None])
            return torch.where(ok, tt, TMAX)

        tt = torch.minimum(accept((-b - sq) * 0.5), accept((-b + sq) * 0.5))
        cand, k = tt.min(dim=1)
        return cand, pid.gather(1, k[:, None])[:, 0]

    return leaf


def bvh4s_closest_hit(bvh: SphereBVH4, o, d):
    """Closest sphere hit: (t [N] f32, sphere id [N] int32); TMAX / -1 on
    a miss."""
    t, sid, _ = walk(bvh.fat, bvh.stack_size,
                     _sphere_leaf(WIDTH * bvh.leaf_size), o, d,
                     any_hit=False)
    return t, sid


def bvh4s_any_hit(bvh: SphereBVH4, o, d, max_dist):
    """Shadow any hit: t < max_dist when a sphere occludes the ray, else
    TMAX."""
    t, _, _ = walk(bvh.fat, bvh.stack_size,
                   _sphere_leaf(WIDTH * bvh.leaf_size), o, d, any_hit=True,
                   max_dist=max_dist)
    return t
