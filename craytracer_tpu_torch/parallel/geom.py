"""Geometry sharding over the ranks of a mesh axis (counterpart of
craytracer_tpu/parallel/geom.py: `reduce_hit` :53, `shard_scene_geometry`
:82, `make_geom_mesh` :134 (here in sharded.py), `geom_sharded_render_pass`
:146 and `geom_sharded_train_step` :167).

The triangle soup is split into G contiguous blocks, one per rank of the
geom axis; each rank builds its own block's accelerator table and holds a
full copy of the small replicated tables (materials, lights, analytic
primitives, textures). Every bounce each rank intersects the whole ray
batch against its block, then `reduce_hit` elects each lane's winning
rank with one all-reduce MIN of t and one of the candidate rank (ties go
to the lowest rank, so an all-miss lane keeps rank 0's miss record), and
broadcasts the winner's hit record with one all-reduce SUM of the record
masked to the winner: of its bits, the floats viewed as int32 beside the
int fields, so the winner's values arrive exactly, -0.0 included (a SUM
of the floats, as JAX's psum, would turn -0.0 into +0.0, and the shading
frame's sign test reads the sign of a zero). The shadow rays' distances
reduce with one all-reduce MIN. Shading then runs
replicated along the axis: identical inputs, and the counter RNG keyed by
the replicated pixel ids.

The record's backward is a SUM all-reduce of the cotangents, the
transpose JAX gives `psum` under `shard_map(check_vma=False)`: every rank
of the axis adds its replicated shading's cotangent, so the winning
shard's fill receives G times the cotangent of the unsharded pass. Each
geometry rank's gradient is then its own: a triangle row gets G times its
unsharded gradient on its shard, an analytic primitive (a tie, won by
rank 0) G times on rank 0 and 0 elsewhere, and a replicated leaf that
reaches a fill (a rough material's alpha, through the next bounce's ray)
a different value on each rank; the mean over the axis is the unsharded
gradient. The port matches JAX's numbers, shard for shard (ROADMAP's
documented deviations: JAX's convention, kept).

A scene with mesh lights is refused: their NEE reads global triangle rows
at shading time. Shards are padded to equal triangle counts with copies
of their last row; a pad row's hit is geometrically a real one, so only
its global prim id is meaningless, and without mesh lights nothing reads
a triangle prim id.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from craytracer_tpu_torch.integrator.wavefront import render_sample
from craytracer_tpu_torch.parallel.sharded import (Axis, Mesh, _grads,
                                                   _mse, all_reduce,
                                                   mean_over, ray_block,
                                                   render_rays,
                                                   with_grad_leaves)
from craytracer_tpu_torch.scene import types as T

_ROUTES = ("bounce", "shade", "general")


class _RecordOverAxis(torch.autograd.Function):
    """The winner's hit record on every rank of an axis: forward, one
    all-reduce SUM of the record's bits masked to the winner (the floats
    viewed as int32 beside the int fields), which copies the winner's
    values exactly, -0.0 included; backward, an all-reduce SUM of the
    floats' cotangent (the transpose JAX gives psum)."""

    @staticmethod
    def forward(ctx, floats, ints, axis: Axis):
        ctx.axis = axis
        k = floats.shape[1]
        bits = all_reduce(torch.cat([floats.view(torch.int32), ints], dim=1),
                          axis)
        out_i = bits[:, k:]
        ctx.mark_non_differentiable(out_i)
        return bits[:, :k].view(floats.dtype), out_i

    @staticmethod
    def backward(ctx, g, _):
        return all_reduce(g, ctx.axis), None, None


def reduce_hit(hit, axis: Axis, tri_base: int = 0):
    """The closest of the axis' per-shard hits on every lane (geom.py
    :53-79), on every rank: the winner is the lowest rank at the least t,
    and triangle prim ids are rebased by `tri_base`, this shard's first
    global row. Gradients flow back to the winner's fill."""
    from craytracer_tpu_torch.ops.intersect import Hit

    t_det = hit.t.detach()
    t_min = all_reduce(t_det, axis, dist.ReduceOp.MIN)
    cand = torch.where(t_det <= t_min, axis.index, 1 << 30).to(torch.int32)
    mine = (cand == all_reduce(cand, axis, dist.ReduceOp.MIN))[:, None]
    prim = torch.where(hit.group == T.GROUP_TRIANGLE, hit.prim + tri_base,
                       hit.prim)
    ints = torch.stack([hit.group, prim, hit.mat_id], dim=1).to(torch.int32)
    floats = torch.cat([hit.t[:, None], hit.point, hit.normal, hit.dpdu,
                        hit.uv], dim=1).to(torch.float32)
    floats, ints = _RecordOverAxis.apply(
        torch.where(mine, floats, torch.zeros_like(floats)),
        torch.where(mine, ints, 0), axis)
    t, point, normal, dpdu, uv = (x.contiguous() for x in torch.split(
        floats, (1, 3, 3, 3, 2), dim=1))
    group, prim, mat_id = (x.contiguous() for x in ints.unbind(1))
    return Hit(t=t[:, 0], group=group, prim=prim, point=point,
               normal=normal, dpdu=dpdu, uv=uv, mat_id=mat_id)


def reduce_shadow(t_shadow, axis: Axis):
    """The least shadow-ray distance over the axis' shards (geom.py's
    `pmin` of t_shadow, integrator/wavefront.py:116, :289)."""
    return all_reduce(t_shadow, axis, dist.ReduceOp.MIN)


def check_same_route(axis: Axis, route: str, compact_at: int, device):
    """Raise unless every rank of the axis takes the same route and the
    same compaction bounce: they run the same collectives only then."""
    mine = torch.tensor([_ROUTES.index(route), compact_at])
    both = all_reduce(torch.cat([mine, -mine]).to(device), axis,
                      dist.ReduceOp.MAX).cpu()
    if not torch.equal(both[:2], -both[2:]):
        raise RuntimeError(f"the geometry shards of one group take different "
                           f"routes: (route, compact_at) from {mine.tolist()} "
                           f"to {both[:2].tolist()}")


def shard_scene_geometry(scene: T.Scene, n_shards: int, index: int,
                         accel: str = "bvh4"):
    """Geometry shard `index` of `n_shards` (geom.py:82-131): (the scene
    with only that contiguous block of its triangles, padded to the
    largest block's count with copies of its last row, and the block's own
    `accel` table, "bvh4" or "bvh"; the block's first global row,
    `tri_base`). The other fields are the scene's own; a bvh4 table past
    the part budget is also cut into parts, as the scene builder cuts
    one. Blocks are np.array_split's. A scene with mesh lights, or with
    fewer triangles than shards, raises ValueError."""
    if accel not in ("bvh", "bvh4"):
        raise ValueError(f"geometry sharding supports bvh and bvh4, not "
                         f"{accel!r}")
    if scene.mesh_lights.surface_area.shape[0]:
        raise ValueError("geometry sharding requires a scene without mesh "
                         "lights: mesh-light NEE reads global triangle "
                         "rows at shading time")
    n_tris = scene.triangles.mat_id.shape[0]
    if n_tris < n_shards:
        raise ValueError(f"{n_tris} triangles for {n_shards} geometry "
                         "shards")
    blocks = np.array_split(np.arange(n_tris), n_shards)
    per = max(b.size for b in blocks)
    b = blocks[index]
    idx = np.concatenate([b, np.full(per - b.size, b[-1], b.dtype)])
    sel = torch.from_numpy(idx).to(scene.device)
    tris = dataclasses.replace(scene.triangles, **{
        f.name: getattr(scene.triangles, f.name)[sel]
        for f in dataclasses.fields(T.Triangles)})
    v = [getattr(tris, k).detach().cpu().numpy() for k in ("v0", "v1", "v2")]
    parts = None
    if accel == "bvh":
        from craytracer_tpu_torch.accel.bvh import build_bvh

        table = build_bvh(*v)
    else:
        from craytracer_tpu_torch.accel import bvh4_parts
        from craytracer_tpu_torch.accel.bvh4 import build_bvh4

        table = build_bvh4(*v)
        if table.fat.numel() * 4 > bvh4_parts.PART_BUDGET_BYTES:
            parts = bvh4_parts.partition_bvh4(table,
                                              bvh4_parts.PART_BUDGET_BYTES)
    shard = dataclasses.replace(scene, triangles=tris, tri_bvh=table,
                                tri_shadow=None, tri_parts=parts,
                                accel=accel)
    return T.to_device(shard, scene.device), int(b[0])


def geom_sharded_render_pass(mesh: Mesh, max_depth: int,
                             estimator: str = "reference", fast_shade=True,
                             with_metrics: bool = False, kernels=None):
    """A pass (shard, tri_base, camera, film, pixel_ids, seed, spp_index)
    -> the radiance of every pixel id on every rank (geom.py:146-164):
    the pixel ids split over the ray axis, `shard` this rank's geometry
    shard (`shard_scene_geometry`) with its `tri_base`, the hits reduced
    over the geom axis every bounce. `fast_shade` and `with_metrics` as
    for sharded_render_pass: True takes the gate's route, where a "bounce"
    scene takes the per-bounce "shade" route (the reduction needs the hit
    between stages, as JAX's render_sample skips its megakernel, :603);
    False the general step. `kernels` as for render_sample."""

    def render(shard, tri_base, camera, film, pixel_ids, seed, spp_index):
        return render_rays(mesh, pixel_ids, with_metrics, lambda block:
                           render_sample(shard, camera, film, block, seed,
                                         spp_index, max_depth, estimator,
                                         general=not fast_shade,
                                         kernels=kernels,
                                         geom_axis=mesh.geom,
                                         tri_base=tri_base,
                                         with_metrics=with_metrics))

    return render


def geom_sharded_train_step(mesh: Mesh, max_depth: int):
    """The inverse-rendering step on a (rays, geom) mesh (geom.py
    :167-202): a step (shard, tri_base, camera, film, pixel_ids, seed,
    spp_index, target) -> (loss, grads) with the hits reduced over geom
    every bounce; loss is averaged over rays and geom, grads (by
    `float_leaves` name, of this rank's shard) over rays. The replicated
    tables' gradients are the same on every geom rank; the winning
    shard's geometry gradients come back through the hit reduction
    (module docstring)."""

    def step(shard, tri_base, camera, film, pixel_ids, seed, spp_index,
             target):
        pixel_ids = torch.as_tensor(pixel_ids, device=mesh.device)
        shard_g, leaves = with_grad_leaves(shard)
        img = render_sample(shard_g, camera, film,
                            ray_block(pixel_ids, mesh.rays), seed, spp_index,
                            max_depth, estimator="physical",
                            geom_axis=mesh.geom, tri_base=tri_base)
        loss = _mse(img, ray_block(target, mesh.rays))
        loss_g = mean_over([loss, *_grads(loss, leaves)], mesh.rays)
        loss = loss_g[0]
        if mesh.geom is not None:
            loss = mean_over([loss], mesh.geom)[0]
        return loss, dict(zip(leaves, loss_g[1:]))

    return step
