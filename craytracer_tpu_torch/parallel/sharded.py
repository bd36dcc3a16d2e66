"""Ray-sharded rendering and the inverse-rendering step over
torch.distributed (counterpart of craytracer_tpu/parallel/sharded.py:
`make_mesh` :39, `sharded_render_pass` :48, `_render_loss` :65,
`sharded_train_step` :74).

The JAX package runs one program over a device mesh (`shard_map`); the
port runs one process per rank, each with its own CUDA context, and the
caller starts them and calls `torch.distributed.init_process_group`
naming the backend (dryrun.py does both). A `Mesh` is this rank's place
in a (rays, geom) grid of the first R x G ranks, geom innermost (rank =
r x G + g, parallel/geom.py:134-139): the process group of each axis it
lies on, its index along it, and the device it renders on.

* Forward rendering is data-parallel over rays: the pixel ids split into
  R contiguous equal blocks (as `P(RAY_AXIS)` splits them; a count that
  does not divide raises, as shard_map does), each rank renders its
  block against the whole scene through `render_sample`, on the route
  the gate picks (K1 for a "bounce" scene, K3 -> K2 -> K4 for a bvh4
  mesh), and the image is assembled on every rank by one all-reduce SUM
  into a zeroed buffer. The sum is exact: each element has one
  contributor. JAX returns a global array; every rank here holds the
  whole image.
* The train step differentiates the physical-estimator MSE of the rank's
  block (`_render_loss`) with respect to every float leaf of the scene's
  geometry, material, light, env and texture tables, and all-reduces the
  loss and the gradients to their mean over the ray ranks in one flat
  buffer (the pmean of :93-101). The accelerator tables (tri_bvh,
  tri_shadow, tri_parts, sph_bvh) are left out: the search is detached in
  both packages (ops/intersect.py), so their gradient is zero.

Gloo reduces CUDA tensors through the host; every collective here is an
`all_reduce` (SUM, MIN), which it supports for them. Every rank of a
group enters every collective in the same order: the code paths depend on
shapes and static scene fields only, never on a rank's data.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from craytracer_tpu_torch.integrator.wavefront import render_sample
from craytracer_tpu_torch.scene import types as T

# the scene fields that hold accelerator tables: their gradient is zero
_TABLES = ("tri_bvh", "tri_shadow", "tri_parts", "sph_bvh")


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: the process group of the ranks
    along it, this rank's index in that group and the group's size."""

    group: object  # torch.distributed.ProcessGroup
    index: int
    size: int


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid of ranks: its ray axis, its geometry
    axis (None for a ray-only mesh) and the device it renders on."""

    rays: Axis
    geom: Optional[Axis]
    device: torch.device


def _rank_device(device):
    """`device`, or the card the rank's index picks among the visible ones
    (several ranks share a card when there are fewer cards than ranks)."""
    if device is not None:
        return torch.device(device)
    T.resolve_device(None)  # raises without a card
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def make_geom_mesh(n_ray_shards: int, n_geom_shards: int,
                   device=None) -> Optional[Mesh]:
    """The (rays, geom) mesh over the first R x G ranks of the default
    process group, geom innermost: rank r x G + g holds ray block r and
    geometry shard g (the JAX make_geom_mesh, parallel/geom.py:134-139).
    Every rank of the world must call it (group creation is collective);
    a rank outside the mesh gets None. `device` None takes the card
    (`_rank_device`)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n_r, n_g = n_ray_shards, n_geom_shards
    if n_r < 1 or n_g < 1 or n_r * n_g > world:
        raise ValueError(f"a {n_r} x {n_g} mesh needs {n_r * n_g} ranks; "
                         f"the world has {world}")
    cols = [dist.new_group([r * n_g + g for r in range(n_r)])
            for g in range(n_g)]
    rows = [dist.new_group([r * n_g + g for g in range(n_g)])
            for r in range(n_r)] if n_g > 1 else None
    if rank >= n_r * n_g:
        return None
    r, g = divmod(rank, n_g)
    return Mesh(rays=Axis(cols[g], r, n_r),
                geom=Axis(rows[r], g, n_g) if rows else None,
                device=_rank_device(device))


def make_mesh(n_devices: Optional[int] = None, device=None) -> Optional[Mesh]:
    """The ray-only mesh over the first `n_devices` ranks (the whole world
    when None) of the default process group, which the caller has
    initialized with the backend it names. Every rank of the world must
    call it; a rank outside the mesh gets None."""
    return make_geom_mesh(n_devices or dist.get_world_size(), 1, device)


def ray_block(x, axis: Axis):
    """This rank's contiguous block of the leading dimension of `x`, split
    into `axis.size` equal blocks; a length that does not divide raises."""
    n = x.shape[0]
    if n % axis.size:
        raise ValueError(f"{n} lanes do not split into {axis.size} equal "
                         "ray blocks")
    per = n // axis.size
    return x[axis.index * per:(axis.index + 1) * per]


def all_reduce(x, axis: Axis, op=dist.ReduceOp.SUM):
    """A reduced copy of `x` over the axis' group (`x` is not changed)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=op, group=axis.group)
    return out


def gather_rays(block, n: int, axis: Axis):
    """The [n, ...] array whose ray blocks the ranks of `axis` hold, on
    every rank: one all-reduce SUM into a zeroed buffer, exact because
    each element has one contributor (x + 0 is x; a -0.0 comes back
    +0.0)."""
    out = torch.zeros((n,) + tuple(block.shape[1:]), dtype=block.dtype,
                      device=block.device)
    per = block.shape[0]
    out[axis.index * per:(axis.index + 1) * per] = block
    dist.all_reduce(out, group=axis.group)
    return out


def render_rays(mesh: Mesh, pixel_ids, with_metrics: bool, render):
    """`render(block)` of this rank's block of the pixel ids, assembled
    over the ray axis: the image, and with `with_metrics` also the per-lane
    good_paths, ray and shadow-ray counts (one more all-reduce)."""
    pixel_ids = torch.as_tensor(pixel_ids, device=mesh.device)
    n = pixel_ids.shape[0]
    out = render(ray_block(pixel_ids, mesh.rays))
    if not with_metrics:
        return gather_rays(out, n, mesh.rays)
    img, good, m = out
    ints = torch.stack([good, m["lane_rays"], m["lane_shadow_rays"]],
                       dim=1).to(torch.int32)
    return (gather_rays(img, n, mesh.rays),
            *gather_rays(ints, n, mesh.rays).unbind(1))


def sharded_render_pass(mesh: Mesh, max_depth: int,
                        estimator: str = "reference", fast_shade=True,
                        with_metrics: bool = False):
    """A pass (scene, camera, film, pixel_ids, seed, spp_index) -> the
    radiance of every pixel id [N, 3] on every rank of the ray axis, the
    pixel ids split over it and the scene replicated (sharded.py:48-62).
    `spp_index` is one int for the whole pass, as JAX's replicated spec
    takes it. `fast_shade` True renders each block on the gate's route,
    the kernels on the card (the port's render_sample); False asks for the
    general step on any admitted scene (the JAX default fast_shade=False,
    its XLA step). `with_metrics` returns (image, good_paths, lane_rays,
    lane_shadow_rays), every one per pixel id."""

    def render(scene, camera, film, pixel_ids, seed, spp_index):
        return render_rays(mesh, pixel_ids, with_metrics, lambda block:
                           render_sample(scene, camera, film, block, seed,
                                         spp_index, max_depth, estimator,
                                         general=not fast_shade,
                                         with_metrics=with_metrics))

    return render


def _float_fields(obj, prefix: str):
    """(dotted name, tensor) of every floating tensor field of a (nested)
    dataclass."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _float_fields(v, f"{prefix}{f.name}.")
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            yield f"{prefix}{f.name}", v


def float_leaves(scene: T.Scene) -> dict:
    """Every float leaf of the scene but its accelerator tables, by dotted
    name ("materials.color", "triangles.v0", "env.intensity", ...): the
    leaves a train step differentiates."""
    return {name: v for name, v in _float_fields(scene, "")
            if name.split(".")[0] not in _TABLES}


def replace_leaves(scene: T.Scene, leaves: dict) -> T.Scene:
    """The scene with the leaves of `leaves` (dotted name -> tensor) in
    place of its own."""
    groups: dict = {}
    for name, v in leaves.items():
        group, field = name.split(".")
        groups.setdefault(group, {})[field] = v
    return dataclasses.replace(scene, **{
        g: dataclasses.replace(getattr(scene, g), **fields)
        for g, fields in groups.items()})


def with_grad_leaves(scene: T.Scene):
    """(a copy of the scene whose float leaves are fresh leaf tensors that
    require grad, those leaves by name)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in float_leaves(scene).items()}
    return replace_leaves(scene, leaves), leaves


def mean_over(tensors, axis: Axis):
    """The mean of each tensor over the axis' ranks, through one
    all-reduce of a flat buffer (JAX's pmean: the sum over the axis
    divided by its size)."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=axis.group)
    flat = flat / axis.size
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def _grads(loss, leaves: dict):
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return [torch.zeros_like(v) if g is None else g
            for v, g in zip(leaves.values(), gs)]


def _mse(img, target):
    err = img - target
    return torch.mean(err * err)


def sharded_train_step(mesh: Mesh, max_depth: int):
    """The inverse-rendering step (sharded.py:74-103): a step (scene,
    camera, film, pixel_ids, seed, spp_index, target[N, 3]) -> (loss,
    grads), where loss is the physical-estimator MSE of each rank's block
    against its block of `target`, averaged over the ray ranks, and grads
    maps every `float_leaves` name to the gradient of the rank's loss,
    averaged over the ray ranks. Both are the same on every rank."""

    def step(scene, camera, film, pixel_ids, seed, spp_index, target):
        pixel_ids = torch.as_tensor(pixel_ids, device=mesh.device)
        scene_g, leaves = with_grad_leaves(scene)
        img = render_sample(scene_g, camera, film,
                            ray_block(pixel_ids, mesh.rays), seed, spp_index,
                            max_depth, estimator="physical")
        loss = _mse(img, ray_block(target, mesh.rays))
        loss_g = mean_over([loss, *_grads(loss, leaves)], mesh.rays)
        return loss_g[0], dict(zip(leaves, loss_g[1:]))

    return step
