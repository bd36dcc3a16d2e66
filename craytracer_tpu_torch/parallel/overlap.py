"""Per-bounce gradient buckets reduced inside the backward pass
(counterpart of craytracer_tpu/parallel/overlap.py: `_pmean_grad` :33,
`_bucket_scene` :50, `trace_paths_bucketed` :62, `bucketed_train_step`
:77).

`sharded_train_step` all-reduces the gradients once, after the whole
backward pass. The bucketed step wraps every float leaf of the scene, once
per bounce of an unrolled wavefront, in an identity whose backward
all-reduces that bounce's gradient to its mean over the ray axis the
moment the bounce's backward segment produces it (the DDP bucket idea,
keyed to wavefront stages). The mean is linear, so the sum over bounces
of the means equals the mean of the sum up to the order of the float
additions: the same loss and gradients as `sharded_train_step`.

The backward runs the wrapped leaves' reductions in autograd's order,
which is the same on every rank: the graph's shape depends on the code
path only, never on a rank's data.
"""

from __future__ import annotations

import torch

from craytracer_tpu_torch.integrator.wavefront import (_general_step,
                                                       _init_state,
                                                       camera_rays)
from craytracer_tpu_torch.parallel.sharded import (Axis, Mesh, _grads, _mse,
                                                   all_reduce, float_leaves,
                                                   mean_over, ray_block,
                                                   replace_leaves,
                                                   with_grad_leaves)
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter


class _MeanGrad(torch.autograd.Function):
    """Identity whose cotangent is averaged over an axis' ranks."""

    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis) / ctx.axis.size, None


def _bucket_scene(scene, axis: Axis):
    """The scene with every float leaf (`float_leaves`) wrapped so its
    gradient is averaged over the axis inside the backward pass."""
    return replace_leaves(scene, {k: _MeanGrad.apply(v, axis)
                                  for k, v in float_leaves(scene).items()})


def trace_paths_bucketed(scene, origin, direction, seed: int, pixel_ids,
                         spp_index, max_depth: int, axis: Axis):
    """The unrolled general step (the JAX XLA step), bounce b reading a
    freshly wrapped scene: the backward pass averages each (leaf, bounce)
    gradient over `axis` as soon as bounce b's backward segment is done.
    Returns (L, good). The search goes through K3 and K4 for rays on the
    card."""
    state = _init_state(origin.contiguous(), direction.contiguous(),
                        max_depth, pixel_ids)
    kernels = origin.device.type == "cuda"
    for bounce in range(max_depth + 1):
        state = _general_step(_bucket_scene(scene, axis), seed, spp_index,
                              max_depth, bounce, state, kernels=kernels)
    return state[3], state[4]


def bucketed_train_step(mesh: Mesh, max_depth: int):
    """The per-bounce-bucketed twin of sharded_train_step (overlap.py
    :77-110): the same step signature, loss and gradients (up to the order
    of float additions), with the gradients' all-reduce issued per bounce
    inside the backward pass and the loss averaged once."""

    def step(scene, camera, film, pixel_ids, seed, spp_index, target):
        pixel_ids = torch.as_tensor(pixel_ids, device=mesh.device)
        block = ray_block(pixel_ids, mesh.rays)
        scene_g, leaves = with_grad_leaves(scene)
        o, d = camera_rays(camera, film, block, seed, spp_index,
                           stratified_jitter(seed, block, spp_index))
        L, _ = trace_paths_bucketed(scene_g, o, d, seed, block, spp_index,
                                    max_depth, mesh.rays)
        loss = _mse(L, ray_block(target, mesh.rays))
        grads = _grads(loss, leaves)
        return mean_over([loss], mesh.rays)[0], dict(zip(leaves, grads))

    return step
