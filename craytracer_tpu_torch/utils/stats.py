"""Intersect diagnostics (counterpart of craytracer_tpu/utils/stats.py:
`intersect_stats` :17, `format_stats` :55): the batched form of the
reference's printed instrumentation, per-group intersection-test counts
(intersect.h:363-364, shapes/shapes.cpp:3-6, printed main.cpp:320,
331-332). A brute-force group costs n_rays x group_size tests; a bvh4
scene's triangles report the plain traversal's node visits per lane
(pops: mean, p99, max) and the slot tests they imply. Diagnostics only:
the pops come from the plain traversal (accel/bvh4.py
`bvh4_closest_hit_stats`) on any device, so K3 does not run here."""

from __future__ import annotations

import numpy as np

from craytracer_tpu_torch.ops.intersect import _GROUPS


def _group_size(scene, name: str) -> int:
    return int(getattr(scene, name).mat_id.shape[0])


def intersect_stats(scene, o, d) -> dict:
    """Per-group test counts for one ray batch, plus the BVH4 pop
    statistics when the scene's triangles use the bvh4 table."""
    n = o.shape[0]
    out: dict = {"rays": n, "groups": {}}
    for _, name, _, _ in _GROUPS:
        sz = _group_size(scene, name)
        if sz == 0:
            continue
        accelerated = ((name == "triangles" and scene.accel != "none")
                       or (name == "spheres" and scene.sph_bvh is not None))
        out["groups"][name] = {"prims": sz,
                               "tests": "accelerated" if accelerated
                               else n * sz}
    if scene.accel == "bvh4" and scene.tri_bvh is not None:
        from craytracer_tpu_torch.accel.bvh4 import (WIDTH,
                                                     bvh4_closest_hit_stats)

        _, _, pops = bvh4_closest_hit_stats(scene.tri_bvh, o, d)
        pops = pops.cpu().numpy()
        k_slots = WIDTH * scene.tri_bvh.leaf_size
        out["bvh4"] = {
            "nodes": int(scene.tri_bvh.fat.shape[0]),
            "pops_mean": float(pops.mean()),
            "pops_p99": float(np.percentile(pops, 99)),
            "pops_max": int(pops.max()),
            # every pop tests k_slots inline triangles
            "tri_tests": int(pops.sum()) * k_slots,
        }
    return out


def format_stats(stats: dict) -> str:
    """The reference-style printout (main.cpp:320,331-332)."""
    lines = [f"rays: {stats['rays']}"]
    for name, g in stats["groups"].items():
        lines.append(f"  {name:10s} prims {g['prims']:8d}  tests {g['tests']}")
    if "bvh4" in stats:
        b = stats["bvh4"]
        lines.append(
            f"  bvh4: {b['nodes']} nodes, pops mean {b['pops_mean']:.1f} "
            f"p99 {b['pops_p99']:.0f} max {b['pops_max']} "
            f"(tri tests {b['tri_tests']})")
    return "\n".join(lines)
