"""The check the general-route tests share: the port's `trace_paths`
through `_general_step` against the JAX package's XLA `trace_paths`
(fast_shade=False) on the same camera rays, 24x24 at 2 spp per lane
(1,152 lanes, seed 7), as tests/test_torch_pass_mesh.py makes them.

Bars: `good` equal on every lane, the ray and shadow-ray counts and the
per-bounce live histogram equal, L within 2e-5 (rtol and atol, the JAX
package's own bar between its branches, tests/test_pallas_shade.py
:57-67). XLA:CPU compiles JAX's fori_loop body and the same step
unrolled (trace_paths_logged) into different fusions, with different
multiply-adds contracted into FMAs, and on a few lanes the two JAX
programs differ by more than the bar themselves. Each test names those
lanes (`excused`, measured on an x86 CPU); on them the port is held to
the unrolled program at the same bar. With `mis=True` both sides trace
the MIS estimator (the JAX `trace_paths(..., mis=True)`), and the
unrolled program is `_make_bounce_step(..., mis=True)` stepped bounce by
bounce (`trace_paths_logged` takes no `mis`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from craytracer_tpu.camera import generate_rays as j_generate_rays
from craytracer_tpu.integrator.wavefront import _init_state as j_init_state
from craytracer_tpu.integrator.wavefront import _make_bounce_step
from craytracer_tpu.integrator.wavefront import trace_paths as j_trace
from craytracer_tpu.integrator.wavefront import trace_paths_logged
from craytracer_tpu.sampling.multijitter import stratified_jitter as j_strat
from craytracer_tpu_torch.integrator.wavefront import trace_paths

SIZE = 24
SEED = 7
BAR = dict(rtol=2e-5, atol=2e-5)


def jax_rays(jcam, jfilm):
    """(o, d, pix, spp) numpy: SIZE x SIZE pixels at spp 3 and 4."""
    jfilm = jfilm.replace(width=SIZE, height=SIZE)
    n = SIZE * SIZE
    pix = np.tile(np.arange(n, dtype=np.int32), 2)
    spp = np.repeat(np.arange(2, dtype=np.int32), n) + 3
    jo, jd = j_generate_rays(jcam, jfilm, jnp.asarray(pix),
                             j_strat(SEED, jnp.asarray(pix), jnp.asarray(spp)))
    return np.array(jo), np.array(jd), pix, spp


def _unrolled(js, o, d, pix, spp, depth, mis):
    """L of JAX's bounce step run bounce by bounce, outside the fori."""
    if not mis:
        return np.asarray(trace_paths_logged(
            js, jnp.asarray(o), jnp.asarray(d), SEED, jnp.asarray(pix),
            jnp.asarray(spp), depth)[0])
    step = _make_bounce_step(js, SEED, jnp.asarray(spp), depth, mis=True)
    state = j_init_state(jnp.asarray(o), jnp.asarray(d), depth,
                         jnp.asarray(pix))
    for bounce in range(depth + 1):
        state = step(bounce, state)[0]
    return np.asarray(state[3])


@functools.lru_cache(maxsize=None)
def jax_trace(depth, mis):
    """JAX's XLA trace_paths at `depth`, jitted with the scene as an
    argument: its tables are not folded into the program as constants,
    which compiles faster, and one jitted function serves every scene."""
    return jax.jit(lambda scene, o, d, pix, spp: j_trace(
        scene, o, d, SEED, pix, spp, depth, with_metrics=True,
        fast_shade=False, mis=mis))


def check_general(js, ts, rays, depth, excused=(), mis=False):
    """Hold the port's general trace_paths against the JAX XLA one."""
    o, d, pix, spp = rays
    ref = jax_trace(depth, mis)(js, *(jnp.asarray(x) for x in (o, d, pix,
                                                              spp)))
    L, good, m = trace_paths(ts, torch.from_numpy(o), torch.from_numpy(d),
                             SEED, torch.from_numpy(pix),
                             torch.from_numpy(spp), depth, with_metrics=True,
                             general=True, mis=mis)
    L, Lr = L.numpy(), np.asarray(ref[0])
    np.testing.assert_array_equal(good.numpy(), np.asarray(ref[1]))
    assert int(m["rays"]) == int(ref[2]["rays"])
    assert int(m["shadow_rays"]) == int(ref[2]["shadow_rays"])
    np.testing.assert_array_equal(m["bounce_live"].numpy(),
                                  np.asarray(ref[2]["bounce_live"]))
    keep = np.ones(L.shape[0], bool)
    keep[list(excused)] = False
    np.testing.assert_allclose(L[keep], Lr[keep], **BAR)
    if excused:
        unrolled = _unrolled(js, o, d, pix, spp, depth, mis)
        np.testing.assert_allclose(L[~keep], unrolled[~keep], **BAR)
    return L, m
