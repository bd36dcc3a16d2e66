"""Inverse rendering: gradient-based recovery of scene parameters
through the differentiable wavefront tracer (counterpart of
craytracer_tpu/inverse.py: `InverseConfig` :36, `_make_optimizer` :68,
`InverseRenderer` :79 with `step` :125, `run` :153, `save_state` :163
and `load_state` :172).

- The caller owns the parameterization: `params0` is a tensor or a
  (nested) dict, list or tuple of tensors, and `apply_fn(scene, params)
  -> scene` grafts it into the scene out of place (dataclasses.replace,
  torch.where, torch.cat, index_put), as `.at[].set` does.
- Each step renders `spp_per_step` stratified passes through
  `render_sample` under autograd, so the gate takes the general step (K3
  and K4 still search on the card, detached); spp_index cycles over
  `spp_cycle`, so successive steps see different sample sets.
- The optimizers are optax.adam's update as a torch.optim.Optimizer
  (`OptaxAdam`: b1 0.9, b2 0.999, eps 1e-8, its bias corrections
  computed in f32 as optax computes them, where torch.optim.Adam takes
  them in f64: 1 - 0.999 in f32 is 1.3e-5 off 0.001, and the runs part
  by that much a step) and torch.optim.SGD (optax.sgd: p - lr g).
  `decay_steps` gives optax's cosine decay, lr * 0.5 * (1 + cos(pi *
  min(k, T) / T)), where k counts the updates taken: a skipped step
  advances neither the optimizer nor the schedule.
- A step whose loss or global gradient norm is not finite is skipped and
  counted in `nan_steps`; `clip_fn` runs after each update, without
  autograd.
- `save_state` / `load_state` keep params, optimizer state, update
  count, step, seed and history (torch.save), so a resumed run continues
  bit for bit. On the card that needs deterministic accumulation in the
  backward pass (the gathers' gradients are sums over lanes): each
  gradient runs under `deterministic()`. A scene with an env light
  rotates directions by a matmul, which cuBLAS keeps bit-exact only with
  CUBLAS_WORKSPACE_CONFIG set before the process's first cuBLAS call:
  set it at start-up (the demo's main does) where such a scene is
  optimized on the card.
"""

from __future__ import annotations

import contextlib
import math
import os
import warnings
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from craytracer_tpu_torch.integrator.wavefront import render_sample


@dataclass(frozen=True)
class InverseConfig:
    learning_rate: float = 0.05
    max_depth: int = 2
    estimator: str = "physical"
    spp_cycle: int = 4  # spp_index cycles 0..spp_cycle-1
    # samples averaged per gradient step: the MSE against a noisy render
    # is biased low by the estimator's variance, which the average cuts
    spp_per_step: int = 4
    optimizer: str = "adam"  # adam | sgd
    # cosine-decay the learning rate to 0 over this many updates (0: a
    # constant rate)
    decay_steps: int = 0
    # "mse", or "log1p": the MSE in log1p space, which tames the heavy
    # tails of Monte-Carlo renders of sharp glossy lobes
    loss: str = "mse"


class OptaxAdam(torch.optim.Optimizer):
    """optax.adam(lr, b1, b2, eps) (optax scale_by_adam, then the rate):
    mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, count += 1,
    p += -lr (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps),
    every term in the parameter's dtype (f32)."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self):
        f32 = torch.float32
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=f32)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                g = p.grad
                st["step"] += 1
                mu = st["exp_avg"].mul_(b1).add_(g, alpha=1.0 - b1)
                nu = st["exp_avg_sq"].mul_(b2).addcmul_(g, g,
                                                        value=1.0 - b2)
                # 1 - b^count in f32, on the host
                count = torch.tensor(float(st["step"]), dtype=f32)
                bc1, bc2 = (float(1.0 - torch.pow(torch.tensor(b, dtype=f32),
                                                  count)) for b in (b1, b2))
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + group["eps"])
                p.add_(u * (-group["lr"]))


def _flatten(tree):
    """A tensor or (nested) dict / list / tuple of tensors -> (leaves,
    rebuild), dict keys in sorted order as JAX's pytrees order them."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(x) for x in tree]
    else:
        raise TypeError(f"params leaves must be tensors, not {type(tree)}")
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, rb), n in zip(parts, sizes):
            out.append(rb(leaves[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return [x for p in parts for x in p[0]], rebuild


def cosine_decay(learning_rate: float, decay_steps: int, count: int):
    """optax.cosine_decay_schedule(learning_rate, decay_steps) at
    `count`."""
    k = min(count, decay_steps)
    return learning_rate * 0.5 * (1.0 + math.cos(math.pi * k / decay_steps))


def image_loss(img, target, kind: str):
    """"mse": mean((img - target)^2); "log1p": the same of log1p(img)
    and log1p(target)."""
    if kind == "log1p":
        img, target = torch.log1p(img), torch.log1p(target)
    elif kind != "mse":
        raise ValueError(f"unknown loss {kind!r}")
    diff = img - target
    return torch.mean(diff * diff)


def render_mean(scene, camera, film, pixel_ids, seed: int, spp_index: int,
                config: InverseConfig, kernels=None):
    """The mean of `spp_per_step` passes of render_sample, spp indices
    spp_index * spp_per_step + k."""
    img = 0.0
    for k in range(config.spp_per_step):
        img = img + render_sample(
            scene, camera, film, pixel_ids, seed,
            spp_index * config.spp_per_step + k, config.max_depth,
            estimator=config.estimator, kernels=kernels)
    return img / config.spp_per_step


CUBLAS_CONFIG = ":4096:8"  # cuBLAS's deterministic workspace setting


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms inside the block; it, and
    CUBLAS_WORKSPACE_CONFIG, restored on exit. Torch refuses a cuBLAS
    matmul under deterministic algorithms unless that variable is set, so
    it is set to CUBLAS_CONFIG when unset; but cuBLAS sizes its workspace
    at the process's first cuBLAS call, so only a variable set before
    then makes the matmul deterministic (module docstring), and a warning
    says so when CUDA had started before the block. The outputs of every
    kernel are written in full, so uninitialized memory is not filled."""
    from torch.utils import deterministic as det

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory)
    prev_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if prev_env is None:
        if torch.cuda.is_initialized():
            warnings.warn("CUBLAS_WORKSPACE_CONFIG is set only after CUDA "
                          "started: a cuBLAS matmul (an env light's "
                          "rotation) may not be bit-exact; set it at "
                          "start-up", stacklevel=3)
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_CONFIG
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]
        if prev_env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]


class InverseRenderer:
    """Optimize `params` so the rendered image matches `target`.

    >>> inv = InverseRenderer(scene, cam, film, target, params0, apply_fn)
    >>> for _ in range(100):
    ...     loss, gnorm = inv.step()
    >>> inv.save_state("ckpt.pt")          # later:
    >>> inv2 = InverseRenderer(...); inv2.load_state("ckpt.pt")

    `params` holds the optimized tensors (leaves that require grad) in
    the shape of `params0`; `kernels=False` runs the plain versions of
    the search on the card as well (render_sample's `kernels`)."""

    def __init__(self, scene, cam, film, target, params0,
                 apply_fn: Callable, config: Optional[InverseConfig] = None,
                 seed: int = 7, clip_fn: Optional[Callable] = None,
                 kernels=None):
        self.config = cfg = config or InverseConfig()
        self.scene, self.cam, self.film = scene, cam, film
        self.device = scene.device
        leaves, self._rebuild = _flatten(params0)
        self._leaves = [x.detach().to(self.device, copy=True)
                        .requires_grad_(True) for x in leaves]
        self.params = self._rebuild(self._leaves)
        if cfg.optimizer == "adam":
            self.opt = OptaxAdam(self._leaves, lr=cfg.learning_rate)
        elif cfg.optimizer == "sgd":
            self.opt = torch.optim.SGD(self._leaves, lr=cfg.learning_rate)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.updates = 0  # optimizer updates taken (the schedule's count)
        self.step_idx = 0
        self.seed = seed
        self.nan_steps = 0  # skipped non-finite steps
        self.history: list = []  # (loss, grad_norm) per step
        self._apply_fn = apply_fn
        self._clip_fn = clip_fn
        self.kernels = kernels
        self.target = torch.as_tensor(target, device=self.device)
        self.pixel_ids = torch.arange(film.num_pixels, dtype=torch.int32,
                                      device=self.device)

    def loss(self, params, spp_index: int):
        """The loss of `params` on the passes of `spp_index`."""
        img = render_mean(self._apply_fn(self.scene, params), self.cam,
                          self.film, self.pixel_ids, self.seed, spp_index,
                          self.config, self.kernels)
        return image_loss(img, self.target, self.config.loss)

    def value_and_grad(self):
        """(loss, [gradient per leaf]) at the current params, on this
        step's passes; nothing is updated."""
        spp = self.step_idx % self.config.spp_cycle
        for p in self._leaves:
            p.grad = None
        with deterministic():
            loss = self.loss(self.params, spp)
            loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self._leaves]
        return loss.detach(), grads

    def step(self):
        """One optimization step; returns (loss, global_grad_norm). A
        non-finite loss or gradient skips the update (counted in
        nan_steps): one bad Monte-Carlo step must not poison the
        parameters or the optimizer's moments."""
        loss, grads = self.value_and_grad()
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        rec = (float(loss), float(gnorm))
        if not (math.isfinite(rec[0]) and math.isfinite(rec[1])):
            self.nan_steps += 1
        else:
            if self.config.decay_steps:
                for group in self.opt.param_groups:
                    group["lr"] = cosine_decay(self.config.learning_rate,
                                               self.config.decay_steps,
                                               self.updates)
            self.opt.step()
            self.updates += 1
            if self._clip_fn is not None:
                with torch.no_grad():
                    clipped, _ = _flatten(self._clip_fn(self.params))
                    for p, c in zip(self._leaves, clipped):
                        p.copy_(c)
        for p in self._leaves:
            p.grad = None
        self.step_idx += 1
        self.history.append(rec)
        return rec

    def run(self, n_steps: int, log_every: int = 0):
        for i in range(n_steps):
            loss, gnorm = self.step()
            if log_every and (i % log_every == 0):
                print(f"step {self.step_idx:5d}  loss {loss:.6g}  "
                      f"|grad| {gnorm:.6g}")
        return self.params

    # -- checkpoint / resume ------------------------------------------------

    def save_state(self, path: str):
        """Persist params, optimizer state, update count, step, seed and
        history."""
        torch.save({"params": [p.detach().cpu() for p in self._leaves],
                    "optimizer": self.opt.state_dict(),
                    "updates": self.updates, "step_idx": self.step_idx,
                    "seed": self.seed, "history": self.history}, path)

    def load_state(self, path: str):
        st = torch.load(path, map_location=self.device)
        if st["seed"] != self.seed:
            raise ValueError(
                f"checkpoint was created with seed {st['seed']}, renderer "
                f"uses {self.seed}: resuming would mix RNG streams")
        with torch.no_grad():
            for p, v in zip(self._leaves, st["params"]):
                p.copy_(v)
        self.opt.load_state_dict(st["optimizer"])
        self.updates = st["updates"]
        self.step_idx = st["step_idx"]
        self.history = [tuple(h) for h in st["history"]]
        return self
