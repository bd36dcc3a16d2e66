"""Tone mapping (counterpart of craytracer_tpu/utils/tonemap.py:9;
toneMap, shading.h:33-63): exponential exposure -2, then gamma 2.2."""

from __future__ import annotations

import torch


def tone_map(color, exposure: float = -2.0, gamma: float = 2.2):
    r = 1.0 - torch.exp(color * exposure)
    return torch.pow(torch.clamp(r, min=0.0), 1.0 / gamma)
