"""Per-pass render metrics (counterpart of
craytracer_tpu/utils/metrics.py: `PassMetrics` :19, `collect` :49): the
device counters of `trace_paths(..., with_metrics=True)` and the NaN
count turned into host numbers (rays/s, live lanes per bounce), the
structured form of the reference's printed counters (intersect.h:363-364,
main.cpp:70-86).

The port's metrics dict carries `rays` and `shadow_rays` as 0-d tensors,
the sums of its per-lane counters (integrator/wavefront.py `_trace`), and
`bounce_live` as a [depth + 1] tensor; `collect` reads them on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class PassMetrics:
    rays: int = 0
    shadow_rays: int = 0
    bounce_live: np.ndarray = None
    wall_s: float = 0.0
    nan_pixels: int = 0

    @property
    def total_rays(self) -> int:
        return self.rays + self.shadow_rays

    @property
    def rays_per_sec(self) -> float:
        return self.total_rays / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def occupancy(self) -> np.ndarray:
        """Live-lane fraction per bounce (the wavefront's divergence)."""
        bl = np.asarray(self.bounce_live, np.float64)
        return bl / max(bl[0], 1)

    def summary(self) -> str:
        occ = ", ".join(f"{x:.2f}" for x in self.occupancy)
        return (f"{self.rays_per_sec / 1e6:8.1f}M rays/s "
                f"({self.rays} closest + {self.shadow_rays} shadow in "
                f"{self.wall_s * 1e3:.1f}ms) occupancy/bounce [{occ}]"
                + (f" NaN={self.nan_pixels}" if self.nan_pixels else ""))


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def collect(metrics_dev, radiance, wall_s: float) -> PassMetrics:
    """The device counters and the count of lanes with a NaN in
    `radiance` ([N, 3], a tensor or an array) as host numbers."""
    nan_px = int(np.isnan(_host(radiance)).any(axis=-1).sum())
    return PassMetrics(
        rays=int(metrics_dev["rays"]),
        shadow_rays=int(metrics_dev["shadow_rays"]),
        bounce_live=_host(metrics_dev["bounce_live"]),
        wall_s=wall_s,
        nan_pixels=nan_px,
    )
