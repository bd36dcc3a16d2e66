"""Camera + film: batched primary-ray generation (counterpart of
craytracer_tpu/camera.py: `make_camera` :60, `make_camera_jax` :89 as
`make_camera_torch`, `film_dims` :110,
`generate_rays` :118 with its pinhole :127-144 and thin-lens :146-169
branches).

Conventions are the JAX package's (and the reference's): lookAt basis
z = -normalize(look - pos), x = normalize(up x z), y = z x x; film
length 2 sin(fov/2) focal_dist; image-plane x = -L/2 + px (col + jx),
y = H/2 - px (row + jy). The pinhole ray starts on the view plane and
points away from the focal point; the thin-lens ray starts on the lens
disk (polar warp of the lens samples, scaled by lens_radius) and aims at
the focal-plane point (calcRayThinLens, camera.cpp:94-127).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.sampling.mappings import map_to_disk_polar
from craytracer_tpu_torch.scene.types import to_device

PINHOLE = 0
THINLENS = 1


@dataclass(frozen=True)
class Camera:
    position: torch.Tensor  # [3]
    x_axis: torch.Tensor  # [3]
    y_axis: torch.Tensor  # [3]
    z_axis: torch.Tensor  # [3]
    focal_dist: torch.Tensor  # scalar; view-plane distance
    focal_length: torch.Tensor  # scalar; focal-plane distance (thin lens)
    lens_radius: torch.Tensor  # scalar
    camera_type: int = PINHOLE

    def to(self, device) -> "Camera":
        return to_device(self, device)


@dataclass(frozen=True)
class Film:
    fov: torch.Tensor  # scalar, radians
    width: int = 256
    height: int = 256

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def to(self, device) -> "Film":
        return to_device(self, device)


def make_camera(position, look_point, up=(0.0, 1.0, 0.0),
                focal_dist: float = 0.035, camera_type: int = PINHOLE,
                focal_length: float = 3.0, lens_radius: float = 0.2,
                device="cpu") -> Camera:
    """Host-side lookAt in numpy f32, exactly as camera.py:60-86."""
    position = np.asarray(position, np.float32)
    look = np.asarray(look_point, np.float32)
    up = np.asarray(up, np.float32)
    z = -(look - position)
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)

    def t(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    return Camera(position=t(position), x_axis=t(x), y_axis=t(y),
                  z_axis=t(z), focal_dist=t(focal_dist),
                  focal_length=t(focal_length), lens_radius=t(lens_radius),
                  camera_type=camera_type)


def make_camera_torch(position, look_point, up=(0.0, 1.0, 0.0),
                      focal_dist=0.035, camera_type: int = PINHOLE,
                      focal_length=3.0, lens_radius=0.2) -> Camera:
    """Differentiable lookAt in torch ops (make_camera_jax,
    camera.py:89-107): gradients flow from the basis into `position` and
    `look_point`, so the camera's position and orientation can be
    optimized. Tensor arguments keep their graph; the others become f32
    tensors on the device of the first tensor argument, else on the CPU.
    `make_camera` is the host-side numpy twin."""
    given = [v for v in (position, look_point, up, focal_dist,
                         focal_length, lens_radius)
             if isinstance(v, torch.Tensor)]
    dev = given[0].device if given else torch.device("cpu")

    def t(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    position, look, upv = t(position), t(look_point), t(up)
    z = vm.normalize(position - look)
    x = vm.normalize(vm.cross(upv, z))
    y = vm.cross(z, x)
    return Camera(position=position, x_axis=x, y_axis=y, z_axis=z,
                  focal_dist=t(focal_dist), focal_length=t(focal_length),
                  lens_radius=t(lens_radius), camera_type=camera_type)


def film_dims(film: Film, camera: Camera):
    """(frame_length, frame_height, pixel_length) f32 scalars —
    calcFilmDimension (camera.cpp:144-149)."""
    frame_length = 2.0 * torch.sin(film.fov / 2.0) * camera.focal_dist
    frame_height = frame_length * (film.height / film.width)
    pixel_length = frame_length / film.width
    return frame_length, frame_height, pixel_length


def generate_rays(camera: Camera, film: Film, pixel_ids, jitter,
                  lens_u=None):
    """Primary rays for `pixel_ids` ([N] int) with film jitter ([N, 2] in
    [0, 1)); a thin-lens camera also takes the lens samples `lens_u`
    ([N, 2]). Returns (origin[N,3], direction[N,3])."""
    if camera.camera_type not in (PINHOLE, THINLENS):
        raise ValueError(f"camera_type {camera.camera_type} is neither "
                         "PINHOLE nor THINLENS")
    frame_length, frame_height, pixel_length = film_dims(film, camera)
    pixel_ids = torch.as_tensor(pixel_ids)
    col = (pixel_ids % film.width).to(torch.float32)
    row = torch.div(pixel_ids, film.width, rounding_mode="floor"
                    ).to(torch.float32)
    ix = -frame_length / 2.0 + pixel_length * (col + jitter[..., 0])
    iy = frame_height / 2.0 - pixel_length * (row + jitter[..., 1])
    if camera.camera_type == PINHOLE:
        fd = -camera.focal_dist.expand(ix.shape)
        direction = vm.normalize(ix[..., None] * camera.x_axis
                                 + iy[..., None] * camera.y_axis
                                 + fd[..., None] * camera.z_axis)
        origin = (ix[..., None] * camera.x_axis
                  + iy[..., None] * camera.y_axis + camera.position)
        return origin, direction
    if lens_u is None:
        raise ValueError("a thin-lens camera needs the lens samples lens_u")
    disk = map_to_disk_polar(lens_u) * camera.lens_radius
    scale = camera.focal_length / camera.focal_dist
    fp = torch.stack([ix * scale, iy * scale,
                      -camera.focal_length.expand(ix.shape)], dim=-1)
    o_cam = torch.stack([disk[..., 0], disk[..., 1],
                         camera.focal_dist.expand(ix.shape)], dim=-1)
    d_cam = vm.normalize(fp - o_cam)
    direction = (d_cam[..., 0:1] * camera.x_axis
                 + d_cam[..., 1:2] * camera.y_axis
                 + d_cam[..., 2:3] * camera.z_axis)
    origin = (o_cam[..., 0:1] * camera.x_axis + o_cam[..., 1:2] * camera.y_axis
              + o_cam[..., 2:3] * camera.z_axis + camera.position)
    return origin, direction
