"""Table-driven samplers (counterpart of craytracer_tpu/sampling/tables.py:
`regular_table` :37, `hammersley_table` :58, `SampleTable` :74,
`make_sample_table` :89, `table_sample` :104): the reference's three 2-D
point-set kinds (genRegularSamples sampling.cpp:169-198,
genMultijitteredSamples :260-352, genHammersleySamples :326-352) in a
[num_sets, num_samples, 2] table built in numpy, bit-equal with the JAX
package's.

A pixel's set for a dimension is a stateless hash of (pixel, dim, seed),
the counter-RNG form of the reference's random_sets and
permutation_arrays (sampling.cpp:514-603):

    set_id = hash(pixel ^ seed * 0x9E3779B9 ^ dim * 0x85EBCA6B) % num_sets
    u2     = table[set_id, spp_index % num_samples]

`render_sample(..., sampler=table)` takes the film jitter from the table;
every other dimension keeps the counter RNG. The JAX package gathers the
row through `ops/gather.py take_rows`, a TPU workaround; plain indexing
replaces it here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from craytracer_tpu_torch.sampling.multijitter import multijittered_table
from craytracer_tpu_torch.sampling.rng import (GOLDEN, MASK32, as_u32,
                                               hash_u32)

KINDS = ("regular", "multijittered", "hammersley")


def regular_table(num_samples: int, num_sets: int) -> np.ndarray:
    """The n x n lattice of stratum centers, identical in every set."""
    n = int(np.sqrt(num_samples))
    if n * n != num_samples:
        raise ValueError("num_samples must be a perfect square")
    ij = (np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                   axis=-1).reshape(-1, 2) + 0.5) / n
    pts = ij[:, ::-1].astype(np.float32)  # x fast, y slow, as the loop
    return np.broadcast_to(pts, (num_sets, num_samples, 2)).copy()


def _radical_inverse_base2(i: np.ndarray) -> np.ndarray:
    bits = i.astype(np.uint32)
    bits = (bits << 16) | (bits >> 16)
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    return bits.astype(np.float64) * 2.0 ** -32


def hammersley_table(num_samples: int, num_sets: int,
                     shuffle_seed: int = 0) -> np.ndarray:
    """(i/N, phi2(i)) in an order shuffled per set (shuffleSamples): the
    same point set, a different walk per set."""
    i = np.arange(num_samples)
    pts = np.stack([i / num_samples, _radical_inverse_base2(i)],
                   axis=-1).astype(np.float32)
    rng = np.random.default_rng(shuffle_seed)
    out = np.empty((num_sets, num_samples, 2), np.float32)
    for s in range(num_sets):
        out[s] = pts[rng.permutation(num_samples)]
    return out


@dataclass
class SampleTable:
    """A sample-set table on a device."""

    points: torch.Tensor  # [num_sets, num_samples, 2] f32
    kind: str = "multijittered"

    @property
    def num_sets(self) -> int:
        return self.points.shape[0]

    @property
    def num_samples(self) -> int:
        return self.points.shape[1]


def make_sample_table(kind: str, num_samples: int, num_sets: int = 83,
                      seed: int = 0, device="cpu") -> SampleTable:
    """kind in KINDS, the reference's three generators, at its config's
    num_samples x num_sample_sets (config.h:37-40)."""
    if kind == "regular":
        pts = regular_table(num_samples, num_sets)
    elif kind == "multijittered":
        pts = multijittered_table(num_samples, num_sets, seed)
    elif kind == "hammersley":
        pts = hammersley_table(num_samples, num_sets, seed)
    else:
        raise ValueError(f"unknown sample-table kind {kind!r}")
    return SampleTable(points=torch.from_numpy(pts).to(device), kind=kind)


def table_sample(table: SampleTable, seed: int, pixel_ids, spp_index,
                 dim: int):
    """[N, 2] f32 table sample for (pixel, spp, dim); `spp_index` is an int
    or a per-lane [N] tensor."""
    pix = as_u32(pixel_ids)
    key = (((int(seed) * GOLDEN) & MASK32)
           ^ ((int(dim) * 0x85EBCA6B) & MASK32))
    set_id = hash_u32(pix ^ key) % table.num_sets
    spp = as_u32(torch.as_tensor(spp_index, device=pix.device))
    rows = set_id * table.num_samples + spp % table.num_samples
    return table.points.reshape(-1, 2)[rows]
