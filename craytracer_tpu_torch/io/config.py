"""config.txt parsing (counterpart of craytracer_tpu/io/config.py:8-44,
parseConfigFile, config.h:10-103): one "key value" pair per line; a line
whose first word starts with "#", or with fewer than two words, is
skipped; an unknown key is ignored."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ConfigParams:
    scene_file: str = "cornell_box.txt"
    num_samples: int = 1
    num_sample_sets: int = 83
    max_depth: int = 1
    trace_type: str = "PATHTRACE"  # RAYCAST | WHITTED | PATHTRACE
    accel_struct: str = "GRID"  # BVH | BVH4 | GRID | NONE
    image_save: bool = False
    caustic_map: bool = False


_YES = ("yes", "true", "1")


def parse_config(path: str) -> ConfigParams:
    cfg = ConfigParams()
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2 or parts[0].startswith("#"):
                continue
            key, val = parts[0], parts[1]
            if key in ("scene_file", "trace_type", "accel_struct"):
                setattr(cfg, key, val)
            elif key in ("num_samples", "num_sample_sets", "max_depth"):
                setattr(cfg, key, int(val))
            elif key in ("image_save", "caustic_map"):
                setattr(cfg, key, val.lower() in _YES)
    return cfg
