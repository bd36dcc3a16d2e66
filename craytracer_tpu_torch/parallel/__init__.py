"""Multi-rank rendering over torch.distributed (counterpart of
craytracer_tpu/parallel/): ray-sharded passes and train steps
(sharded.py), geometry sharding with a per-bounce hit reduction
(geom.py), per-bounce gradient buckets (overlap.py), and the dryrun that
starts the ranks (dryrun.py, `python -m
craytracer_tpu_torch.parallel.dryrun`)."""

from craytracer_tpu_torch.parallel.sharded import (  # noqa: F401
    make_geom_mesh,
    make_mesh,
    sharded_render_pass,
    sharded_train_step,
)
from craytracer_tpu_torch.parallel.geom import (  # noqa: F401
    geom_sharded_render_pass,
    geom_sharded_train_step,
    reduce_hit,
    shard_scene_geometry,
)
from craytracer_tpu_torch.parallel.overlap import (  # noqa: F401
    bucketed_train_step,
    trace_paths_bucketed,
)
