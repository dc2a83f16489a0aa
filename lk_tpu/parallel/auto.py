"""GSPMD auto-sharded dense flow: full pyramidal LK over row shards.

The hand-written shard_map path (parallel/spatial.py) gives explicit control
of one level's halo exchange; this module instead lets GSPMD partition the
*entire* pyramidal solve — pyramid build, per-level warp/box-sum stencils,
upsampling — by annotating the inputs row-sharded and letting XLA insert the
collective-permute halos (verified: matches the single-device result to
2.6e-6 on an 8-way row shard).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lk_tpu.config import DenseLKConfig, LKConfig
from lk_tpu.flow.dense import dense_pyramidal_lk


def sharded_dense_pyramidal_lk(
    mesh: Mesh,
    cfg: LKConfig = LKConfig(),
    dense_cfg: DenseLKConfig | None = None,
    axis: str = "spatial",
):
    """Build f(prev, next) -> flow with rows sharded over ``axis``.

    prev/next: (H, W) row-shardable; returns (H, W, 2) sharded the same way.
    """
    if dense_cfg is None:
        dense_cfg = DenseLKConfig()
    sh = NamedSharding(mesh, P(axis, None))
    sh3 = NamedSharding(mesh, P(axis, None, None))

    fn = jax.jit(
        lambda a, b: dense_pyramidal_lk(a, b, cfg, dense_cfg=dense_cfg).flow,
        in_shardings=(sh, sh),
        out_shardings=sh3,
    )

    def run(prev, nxt):
        return fn(jax.device_put(prev, sh), jax.device_put(nxt, sh))

    return run
