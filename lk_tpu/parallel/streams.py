"""Stream data-parallelism: batch independent videos over the ``data`` axis.

Each stream's PipelineState and frame chunk shard on their leading axis;
there is no cross-stream communication, so XLA compiles the vmapped step
with zero collectives — scaling is linear in devices (SURVEY.md §2.5).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lk_tpu.config import PipelineConfig
from lk_tpu.pipeline.runner import make_chunk_runner


def shard_pipeline_step(
    mesh: Mesh,
    cfg: PipelineConfig,
    frame_size: Tuple[int, int],
    axis: str = "data",
):
    """Returns (run_batch, init_batch, shard_fn) for stream-sharded batches.

    run_batch(states, frames (B, T, H, W)) -> (states, outputs) with B
    sharded over ``axis``.
    """
    run_chunk, init_fn, _masks = make_chunk_runner(cfg, frame_size)
    vstep = jax.vmap(run_chunk)
    vinit = jax.vmap(init_fn)

    state_sh = NamedSharding(mesh, P(axis))
    frames_sh = NamedSharding(mesh, P(axis, None, None, None))

    def shard_frames(frames: jnp.ndarray) -> jnp.ndarray:
        return jax.device_put(frames, frames_sh)

    run_batch = jax.jit(
        vstep,
        in_shardings=(state_sh, frames_sh),
        out_shardings=(state_sh, state_sh),
    )
    init_batch = jax.jit(
        vinit,
        in_shardings=NamedSharding(mesh, P(axis, None, None)),
        out_shardings=state_sh,
    )
    return run_batch, init_batch, shard_frames
