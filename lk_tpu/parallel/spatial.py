"""Spatial (row-sharded) dense LK with halo exchange — the SP/CP analogue.

For frames too large for one device (or to cut per-frame latency), rows are
sharded over the ``spatial`` mesh axis; halos move between devices with
jax.lax.ppermute inside shard_map (SURVEY.md §2.5, §5.7).

Halo envelope (documented because it is the correctness contract):

* One iteration of a dense LK level at pixel p reads image data within
  ``win_h//2 + max_disp + 2`` rows (window + warp reach + bilinear/interp
  margin) and — through the coherence box sums ``box[gI*(D - gI.v)]``
  (flow.dense.dense_lk_level body) — the *flow* of neighbors within
  ``win_h//2`` rows.
* Flow values in the exchanged halo band are computed from edge-truncated
  data, so their error front propagates inward ``win_h//2`` rows per
  additional iteration.  A single exchange therefore needs
  ``halo = max_disp + win_h//2 + 4 + (n_iters - 1) * (win_h//2)``
  to keep every interior row exact for the full iteration count; the
  previous revision sized the halo for ONE iteration and was only safe
  because flow near seams stayed small.
* ``exchange_per_iter=True`` instead re-exchanges a one-iteration halo
  (``max_disp + win_h//2 + 4``) before every outer iteration — n_iters
  ppermute rounds instead of one, for (n_iters-1)*win_h//2 fewer halo rows
  of redundant compute.  The per-pixel eps early-stop (``active``) is
  carried ACROSS rounds and frozen pixels are masked outside the level
  call, reproducing the unsharded iteration sequence on interior rows
  (r5; the old per-round restart caused ~0.8 px scatter).  Residual
  deviation is a bounded ulp-flip population: the outside step test
  ``fl(f+du)-f`` can land on the other side of eps than ``du``, flipping
  a freeze decision for ~2e-4 of pixels (measured at 8-way 1080p:
  bulk p99 ~7e-6 px, isolated flips up to ~1 px on aliased texture —
  tests/test_parallel.py::test_spatial_per_iter_halo_production_geometry).

Both variants are pinned against the single-device level at the
displacement bound (flow == max_disp crossing a shard seam) in
tests/test_parallel.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from lk_tpu.config import DenseLKConfig, LKConfig
from lk_tpu.flow.dense import dense_lk_level


def halo_exchange(x: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """Pad a row-sharded block with `halo` rows from ring neighbors.

    x: (local_h, W).  Returns (local_h + 2*halo, W); at the outer edges the
    halo is edge-padding (replicating the reference's border handling).
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    top_rows = x[:halo]        # my top rows -> neighbor above wants them? no:
    bot_rows = x[-halo:]
    # neighbor above (idx-1) needs my top rows as its bottom halo; I need the
    # bottom rows of idx-1 as my top halo.
    up = [(i, (i - 1) % n) for i in range(n)]     # send to idx-1
    down = [(i, (i + 1) % n) for i in range(n)]   # send to idx+1
    from_below = jax.lax.ppermute(top_rows, axis_name, up)
    from_above = jax.lax.ppermute(bot_rows, axis_name, down)
    # edge shards: replicate own edge rows instead of wrapping around
    edge_top = jnp.repeat(x[:1], halo, axis=0)
    edge_bot = jnp.repeat(x[-1:], halo, axis=0)
    top_halo = jnp.where(idx == 0, edge_top, from_above)
    bot_halo = jnp.where(idx == n - 1, edge_bot, from_below)
    return jnp.concatenate([top_halo, x, bot_halo], axis=0)


def _iteration_halo(cfg: LKConfig, max_disp: int) -> int:
    """Rows one outer iteration can reach: window + warp + interp margin."""
    return max_disp + cfg.win_size[1] // 2 + 4


def spatial_dense_lk_level(
    mesh: Mesh,
    cfg: LKConfig = LKConfig(),
    dense_cfg: DenseLKConfig = DenseLKConfig(),
    max_disp: int = 8,
    axis_name: str = "spatial",
    exchange_per_iter: bool = True,
):
    """Build a row-sharded dense LK level: (H, W) sharded on rows -> flow.

    Returns f(prev, next, flow_init) with all arrays sharded
    P(axis_name, None) on rows; flow_init (H, W, 2) sharded the same.
    Interior rows match the single-device level for |flow| <= max_disp
    (see the module docstring for the halo envelope).

    Default: per-iter exchange.  At 8-way 1080p (6 iters, win 15, disp 8)
    the single exchange's wide halo is 108 redundant rows on a 135-row
    shard (80% extra compute), while per-iter exchange adds 5 rounds of
    ~0.58 MB of flow halo per level.  Numerics: the eps
    early-stop mask is carried across exchange rounds (see module
    docstring), so per-iter matches the unsharded program except for a
    ~2e-4 population of eps-threshold ulp flips; single-exchange
    (False) is bitwise-faithful to the unsharded sequence at the cost
    of the redundant halo compute."""
    win_h = cfg.win_size[1]
    base = _iteration_halo(cfg, max_disp)
    n_iters = dense_cfg.outer_iters

    def run_level(prev_h, next_h, flow_h, halo, dcfg):
        res = dense_lk_level(prev_h, next_h, flow_h, cfg, dcfg,
                             max_disp=max_disp)
        return res.flow[halo:-halo]

    if exchange_per_iter:
        one_iter = dataclasses.replace(dense_cfg, outer_iters=1,
                                       iter_schedule=())
        # The XLA level body has a per-pixel eps early-stop; chopping the
        # loop into 1-iteration calls would restart it each round (the old
        # behavior — scattered ~0.8 px deviations vs the unsharded
        # program).  Carrying the converged mask ACROSS rounds and freezing
        # masked pixels outside the call reproduces the unsharded sequence
        # exactly on interior rows: the box sums read start-of-round flow,
        # so a frozen pixel feeds its neighbors the same value the
        # unsharded iteration would.
        eps2 = jnp.float32(cfg.eps * cfg.eps)

        def local_fn(prev, nxt, flow):
            # frames don't change across iterations: exchange them once,
            # only the evolving flow re-exchanges inside the loop
            prev_h = halo_exchange(prev, base, axis_name)
            next_h = halo_exchange(nxt, base, axis_name)

            def body(_, carry):
                f, active = carry
                fx = halo_exchange(f[..., 0], base, axis_name)
                fy = halo_exchange(f[..., 1], base, axis_name)
                f_new = run_level(prev_h, next_h,
                                  jnp.stack([fx, fy], axis=-1),
                                  base, one_iter)
                delta = f_new - f
                f_kept = jnp.where(active[..., None], f_new, f)
                active = active & (
                    jnp.sum(delta * delta, axis=-1) > eps2)
                return f_kept, active

            # derive from flow (not a fresh constant) so the carry stays
            # axis-varying under shard_map (cf. flow/dense.py active0)
            active0 = jnp.sum(flow * flow, axis=-1) >= -1.0
            f, _ = jax.lax.fori_loop(0, n_iters, body, (flow, active0))
            return f
    else:
        # single exchange sized for the full iteration count: the flow
        # coupling in the box sums moves the halo's stale front inward
        # win_h//2 rows per iteration after the first
        halo = base + (n_iters - 1) * (win_h // 2)

        def local_fn(prev, nxt, flow):
            prev_h = halo_exchange(prev, halo, axis_name)
            next_h = halo_exchange(nxt, halo, axis_name)
            fx = halo_exchange(flow[..., 0], halo, axis_name)
            fy = halo_exchange(flow[..., 1], halo, axis_name)
            flow_h = jnp.stack([fx, fy], axis=-1)
            return run_level(prev_h, next_h, flow_h, halo, dense_cfg)

    spec = P(axis_name, None)
    spec3 = P(axis_name, None, None)
    return shard_map(
        local_fn, mesh=mesh,
        in_specs=(spec, spec, spec3),
        out_specs=spec3,
    )
