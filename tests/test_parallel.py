"""Multi-device sharding on the fake 8-device CPU mesh (conftest sets it up)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lk_tpu.config import DenseLKConfig, LKConfig, PipelineConfig
from lk_tpu.flow.dense import dense_lk_level
from lk_tpu.parallel import (
    halo_exchange,
    make_mesh,
    shard_pipeline_step,
    spatial_dense_lk_level,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, jax.devices()
    return make_mesh()  # (data=4, spatial=2)


def test_mesh_shape(mesh):
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("data", "spatial")


def test_spatial_dense_lk_matches_single_device(mesh, rng):
    import cv2 as cv

    h, w = 128, 256
    img = (rng.random((h, w)) * 255).astype(np.float32)
    img = cv.GaussianBlur(img, (0, 0), 2.0)
    m = np.float32([[1, 0, 2.0], [0, 1, 1.0]])
    nxt = cv.warpAffine(img, m, (w, h), flags=cv.INTER_LINEAR,
                        borderMode=cv.BORDER_REFLECT_101)
    flow0 = jnp.zeros((h, w, 2), jnp.float32)

    single = dense_lk_level(jnp.asarray(img), jnp.asarray(nxt), flow0,
                            LKConfig(), DenseLKConfig(), max_disp=8).flow

    # spatial mesh axis only: reshape mesh so rows shard over 2 devices
    fn = spatial_dense_lk_level(mesh, LKConfig(), DenseLKConfig(), max_disp=8)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh2 = NamedSharding(mesh, P("spatial", None))
    sh3 = NamedSharding(mesh, P("spatial", None, None))
    prev_s = jax.device_put(jnp.asarray(img), sh2)
    next_s = jax.device_put(jnp.asarray(nxt), sh2)
    flow_s = jax.device_put(flow0, sh3)
    sharded = jax.jit(fn)(prev_s, next_s, flow_s)

    a = np.asarray(single)[12:-12, 12:-12]
    b = np.asarray(sharded)[12:-12, 12:-12]
    # interiors agree; the shard seam sees halo-truncated windows only beyond
    # the exchanged halo, which covers the full stencil
    np.testing.assert_allclose(a, b, atol=5e-2)


def test_halo_exchange_values(mesh):
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = jnp.arange(16.0 * 4).reshape(16, 4)

    def f(blk):
        return halo_exchange(blk, 2, "spatial")

    out = shard_map(
        f, mesh=mesh, in_specs=P("spatial", None),
        out_specs=P("spatial", None),
    )(x)
    out = np.asarray(out)  # (2 shards * (8 + 4) rows, 4)
    # shard 0: rows 0..7 with top halo = replicated row 0
    np.testing.assert_array_equal(out[0], out[1])  # replicated edge
    np.testing.assert_array_equal(out[2], np.asarray(x[0]))
    # shard 0 bottom halo = shard 1 top rows
    np.testing.assert_array_equal(out[10:12], np.asarray(x[8:10]))


def test_stream_sharded_pipeline_runs(mesh):
    """16 concurrent streams of the full VP pipeline sharded over the data
    axis (BASELINE.json config #5's shape, at test-friendly frame size)."""
    cfg = PipelineConfig()
    w, h = 256, 144
    run_batch, init_batch, shard_frames = shard_pipeline_step(
        mesh, cfg, (w, h)
    )
    b, t = 16, 3
    rng = np.random.default_rng(0)
    frames = (rng.random((b, t + 1, h, w)) * 255).astype(np.float32)
    first = jnp.asarray(frames[:, 0])
    states = init_batch(first)
    states, outs = run_batch(states, jnp.asarray(frames[:, 1:]))
    assert outs.show_mask.shape == (b, t)
    assert outs.motion_fracs.shape == (b, t, 4)
    assert states.prev_gray.shape == (b, h, w)


def test_gspmd_auto_sharded_pyramidal(mesh, rng):
    """Full pyramidal dense LK auto-partitioned by GSPMD over row shards
    matches the single-device result (XLA inserts the halo collectives)."""
    import cv2 as cv

    from lk_tpu.flow.dense import dense_pyramidal_lk
    from lk_tpu.parallel import make_mesh as mk, sharded_dense_pyramidal_lk

    m8 = mk(shape=(1, 8), axis_names=("data", "spatial"))
    h, w = 256, 384
    img = (rng.random((h, w)) * 255).astype(np.float32)
    img = cv.GaussianBlur(img, (0, 0), 2.0)
    aff = np.float32([[1, 0, 3.0], [0, 1, 2.0]])
    nxt = cv.warpAffine(img, aff, (w, h), flags=cv.INTER_LINEAR,
                        borderMode=cv.BORDER_REFLECT_101)
    run = sharded_dense_pyramidal_lk(m8)
    flow = np.asarray(run(jnp.asarray(img), jnp.asarray(nxt)))
    ref = np.asarray(
        dense_pyramidal_lk(jnp.asarray(img), jnp.asarray(nxt)).flow
    )
    np.testing.assert_allclose(flow, ref, atol=5e-3)  # fp reduction-order noise


def test_mesh_sharded_serving_matches_single_device():
    """The PRODUCTION batched serving path (feed_staged -> step_batched:
    fold carry, frame-band tracking, compacted outputs) sharded over an
    8-device 'streams' mesh == the single-device run, per stream.  This is
    the serving program the device actually runs (pipeline/step.py
    step_batched), not the vmap(step) of shard_pipeline_step."""
    import dataclasses

    import cv2 as cv
    from jax.sharding import Mesh

    from lk_tpu.io.video import SyntheticRoadStream
    from lk_tpu.pipeline.runner import MultiStreamPipeline

    cfg = dataclasses.replace(PipelineConfig(), width=256, out_cap=48)
    w, h = 256, 144
    b, f, chunk = 16, 17, 8
    u8 = np.empty((f, b, h, w), np.uint8)
    for k in range(b):
        s = SyntheticRoadStream(width=w, height=h, zoom=1.03 + 0.002 * k,
                                seed=100 + k, n_frames=f,
                                vp=(90 + 5 * k, 60 + (k % 3) * 8))
        for t in range(f):
            u8[t, k] = cv.cvtColor(s.frame(t), cv.COLOR_BGR2GRAY)

    smesh = Mesh(np.asarray(jax.devices()), ("streams",))
    kw = dict(src_size=(w, h), n_streams=b, chunk=chunk)
    single = MultiStreamPipeline(cfg, **kw)
    sharded = MultiStreamPipeline(cfg, mesh=smesh, **kw)

    stage_1 = jnp.asarray(u8)
    stage_8 = jax.device_put(u8, sharded.staging_sharding)
    assert sharded.staging_sharding.is_fully_addressable
    t = 0
    while t < f:
        n = min(chunk + (1 if single.states is None else 0), f - t)
        single.feed_staged(stage_1, t, n)
        sharded.feed_staged(stage_8, t, n)
        t += n
    single.drain()
    sharded.drain()

    # states stay sharded on the stream axis between feeds
    leaf = jax.tree_util.tree_leaves(sharded.states)[0]
    assert len(leaf.sharding.device_set) == 8

    for p, q in zip(sharded.pipes, single.pipes):
        assert p.frames_done == q.frames_done == f - 1
        assert len(p.csv_rows) == len(q.csv_rows)
        if p.csv_rows:
            np.testing.assert_allclose(
                np.array(p.csv_rows, np.float64),
                np.array(q.csv_rows, np.float64), atol=1e-4)
        assert len(p.cross_points) == len(q.cross_points)
        for u, v in zip(p.vp_per_frame, q.vp_per_frame):
            if v is None:
                assert u is None
            else:
                assert u == pytest.approx(v, abs=1e-4)


def test_spatial_seam_at_displacement_bound(mesh, rng):
    """Flow at the max_disp bound CROSSING the shard seam: the halo envelope
    must cover every outer iteration, not just the first (the coherence box
    sums couple neighbor flows win//2 rows per iteration — see
    parallel/spatial.py module docstring)."""
    import cv2 as cv

    h, w = 128, 256  # 2 row shards of 64 -> seam at row 64
    img = (rng.random((h, w)) * 255).astype(np.float32)
    img = cv.GaussianBlur(img, (0, 0), 4.0)
    dy = 7.5  # just under max_disp=8, uniform over the seam
    m = np.float32([[1, 0, 0.0], [0, 1, dy]])
    nxt = cv.warpAffine(img, m, (w, h), flags=cv.INTER_LINEAR,
                        borderMode=cv.BORDER_REFLECT_101)
    # coarse-level init 1.5 px from truth (the pyramid handoff regime)
    flow0 = jnp.tile(jnp.asarray([0.0, 6.0], jnp.float32), (h, w, 1))

    single = dense_lk_level(jnp.asarray(img), jnp.asarray(nxt), flow0,
                            LKConfig(), DenseLKConfig(), max_disp=8).flow
    sgl = np.asarray(single)
    # the scenario is real: converged flow ~= the bound, including at seam
    assert abs(sgl[48:80, 32:-32, 1].mean() - dy) < 0.3

    from jax.sharding import NamedSharding, PartitionSpec as P

    sh2 = NamedSharding(mesh, P("spatial", None))
    sh3 = NamedSharding(mesh, P("spatial", None, None))
    prev_s = jax.device_put(jnp.asarray(img), sh2)
    next_s = jax.device_put(jnp.asarray(nxt), sh2)
    flow_s = jax.device_put(flow0, sh3)

    # per-iter exchange carries the eps early-stop mask across rounds
    # (parallel/spatial.py), so both variants reproduce the unsharded
    # iteration sequence on interior rows to fp noise
    for per_iter, atol in ((False, 1e-2), (True, 1e-2)):
        fn = spatial_dense_lk_level(
            mesh, LKConfig(), DenseLKConfig(), max_disp=8,
            exchange_per_iter=per_iter)
        sharded = np.asarray(jax.jit(fn)(prev_s, next_s, flow_s))
        # interior rows (window-truncation belts at the outer frame edges
        # excluded); the seam rows 48..80 are all interior here
        np.testing.assert_allclose(
            sgl[16:-16, 16:-16], sharded[16:-16, 16:-16],
            atol=atol, err_msg=f"exchange_per_iter={per_iter}")


def test_spatial_per_iter_halo_production_geometry(mesh, rng):
    """Full-production-geometry gate for the shipped per-iteration halo
    default (VERDICT r4 weak #3), 8-way at 1080p, split into the two
    claims it actually makes:

    1. SHARDING is exact: the row-sharded per-iteration program matches an
       unsharded driver with identical per-round eps semantics to fp noise
       on interior rows (the halo covers the one-iteration stencil and the
       carried eps mask is pure per-pixel state).
    2. The eps-mask carry matches the true unsharded 6-iteration program
       statistically: the sequences are identical except where the
       outside-the-call step test fl(f+du)-f lands on the other side of
       eps than du itself (ulp-scale flips); measured 388 of 1.8M interior
       pixels > 0.05 px on this scene, bulk exact (p99 ~7e-6).
    """
    import dataclasses

    import cv2 as cv
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    h, w = 1080, 1920
    img = (rng.random((h, w)) * 255).astype(np.float32)
    img = cv.GaussianBlur(img, (0, 0), 3.0)
    # production-regime motion: mild zoom + rotation + shift, flow varying
    # smoothly across every shard seam (the eps stop fires at different
    # iterations per pixel — the regime that produced the old ~0.8 px
    # eps-restart scatter)
    m = cv.getRotationMatrix2D((w / 2.0, h / 2.0), 0.4, 1.004)
    m[:, 2] += (2.0, -1.5)
    nxt = cv.warpAffine(img, m, (w, h), flags=cv.INTER_LINEAR,
                        borderMode=cv.BORDER_REFLECT_101)
    flow0 = jnp.zeros((h, w, 2), jnp.float32)

    cfg, dcfg = LKConfig(), DenseLKConfig()  # outer_iters=6, XLA path
    single = np.asarray(dense_lk_level(
        jnp.asarray(img), jnp.asarray(nxt), flow0, cfg, dcfg,
        max_disp=8).flow)

    # unsharded driver with the per-round eps-carry semantics of
    # parallel/spatial.py (1-iteration calls, mask applied outside)
    one_iter = dataclasses.replace(dcfg, outer_iters=1, iter_schedule=())
    eps2 = np.float32(cfg.eps * cfg.eps)

    @jax.jit
    def ref_per_round(prev, nxt_, f0):
        def body(_, carry):
            f, active = carry
            f_new = dense_lk_level(prev, nxt_, f, cfg, one_iter,
                                   max_disp=8).flow
            delta = f_new - f
            f_kept = jnp.where(active[..., None], f_new, f)
            active = active & (jnp.sum(delta * delta, axis=-1) > eps2)
            return f_kept, active

        active0 = jnp.sum(f0 * f0, axis=-1) >= -1.0
        f, _ = jax.lax.fori_loop(0, dcfg.outer_iters, body, (f0, active0))
        return f

    ref = np.asarray(ref_per_round(jnp.asarray(img), jnp.asarray(nxt),
                                   flow0))

    mesh8 = Mesh(np.asarray(jax.devices()).reshape(8), ("spatial",))
    fn = spatial_dense_lk_level(mesh8, cfg, dcfg, max_disp=8,
                                exchange_per_iter=True)
    sh2 = NamedSharding(mesh8, P("spatial", None))
    sh3 = NamedSharding(mesh8, P("spatial", None, None))
    sharded = np.asarray(jax.jit(fn)(
        jax.device_put(jnp.asarray(img), sh2),
        jax.device_put(jnp.asarray(nxt), sh2),
        jax.device_put(flow0, sh3)))

    # Claim 1 — sharding exact vs the same-semantics driver.  Interior
    # rows only: at the TOP/BOTTOM frame edges the sharded program pads
    # replicated halo rows where the unsharded box sums see the zero
    # border, and that belt propagates inward win//2 rows per iteration.
    belt = 8 * (cfg.win_size[1] // 2 + 4)
    d1 = np.linalg.norm((ref - sharded)[belt:-belt, 16:-16], axis=-1)
    # bulk exact; block-vs-full-frame compilation differs in last-ulp
    # box-sum rounding, which can flip an eps-freeze decision — each flip
    # is worth ~one eps-sized step (measured max 0.046 = 1.5 steps)
    assert d1.mean() < 1e-4, d1.mean()
    assert (d1 > 0.01).mean() < 1e-4, (d1 > 0.01).mean()
    assert d1.max() < 0.15, d1.max()

    # Claim 2 — eps-carry semantics vs the true unsharded program:
    # bulk-exact with a bounded ulp-flip population
    d2 = np.linalg.norm((single - ref)[belt:-belt, 16:-16], axis=-1)
    assert d2.mean() < 1e-3, d2.mean()
    assert np.percentile(d2, 99) < 1e-2, np.percentile(d2, 99)
    assert (d2 > 0.05).mean() < 1e-3, (d2 > 0.05).mean()
