#!/usr/bin/env python3
"""Start-up proof on one GPU: the main paths end to end at real size.

    python chip_smoke.py                # one card: phases 1-5
    python chip_smoke.py --four-cards   # four cards: only the paths that
                                        # span devices, vs one card

Phases (one process; any failure raises and exits non-zero, and the
result line is printed only when every phase passed):

1. Device: JAX's default backend must be a GPU (never the CPU); prints its
   device_kind, the device count and nvidia-smi's name and power limit.
2. Dense flow at 1080p: dense_pyramidal_lk_video with the default configs
   on two seeded clips with exact ground truth (translation, zoom +
   rotation); mean EPE vs ground truth < 0.1 px, and one pair recomputed
   on the CPU backend of this process within stated |dflow| limits.
3. VP serving: lk_tpu.apps.serve.main with 32 streams from a 1280x720
   source (860x483 processing), 64 frames, the `final` preset; every
   stream emits VP rows, and two streams match a CPU-backend
   VideoPipeline on the same staged frames.
4. The app and the graft entry: `lk_tpu.apps final --synthetic --frames
   60` matches its CPU-backend run; jax.jit(fn)(*args) of
   __graft_entry__.entry() runs on the GPU.
5. Readings (findings, not claims): compile seconds, peak device memory,
   steady 1080p dense frames/s, serving frames/s, and the top device ops
   of one profiler trace of the dense step and of the serving step.

Every reading line carries the card's name and power limit.  The last line
of standard output is the JSON result.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "smoke_out")

# Stated tolerances (checked below; see CHANGES.md for the measured diffs).
EPE_GATE_PX = 0.1            # dense mean EPE vs exact ground truth
DENSE_CPU_MEAN_PX = 1e-3     # GPU vs CPU backend, mean |dflow| (interior)
DENSE_CPU_MAX_PX = 0.05      # GPU vs CPU backend, max |dflow| (interior)
# VP csv rows, GPU vs CPU backend: equal row counts and these bounds.  Two
# runs whose tracked points differ by one ulp can disagree on the VP
# update's std-clip keep test (max_cp_std) for a ring entry that sits
# within ~1e-5 px of the clip boundary; the VP then jumps by a fraction of
# a pixel and the update rate halves the gap at each later update.  The
# same jump shows on one backend between the batched and single-stream
# programs (PERF.md), so the max bound is loose and the mean is the check.
VP_ROWS_MEAN_PX = 5e-3
VP_ROWS_MAX_PX = 1.0
FOUR_CARD_ROWS_PX = 0.0      # 4-card stream-sharded serving vs 1-card
FOUR_CARD_DENSE_PX = 1e-4    # 4-card stream-sharded vs 1-card, max |dflow|


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def result_line(device: dict) -> str:
    """The final stdout line: ok plus JAX's device record."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


class Log:
    """Prints phase lines; readings carry the card's name and power limit."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, msg: str) -> None:
        print(msg, flush=True)

    def reading(self, msg: str) -> None:
        print(f"[{self.card}] {msg}", flush=True)


def top_device_ops(trace_dir: str, n: int = 6) -> list:
    """[(op name, total device ms)] of the largest ops in a jax.profiler
    trace: the sum of event durations per name over the device planes.
    The trace directory is deleted afterwards (traces are large)."""
    import glob

    from jax.profiler import ProfileData

    totals: dict = {}
    for path in glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                          recursive=True):
        for plane in ProfileData.from_file(path).planes:
            if not plane.name.startswith("/device:"):
                continue
            lines = list(plane.lines)
            # per-op lines when the plane has them; module-level lines
            # would count every op twice
            ops = [ln for ln in lines if ln.name == "XLA Ops"] or [
                ln for ln in lines if ln.name != "XLA Modules"]
            for line in ops:
                for ev in line.events:
                    totals[ev.name] = totals.get(ev.name, 0.0) + \
                        ev.duration_ns / 1e6
    shutil.rmtree(trace_dir, ignore_errors=True)
    return sorted(totals.items(), key=lambda kv: -kv[1])[:n]


def phase_dense(log: Log, h: int = 1080, w: int = 1920, n_frames: int = 9,
                reps: int = 5, trace: bool = True) -> dict:
    """Phase 2 (+ its readings): the production dense video chain."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from lk_tpu.config import DenseLKConfig, LKConfig
    from lk_tpu.flow.dense import dense_pyramidal_lk_video
    from lk_tpu.io.scenes import (affine_scene, grid_epe, shift_map,
                                  zoom_rot_map)

    log(f"dense: {h}x{w}, {n_frames}-frame clips, LKConfig()/"
        "DenseLKConfig() defaults; precision: pyr_down(fast=True) matmuls "
        "at DEFAULT precision (TF32 on tensor-core GPUs), resize_area at "
        "HIGHEST (f32), everything else elementwise f32")
    rng = np.random.default_rng(2024)
    scenes = {
        "shift": affine_scene(rng, h, w, shift_map(3.7, -2.2), n_frames),
        "zoom+rot": affine_scene(rng, h, w, zoom_rot_map(h, w, 1.004, 0.3),
                                 n_frames),
    }
    fn = jax.jit(lambda fr: dense_pyramidal_lk_video(
        fr, LKConfig(), DenseLKConfig()).flow)
    frames = {k: jnp.asarray(s.frames) for k, s in scenes.items()}
    t0 = time.perf_counter()
    compiled = fn.lower(frames["shift"]).compile()
    compile_s = time.perf_counter() - t0
    log.reading(f"dense compile: {compile_s:.2f} s")
    out = {}
    for name, sc in scenes.items():
        flows = np.asarray(compiled(frames[name]))
        check(flows.shape == (n_frames - 1, h, w, 2) and
              bool(np.isfinite(flows).all()),
              f"dense {name}: bad output {flows.shape}")
        epes = [grid_epe(flows[k], sc.gt) for k in range(n_frames - 1)]
        mean = float(np.mean(epes))
        log(f"dense {name}: mean EPE vs ground truth {mean:.4f} px "
            f"(worst pair {max(epes):.4f}) — limit {EPE_GATE_PX}")
        check(mean < EPE_GATE_PX, f"dense {name} EPE {mean} >= gate")
        out[name] = flows

    # one pair on the CPU backend of this process, same function
    cpu = jax.devices("cpu")[0]
    pair = jax.device_put(scenes["zoom+rot"].frames[:2], cpu)
    ref = np.asarray(jax.jit(lambda fr: dense_pyramidal_lk_video(
        fr, LKConfig(), DenseLKConfig()).flow)(pair))[0]
    d = np.linalg.norm(out["zoom+rot"][0] - ref, axis=-1)[16:-16, 16:-16]
    log(f"dense vs CPU backend (zoom+rot pair 0, 16-px border cropped): "
        f"mean |dflow| {d.mean():.2e} px (limit {DENSE_CPU_MEAN_PX}), "
        f"max {d.max():.2e} px (limit {DENSE_CPU_MAX_PX}), "
        f"p99.9 {np.percentile(d, 99.9):.2e} px")
    check(d.mean() <= DENSE_CPU_MEAN_PX and d.max() <= DENSE_CPU_MAX_PX,
          "dense GPU vs CPU backend outside tolerance")

    times = []
    x = frames["shift"]
    compiled(x).block_until_ready()
    for _ in range(reps):
        t0 = time.perf_counter()
        compiled(x).block_until_ready()
        times.append(time.perf_counter() - t0)
    fps = (n_frames - 1) / statistics.median(times)
    log.reading(f"dense {h}x{w} steady: {fps:.1f} frames/s (median of {reps} "
                f"calls of {n_frames - 1} pairs; per-call s "
                f"{[round(t, 5) for t in times]})")
    if trace:
        tdir = os.path.join(OUT_DIR, "trace_dense")
        with jax.profiler.trace(tdir):
            compiled(x).block_until_ready()
        for name, ms in top_device_ops(tdir):
            log.reading(f"dense trace top op: {ms:9.3f} ms  {name}")
    return {"compile_s": compile_s, "fps": fps}


def _csv_diff(a, b) -> tuple:
    """(mean, max) |d| over two equally long VP csv row lists (px)."""
    import numpy as np

    check(len(a) == len(b), f"row counts differ: {len(a)} vs {len(b)}")
    if not a:
        return 0.0, 0.0
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.mean()), float(d.max())


def _rows_ok(diff: tuple) -> bool:
    return diff[0] <= VP_ROWS_MEAN_PX and diff[1] <= VP_ROWS_MAX_PX


def _fmt(diff: tuple) -> str:
    return (f"mean |d| {diff[0]:.2e} px (limit {VP_ROWS_MEAN_PX}), max "
            f"{diff[1]:.2e} px (limit {VP_ROWS_MAX_PX})")


def phase_serve(log: Log, streams: int = 32, frames: int = 64,
                width: int = 1280, height: int = 720, compare=(0, 1),
                trace: bool = True) -> dict:
    """Phase 3 (+ its readings): batched VP serving through apps.serve."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from lk_tpu.apps import serve
    from lk_tpu.pipeline.runner import MultiStreamPipeline, VideoPipeline

    argv = ["--streams", str(streams), "--frames", str(frames),
            "--width", str(width), "--height", str(height),
            "--preset", "final", "--quiet"]
    t0 = time.perf_counter()
    run = serve.main(argv)
    total_s = time.perf_counter() - t0
    srv = run.server
    log(f"serve: {streams} streams x {frames} frames from {width}x{height} "
        f"({srv.width}x{srv.height} processing), preset final")
    log.reading(f"serve set-up (staging + compile + warm pass): "
                f"{total_s - run.wall_s:.2f} s; timed window "
                f"{run.wall_s:.3f} s")
    log.reading(f"serve aggregate: {run.fps:.1f} frames/s")
    with_rows = [len(p.csv_rows) for p in srv.pipes]
    log(f"serve: streams with VP rows {sum(n > 0 for n in with_rows)}/"
        f"{streams} (rows per stream min {min(with_rows)}, "
        f"max {max(with_rows)})")
    check(all(n > 0 for n in with_rows), "a serving stream emitted no rows")

    args = serve.build_parser().parse_args(argv)
    cfg = srv.cfg
    cpu = jax.devices("cpu")[0]
    for s in compare:
        u8 = serve.stage_u8([serve.scene(args, s)], frames, srv.height,
                            srv.width)[:, 0]
        with jax.default_device(cpu):
            pipe = VideoPipeline(cfg, src_size=(width, height),
                                 chunk=srv.chunk)
            pipe.feed_gray(pipe._finish_jit(jax.device_put(u8, cpu)))
            pipe.drain()
        diff = _csv_diff(srv.pipes[s].csv_rows, pipe.csv_rows)
        log(f"serve stream {s} vs CPU-backend VideoPipeline: "
            f"{len(pipe.csv_rows)} rows each, {_fmt(diff)}")
        check(_rows_ok(diff), f"serve stream {s} differs from CPU")

    if trace:
        c = srv.chunk
        staging = jnp.asarray(serve.stage_u8(
            [serve.scene(args, s) for s in range(streams)], 2 * c + 1,
            srv.height, srv.width))
        ms = MultiStreamPipeline(cfg, src_size=(width, height),
                                 n_streams=streams, chunk=c)
        ms.feed_staged(staging, 0, 1)          # init (untraced)
        ms.feed_staged(staging, 1, c)          # compile + warm (untraced)
        ms.drain()
        tdir = os.path.join(OUT_DIR, "trace_serve")
        with jax.profiler.trace(tdir):
            ms.feed_staged(staging, 1 + c, c)
            ms.drain()
        for name, t in top_device_ops(tdir):
            log.reading(f"serve trace top op: {t:9.3f} ms  {name}")
    return {"fps": run.fps}


def _read_csv(path):
    with open(path) as f:
        return [(float(a), float(b)) for a, b in list(csv.reader(f))[1:]]


def phase_app_and_entry(log: Log, frames: int = 60) -> None:
    """Phase 4: the `final` app vs its CPU-backend run; the graft entry."""
    import numpy as np
    import jax

    from lk_tpu.apps import final

    paths = {}
    for tag, dev in (("gpu", None), ("cpu", jax.devices("cpu")[0])):
        out = os.path.join(OUT_DIR, f"app_{tag}")
        argv = ["--synthetic", "--frames", str(frames), "--out-dir", out,
                "--quiet"]
        t0 = time.perf_counter()
        if dev is None:
            final.main(argv)
        else:
            with jax.default_device(dev):
                final.main(argv)
        log.reading(f"app final ({tag} backend): {time.perf_counter() - t0:.2f}"
                    " s wall incl. compile")
        paths[tag] = os.path.join(out, "vps_synthetic.csv")
    a, b = _read_csv(paths["gpu"]), _read_csv(paths["cpu"])
    diff = _csv_diff(a, b)
    log(f"app final --synthetic --frames {frames}: {len(a)} CSV rows, GPU vs "
        f"CPU backend {_fmt(diff)}")
    check(len(a) > 0 and _rows_ok(diff), "app CSV differs from CPU run")

    sys.path.insert(0, ROOT)
    import __graft_entry__

    fn, fargs = __graft_entry__.entry()
    t0 = time.perf_counter()
    out = jax.jit(fn)(*fargs)
    out.block_until_ready()
    plats = {d.platform for d in out.devices()}
    log.reading(f"entry(): {out.shape} {out.dtype} on {sorted(plats)} "
                f"({time.perf_counter() - t0:.2f} s incl. compile)")
    check(plats == {"gpu"} and bool(np.isfinite(np.asarray(out)).all()),
          "entry() did not run on the GPU")


def phase_four_cards(log: Log, streams: int = 32, frames: int = 33,
                     width: int = 1280, height: int = 720,
                     dense_hw=(1080, 1920), dense_t: int = 3,
                     n_dev: int = 4) -> int:
    """Paths that span devices, each against its one-device run; returns
    the sharded serving run's CSV row count."""
    import dataclasses

    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from lk_tpu.apps import serve
    from lk_tpu.flow.dense import dense_pyramidal_lk_multistream
    from lk_tpu.io.scenes import affine_scene, shift_map
    from lk_tpu.models import PRESETS
    from lk_tpu.pipeline.runner import MultiStreamPipeline

    devs = jax.devices()
    check(len(devs) >= n_dev, f"need {n_dev} devices, found {len(devs)}")
    mesh = Mesh(np.asarray(devs[:n_dev]), ("streams",))

    # serving: stream-sharded MultiStreamPipeline vs one device
    args = serve.build_parser().parse_args(
        ["--streams", str(streams), "--frames", str(frames),
         "--width", str(width), "--height", str(height)])
    cfg = dataclasses.replace(PRESETS["final"], out_cap=args.out_cap)
    runs = {}
    for tag, m in (("one", None), ("four", mesh)):
        ms = MultiStreamPipeline(cfg, src_size=(width, height),
                                 n_streams=streams, chunk=args.chunk, mesh=m)
        u8 = serve.stage_u8([serve.scene(args, s) for s in range(streams)],
                            frames, ms.height, ms.width)
        staging = (jnp.asarray(u8) if m is None
                   else jax.device_put(u8, ms.staging_sharding))
        if m is not None:
            on = {sh.device for sh in staging.addressable_shards}
            log(f"4-card staging shards on {len(on)} devices")
            check(on == set(devs[:n_dev]), "staging not on all 4 devices")
        t0 = time.perf_counter()
        serve._feed_all(ms, staging, args)
        ms.drain()
        if m is not None:
            on = {sh.device for sh in
                  jax.tree_util.tree_leaves(ms.states)[0].addressable_shards}
            check(on == set(devs[:n_dev]), "states not on all 4 devices")
        log.reading(f"serve {tag}-device: {time.perf_counter() - t0:.2f} s "
                    "wall incl. compile")
        runs[tag] = ms
    diffs = [_csv_diff(a.csv_rows, b.csv_rows)
             for a, b in zip(runs["one"].pipes, runs["four"].pipes)]
    worst = (max(d[0] for d in diffs), max(d[1] for d in diffs))
    rows = sum(len(p.csv_rows) for p in runs["four"].pipes)
    log(f"4-card serving vs 1-card: {streams} streams, {rows} CSV rows, "
        f"worst stream max |d| {worst[1]:.2e} px (limit {FOUR_CARD_ROWS_PX})")
    check(worst[1] <= FOUR_CARD_ROWS_PX, "4-card serving differs from 1-card")

    # dense stream-parallel shard_map vs unsharded
    h, w = dense_hw
    rng = np.random.default_rng(7)
    clips = np.stack([affine_scene(rng, h, w, shift_map(1.5 + s, -0.5 * s),
                                   dense_t).frames for s in range(n_dev)])
    x = jax.device_put(clips, jax.sharding.NamedSharding(mesh, P("streams")))
    on = {sh.device for sh in x.addressable_shards}
    check(on == set(devs[:n_dev]), "dense clips not on all 4 devices")
    dp = jax.jit(shard_map(lambda fr: dense_pyramidal_lk_multistream(fr).flow,
                           mesh=mesh, in_specs=P("streams"),
                           out_specs=P("streams")))
    flows = dp(x)
    on = {sh.device for sh in flows.addressable_shards}
    check(on == set(devs[:n_dev]), "dense flows not on all 4 devices")
    ref = jax.jit(lambda fr: dense_pyramidal_lk_multistream(fr).flow)(
        jax.device_put(clips, devs[0]))
    d = float(np.abs(np.asarray(flows) - np.asarray(ref)).max())
    log(f"4-card dense stream-DP at {h}x{w}: {n_dev} streams x "
        f"{dense_t - 1} pairs, max |dflow| vs unsharded {d:.2e} px "
        f"(limit {FOUR_CARD_DENSE_PX})")
    check(d <= FOUR_CARD_DENSE_PX, "4-card dense differs from unsharded")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--four-cards", action="store_true",
                   help="run only the paths that span 4 devices")
    args = p.parse_args(argv)

    from lk_tpu.utils import enable_compilation_cache
    from lk_tpu.utils.device import card_reading, require_gpu

    device = require_gpu()
    enable_compilation_cache()
    card = card_reading()
    log = Log(card)
    log(f"device: {device['kind']} x{device['count']} "
        f"(platform {device['platform']})")
    log(f"card (nvidia-smi name, power.limit): {card}")
    os.makedirs(OUT_DIR, exist_ok=True)

    import jax

    if args.four_cards:
        check(phase_four_cards(log) > 0, "4-card serving emitted no rows")
        device = {**device, "count": len(jax.devices())}
    else:
        phase_dense(log)
        phase_serve(log)
        phase_app_and_entry(log)
    stats = jax.devices()[0].memory_stats() or {}
    log.reading(f"peak_bytes_in_use (device 0): "
                f"{stats.get('peak_bytes_in_use', 'not available')}")
    print(result_line(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
