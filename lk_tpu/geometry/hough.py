"""Hough-style road-line voting over accepted flow segments.

The reference's road-line stage only accumulates per-segment length/angle
stats (reference LK2_road_line_detection.py:214-216) and plots their
distribution (LK2:274-294); the BASELINE north-star narrative names
"Hough-style voting" as the production capability for the same stage.
This module provides it as a fixed-shape tensor program: every accepted
flow segment votes for the infinite line it lies on in a (theta, rho)
parameter grid, and the whole accumulation is ONE masked matmul — no
scatters, no data-dependent control flow, so it batches over any number of
segments.

Parameterization (classic normal form): a line is
``x*cos(theta) + y*sin(theta) = rho`` with ``theta in [0, pi)`` the normal
direction and ``rho in [-rho_max, rho_max]`` the signed distance from the
origin (image coordinates, y down; rho_max = hypot(W, H)).  A segment with
direction d votes for theta = angle(d) + 90deg (mod pi), rho from its
midpoint.

Votes are length-weighted by default: long coherent lane segments should
dominate short tracking jitter, which is also what the reference's
length-EMA accept filter selects for.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import math

import jax
import jax.numpy as jnp


class HoughResult(NamedTuple):
    accumulator: jnp.ndarray  # (n_theta, n_rho) float32 votes
    theta: jnp.ndarray        # (k,) radians in [0, pi) — peak lines
    rho: jnp.ndarray          # (k,) signed px distance from origin
    votes: jnp.ndarray        # (k,) peak vote mass (<=0 marks empty slots)


def segment_line_params(
    start: jnp.ndarray, stop: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(theta, rho) of the infinite line through each (N, 2) segment.

    theta in [0, pi); rho signed.  Zero-length segments get theta=0 and
    rho=x — callers mask them out (FlowLineStats.moving already does).
    """
    d = stop - start
    # normal angle: segment direction rotated 90deg, folded into [0, pi)
    theta = jnp.mod(jnp.arctan2(d[..., 1], d[..., 0]) + jnp.pi / 2, jnp.pi)
    mid = 0.5 * (start + stop)
    rho = mid[..., 0] * jnp.cos(theta) + mid[..., 1] * jnp.sin(theta)
    return theta, rho


def hough_vote(
    start: jnp.ndarray,
    stop: jnp.ndarray,
    mask: jnp.ndarray,
    image_size: Tuple[int, int],
    n_theta: int = 180,
    n_rho: int = 256,
    length_weighted: bool = True,
) -> jnp.ndarray:
    """Accumulate (N,) masked segments into an (n_theta, n_rho) vote grid.

    The accumulation is ``onehot(theta_bins).T @ weighted_onehot(rho_bins)``
    — a single (n_theta, N) x (N, n_rho) matmul, the scatter-free 2-D
    histogram form.  rho votes are bilinearly
    split between the two nearest bins so peak positions are stable under
    sub-bin jitter; theta uses nearest-bin (the theta->rho coupling at the
    0/pi wrap flips rho's sign, so spreading theta across the wrap would
    need a paired rho flip for no measurable gain at 1-degree bins).
    """
    w, h = image_size
    rho_max = math.hypot(float(w), float(h))
    theta, rho = segment_line_params(start, stop)
    weight = jnp.where(mask, 1.0, 0.0).astype(jnp.float32)
    if length_weighted:
        weight = weight * jnp.linalg.norm(stop - start, axis=-1)

    t_raw = jnp.clip(
        jnp.round(theta / jnp.pi * n_theta).astype(jnp.int32), 0, n_theta
    )
    # round can hit n_theta at the wrap: (pi-eps, rho) is the SAME line as
    # (0, -rho) — the fold to bin 0 must flip rho's sign with it, or
    # near-vertical segments vote for the reflected line (r5 fix; verified
    # end-to-end: theta=-0.3 bin, rho=+100 used to come back at -99)
    rho = jnp.where(t_raw == n_theta, -rho, rho)
    t_idx = t_raw % n_theta
    t_hot = jax.nn.one_hot(t_idx, n_theta, dtype=jnp.float32)

    r_pos = (rho + rho_max) / (2.0 * rho_max) * (n_rho - 1)
    r_pos = jnp.clip(r_pos, 0.0, float(n_rho - 1))
    r_lo = jnp.floor(r_pos).astype(jnp.int32)
    frac = r_pos - r_lo
    r_hot = (
        jax.nn.one_hot(r_lo, n_rho, dtype=jnp.float32) * (1.0 - frac)[:, None]
        + jax.nn.one_hot(jnp.minimum(r_lo + 1, n_rho - 1), n_rho,
                         dtype=jnp.float32) * frac[:, None]
    )
    return jnp.einsum(
        "nt,nr->tr", t_hot * weight[:, None], r_hot,
        precision=jax.lax.Precision.HIGHEST,
    )


_PROF_R = 16   # half-width of the per-peak profile window (bins)


def _axis_profile_theta(acc, t, r, n_theta, n_rho):
    """(2*_PROF_R+1,) accumulator profile along theta through peak (t, r).

    Crossing the 0/pi wrap flips the line's rho sign, so the wrapped
    neighbor is sampled at the MIRRORED rho bin (the rho grid is symmetric
    about 0: bin n_rho-1-r holds exactly -rho(r))."""
    offs = jnp.arange(-_PROF_R, _PROF_R + 1)
    raw = t + offs
    tt = raw % n_theta
    crossed = (raw < 0) | (raw >= n_theta)
    rr = jnp.where(crossed, n_rho - 1 - r, r)
    # flattened 1-D gather (33 elements)
    return acc.reshape(-1)[tt * n_rho + rr]


def _axis_profile_rho(acc, t, r, n_rho):
    """(2*_PROF_R+1,) profile along rho through peak (t, r), edge-clamped
    (votes are clipped into the grid, so beyond-edge bins repeat the edge
    value rather than pretending zero support)."""
    offs = jnp.arange(-_PROF_R, _PROF_R + 1)
    rr = jnp.clip(r + offs, 0, n_rho - 1)
    return acc.reshape(-1)[t * n_rho + rr]


def _parabolic_offset(prof):
    """Sub-bin offset of the apex from a 3-tap parabola at the profile
    center; 0 on a flat neighborhood.  An INTERIOR neighbor tie is real
    data (a rho exactly midway between bins splits its bilinear vote
    50/50, y0 == neighbor, apex exactly ±0.5 — the formula handles it);
    edge-CLAMPED repeats are not data and are zeroed by the caller."""
    c = _PROF_R
    ym, y0, yp = prof[c - 1], prof[c], prof[c + 1]
    denom = ym - 2.0 * y0 + yp
    ok = jnp.abs(denom) > 1e-12
    safe = jnp.where(ok, denom, 1.0)
    off = jnp.where(ok, 0.5 * (ym - yp) / safe, 0.0)
    return jnp.clip(off, -0.5, 0.5)


def _hwhm_radius(prof, val, max_r):
    """Half-width-at-half-max suppression radius from the peak's own vote
    spread: the first offset (either side) where the profile drops below
    half the peak value, clamped to [2, max_r].  Replaces the r3 magic
    n//24 constants — a sharp peak no longer suppresses a neighbor 10
    bins away, a broad smeared peak still suppresses its full footprint."""
    c = _PROF_R
    below = prof < 0.5 * val
    right = jnp.where(jnp.any(below[c:]),
                      jnp.argmax(below[c:]), _PROF_R + 1)
    left_rev = jnp.flip(below[:c + 1])   # [c, c-1, ..., 0] (static rev)
    left = jnp.where(jnp.any(left_rev), jnp.argmax(left_rev), _PROF_R + 1)
    return jnp.clip(jnp.maximum(left, right), 2, max_r)


def hough_peaks(
    acc: jnp.ndarray,
    k: int = 4,
    image_size: Tuple[int, int] = (1, 1),
    suppress_theta: int | None = None,
    suppress_rho: int | None = None,
) -> HoughResult:
    """Top-k accumulator peaks: greedy non-max suppression + sub-bin
    refinement (r5; r3 returned raw bin centers with fixed n//24 radii).

    k is static and small (dominant road lines), so the greedy loop is a
    k-step ``lax.scan`` masking a suppression window around each peak;
    theta distance wraps (bin 0 and bin n_theta-1 are neighbors, with the
    rho mirror — see _axis_profile_theta).

    Each peak's (theta, rho) is refined by an independent 3-tap parabolic
    fit along each axis (the standard sub-bin apex estimate; exact for a
    quadratic peak, and the bilinear rho vote split makes the profile
    locally quadratic under sub-bin jitter).  Suppression radii default to
    the measured half-width-at-half-max of each peak's own profile
    (clamped [2, _PROF_R]); pass explicit suppress_theta/suppress_rho for
    the fixed-radius behavior.
    """
    n_theta, n_rho = acc.shape
    w, h = image_size
    rho_max = math.hypot(float(w), float(h))
    ti = jnp.arange(n_theta)
    ri = jnp.arange(n_rho)

    def body(grid, _):
        flat = jnp.argmax(grid)
        t, r = flat // n_rho, flat % n_rho
        val = grid[t, r]
        # profiles come from the ORIGINAL accumulator: earlier peaks'
        # -inf suppression must not distort this peak's shape estimate
        prof_t = _axis_profile_theta(acc, t, r, n_theta, n_rho)
        prof_r = _axis_profile_rho(acc, t, r, n_rho)
        if suppress_theta is None:
            sup_t = _hwhm_radius(prof_t, val, _PROF_R)
        else:
            sup_t = jnp.int32(suppress_theta)
        if suppress_rho is None:
            sup_r = _hwhm_radius(prof_r, val, _PROF_R)
        else:
            sup_r = jnp.int32(suppress_rho)
        # theta distance wraps; where the SHORTER path crosses the 0/pi
        # boundary the same physical line sits at the MIRRORED rho bin —
        # suppress there, or a near-vertical line's alias across the wrap
        # survives and consumes a top-k slot as a duplicate
        diff = jnp.abs(ti - t)
        dt = jnp.minimum(diff, n_theta - diff)
        crossed = (n_theta - diff) < diff
        rho_near = jnp.abs(ri[None, :] - r) <= sup_r
        rho_mirr = jnp.abs(ri[None, :] - (n_rho - 1 - r)) <= sup_r
        win = (dt[:, None] <= sup_t) & jnp.where(
            crossed[:, None], rho_mirr, rho_near)
        t_sub = t.astype(jnp.float32) + _parabolic_offset(prof_t)
        # rho-EDGE peaks have clamped (repeated, non-data) neighbors on
        # one side, where the raw fit degenerates to exactly +-0.5 and
        # biases the peak half a bin outside the grid: zero it there
        # (theta has no edges — it wraps)
        r_off = jnp.where((r == 0) | (r == n_rho - 1), 0.0,
                          _parabolic_offset(prof_r))
        r_sub = r.astype(jnp.float32) + r_off
        return jnp.where(win, -jnp.inf, grid), (t_sub, r_sub, val)

    _, (ts, rs, vals) = jax.lax.scan(body, acc, None, length=k)
    theta = jnp.mod(ts, float(n_theta)) * (jnp.pi / n_theta)
    rho = rs / (n_rho - 1) * (2.0 * rho_max) - rho_max
    # a refined theta that wrapped across 0/pi names the same line at
    # NEGATED rho ((0-eps == pi-eps, -rho)); without the flip the
    # returned line is reflected about the origin (~2|rho| off).  Only
    # the negative side can occur: t <= n_theta-1 and |offset| <= 0.5
    rho = jnp.where(ts < 0.0, -rho, rho)
    return HoughResult(accumulator=acc, theta=theta, rho=rho, votes=vals)


def hough_road_lines(
    start: jnp.ndarray,
    stop: jnp.ndarray,
    mask: jnp.ndarray,
    image_size: Tuple[int, int],
    k: int = 4,
    n_theta: int = 180,
    n_rho: int = 256,
    length_weighted: bool = True,
) -> HoughResult:
    """Vote + peak-extract in one jittable call (the app-facing entry)."""
    acc = hough_vote(start, stop, mask, image_size, n_theta, n_rho,
                     length_weighted)
    return hough_peaks(acc, k, image_size)   # adaptive HWHM suppression
