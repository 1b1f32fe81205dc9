"""Differentiable sphere-tracing raycaster over the TSDF grid.

NEW capability vs the reference (which only renders via marching cubes +
RViz, sdf.cpp:317-391); required by BASELINE.json: depth/normal/color images
and pixel gradients w.r.t. pose and SDF values.

Design:
  * All rays march in lockstep inside one lax.fori_loop with a fixed step
    count — no data-dependent control flow; finished rays are masked, not
    branched.
  * Rays are clipped to the grid's bounding box first, so steps are never
    wasted outside the volume.
  * The canonical D is positive in free space, so the sphere-tracing step is
    simply phi * step_scale; unobserved space (no valid interpolation) is
    crossed at a fixed miss_step.
  * Gradients: the march itself is wrapped in stop_gradient; the returned
    range applies one implicit-function Newton step
        t* = t_march - phi(o + t u) / (grad_phi . u)
    through which d t*/d(pose, D) flows exactly (at the surface the quotient
    rule's second term vanishes). This is the standard differentiable-
    rendering trick: iteration count does not contaminate the derivative.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tracking_sdf_tpu.config import GridParams, RaycastConfig
from tracking_sdf_tpu.core.camera import PinholeCamera, pixel_rays
from tracking_sdf_tpu.core.lie import Pose
from tracking_sdf_tpu.grid.grid import TSDFGrid, world_to_voxel
from tracking_sdf_tpu.grid.interp import (
    interp_color,
    masked_view,
    trilinear_with_grad,
    trilinear_with_grad_nan,
)

_HI = jax.lax.Precision.HIGHEST


class RenderResult(NamedTuple):
    depth: jnp.ndarray  # (H, W) z-depth in camera frame; NaN on miss
    range_t: jnp.ndarray  # (H, W) Euclidean distance along the ray; NaN on miss
    hit: jnp.ndarray  # (H, W) bool
    normal_world: jnp.ndarray  # (H, W, 3); NaN on miss
    normal_cam: jnp.ndarray  # (H, W, 3); NaN on miss
    rgb: Optional[jnp.ndarray]  # (H, W, 3) in [0,1] or None
    steps: jnp.ndarray  # (H, W) int32 — march steps taken (profiling)
    # rays beyond phase-2 compaction capacity (int32 scalar at runtime).
    # Python-int default: a jnp default would run a device op AT IMPORT
    # TIME, initializing the default backend before callers can force CPU
    dropped: jnp.ndarray = 0


def _ray_box(origin, unit, lo, hi):
    """Entry/exit distances of rays o + t*u against an AABB."""
    safe_u = jnp.where(jnp.abs(unit) < 1e-12, 1e-12, unit)
    t0 = (lo - origin) / safe_u
    t1 = (hi - origin) / safe_u
    t_enter = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_exit = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return t_enter, t_exit


_ROW_W_RC = 128  # nearest-sample gather row width (not tuned on the H100)
_SKIP_B = 8  # empty-skip mip brick side (voxels); independent of fusion bricks
_SKIP_K = 8  # chamfer iterations = max leap distance in bricks


def _chamfer(occ: jnp.ndarray) -> jnp.ndarray:
    """L-inf chamfer distance (capped at _SKIP_K) to the nearest True cell
    of a (nb, nb, nb) boolean grid, via _SKIP_K-1 separable 3^3 min-pools."""
    nb = occ.shape[0]
    big = jnp.int32(_SKIP_K)
    dist = jnp.where(occ, 0, big)
    for _ in range(_SKIP_K - 1):
        a = dist
        for ax in range(3):  # 3x3x3 min-pool, axis-separable
            pad = [(1, 1) if i == ax else (0, 0) for i in range(3)]
            p = jnp.pad(a, pad, constant_values=_SKIP_K)
            lo_, mid, hi_ = (
                jax.lax.slice_in_dim(p, 0, nb, axis=ax),
                jax.lax.slice_in_dim(p, 1, nb + 1, axis=ax),
                jax.lax.slice_in_dim(p, 2, nb + 2, axis=ax),
            )
            a = jnp.minimum(jnp.minimum(lo_, mid), hi_)
        dist = jnp.minimum(dist, a + 1)
    return dist.astype(jnp.int32)


def _skip_mip(W: jnp.ndarray) -> jnp.ndarray:
    """(nb, nb, nb) int32 L-inf chamfer distance to the nearest OBSERVED
    8^3-voxel brick (0 = this brick has observed voxels; capped at _SKIP_K).

    A ray at a point whose brick has distance s >= 2 cannot reach observed
    space within (s-1) bricks in any direction, so a leap of
    (s-1) * brick_extent is safe (cannot tunnel through a surface band)."""
    m = W.shape[0]
    nb = m // _SKIP_B
    occ = (
        W.reshape(nb, _SKIP_B, nb, _SKIP_B, nb, _SKIP_B).max(axis=(1, 3, 5))
        > 0
    )
    return _chamfer(occ)


def _band_skip_mip(Dm: jnp.ndarray, params: GridParams,
                   band_frac: float) -> jnp.ndarray:
    """(nb, nb, nb) int32 L-inf chamfer distance to the nearest
    SURFACE-BAND 8^3 brick (RaycastConfig.far_field="chamfer").

    Surface-BAND brick: any voxel with SIGNED D < band (= band_frac *
    delta; NaN voxels compare False — unobserved space holds no surface).
    SAFETY: a trilinear zero crossing requires a NEGATIVE corner voxel
    (D <= 0 < band), so every crossing cell touches a band brick or its
    1-voxel neighborhood; a ray in a brick at chamfer distance s >= 2 is
    therefore >= (s-1) * brick_min_extent (Euclidean) from every crossing
    and may leap that far regardless of observation state. This
    generalizes _skip_mip's W-based occupancy — which is blind in
    observed SATURATED free space (D = +delta, W > 0: a mature scene's
    entire interior, where the leap never fired) — while building the same
    tiny (m/8)^3 mip: one full-grid min-reduce, no extended-field
    materialization (a first implementation materialized max(D, lead) as a
    full (m, m, m) tensor on every render)."""
    m = Dm.shape[0]
    nb = m // _SKIP_B
    band = jnp.asarray(band_frac * params.delta, Dm.dtype)
    Dv = jnp.where(jnp.isnan(Dm), jnp.inf, Dm)
    occ = (
        Dv.reshape(nb, _SKIP_B, nb, _SKIP_B, nb, _SKIP_B).min(axis=(1, 3, 5))
        < band
    )
    return _chamfer(occ)


def _skip_lookup(rows: jnp.ndarray, flat: jnp.ndarray) -> jnp.ndarray:
    """Gather skip values by flat brick index from a (NB/128, 128) row
    table — width-128 row gathers + iota lane select (chosen where 1-D
    shaped takes were far slower; not measured on the H100)."""
    n = flat.shape[0]
    lane_w = rows.shape[1]
    npad = -(-n // lane_w) * lane_w
    fl = jnp.pad(flat, (0, npad - n))
    row, lane = fl // lane_w, fl % lane_w
    got = jnp.take(rows, row.reshape(-1, lane_w), axis=0, mode="clip")
    io = jnp.arange(lane_w, dtype=jnp.int32)
    val = jnp.sum(
        jnp.where(io == lane.reshape(-1, lane_w, 1), got, 0), axis=-1
    )
    return val.reshape(npad)[:n]


@partial(jax.jit, static_argnames=("params", "cam", "cfg", "stride", "with_color"))
def raycast(
    grid: TSDFGrid,
    pose: Pose,
    *,
    params: GridParams,
    cam: PinholeCamera,
    cfg: RaycastConfig = RaycastConfig(),
    stride: int = 1,
    with_color: bool = False,
    t_init: Optional[jnp.ndarray] = None,  # (H, W) prev range_t (NaN=miss)
    dirs_cam: Optional[jnp.ndarray] = None,  # explicit (h, w, 3) camera-frame
    # ray dirs (z=1) overriding pixel_rays(cam, stride) — the SPMD renderer
    # (parallel.render.sharded_raycast) shards the image's rays over
    # devices and passes each shard's block here
) -> RenderResult:
    dtype = grid.D.dtype
    miss_step = cfg.miss_step if cfg.miss_step > 0 else params.delta / 2
    Dm = masked_view(grid.D, grid.W)  # one gather per sample instead of two
    if dirs_cam is None:
        dirs_cam, _ = pixel_rays(cam, stride)  # (H, W, 3), z == 1
    d_world = jnp.einsum("ij,hwj->hwi", pose.R, dirs_cam, precision=_HI)
    dn = jnp.linalg.norm(d_world, axis=-1, keepdims=True)
    unit = d_world / dn
    origin = pose.t

    lo = jnp.asarray(params.origin, dtype=dtype)
    hi = lo + jnp.asarray(params.extent, dtype=dtype)
    t_enter, t_exit = _ray_box(origin, unit, lo, hi)
    t_start = jnp.maximum(t_enter, cfg.t_near)
    t_stop = jnp.minimum(t_exit, cfg.t_far)
    alive0 = t_start < t_stop  # ray intersects the volume at all

    # ---- march (flat ray state; two-phase with alive compaction) ----------
    # Every sphere-tracing step gathers 8 grid corners for EVERY ray in the
    # batch — finished rays are masked, not free. Most primary rays hit
    # within ~20 steps; the stragglers (misses, silhouette grazes) then
    # march on a 4x-smaller compacted batch, cutting render time ~3x. Rays
    # beyond the compaction capacity are dropped as misses (counted; rare —
    # capacity is 1/4 of the batch for a typical <10% phase-A survival).
    shape = t_start.shape
    N = int(np.prod(shape))
    unit_f = unit.reshape(N, 3)
    t_start_f = t_start.reshape(N)
    t_stop_f = t_stop.reshape(N)

    # ---- temporal warm start (cfg.warm_backoff / RenderResult.range_t) ----
    # Sequential renders start at the previous frame's surface range minus
    # a backoff instead of the volume entry. A 3x3 MIN-pool over the prior
    # absorbs small pixel shifts at silhouettes (the nearer neighbor wins);
    # backoff defaults to delta — the truncation band is >= 2*delta thick
    # along the ray, so a surface that approached by < delta is still
    # ahead of the warm start (and the Newton finish pulls back within the
    # clip floor). Rays with no prior (NaN) start cold.
    if t_init is not None:
        backoff = cfg.warm_backoff if cfg.warm_backoff > 0 else params.delta
        # f32 regardless of grid storage dtype: a bf16 cast would quantize
        # the prior by ~8 mm at 2-4 m range and erode small backoffs
        ti = jnp.asarray(
            t_init, dtype=jnp.promote_types(dtype, jnp.float32)
        ).reshape(shape)
        big = jnp.asarray(jnp.inf, dtype)
        tif = jnp.where(jnp.isfinite(ti), ti, big)
        pooled = tif
        for ax in (0, 1):
            lo_s = jnp.concatenate(
                [tif[1:], jnp.full_like(tif[:1], big)] if ax == 0 else
                [tif[:, 1:], jnp.full_like(tif[:, :1], big)], axis=ax)
            hi_s = jnp.concatenate(
                [jnp.full_like(tif[:1], big), tif[:-1]] if ax == 0 else
                [jnp.full_like(tif[:, :1], big), tif[:, :-1]], axis=ax)
            pooled = jnp.minimum(pooled, jnp.minimum(lo_s, hi_s))
            tif = pooled
        warm = jnp.isfinite(pooled).reshape(N)
        t_warm = jnp.clip(pooled.reshape(N) - backoff, 0.0, None)
        t_start_f = jnp.where(warm, jnp.maximum(t_start_f, t_warm),
                              t_start_f)
        t_start_f = jnp.minimum(t_start_f, t_stop_f)

    # ---- empty-space skip mip (cfg.empty_skip) ----------------------------
    # L-inf chamfer over observed 8^3 bricks; leap (s-1)*brick_min_extent
    # through unobserved space instead of crawling at miss_step. One extra
    # width-128 row gather per step (~1/8 of the trilinear sample's cost).
    skip_rows = None
    if cfg.empty_skip and params.m % _SKIP_B == 0 \
            and (params.m // _SKIP_B) ** 3 % 128 == 0:
        nb_skip = params.m // _SKIP_B
        skip_rows = _skip_mip(grid.W).reshape(-1, 128)
        brick_min_ext = _SKIP_B * min(
            params.width / params.m, params.height / params.m,
            params.depth / params.m,
        )

    # march_unroll (cfg): U steps per while iteration — bitwise-equivalent
    # when U divides the loop's budget (the alive-check only decides when
    # the loop STOPS; per-ray updates are masked and deterministic), so a
    # non-dividing U falls back to 1 for that loop rather than change
    # results. Cuts per-iteration loop overhead (cond reduce + control)
    # that rivals the tiny per-step gather on small/strided ray batches.
    U_cfg = max(1, int(getattr(cfg, "march_unroll", 1)))

    def _unrolled(body_one, cond, state, budget):
        U = U_cfg if U_cfg > 1 and budget % U_cfg == 0 else 1
        if U == 1:
            return jax.lax.while_loop(cond, body_one, state)

        def body_u(s):
            for _ in range(U):
                s = body_one(s)
            return s

        return jax.lax.while_loop(cond, body_u, state)

    def march(state0, unit_v, t_lo, t_hi, budget):
        def sample(t):
            pos = origin + t[..., None] * unit_v
            uvw = world_to_voxel(params, pos)
            phi, _, ok = trilinear_with_grad_nan(Dm, uvw)
            return phi, ok, uvw

        def cond(state):
            k, t, hit, alive, steps = state
            return (k < budget) & jnp.any(alive)

        def body(state):
            k, t, hit, alive, steps = state
            phi, ok, uvw = sample(t)
            hit_now = alive & ok & (jnp.abs(phi) < cfg.hit_epsilon)
            step = jnp.where(ok, phi * cfg.step_scale, miss_step)
            # never step backwards past the entry point; cap forward progress
            # at the truncation band
            step = jnp.clip(step, -params.delta, params.delta)
            if skip_rows is not None:
                b = jnp.clip(
                    (uvw / _SKIP_B).astype(jnp.int32), 0, nb_skip - 1)
                flat = (b[..., 0] * nb_skip + b[..., 1]) * nb_skip + b[..., 2]
                s = _skip_lookup(skip_rows, flat)
                leap = (s - 1).astype(step.dtype) * brick_min_ext
                # provably-safe long stride through unobserved space (the
                # leap cannot reach an observed brick) — bypasses the
                # truncation-band clip, which only bounds phi-driven steps
                step = jnp.where(~ok, jnp.maximum(step, leap), step)
            t_new = jnp.where(alive & ~hit_now, t + step, t)
            t_new = jnp.maximum(t_new, t_lo)
            out_of_volume = t_new > t_hi
            return (
                k + 1,
                t_new,
                hit | hit_now,
                alive & ~hit_now & ~out_of_volume,
                steps + alive.astype(jnp.int32),
            )

        return _unrolled(body, cond, (jnp.int32(0),) + state0, budget)[1:]

    # ---- far-field nearest-sample march (cfg.sample="nearest_far") --------
    # One gather row per ray per step instead of 8: |phi(x) - phi(nearest
    # voxel center)| <= L * (sqrt(3)/2) * h with L <= 1 for a TSDF, so the
    # margin-reduced step cannot cross the surface. Rays FREEZE when the
    # nearest phi falls under fine_threshold voxels; a short full-batch
    # trilinear phase then walks the exact crossing (the final Newton
    # refinement is trilinear in every mode). The 8-row fetch per step is
    # what this saves.
    m_vox = params.m
    total = m_vox ** 3
    nearest_ok = cfg.sample == "nearest_far" and total % _ROW_W_RC == 0

    # far-field band-chamfer leaps (cfg.far_field="chamfer"): a tiny
    # (m/8)^3 distance mip to the surface band lets the nearest-sample
    # phase leap (s-1)*brick_min_ext per step through far space —
    # observed OR unobserved. Later phases (fine/newton/recovery) stay on
    # the true Dm near the surface, so hits/depths are unchanged — only
    # step counts drop.
    band_rows = None
    far_ok = (getattr(cfg, "far_field", "off") == "chamfer" and nearest_ok
              and params.m % _SKIP_B == 0
              and (params.m // _SKIP_B) ** 3 % 128 == 0)
    if far_ok:
        nb_band = params.m // _SKIP_B
        band_rows = _band_skip_mip(
            Dm, params, getattr(cfg, "far_band", 0.75)).reshape(-1, 128)
        band_min_ext = _SKIP_B * min(
            params.width / params.m, params.height / params.m,
            params.depth / params.m)

    def march_nearest(state0, unit_v, t_lo, t_hi, budget, t_fine, margin):
        rows = Dm.reshape(total // _ROW_W_RC, _ROW_W_RC)

        def sample_n(t):
            pos = origin + t[..., None] * unit_v
            uvw = world_to_voxel(params, pos)
            n = jnp.clip(jnp.round(uvw), 0, m_vox - 1).astype(jnp.int32)
            flat = (n[..., 0] * m_vox + n[..., 1]) * m_vox + n[..., 2]
            r, lane = flat // _ROW_W_RC, flat % _ROW_W_RC
            got = jnp.take(rows, r, axis=0)
            io = jnp.arange(_ROW_W_RC, dtype=jnp.int32)
            # where-select (NaN sentinels — a 0-multiply would poison)
            phi = jnp.sum(jnp.where(io == lane[..., None], got, 0.0), axis=-1)
            return phi.astype(t.dtype), uvw

        def cond(state):
            k, t, near, alive, steps = state
            return (k < budget) & jnp.any(alive)

        def body(state):
            k, t, near, alive, steps = state
            phi, uvw = sample_n(t)
            ok = jnp.isfinite(phi)
            near_now = alive & ok & (phi < t_fine)
            step = jnp.where(ok, jnp.maximum(phi - margin, 0.0)
                             * cfg.step_scale, miss_step)
            step = jnp.minimum(step, params.delta)
            if skip_rows is not None:
                b = jnp.clip((uvw / _SKIP_B).astype(jnp.int32), 0, nb_skip - 1)
                flat_b = (b[..., 0] * nb_skip + b[..., 1]) * nb_skip + b[..., 2]
                s = _skip_lookup(skip_rows, flat_b)
                leap = (s - 1).astype(step.dtype) * brick_min_ext
                step = jnp.where(~ok, jnp.maximum(step, leap), step)
            if band_rows is not None:
                b = jnp.clip((uvw / _SKIP_B).astype(jnp.int32),
                             0, nb_band - 1)
                flat_b = (b[..., 0] * nb_band + b[..., 1]) * nb_band \
                    + b[..., 2]
                s = _skip_lookup(band_rows, flat_b)
                leap = (s - 1).astype(step.dtype) * band_min_ext
                # safe regardless of observation state (proof in
                # _band_skip_mip) — bypasses the truncation-band cap
                step = jnp.maximum(step, leap)
            t_new = jnp.where(alive & ~near_now, t + step, t)
            t_new = jnp.maximum(t_new, t_lo)
            oov = t_new > t_hi
            return (k + 1, t_new, near | near_now,
                    alive & ~near_now & ~oov,
                    steps + alive.astype(jnp.int32))

        return _unrolled(body, cond, (jnp.int32(0),) + state0, budget)[1:]

    hit0 = jnp.zeros((N,), dtype=bool)
    steps0 = jnp.zeros((N,), dtype=jnp.int32)
    if nearest_ok:
        h_max = max(params.width, params.height, params.depth) / m_vox
        t_m, near, aliveN, steps = march_nearest(
            (t_start_f, jnp.zeros((N,), bool), alive0.reshape(N), steps0),
            unit_f, t_start_f, t_stop_f, cfg.max_steps,
            cfg.fine_threshold * h_max, 0.8660254 * h_max,
        )
        if cfg.fine_mode == "newton":
            # Newton finish: frozen rays are within ~fine_threshold voxels
            # of the crossing; t <- t - phi/(grad.u) lands in 2-3
            # iterations where the phi-clipped march crawls ~12 steps (at
            # full-batch 8-gather cost each). Grazers — tangent rays whose
            # denominator vanishes or that converge to a non-crossing
            # minimum — stay un-hit and fall through to the compacted
            # recovery march below, exactly as in march mode.
            act0 = near | aliveN
            n_iter = max(2, cfg.fine_steps // 3)

            def nbody(k, st):
                t, hit = st
                pos = origin + t[..., None] * unit_f
                phi, g_uvw, ok = trilinear_with_grad_nan(
                    Dm, world_to_voxel(params, pos))
                scale_v = jnp.asarray(
                    [params.m / params.width, params.m / params.height,
                     params.m / params.depth], dtype=g_uvw.dtype)
                denom = jnp.sum(g_uvw * scale_v * unit_f, axis=-1)
                hit_now = ok & (jnp.abs(phi) < cfg.hit_epsilon)
                good = act0 & ok & ~hit & ~hit_now & (jnp.abs(denom) > 1e-6)
                step = jnp.clip(phi / jnp.where(good, denom, 1.0),
                                -params.delta, params.delta)
                t_new = jnp.where(good, t - step, t)
                t_new = jnp.clip(t_new, t_start_f, t_stop_f)
                return t_new, hit | (act0 & hit_now)

            t_m, hitN = jax.lax.fori_loop(0, n_iter, nbody, (t_m, hit0))
            # one final hit test at the converged t (the loop's hit flag
            # lags the last update by one sample)
            posF = origin + t_m[..., None] * unit_f
            phiF, _, okF = trilinear_with_grad_nan(
                Dm, world_to_voxel(params, posF))
            hit = hitN | (act0 & okF & (jnp.abs(phiF) < cfg.hit_epsilon))
            alive = act0 & ~hit
            steps = steps + n_iter * act0.astype(jnp.int32)
        else:
            # trilinear finish on the frozen-near (and any still-alive)
            # rays — full batch, short budget: they start within
            # ~fine_threshold voxels
            t_m, hit, alive, steps_f = march(
                (t_m, hit0, near | aliveN, steps),
                unit_f, t_start_f, t_stop_f, cfg.fine_steps,
            )
            steps = steps_f
        dropped = jnp.int32(0)
        # grazing recovery: rays still alive after the finish (skimmed past
        # a surface and must travel on, ~3% of rays) get a compacted
        # trilinear march — without it they read as misses (97.1% hit
        # coverage). The compacted phase costs K x budget regardless of
        # real survivor count (static shapes), so K is a tight N/16
        # (overflow -> reported drops); at N/4 it cost as much as the
        # nearest-mode march saved.
        tp = getattr(cfg, "two_phase", "auto")
        two_phase = N >= 4096 if tp == "auto" else tp == "on"
        budget_a = cfg.max_steps - cfg.max_steps // 2  # recovery budget
        k_div = 16
    else:
        tp = getattr(cfg, "two_phase", "auto")
        two_phase = ((N >= 4096 if tp == "auto" else tp == "on")
                     and cfg.max_steps > 20)
        budget_a = 20 if two_phase else cfg.max_steps
        k_div = 4
        t_m, hit, alive, steps = march(
            (t_start_f, hit0, alive0.reshape(N), steps0),
            unit_f, t_start_f, t_stop_f, budget_a,
        )
        dropped = jnp.int32(0)
    if two_phase:
        K = -(-max(1024, N // k_div) // 128) * 128
        idx = jnp.nonzero(alive, size=K, fill_value=N)[0]
        slot_ok = idx < N
        safe = jnp.where(slot_ok, idx, 0)
        sub0 = (t_m[safe], hit[safe] & slot_ok, slot_ok,
                jnp.zeros((K,), jnp.int32))
        t_c, hit_c, _, steps_c = march(
            sub0, unit_f[safe], t_start_f[safe], t_stop_f[safe],
            cfg.max_steps - budget_a,
        )
        tgt = jnp.where(slot_ok, idx, N)
        t_m = t_m.at[tgt].set(t_c, mode="drop")
        hit = hit.at[tgt].set(hit_c, mode="drop")
        steps = steps.at[tgt].add(steps_c, mode="drop")
        dropped = jnp.sum(alive.astype(jnp.int32)) - jnp.sum(slot_ok.astype(jnp.int32))

    t_m = jax.lax.stop_gradient(t_m).reshape(shape)
    hit = hit.reshape(shape)
    steps = steps.reshape(shape)

    # Implicit-function refinement: exact differentiable surface distance.
    pos = origin + t_m[..., None] * unit
    uvw = world_to_voxel(params, pos)
    phi, g_uvw, ok = trilinear_with_grad(grid.D, grid.W, uvw)
    scale = jnp.asarray(
        [params.m / params.width, params.m / params.height, params.m / params.depth],
        dtype=dtype,
    )
    g_world = g_uvw * scale
    denom = jnp.sum(g_world * unit, axis=-1)
    safe_denom = jnp.where(jnp.abs(denom) > 1e-6, denom, 1.0)
    # double-where NaN hygiene (round 4): phi is NaN on invalid
    # interpolation (masked D); even under a zero cotangent, the
    # division's partial w.r.t. denom is -phi/denom^2 = NaN, and 0 * NaN
    # poisons the ROTATION gradient through denom = g.unit (translation
    # never touches denom). Zeroing phi where unused keeps the partials
    # finite without changing any primal value.
    use = hit & ok & (jnp.abs(denom) > 1e-6)
    phi_s = jnp.where(use, phi, 0.0)
    t_refined = jnp.where(use, t_m - phi_s / safe_denom, t_m)
    hit = hit & ok

    gn = jnp.linalg.norm(g_world, axis=-1, keepdims=True)
    n_world = g_world / jnp.maximum(gn, 1e-12)  # outward normal: +grad (+outside SDF)
    # orient toward the camera (n . view_dir < 0)
    n_world = jnp.where(jnp.sum(n_world * unit, -1, keepdims=True) > 0, -n_world, n_world)
    n_cam = jnp.einsum("ji,hwj->hwi", pose.R, n_world, precision=_HI)

    nan = jnp.asarray(jnp.nan, dtype=dtype)
    range_t = jnp.where(hit, t_refined, nan)
    # divide BEFORE the NaN mask: depth = range_t / dn would put the
    # miss-pixel NaNs into the division's partial w.r.t. dn (-range_t/dn^2),
    # and dn = ||R dirs|| is the one depth path that is ROTATION-dependent —
    # 0-cotangent x NaN-partial poisoned d(depth)/d(pose.R) (double-where
    # rule; t_refined is finite everywhere, t_m fallback)
    depth = jnp.where(hit, t_refined / dn[..., 0], nan)  # camera z-depth
    n_world = jnp.where(hit[..., None], n_world, nan)
    n_cam = jnp.where(hit[..., None], n_cam, nan)

    rgb = None
    if with_color:
        hit_pos = origin + jnp.where(hit, t_refined, t_m)[..., None] * unit
        rgb_v, c_ok = interp_color(
            grid.R, grid.G, grid.B, grid.Wc, world_to_voxel(params, hit_pos)
        )
        rgb = jnp.where((hit & c_ok)[..., None], rgb_v, nan)

    return RenderResult(
        depth=depth, range_t=range_t, hit=hit,
        normal_world=n_world, normal_cam=n_cam, rgb=rgb, steps=steps,
        dropped=dropped,
    )
