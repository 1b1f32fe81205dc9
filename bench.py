"""Headline benchmark: fused frames/s/chip on the flagship configuration.

One frame = Gauss-Newton tracking (640x480, pixel stride 3) + full TSDF
depth+color fusion into the 256^3 grid (BENCH_PRESET=tum512 for 512^3) —
the reference's per-frame pipeline (sdf_reconstruction.cpp:21-80) at its
own configuration (:83-88), on the brick-major fusion path. Also prints
(stderr) a fuse/track breakdown and an end-to-end line including
bilateral+normals preprocessing.

The workload is a K-frame camera trajectory with realistic handheld motion
(~13 mm + ~0.9 deg per frame, TUM fr1-like, with 30% frame-to-frame
"acceleration" jitter). Each frame has its own rendered depth image; the
tracker starts from the previous frame's pose (the reference's
initialization — see PipelineConfig.pose_init for why constant-velocity
extrapolation is not used) and the grid fuses at the TRACKED pose, so
drift compounds exactly as in the real pipeline.

The K-frame loop runs ON DEVICE inside one dispatch (lax.fori_loop carrying
grid+poses), so the figure is the device rate without per-frame host
dispatch; the best of 3 runs is reported.

Runs only on a GPU: anywhere else it exits nonzero and prints no result.

Baseline: the paper's CUDA implementation, ~23 ms/frame at m=256 on a laptop
Quadro GPU (bylow_etal_rss2013.pdf §V-E; BASELINE.md) = 43.5 frames/s.

Prints ONE JSON line on stdout, preceded by a line naming the card and its
power limit:
  {"metric": "fused_frames_per_s_per_chip", "value": N, "unit": "frames/s",
   "vs_baseline": N / 43.478}
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp


def baseline_fps(preset_name: str) -> float:
    # paper §V-E: 23 ms/frame at m=256; 52.7 ms at m=512
    return 1000.0 / 52.7 if preset_name == "tum512" else 1000.0 / 23.0


BASELINE_FPS = baseline_fps(os.environ.get("BENCH_PRESET", "tum256"))
# frames per on-device dispatch (compile time scales with K). BENCH_K
# lets cadence A/Bs pick a K divisible by color_every (the loop silently
# falls back to color-every-frame when K % ce != 0 — a "ce=3" run at
# K=10 was once actually ce=1). _K0 is the REQUESTED value;
# build_inputs snaps the module K from _K0 each call (snapping from the
# current K would compound across in-process multi-preset runs).
_K0 = int(os.environ.get("BENCH_K", "10"))
K = _K0


def make_scene():
    from tracking_sdf_tpu.data.synthetic import CuboidScene, SphereScene

    # Sphere + box + full-FOV back wall: dense valid depth like an indoor
    # TUM frame, all 6 DoF observable.
    sphere = SphereScene(center=(0.3, 1.2, 0.9), radius=0.45)
    box = CuboidScene(min_corner=(-1.0, 1.0, 0.2), max_corner=(-0.3, 1.9, 0.9))
    wall = CuboidScene(min_corner=(-8.0, 2.6, -8.0), max_corner=(8.0, 3.0, 8.0))

    class Scene:
        def sdf(self, x):
            return jnp.minimum(jnp.minimum(sphere.sdf(x), box.sdf(x)), wall.sdf(x))

        def color(self, x):
            return sphere.color(x)

        def intersect(self, o, d):
            t = sphere.intersect(o, d)
            for s in (box, wall):
                tb = s.intersect(o, d)
                t = jnp.where(jnp.isnan(t), tb,
                              jnp.where(jnp.isnan(tb), t, jnp.minimum(t, tb)))
            return t

    return Scene()


def build_inputs(preset_name=None):
    """Returns (cfg, cam, poses (K+1 list), PTS, NRM, PTS_strided, rgb).

    poses[k] is the groundtruth pose of frame k; PTS[k-1]/NRM[k-1] are the
    camera-frame point/normal images observed at poses[k] for k>=1 (frame 0
    bootstraps the grid directly at poses[0])."""
    from tracking_sdf_tpu.config import preset
    from tracking_sdf_tpu.core.camera import backproject, ros_default_camera
    from tracking_sdf_tpu.core.lie import pose_compose, se3_exp
    from tracking_sdf_tpu.data.synthetic import look_at, render_scene_depth
    from tracking_sdf_tpu.tracking.preprocess import estimate_normals

    # BENCH_PRESET: tum256 (default; the paper's headline config) or
    # tum512 (its high-res config; the paper's 52.7 ms/frame = 19.0 fps)
    cfg = preset(preset_name or os.environ.get("BENCH_PRESET", "tum256"))
    # BENCH_STRIDE: tracking pixel-stride A/B knob (CPU closed loops
    # measure stride 4 MORE accurate than the reference's 3 with ~44%
    # fewer gathered rows/iteration)
    _stride = int(os.environ.get("BENCH_STRIDE", "0"))
    if _stride:
        cfg = dataclasses.replace(
            cfg, tracking=cfg.tracking._replace(pixel_stride=_stride))
    # BENCH_SHARE: "SKxSJ" pixel-share override (A/B knob)
    _share = os.environ.get("BENCH_SHARE")
    if _share:
        sk, sj = (int(v) for v in _share.split("x"))
        cfg = dataclasses.replace(
            cfg, fusion=cfg.fusion._replace(pixel_share=sk, pixel_share_j=sj))
    # BENCH_COLOR_EVERY: temporal color cadence override (A/B knob)
    _ce = int(os.environ.get("BENCH_COLOR_EVERY", "0"))
    if _ce:
        cfg = dataclasses.replace(
            cfg, fusion=cfg.fusion._replace(color_every=_ce))
    # BENCH_DISTANCE: fusion distance override (A/B knob)
    _dist = os.environ.get("BENCH_DISTANCE")
    if _dist:
        cfg = dataclasses.replace(
            cfg, fusion=cfg.fusion._replace(distance=_dist))
    # BENCH_WDTYPE / BENCH_MAXW: weight-accumulator dtype + clamp (A/B).
    # BENCH_MAXW=0 means clamp OFF (None) — the presets now ship 128, so
    # the unclamped baseline must be expressible
    _wdt = os.environ.get("BENCH_WDTYPE")
    if _wdt:
        cfg = dataclasses.replace(
            cfg, fusion=cfg.fusion._replace(weight_dtype=_wdt))
    _mw_env = os.environ.get("BENCH_MAXW")
    if _mw_env is not None:
        cfg = dataclasses.replace(
            cfg, fusion=cfg.fusion._replace(
                max_weight=float(_mw_env) or None))
    # BENCH_FOLD=0: disable free_fold (A/B)
    if os.environ.get("BENCH_FOLD") == "0":
        cfg = dataclasses.replace(
            cfg, fusion=cfg.fusion._replace(free_fold=False))
    # BENCH_SHARE_SAFE=1/0: exact-under-share proof bounds on/off (default
    # ON since round 4; 0 measures the historical share-1-exact bounds —
    # only p2plane configs differ, see share_classify_margin)
    _ss = os.environ.get("BENCH_SHARE_SAFE")
    if _ss is not None:
        cfg = dataclasses.replace(
            cfg, fusion=cfg.fusion._replace(share_safe_classify=_ss == "1"))
    # BENCH_CAP / BENCH_CAP_FREE: brick-cap overrides (A/B knobs)
    for _env, _field in (("BENCH_CAP", "brick_cap"),
                         ("BENCH_CAP_FREE", "brick_cap_free")):
        _v = int(os.environ.get(_env, "0"))
        if _v:
            cfg = dataclasses.replace(
                cfg, fusion=cfg.fusion._replace(**{_field: _v}))
    # BENCH_DAMP_DECAY: LM-style per-iteration damping multiplier (A/B knob)
    _dd = float(os.environ.get("BENCH_DAMP_DECAY", "0"))
    if _dd:
        cfg = dataclasses.replace(
            cfg, tracking=cfg.tracking._replace(damping_decay=_dd))
    # BENCH_PYR: tracking-pyramid override, e.g. "2,1" / "4,2,1" / "flat"
    _pyr = os.environ.get("BENCH_PYR")
    if _pyr:
        levels = (None if _pyr == "flat"
                  else tuple(int(v) for v in _pyr.split(",")))
        cfg = dataclasses.replace(cfg, pyramid_levels=levels)
    # the K-loop statically unrolls the color cadence and needs
    # K % color_every == 0 (else it silently measures color-every-frame:
    # the 22.2-fps "ce=3" trap) — snap K to the largest compatible
    # multiple for this preset
    global K
    _ce_k = getattr(cfg.fusion, "color_every", 1)
    K = _K0
    if _ce_k > 1 and K % _ce_k:
        K = max((K // _ce_k) * _ce_k, _ce_k)
    cam = ros_default_camera()
    scene = make_scene()

    pose0 = look_at((0.0, -0.8, 0.8), (0.0, 1.2, 0.7))
    # TUM fr1-like inter-frame motion: ~13 mm translation + ~0.9 deg
    # rotation per frame, with 30% alternating jitter (the constant-velocity
    # prediction error is then ~30% of the step, not zero).
    xi_base = jnp.asarray([0.008, -0.004, 0.007, 0.007, -0.005, 0.006],
                          jnp.float32)
    poses = [pose0]
    for k in range(1, K + 1):
        xi_k = xi_base * (1.0 + 0.3 * (1.0 if k % 2 == 0 else -1.0))
        poses.append(pose_compose(poses[-1], se3_exp(xi_k)))

    render = jax.jit(lambda p: render_scene_depth(scene, cam, p))
    pts_frames, nrm_frames = [], []
    for k in range(1, K + 1):
        depth = render(poses[k])
        pts = backproject(cam, depth)
        pts_frames.append(pts)
        nrm_frames.append(estimate_normals(pts))
    PTS = jnp.stack(pts_frames)  # (K, H, W, 3)
    NRM = jnp.stack(nrm_frames)
    stride = cfg.tracking.pixel_stride
    PTS_S = PTS[:, ::stride, ::stride].reshape(K, -1, 3)
    rgb = jnp.full(PTS.shape[1:], 0.5, dtype=jnp.float32)
    return cfg, cam, poses, PTS, NRM, PTS_S, rgb


def _emit(fps, preset_name=None, primary=True):
    base = (baseline_fps(preset_name) if preset_name is not None
            else BASELINE_FPS)
    line = json.dumps({
        "metric": "fused_frames_per_s_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / base, 3),
    })
    if primary:
        print(line)
    else:
        # secondary preset line: driver-visible via the recorded stderr
        # tail, while stdout keeps exactly ONE parsed JSON line (tum256)
        print(f"# {preset_name}: {line}", file=sys.stderr)


def _bootstrap(cfg, cam, poses, rgb):
    """Fuse frame 0 at its groundtruth pose into an empty grid."""
    from tracking_sdf_tpu.core.camera import backproject
    from tracking_sdf_tpu.data.synthetic import render_scene_depth
    from tracking_sdf_tpu.fusion.fuse import fuse_frame
    from tracking_sdf_tpu.grid.grid import empty_grid
    from tracking_sdf_tpu.tracking.preprocess import estimate_normals

    depth0 = render_scene_depth(make_scene(), cam, poses[0])
    pts0 = backproject(cam, depth0)
    nrm0 = estimate_normals(pts0)
    grid = empty_grid(cfg.grid)
    return fuse_frame(grid, poses[0], pts0, nrm0, rgb,
                      params=cfg.grid, cam=cam, cfg=cfg.fusion)


def _bootstrap_brickmajor(cfg, cam, poses, rgb, vdt):
    """Fuse frame 0 directly into an empty brick grid.

    The dense _bootstrap at 512^3 materializes a (m^3, C) per-voxel pixel
    buffer (4.3 GB in f32); brickmajor fusion of the same frame stays
    within the brick caps' footprint. Caps are the preset's steady-state
    caps; overflow (frame 0 can exceed cap_free) is the same REPORTED
    behavior as any other frame."""
    from tracking_sdf_tpu.core.camera import backproject
    from tracking_sdf_tpu.data.synthetic import render_scene_depth
    from tracking_sdf_tpu.fusion.brickmajor import (
        empty_brick_grid, fuse_frame_brickmajor)
    from tracking_sdf_tpu.tracking.preprocess import estimate_normals

    depth0 = render_scene_depth(make_scene(), cam, poses[0])
    pts0 = backproject(cam, depth0)
    nrm0 = estimate_normals(pts0)
    wdt = (jnp.bfloat16 if cfg.fusion.weight_dtype == "bfloat16" else None)
    bg = empty_brick_grid(cfg.grid, (8, 8, 8), value_dtype=vdt,
                          weight_dtype=wdt)
    fcfg = cfg.fusion
    bg, _, stats = fuse_frame_brickmajor(
        bg, poses[0], pts0, nrm0, rgb, params=cfg.grid, cam=cam, cfg=fcfg,
        bs=(8, 8, 8), cap=fcfg.brick_cap,
        cap_free=fcfg.brick_cap_free or None, emit_dm=False)
    ovf, ovf_act = int(stats.overflow), int(stats.overflow_active)
    if ovf or ovf_act:
        # overflow is REPORTED, never silent: frame 0's frustum can exceed
        # the steady-state caps, which would carve a differently-initialized
        # grid than the dense bootstrap
        print(f"# bootstrap brick overflow: {ovf} FULL / {ovf_act} FREE "
              f"bricks dropped (caps {fcfg.brick_cap}/"
              f"{fcfg.brick_cap_free or fcfg.brick_cap})", file=sys.stderr)
    return bg


def _frame_fn(cfg, cam):
    """One tracked+fused frame, initialized at the previous pose (the
    reference's scheme and the config default — constant-velocity
    extrapolation measures UNSTABLE for frame-to-model tracking, see
    PipelineConfig.pose_init)."""
    from tracking_sdf_tpu.fusion.brick import fuse_frame_bricked
    from tracking_sdf_tpu.tracking.gauss_newton import track_frame

    params, tcfg = cfg.grid, cfg.tracking
    fcfg = cfg.fusion._replace(mode="bricked")

    def frame(grid, pose_prev2, pose_prev, pts_s, pts, nrm, rgb):
        res = track_frame(grid, pose_prev, pts_s, params=params, cfg=tcfg)
        grid, _ = fuse_frame_bricked(
            grid, res.pose, pts, nrm, rgb, params=params, cam=cam,
            cfg=fcfg, bs=fcfg.brick_shape, cap=fcfg.brick_cap)
        return grid, res
    return frame


def _frame_fn_brickmajor(cfg, cam):
    """Brick-major state variant: carries (bgrid, Dm) instead of the dense
    grid; Dm is the zero-copy BrickMaskedView — tracking gathers corners
    straight from the brick rows, so no relayout pass exists anywhere.
    Tracking runs the preset's coarse-to-fine pyramid when configured —
    the coarse stride-6 pass absorbs nearly all GN iterations at ~equal
    per-iteration cost but leaves only ~1.6 full-res iterations/frame."""
    from tracking_sdf_tpu.fusion.brickmajor import fuse_frame_brickmajor
    from tracking_sdf_tpu.tracking.gauss_newton import track_frame
    from tracking_sdf_tpu.tracking.pyramid import track_frame_pyramid

    params, tcfg = cfg.grid, cfg.tracking
    fcfg = cfg.fusion._replace(mode="bricked")
    bs = (8, 8, 8)

    def frame(state, pose_prev2, pose_prev, pts_s, pts, nrm, rgb,
              color_on=True):
        """color_on is a PYTHON static (no lax.cond color gate): the
        K-loop unrolls the color_every cadence into static on/off
        frames."""
        bgrid, Dm = state
        if cfg.pyramid_levels:
            res, _ = track_frame_pyramid(
                None, pose_prev, pts, params=params, cfg=tcfg,
                levels=cfg.pyramid_levels, Dm=Dm)
        else:
            res = track_frame(None, pose_prev, pts_s, params=params,
                              cfg=tcfg, Dm=Dm)
        bgrid, Dm, _ = fuse_frame_brickmajor(
            bgrid, res.pose, pts, nrm, rgb if color_on else None,
            params=params, cam=cam,
            cfg=fcfg._replace(fuse_color=bool(color_on)), bs=bs,
            cap=fcfg.brick_cap, cap_free=fcfg.brick_cap_free or None,
            emit_dm="view")
        return (bgrid, Dm), res
    return frame


def _frame_fn_packed(cfg, cam):
    """Packed single-array variant: the grid is ONE (NB, 6, BV) array, the
    merge is one gather + one scatter over all channels (fusion.packed), and
    Dm is the zero-copy pitch view over the same storage."""
    from tracking_sdf_tpu.fusion.packed import fuse_frame_packed
    from tracking_sdf_tpu.tracking.gauss_newton import track_frame
    from tracking_sdf_tpu.tracking.pyramid import track_frame_pyramid

    params, tcfg = cfg.grid, cfg.tracking
    fcfg = cfg.fusion._replace(mode="bricked")
    bs = (8, 8, 8)

    def frame(state, pose_prev2, pose_prev, pts_s, pts, nrm, rgb):
        pgrid, Dm = state
        if cfg.pyramid_levels:
            res, _ = track_frame_pyramid(
                None, pose_prev, pts, params=params, cfg=tcfg,
                levels=cfg.pyramid_levels, Dm=Dm)
        else:
            res = track_frame(None, pose_prev, pts_s, params=params,
                              cfg=tcfg, Dm=Dm)
        pgrid, Dm, _ = fuse_frame_packed(
            pgrid, res.pose, pts, nrm, rgb, params=params, cam=cam,
            cfg=fcfg, bs=bs, cap=fcfg.brick_cap,
            cap_free=fcfg.brick_cap_free or None,
            emit_dm="view")
        return (pgrid, Dm), res
    return frame


def _print_breakdown(cfg, cam, state, poses, PTS, NRM, PTS_S, rgb, frame_ms):
    """Per-phase split of the headline: a fuse-only on-device K-loop on the
    warmed state; track = frame - fuse. Fuse-only (not track-only) because
    fusion cost is pose-insensitive while a track-only loop re-tracks from
    stale poses and inflates the GN iteration count ~3x. One extra compile
    (cached across runs)."""
    from tracking_sdf_tpu.fusion.brickmajor import fuse_frame_brickmajor

    params = cfg.grid
    fcfg = cfg.fusion._replace(mode="bricked")
    bgrid, _ = state

    @jax.jit
    def fuse_k(bg, pose):
        def body(k, bg):
            # k-dependent inputs (PTS[k]) keep XLA from hoisting the body
            bg2, _, _ = fuse_frame_brickmajor(
                bg, pose, PTS[k % K], NRM[k % K], rgb, params=params,
                cam=cam, cfg=fcfg, bs=(8, 8, 8), cap=fcfg.brick_cap,
                cap_free=fcfg.brick_cap_free or None, emit_dm="view")
            return bg2
        return jax.lax.fori_loop(0, K, body, bg)

    out = fuse_k(bgrid, poses[0])
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        out = fuse_k(out, poses[0])
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / K)
    fuse_ms = best * 1e3
    ce = getattr(cfg.fusion, "color_every", 1)
    note = (f" (fuse row = color-ON cost; preset fuses color every "
            f"{ce} frames)" if ce > 1 else "")
    print(f"# breakdown: fuse {fuse_ms:.1f} ms + "
          f"track ~{frame_ms - fuse_ms:.1f} ms = {frame_ms:.1f} ms/frame"
          f"{note}", file=sys.stderr)

    # ---- end-to-end: + bilateral filter + normal estimation ---------------
    # The reference's per-frame callback includes preprocessing
    # (sdf_reconstruction.cpp:36-49); the headline above (like the paper's
    # 23 ms §V-E scope) covers track+fuse only, so also report the full
    # per-frame cost with the 11x11 bilateral + integral-normals included.
    from tracking_sdf_tpu.data.synthetic import render_scene_depth
    from tracking_sdf_tpu.tracking.preprocess import preprocess_frame

    scene = make_scene()
    DEPTH = jnp.stack([render_scene_depth(scene, cam, poses[k])
                       for k in range(1, K + 1)])

    @jax.jit
    def prep_k(D):
        def body(k, acc):
            pts, nrm = preprocess_frame(
                D[k % K], cam=cam, bilateral=True,
                bilateral_mode=getattr(cfg, "bilateral_mode", "full"))
            # full reductions force the whole chain (a scalar probe would
            # let XLA slice away most of the work)
            return acc + jnp.nansum(nrm[..., 0]) + jnp.nansum(pts[..., 2])
        return jax.lax.fori_loop(0, K, body, jnp.float32(0.0))

    float(prep_k(DEPTH))
    best = float("inf")
    for rep in range(1, 3):
        # vary inputs per rep (identical re-dispatches could be served
        # from a cached result) and fetch a value to stop the clock
        d_rep = DEPTH + jnp.float32(1e-6 * rep)
        t0 = time.perf_counter()
        float(prep_k(d_rep))
        best = min(best, (time.perf_counter() - t0) / K)
    prep_ms = best * 1e3
    e2e = frame_ms + prep_ms
    print(f"# end-to-end: preprocess {prep_ms:.1f} ms -> "
          f"{e2e:.1f} ms/frame = {1000.0 / e2e:.1f} fps incl. "
          f"bilateral+normals", file=sys.stderr)

    # ---- FUSED end-to-end: prep+track+fuse in ONE program -----------------
    # The additive number above pays each program's own launch and memory
    # passes. The real pipeline can run preprocessing inside the same XLA
    # program as track+fuse, where its elementwise passes may overlap the
    # tracking gathers — the analogue of the reference's concurrent
    # preprocessing nodelets (launch/kinect_normal.launch). Same math, same
    # per-frame semantics.
    frame = _frame_fn_brickmajor(cfg, cam)
    stride = cfg.tracking.pixel_stride

    ce_e = getattr(cfg.fusion, "color_every", 1)
    ce_e = ce_e if ce_e > 1 and K % ce_e == 0 else 1

    @jax.jit
    def e2e_k(state, pose_prev2, pose_prev, D, eps):
        def body(j, carry):
            state, p2, p1 = carry
            for r in range(ce_e):
                k = j * ce_e + r
                pts, nrm = preprocess_frame(
                    D[k % K] + eps * (k + 1), cam=cam, bilateral=True,
                    bilateral_mode=getattr(cfg, "bilateral_mode", "full"))
                pts_s = pts[::stride, ::stride].reshape(-1, 3)
                state, res = frame(state, p2, p1, pts_s, pts, nrm, rgb,
                                   color_on=(r == 0))
                p2, p1 = p1, res.pose
            return (state, p2, p1)
        return jax.lax.fori_loop(0, K // ce_e, body,
                                 (state, pose_prev2, pose_prev))

    st = state
    out = e2e_k(st, poses[0], poses[0], DEPTH, jnp.float32(0.0))
    _ = float(jax.tree_util.tree_leaves(out[0])[0].ravel()[0])
    best = float("inf")
    for rep in range(1, 3):
        t0 = time.perf_counter()
        out = e2e_k(out[0], poses[0], poses[0], DEPTH, jnp.float32(rep * 1e-7))
        _ = float(jax.tree_util.tree_leaves(out[0])[0].ravel()[0])
        best = min(best, (time.perf_counter() - t0) / K)
    print(f"# end-to-end FUSED (one program): {best*1e3:.1f} ms/frame = "
          f"{1000.0 / (best*1e3):.1f} fps incl. bilateral+normals",
          file=sys.stderr)


def main(preset_name=None, primary=True):
    cfg, cam, poses, PTS, NRM, PTS_S, rgb = build_inputs(preset_name)
    mode = os.environ.get("BENCH_MODE", "brickmajor")
    if mode == "brickmajor":
        from tracking_sdf_tpu.fusion.brickmajor import (
            brick_grid_from_dense, brick_masked_view)

        # BENCH_DTYPE overrides the preset's storage_dtype (A/B knob):
        # bfloat16 or float32; unset -> preset default
        _dt = os.environ.get("BENCH_DTYPE", cfg.fusion.storage_dtype)
        if _dt not in ("bfloat16", "float32"):
            raise ValueError(
                f"BENCH_DTYPE must be 'bfloat16' or 'float32', got {_dt!r}"
                " — refusing to measure the wrong variant silently")
        vdt = jnp.bfloat16 if _dt == "bfloat16" else None
        frame = _frame_fn_brickmajor(cfg, cam)
        if cfg.grid.m >= 512:
            # dense bootstrap OOMs at 512^3 — see _bootstrap_brickmajor
            bg0 = _bootstrap_brickmajor(cfg, cam, poses, rgb, vdt)
        else:
            dense0 = _bootstrap(cfg, cam, poses, rgb)
            bg0 = brick_grid_from_dense(
                dense0, (8, 8, 8), value_dtype=vdt,
                weight_dtype=(jnp.bfloat16
                              if cfg.fusion.weight_dtype == "bfloat16"
                              else None))
        state0 = (bg0, brick_masked_view(bg0, cfg.grid, (8, 8, 8)))
    elif mode == "packed":
        from tracking_sdf_tpu.fusion.packed import (
            packed_from_dense, packed_masked_view)

        frame = _frame_fn_packed(cfg, cam)
        pg0 = packed_from_dense(_bootstrap(cfg, cam, poses, rgb), (8, 8, 8))
        state0 = (pg0, packed_masked_view(pg0, cfg.grid, (8, 8, 8)))
    else:
        frame = _frame_fn(cfg, cam)
        state0 = _bootstrap(cfg, cam, poses, rgb)

    # color_every cadence: statically unroll ce frames per loop iteration
    # (frame 0 of each group fuses color) — python-static on/off, no
    # lax.cond gate
    ce = getattr(cfg.fusion, "color_every", 1)
    ce = ce if ce > 1 and K % ce == 0 else 1

    @jax.jit
    def run_k(state, pose_prev2, pose_prev):
        def body(j, carry):
            state, p2, p1, iters = carry
            for r in range(ce):
                k = j * ce + r
                state, res = frame(state, p2, p1, PTS_S[k], PTS[k], NRM[k],
                                   rgb, color_on=(r == 0))
                p2, p1 = p1, res.pose
                iters = iters + res.iterations
            return (state, p2, p1, iters)
        return jax.lax.fori_loop(
            0, K // ce, body, (state, pose_prev2, pose_prev, jnp.int32(0)))

    jax.block_until_ready(jax.tree_util.tree_leaves(state0)[0])
    state, _, pose_out, iters = run_k(state0, poses[0], poses[0])  # compile+warm
    jax.block_until_ready(jax.tree_util.tree_leaves(state)[0])
    # accuracy from the CLEAN warmup run: the timing reps below re-track the
    # same frames against an already-multiply-fused grid from poses[0], so
    # their trajectory error is a harness artifact, not pipeline drift
    err = float(jnp.linalg.norm(pose_out.t - poses[K].t))
    it = int(iters)

    best_dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        s, _, p_out, _ = run_k(state, poses[0], poses[0])
        _ = float(jax.tree_util.tree_leaves(s)[0].ravel()[0])  # force materialization
        best_dt = min(best_dt, (time.perf_counter() - t0) / K)
        state = s

    fps = 1.0 / best_dt
    d = jax.devices()[0]
    if primary:
        from tracking_sdf_tpu.utils.gpu import card_line

        print(f"# card: {card_line()}; {d.platform}:{d.device_kind}")
    _emit(fps, preset_name, primary)
    base = baseline_fps(preset_name) if preset_name is not None else BASELINE_FPS
    print(
        f"# {d.platform}:{d.device_kind} m={cfg.grid.m} K={K} on-device loop, "
        f"mode={mode} track(stride {cfg.tracking.pixel_stride})+fuse(color, "
        f"pixel_share={cfg.fusion.pixel_share}x{cfg.fusion.pixel_share_j}) "
        f"{best_dt*1e3:.1f} ms/frame, {int(it)} GN iters/{K} frames, "
        f"final |t err| {err*1e3:.1f} mm (baseline {base:.1f} fps)",
        file=sys.stderr,
    )
    if (primary and mode == "brickmajor"
            and os.environ.get("BENCH_BREAKDOWN", "1") != "0"):
        _print_breakdown(cfg, cam, state, poses, PTS, NRM, PTS_S, rgb,
                         best_dt * 1e3)


if __name__ == "__main__":
    from tracking_sdf_tpu.utils.compile_cache import enable_compile_cache
    from tracking_sdf_tpu.utils.gpu import require_gpu

    enable_compile_cache()
    require_gpu("bench.py")
    main()
    # A plain `python bench.py` also measures tum512 and prints its fps to
    # STDERR; stdout keeps exactly one parsed JSON line (tum256). Skipped
    # when BENCH_PRESET pins a preset or BENCH_SECOND=0. In-process: one
    # JAX process per card.
    if (not os.environ.get("BENCH_PRESET")
            and os.environ.get("BENCH_SECOND", "1") != "0"):
        main(preset_name="tum512", primary=False)
