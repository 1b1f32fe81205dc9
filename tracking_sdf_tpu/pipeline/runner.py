"""End-to-end reconstruction runner: the reference's frame loop.

Plays the role of SDF_Reconstruction + kinect_callback
(sdf_reconstruction.cpp:21-110): per frame — preprocess (bilateral filter,
backprojection, normal estimation), track from frame 2 (or take the pose
from groundtruth, the fusion-only oracle mode of sdf_reconstruction.cpp:51-66),
append the pose to a TUM trajectory file, fuse. Meshing runs synchronously
every `mesh_every` frames on the CURRENT grid snapshot — the functional
replacement for the reference's intentionally-racy 1 Hz visualization thread
(sdf.cpp:317-391; SURVEY.md §5 "race detection": purity removes the race).

Single-device by default; pass a `jax.sharding.Mesh` to run the SPMD path
(slab-sharded grid + psum'd tracking) on every device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tracking_sdf_tpu.config import PipelineConfig
from tracking_sdf_tpu.core.camera import PinholeCamera
from tracking_sdf_tpu.core.lie import (
    Pose,
    matrix_from_quaternion,
    pose_compose,
    pose_inverse,
)
from tracking_sdf_tpu.fusion.fuse import make_fuse_fn
from tracking_sdf_tpu.grid.grid import TSDFGrid, empty_grid
from tracking_sdf_tpu.pipeline.trajectory import TrajectoryWriter
from tracking_sdf_tpu.tracking.gauss_newton import track_frame
from tracking_sdf_tpu.tracking.preprocess import preprocess_frame

# Initial pose modeled on the reference (camera_tracking.cpp:5-7): camera z
# forward along world -y, 1 m up — appropriate for the TUM sequences' first
# frame in the grid volume. DELIBERATE deviation: the reference's literal
# rot (1,0,0, 0,0,-1, 0,-1,0) has det = -1 — a REFLECTION, not a rotation —
# which poisons every downstream pose (GN composes proper rotations onto
# it, so det stays -1 for the whole run) and makes quaternion trajectory
# export mathematically invalid (an improper matrix has no quaternion; the
# export would silently emit garbage orientations). We flip the third
# row's sign to the proper rotation with the same camera-z axis.
REFERENCE_INITIAL_POSE = Pose(
    R=jnp.asarray([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]], jnp.float32),
    t=jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
)


def _pyramid_tracker(make, config: PipelineConfig):
    """fn(target, pose0, points_img) running the config's coarse-to-fine
    schedule (one level when it has no pyramid) — what track_frame_pyramid
    does single-device — over trackers ``make(level_cfg)`` that take
    ``(target, pose, points (N, 3))``. The sharded paths use it, so one
    preset tracks the same way on one device and on a mesh."""
    from tracking_sdf_tpu.tracking.pyramid import pyramid_schedule

    schedule = pyramid_schedule(config.tracking,
                                config.pyramid_levels or (1,))
    levels = [(stride, make(level_cfg)) for stride, level_cfg in schedule]

    def track(target, pose, points_img):
        for stride, fn in levels:
            res = fn(target, pose,
                     points_img[::stride, ::stride].reshape(-1, 3))
            pose = res.pose
        return res
    return track


@dataclasses.dataclass
class FrameStats:
    index: int
    timestamp: float
    track_ms: float
    fuse_ms: float
    gn_iterations: int
    num_valid: int
    mean_abs_residual: float
    rejected: bool = False  # tracking-failure gate fired; frame dropped


class Reconstruction:
    """Stateful frame-loop host: owns the grid, pose, and trajectory file."""

    def __init__(
        self,
        cam: PinholeCamera,
        config: PipelineConfig = PipelineConfig(),
        initial_pose: Optional[Pose] = None,
        mesh: Optional[Any] = None,  # jax.sharding.Mesh for the SPMD path
    ):
        self.cam = cam
        self.config = config
        self.pose = initial_pose if initial_pose is not None else REFERENCE_INITIAL_POSE
        # previous frame's pose, for the constant-velocity prediction
        # (config.pose_init="velocity"); None = no velocity estimate yet
        self._pose_prev: Optional[Pose] = None
        self.frame_num = 0
        self.stats: List[FrameStats] = []
        self._writer = (
            TrajectoryWriter(config.trajectory_path)
            if config.trajectory_path
            else None
        )
        self._mesh = mesh
        # brick-major state (mode="brickmajor", single-device): the grid
        # lives as (NB, BV) brick rows + a zero-copy BrickMaskedView that
        # tracking interpolates from directly (no per-frame relayout).
        self._bgrid = None
        self._dm = None
        # what self._track consumes: grid | bgrid_d (sharded brick rows)
        self._track_input = "grid"
        if mesh is None and config.fusion.mode in ("brickmajor", "packed"):
            self._bs = config.fusion.brick_shape
            if config.fusion.mode == "packed":
                from tracking_sdf_tpu.fusion.packed import (
                    dense_from_packed,
                    empty_packed_grid,
                    packed_from_dense,
                    packed_masked_view,
                )

                self._bgrid = empty_packed_grid(config.grid, self._bs)
                self._bm_view = lambda bg: packed_masked_view(
                    bg, config.grid, self._bs)
                self._bm_to_dense = lambda bg: dense_from_packed(
                    bg, config.grid, self._bs)
                self._bm_from_dense = lambda g: packed_from_dense(g, self._bs)
            else:
                from tracking_sdf_tpu.fusion.brickmajor import (
                    brick_grid_from_dense,
                    brick_masked_view,
                    dense_from_brick_grid,
                    empty_brick_grid,
                )

                vdt = (jnp.bfloat16
                       if config.fusion.storage_dtype == "bfloat16" else None)
                wdt = (jnp.bfloat16
                       if getattr(config.fusion, "weight_dtype", "float32")
                       == "bfloat16" else None)
                self._bgrid = empty_brick_grid(config.grid, self._bs,
                                               value_dtype=vdt,
                                               weight_dtype=wdt)
                self._bm_view = lambda bg: brick_masked_view(
                    bg, config.grid, self._bs)
                self._bm_to_dense = lambda bg: dense_from_brick_grid(
                    bg, config.grid, self._bs)
                self._bm_from_dense = lambda g: brick_grid_from_dense(
                    g, self._bs, value_dtype=vdt, weight_dtype=wdt)
            self._dm = self._bm_view(self._bgrid)
        # saturated-FREE skip state (FusionConfig.sat_skip, round 5): a
        # per-brick bitset carried across frames (single-device brickmajor
        # paths). NOT checkpointed: restoring all-False is exact — skipped
        # updates were no-ops, so re-running them until bricks re-prove
        # saturation reproduces the identical grid.
        self._sat = None
        if (getattr(config.fusion, "sat_skip", False)
                and config.fusion.mode == "brickmajor" and mesh is None):
            bi_, bj_, bk_ = self._bs
            m_ = config.grid.m
            self._sat = jnp.zeros(
                ((m_ // bi_) * (m_ // bj_) * (m_ // bk_),), bool)
        if mesh is not None:
            from tracking_sdf_tpu.parallel import (
                shard_grid,
                sharded_fuse_frame,
                sharded_fuse_frame_bricked,
                sharded_track_frame,
            )

            fcfg = config.fusion
            if fcfg.mode == "brickmajor":
                # sharded BRICK-MAJOR: contiguous brick-row slabs per device,
                # per-slab classify+merge (zero collectives), per-slab Dm
                # relayout feeding the masked-slab tracking (see
                # parallel.sharded.sharded_fuse_frame_brickmajor)
                self._init_sharded_brickmajor(mesh, cam, fcfg)
            else:
                self.grid: TSDFGrid = shard_grid(empty_grid(config.grid), mesh)
                if fcfg.mode == "packed":
                    # packed stays single-device; map to the flat-layout
                    # bricked equivalent with its best measured brick shape
                    # that still divides the grid (m < 128 presets)
                    bs = (1, 8, 128)
                    if any(config.grid.m % b for b in bs):
                        bs = (1, 8, min(128, config.grid.m))
                    fcfg = fcfg._replace(mode="bricked", brick_shape=bs)
                if fcfg.mode == "bricked":
                    fuse_b = sharded_fuse_frame_bricked(
                        mesh, params=config.grid, cam=cam, cfg=fcfg
                    )

                    def fuse(grid, pose, pts, normals, rgb):
                        grid, stats = fuse_b(grid, pose, pts, normals, rgb)
                        self.last_fuse_stats = stats
                        return grid

                    self._fuse = fuse
                else:
                    self._fuse = sharded_fuse_frame(
                        mesh, params=config.grid, cam=cam, cfg=config.fusion
                    )
                self._track = _pyramid_tracker(
                    lambda c: sharded_track_frame(
                        mesh, params=config.grid, cfg=c), config)
        elif self._bgrid is not None:
            if config.fusion.mode == "packed":
                from tracking_sdf_tpu.fusion.packed import (
                    fuse_frame_packed as _fuse_kernel,
                )
            else:
                from tracking_sdf_tpu.fusion.brickmajor import (
                    fuse_frame_brickmajor as _fuse_kernel,
                )

            cap_max = config.fusion.brick_cap
            self._cap_levels = sorted({max(256, cap_max // 4),
                                       max(256, cap_max // 2), cap_max})
            self._cap_idx = len(self._cap_levels) - 1

            def fuse_bm(pose, pts, normals, rgb):
                cap = self._cap_levels[self._cap_idx]
                kw = {}
                if self._sat is not None:  # brickmajor-only (init guard)
                    kw["sat"] = self._sat
                out = _fuse_kernel(
                    self._bgrid, pose, pts, normals, rgb,
                    params=config.grid, cam=cam, cfg=config.fusion,
                    bs=self._bs, cap=cap,
                    cap_free=config.fusion.brick_cap_free or None,
                    emit_dm="view", **kw,
                )
                if self._sat is not None:
                    self._bgrid, self._dm, stats, self._sat = out
                else:
                    self._bgrid, self._dm, stats = out
                self.last_fuse_stats = stats
                need = int(stats.n_full) * 1.3
                self._cap_idx = next(
                    (i for i, c in enumerate(self._cap_levels) if c >= need),
                    len(self._cap_levels) - 1,
                )

            self._fuse_bm = fuse_bm
            self._track = None
        else:
            self.grid = empty_grid(config.grid)
            if config.fusion.mode == "bricked":
                from tracking_sdf_tpu.fusion.brick import fuse_frame_bricked

                # Adaptive cap: gather/scatter cost scales with the PADDED
                # cap, so pick the smallest of three jit-cached levels that
                # covers ~1.3x the previous frame's FULL-brick count
                # (scenes change slowly; overflow is reported and escalates
                # the next frame).
                cap_max = config.fusion.brick_cap
                self._cap_levels = sorted({max(256, cap_max // 4),
                                           max(256, cap_max // 2), cap_max})
                self._cap_idx = len(self._cap_levels) - 1

                def fuse(grid, pose, pts, normals, rgb):
                    cap = self._cap_levels[self._cap_idx]
                    grid, stats = fuse_frame_bricked(
                        grid, pose, pts, normals, rgb,
                        params=config.grid, cam=cam, cfg=config.fusion,
                        bs=config.fusion.brick_shape, cap=cap,
                    )
                    self.last_fuse_stats = stats
                    need = int(stats.n_full) * 1.3
                    self._cap_idx = next(
                        (i for i, c in enumerate(self._cap_levels) if c >= need),
                        len(self._cap_levels) - 1,
                    )
                    return grid

                self._fuse = fuse
            else:
                self._fuse = make_fuse_fn(config.grid, cam, config.fusion)
            self._track = None  # dense path calls track_frame directly
        self.last_fuse_stats = None
        self._publisher = None
        self._chunk_cache: Dict[Any, Any] = {}  # process_chunk jit cache
        # per-chunk-key measured (prep_ms, fuse_ms) per frame — the phase
        # split of chunked metrics
        self._chunk_calib: Dict[Any, Any] = {}

    # ------------------------------------------------------------------ #

    def _init_sharded_brickmajor(self, mesh, cam, fcfg) -> None:
        """Distributed brick-major state: brick-row slabs, zero relayout.

        Fusion updates only the sharded brick rows (emit_dm=False); tracking
        gathers corners straight from the sharded bgrid.D leaf via
        sharded_track_frame_brickmajor (one ppermute'd brick-layer halo) —
        the distributed analogue of the single-device emit_dm="view" path,
        with no per-frame slab-dense Dm relayout."""
        from tracking_sdf_tpu.fusion.brickmajor import (
            brick_grid_from_dense,
            dense_from_brick_grid,
            empty_brick_grid,
        )
        from tracking_sdf_tpu.parallel import (
            shard_brick_grid,
            sharded_fuse_frame_brickmajor,
            sharded_track_frame_brickmajor,
        )

        config = self.config
        bs = self._bs = fcfg.brick_shape
        vdt = jnp.bfloat16 if fcfg.storage_dtype == "bfloat16" else None
        wdt = (jnp.bfloat16
               if getattr(fcfg, "weight_dtype", "float32") == "bfloat16"
               else None)
        self._bgrid = shard_brick_grid(
            empty_brick_grid(config.grid, bs, value_dtype=vdt,
                             weight_dtype=wdt), mesh)
        self._bm_to_dense = lambda bg: dense_from_brick_grid(
            bg, config.grid, bs)
        self._bm_from_dense = lambda g: shard_brick_grid(
            brick_grid_from_dense(g, bs, value_dtype=vdt, weight_dtype=wdt),
            mesh)
        self._dm = None  # tracking reads bgrid.D rows directly

        # built lazily keyed on color presence: fuse_color is baked into the
        # shard_map (the single-device path adapts per call the same way)
        fuse_cache = {}

        def fuse_bm(pose, pts, normals, rgb):
            has_color = fcfg.fuse_color and rgb is not None
            fuse_sh = fuse_cache.get(has_color)
            if fuse_sh is None:
                cfg_k = fcfg if has_color else fcfg._replace(fuse_color=False)
                # every shard gets the whole frame's caps: one slab may
                # hold all of a frame's FULL or FREE bricks, and a split
                # cap would drop bricks that one device fuses
                fuse_sh = fuse_cache[has_color] = sharded_fuse_frame_brickmajor(
                    mesh, params=config.grid, cam=cam, cfg=cfg_k,
                    cap=fcfg.brick_cap,
                    cap_free=fcfg.brick_cap_free or None,
                    emit_dm=False,
                )
            self._bgrid, _, stats = fuse_sh(
                self._bgrid, pose, pts, normals, rgb)
            self.last_fuse_stats = stats

        self._fuse_bm = fuse_bm
        self._track = _pyramid_tracker(
            lambda c: sharded_track_frame_brickmajor(
                mesh, params=config.grid, cfg=c, bs=bs), config)
        self._track_input = "bgrid_d"

    @property
    def grid(self) -> TSDFGrid:
        """Dense (m, m, m) grid view. In brick-major mode this MATERIALIZES
        the dense layout from the brick rows (one transpose pass) — cheap at
        mesh/checkpoint/render rates, not meant for per-frame hot paths."""
        if self._bgrid is not None:
            return self._bm_to_dense(self._bgrid)
        return self._grid

    @grid.setter
    def grid(self, g: TSDFGrid) -> None:
        if getattr(self, "_bgrid", None) is not None:
            self._bgrid = self._bm_from_dense(g)
            # sharded brickmajor tracks off bgrid.D directly (no view cache)
            if getattr(self, "_bm_view", None) is not None:
                self._dm = self._bm_view(self._bgrid)
        else:
            self._grid = g

    def _predict_pose(self) -> Pose:
        """Initial pose guess for the next frame's GN descent.

        "velocity" assumes the camera-frame inter-frame motion repeats:
        T_init = T_{n-1} ∘ (T_{n-2}^{-1} ∘ T_{n-1}). The reference always
        starts at the previous pose (camera_tracking.cpp:66-79)."""
        if self.config.pose_init == "velocity" and self._pose_prev is not None:
            delta = pose_compose(pose_inverse(self._pose_prev), self.pose)
            return pose_compose(self.pose, delta)
        return self.pose

    def process_frame(
        self,
        depth: jnp.ndarray,  # (H, W) meters, NaN holes
        rgb: Optional[jnp.ndarray] = None,  # (H, W, 3) in [0, 1]
        timestamp: Optional[float] = None,
        gt_pose: Optional[Pose] = None,
    ) -> FrameStats:
        """Run the full per-frame pipeline; returns timing/optimizer stats."""
        cfg = self.config
        self.frame_num += 1
        timestamp = float(timestamp) if timestamp is not None else float(self.frame_num)

        # TUM wire formats (native raw stream / process_chunk input):
        # convert on host — the per-frame path is link-bound anyway
        depth = np.asarray(depth)
        if depth.dtype == np.uint16:
            d = depth.astype(np.float32) / 5000.0
            d[depth == 0] = np.nan
            depth = d
        if rgb is not None and np.asarray(rgb).dtype == np.uint8:
            rgb = np.asarray(rgb).astype(np.float32) / 255.0

        points, normals = preprocess_frame(
            jnp.asarray(depth), cam=self.cam, bilateral=cfg.bilateral_filter,
            bilateral_mode=getattr(cfg, "bilateral_mode", "full"),
        )

        gn_iters, nvalid, mean_res = 0, 0, 0.0
        rejected = False
        t0 = time.perf_counter()
        if cfg.use_groundtruth:
            if gt_pose is not None:
                # fusion-only oracle mode (sdf_reconstruction.cpp:51-66)
                self._pose_prev = self.pose
                self.pose = gt_pose
            else:
                # groundtruth gap (no association within max_dt): DROP the
                # frame like the reference's tf-timeout path
                # (sdf_reconstruction.cpp:57-60) — falling through to GN
                # tracking would mix tracked poses into a gt-only run
                rejected = True
                self._pose_prev = None
        elif self.frame_num > 1:
            pose0 = self._predict_pose()
            # brick-major mode: track against the Dm view emitted by the
            # last fusion (no dense grid materialization in the hot loop).
            # self.grid is a MATERIALIZING property in that mode — only
            # touch it inside the branches that consume it.
            bm = self._bgrid is not None and cfg.tracking.jacobian == "analytic"
            dm = self._dm if bm else None
            if self._track is not None:
                target = (self._bgrid.D if self._track_input == "bgrid_d"
                          else self.grid)
                res = self._track(target, pose0, points)
            elif cfg.pyramid_levels:
                from tracking_sdf_tpu.tracking.pyramid import track_frame_pyramid

                res, _ = track_frame_pyramid(
                    None if bm else self.grid, pose0, points, params=cfg.grid,
                    cfg=cfg.tracking, levels=cfg.pyramid_levels, Dm=dm,
                )
            else:
                pts = points[:: cfg.tracking.pixel_stride, :: cfg.tracking.pixel_stride]
                res = track_frame(
                    None if bm else self.grid, pose0, pts.reshape(-1, 3),
                    params=cfg.grid, cfg=cfg.tracking, Dm=dm,
                )
            jax.block_until_ready(res.pose.t)
            gn_iters = int(res.iterations)
            nvalid = int(res.num_valid)
            mean_res = float(res.mean_abs_residual)
            # failure gate: a diverged/starved track must not poison the
            # grid — revert the pose and drop the frame (like the
            # reference's tf-timeout path, sdf_reconstruction.cpp:57-60)
            rejected = nvalid < cfg.min_valid_pixels or (
                cfg.max_mean_residual > 0 and mean_res > cfg.max_mean_residual
            ) or not bool(jnp.all(jnp.isfinite(res.pose.t)))
            if not rejected:
                self._pose_prev = self.pose
                self.pose = res.pose
            else:
                # the velocity estimate is stale once a frame is dropped
                self._pose_prev = None
        track_ms = (time.perf_counter() - t0) * 1e3

        if self._writer is not None and not rejected:
            self._writer.write(timestamp, self.pose)

        t0 = time.perf_counter()
        if not rejected:
            rgb_j = jnp.asarray(rgb) if rgb is not None else None
            # temporal color subsampling (FusionConfig.color_every): color
            # fuses on every Nth frame only; rgb=None selects the no-color
            # program (same grid structure, color leaves untouched)
            ce = getattr(cfg.fusion, "color_every", 1)
            if ce > 1 and rgb_j is not None and self.frame_num % ce:
                rgb_j = None
            if self._bgrid is not None:
                self._fuse_bm(self.pose, points, normals, rgb_j)
                jax.block_until_ready(self._bgrid)
            else:
                self.grid = self._fuse(self.grid, self.pose, points, normals, rgb_j)
                jax.block_until_ready(self.grid.D)
        fuse_ms = (time.perf_counter() - t0) * 1e3

        if self._publisher is not None and not rejected:
            # host-side rate gate: snapshotting costs a dense materialize
            # (brick-major property) + a ~400 MB device copy at 256^3;
            # don't pay it ~50x/s when the publisher consumes one snapshot
            # per interval
            now = time.perf_counter()
            # effective_interval: follows the publisher's auto-degraded rate
            # so snapshot copies aren't paid for exports that can't keep up
            if now - self._last_publish >= self._publisher.effective_interval:
                self._publisher.publish(self.grid)
                self._last_publish = now

        stat = FrameStats(
            index=self.frame_num, timestamp=timestamp, track_ms=track_ms,
            fuse_ms=fuse_ms, gn_iterations=gn_iters, num_valid=nvalid,
            mean_abs_residual=mean_res, rejected=rejected,
        )
        self.stats.append(stat)
        return stat

    # ------------------------------------------------------------------ #
    # Chunked device-side processing: N frames per dispatch.
    #
    # The per-frame host loop pays host round trips every frame (the
    # tracking result is read back for the failure gate). process_chunk
    # runs preprocessing + tracking + the failure gate + fusion for a whole
    # chunk inside ONE jitted lax.fori_loop, exactly the shape bench.py's
    # on-device loop measures — so dataset/offline throughput approaches
    # the device rate. Whether that gain survives on a local GPU host is
    # not measured. No reference counterpart (the
    # reference is ROS-callback-driven). Semantics match process_frame:
    # same preprocessing, same pose init rule, same rejection gate (a
    # rejected frame keeps the pose, skips fusion — implemented by feeding
    # the fuse an all-NaN frame, the pinned no-op), same cap adaptation
    # (applied between chunks), same trajectory/stat reporting.

    def _chunk_supported(self) -> bool:
        """Chunked (N-frames-per-dispatch) processing is available on the
        brickmajor path — single-device, or SPMD when tracking reads the
        sharded brick rows directly (the runner's default sharded setup)."""
        cfg = self.config
        return (self._bgrid is not None
                and (self._mesh is None or self._track_input == "bgrid_d")
                and cfg.fusion.mode == "brickmajor"
                and cfg.tracking.jacobian == "analytic"
                and not cfg.use_groundtruth)

    def _chunk_fuse_impl(self, has_color: bool, cap: int):
        """fuse(bg, pose, pts, nrm, rgb_or_None, fc, sat) -> (bg, Dm,
        stats, sat), shared by the chunk body AND the calibration probe so
        ONE place owns the config/cap-split (round-4 self-review: the two
        copies had started to drift). ``sat`` is the saturated-FREE bitset
        (None when sat_skip is off; passed through unchanged on the
        sharded path, which does not carry it yet)."""
        cfg = self.config
        fcfg = cfg.fusion if has_color else cfg.fusion._replace(
            fuse_color=False)
        params, cam, bs = cfg.grid, self.cam, self._bs
        if self._mesh is not None:
            from tracking_sdf_tpu.parallel import (
                sharded_fuse_frame_brickmajor,
            )

            # whole-frame caps on every shard (see _init_sharded_brickmajor)
            fns = {
                fc: sharded_fuse_frame_brickmajor(
                    self._mesh, params=params, cam=cam,
                    cfg=fcfg._replace(fuse_color=fc), bs=bs, cap=cap,
                    cap_free=cfg.fusion.brick_cap_free or None,
                    emit_dm=False, jit=False)
                for fc in ({True, False} if has_color else {False})
            }

            def fuse(bg, pose, pts, nrm, rgb, fc, sat=None):
                bg, dm, stats = fns[fc](bg, pose, pts, nrm, rgb)
                return bg, dm, stats, sat
            return fuse

        from tracking_sdf_tpu.fusion.brickmajor import fuse_frame_brickmajor

        cap_free = cfg.fusion.brick_cap_free or None

        def fuse(bg, pose, pts, nrm, rgb, fc, sat=None):
            out = fuse_frame_brickmajor(
                bg, pose, pts, nrm, rgb, params=params, cam=cam,
                cfg=fcfg._replace(fuse_color=fc), bs=bs,
                cap=cap, cap_free=cap_free, emit_dm=False, sat=sat)
            return out if sat is not None else (*out, None)
        return fuse

    def _chunk_fn(self, n: int, has_color: bool, raw: bool, cap: int,
                  off_mod=None):
        """``off_mod`` (chunk-start frame index mod color_every, or None):
        when set and n %% color_every == 0, the color cadence is STATICALLY
        UNROLLED into the loop body (color_every frames per fori iteration,
        python-static on/off) instead of a lax.cond gate, whose cost was
        pure overhead once chunks are compute-bound (measured elsewhere,
        not on the H100)."""
        key = (n, has_color, raw, cap, off_mod)
        fn = self._chunk_cache.get(key)
        if fn is not None:
            return fn
        from functools import partial as _partial

        from tracking_sdf_tpu.fusion.brickmajor import brick_masked_view
        from tracking_sdf_tpu.tracking.gauss_newton import track_frame
        from tracking_sdf_tpu.tracking.pyramid import track_frame_pyramid

        cfg = self.config
        cam = self.cam
        params, tcfg = cfg.grid, cfg.tracking
        fcfg = cfg.fusion if has_color else cfg.fusion._replace(
            fuse_color=False)
        bs = self._bs
        levels = cfg.pyramid_levels
        stride = tcfg.pixel_stride
        velocity = cfg.pose_init == "velocity"
        bilateral = cfg.bilateral_filter
        bmode = getattr(cfg, "bilateral_mode", "full")
        min_valid = cfg.min_valid_pixels
        max_res = cfg.max_mean_residual

        # SPMD chunk: the same N-frames-per-dispatch loop, with the
        # shard-mapped fuse/track composed INSIDE the one jitted program —
        # a pod is no longer per-frame dispatch-bound. Same pyramid as the
        # per-frame paths; every shard gets the whole-frame caps
        # (_chunk_fuse_impl).
        sharded = self._mesh is not None
        fuse_impl = self._chunk_fuse_impl(has_color, cap)
        if sharded:
            from tracking_sdf_tpu.parallel import (
                sharded_track_frame_brickmajor,
            )

            track_sharded = _pyramid_tracker(
                lambda c: sharded_track_frame_brickmajor(
                    self._mesh, params=params, cfg=c, bs=bs, jit=False),
                cfg)

        ce = getattr(fcfg, "color_every", 1)
        unroll = (off_mod is not None and has_color and ce > 1
                  and n % ce == 0)

        @_partial(jax.jit, donate_argnums=(0,))
        def chunk(bgrid, pose, prev, have_prev, depths, rgbs, off, sat):
            def frame_step(k, carry, color_mode):
                bgrid, pose, prev, have_prev, out, sat = carry
                d = depths[k]
                if raw:
                    d16 = d.astype(jnp.float32)
                    d = jnp.where(d16 > 0, d16 / 5000.0, jnp.nan)
                pts, nrm = preprocess_frame(
                    d, cam=cam, bilateral=bilateral, bilateral_mode=bmode)
                if velocity:
                    delta = pose_compose(pose_inverse(prev), pose)
                    pred = pose_compose(pose, delta)
                    pose0 = Pose(
                        jnp.where(have_prev, pred.R, pose.R),
                        jnp.where(have_prev, pred.t, pose.t))
                else:
                    pose0 = pose
                if sharded:
                    res = track_sharded(bgrid.D, pose0, pts)
                elif levels:
                    Dm = brick_masked_view(bgrid, params, bs)
                    res, _ = track_frame_pyramid(
                        None, pose0, pts, params=params, cfg=tcfg,
                        levels=levels, Dm=Dm)
                else:
                    Dm = brick_masked_view(bgrid, params, bs)
                    pts_s = pts[::stride, ::stride].reshape(-1, 3)
                    res = track_frame(None, pose0, pts_s, params=params,
                                      cfg=tcfg, Dm=Dm)
                finite = (jnp.all(jnp.isfinite(res.pose.t))
                          & jnp.all(jnp.isfinite(res.pose.R)))
                rejected = (res.num_valid < min_valid) | ~finite
                if max_res > 0:
                    rejected = rejected | (res.mean_abs_residual > max_res)
                pose_new = Pose(
                    jnp.where(rejected, pose.R, res.pose.R),
                    jnp.where(rejected, pose.t, res.pose.t))
                # rejected -> all-NaN inputs -> fusion is a pinned no-op
                nanf = jnp.float32(jnp.nan)
                pts_f = jnp.where(rejected, nanf, pts)
                nrm_f = jnp.where(rejected, nanf, nrm)
                if raw and has_color:
                    rgb_k = rgbs[k].astype(jnp.float32) / 255.0
                elif has_color:
                    rgb_k = rgbs[k]
                else:
                    rgb_k = None

                def fuse_with(rgb_arg, fc):
                    def f(bg_sat):
                        bg, s = bg_sat
                        bg, dm, st, s = fuse_impl(bg, pose_new, pts_f,
                                                  nrm_f, rgb_arg, fc, s)
                        return bg, st, s
                    return f

                if color_mode == "cond":
                    # temporal color subsampling: the absolute frame index
                    # (chunk start 'off' + k) picks the color cadence
                    bgrid, fstats, sat = jax.lax.cond(
                        (off + k) % ce == 0,
                        fuse_with(rgb_k, True),
                        fuse_with(None, False),
                        (bgrid, sat))
                else:
                    bgrid, fstats, sat = fuse_with(
                        rgb_k if color_mode else None, bool(color_mode)
                    )((bgrid, sat))
                out = jax.tree.map(
                    lambda o, s: o.at[k].set(s), out,
                    (pose_new.R, pose_new.t, res.iterations, res.num_valid,
                     res.mean_abs_residual, rejected, fstats.n_full,
                     fstats.overflow + fstats.overflow_active
                     + fstats.overflow_mixed))
                return (bgrid, pose_new, pose, ~rejected, out, sat)

            out0 = (
                jnp.zeros((n, 3, 3), jnp.float32),
                jnp.zeros((n, 3), jnp.float32),
                jnp.zeros((n,), jnp.int32),
                jnp.zeros((n,), jnp.int32),
                jnp.zeros((n,), jnp.float32),
                jnp.zeros((n,), bool),
                jnp.zeros((n,), jnp.int32),
                jnp.zeros((n,), jnp.int32),
            )
            init = (bgrid, pose, prev, have_prev, out0, sat)
            if unroll:
                # static cadence: frame k's absolute index is off + k with
                # off % ce == off_mod, so color_on depends only on r
                def body(j, carry):
                    for r in range(ce):
                        carry = frame_step(
                            j * ce + r, carry, (off_mod + r) % ce == 0)
                    return carry
                return jax.lax.fori_loop(0, n // ce, body, init)

            mode = "cond" if (has_color and ce > 1) else has_color

            def body(k, carry):
                return frame_step(k, carry, mode)
            return jax.lax.fori_loop(0, n, body, init)

        self._chunk_cache[key] = chunk
        return chunk

    def _chunk_calibrate(self, n: int, has_color: bool, raw: bool,
                         cap: int, depths, rgbs, off) -> Tuple[float, float]:
        """Measure (prep_ms, fuse_ms) per frame for this chunk shape — ONE
        extra pair of on-device loops per jit key, then cached.

        The chunk runs track+fuse inside one dispatch, so the per-frame
        phase split (the reference's per-phase couts, sdf.cpp:306) cannot
        be timed directly. This replays the chunk's own frames through (a)
        a preprocess-only loop and (b) a preprocess+fuse loop at a fixed
        pose (fuse cost is pose-insensitive — bench.py breakdown) on a
        device COPY of the grid, both timed with a forced value fetch.
        fuse = b - a; track = chunk_wall - b (distributed over frames by
        GN iteration count in process_chunk)."""
        # the cadence ALIGNMENT changes how many frames fuse color in this
        # chunk (when n % color_every != 0), so it is part of the key
        ce = getattr(self.config.fusion, "color_every", 1)
        key = ("calib", n, has_color, raw, cap,
               int(off) % ce if (has_color and ce > 1) else 0)
        cached = self._chunk_calib.get(key)
        if cached is not None:
            return cached
        from functools import partial as _partial

        cfg = self.config
        cam = self.cam
        fcfg = cfg.fusion if has_color else cfg.fusion._replace(
            fuse_color=False)
        bilateral = cfg.bilateral_filter
        bmode = getattr(cfg, "bilateral_mode", "full")
        fuse_impl = self._chunk_fuse_impl(has_color, cap)

        def decode(d, eps):
            if raw:
                d16 = d.astype(jnp.float32)
                d = jnp.where(d16 > 0, d16 / 5000.0, jnp.nan)
            return d + eps

        @jax.jit
        def prep_loop(depths, eps):
            def body(k, acc):
                pts, nrm = preprocess_frame(
                    decode(depths[k], eps), cam=cam, bilateral=bilateral,
                    bilateral_mode=bmode)
                return acc + jnp.nansum(nrm[..., 0]) + jnp.nansum(pts[..., 2])
            return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

        @jax.jit
        def prep_all(depths):
            def one(d):
                return preprocess_frame(decode(d, jnp.float32(0.0)),
                                        cam=cam, bilateral=bilateral,
                                        bilateral_mode=bmode)
            return jax.vmap(one)(depths)

        # fuse-ONLY loop over PREcomputed point/normal buffers: timing it
        # directly avoids the (prep+fuse) - prep subtraction, whose noise
        # floor swallows the fuse term when fuse << prep (CPU tier)
        @_partial(jax.jit, donate_argnums=(0,))
        def fuse_loop(bgrid, pose_in, PTS, NRM, rgbs, off, eps, sat):
            pose = Pose(pose_in.R, pose_in.t + eps)
            def body(k, carry):
                bgrid, sat = carry
                pts, nrm = PTS[k], NRM[k]
                if raw and has_color:
                    rgb_k = rgbs[k].astype(jnp.float32) / 255.0
                elif has_color:
                    rgb_k = rgbs[k]
                else:
                    rgb_k = None

                def fuse_with(rgb_arg, fc):
                    def f(bg_sat):
                        bg, s = bg_sat
                        bg, _, _, s = fuse_impl(bg, pose, pts, nrm,
                                                rgb_arg, fc, s)
                        return bg, s
                    return f

                ce_c = getattr(fcfg, "color_every", 1)
                if has_color and ce_c > 1:
                    bgrid, sat = jax.lax.cond(
                        (off + k) % ce_c == 0,
                        fuse_with(rgb_k, True),
                        fuse_with(None, False),
                        (bgrid, sat))
                else:
                    bgrid, sat = fuse_with(rgb_k, has_color)((bgrid, sat))
                return bgrid, sat
            return jax.lax.fori_loop(0, n, body, (bgrid, sat))[0]

        def timed(fn, *args_builder):
            best = float("inf")
            for rep in (1, 2):
                args = args_builder[0](rep)
                t0 = time.perf_counter()
                out = fn(*args)
                # a value fetch stops the clock after the device finished
                float(jnp.asarray(jax.tree.leaves(out)[0]).ravel()[0])
                best = min(best, time.perf_counter() - t0)
            return best

        eps0 = jnp.float32(0.0)
        # warm compiles (untimed)
        float(prep_loop(depths, eps0))
        prep_s = timed(prep_loop,
                       lambda rep: (depths, jnp.float32(rep * 1e-6)))
        PTS, NRM = prep_all(depths)
        jax.block_until_ready(NRM)
        sat0 = getattr(self, "_sat", None)  # not donated; result discarded
        snap = jax.tree.map(jnp.copy, self._bgrid)
        snap = fuse_loop(snap, self.pose, PTS, NRM, rgbs, off, eps0,
                         sat0)  # warm
        fuse_s = timed(
            fuse_loop,
            lambda rep: (jax.tree.map(jnp.copy, self._bgrid), self.pose,
                         PTS, NRM, rgbs, off, jnp.float32(rep * 1e-6),
                         sat0))
        del snap, PTS, NRM
        prep_ms = prep_s * 1e3 / n
        fuse_ms = fuse_s * 1e3 / n
        self._chunk_calib[key] = (prep_ms, fuse_ms)
        return prep_ms, fuse_ms

    def process_chunk(
        self,
        depths,  # (N, H, W) float32 meters/NaN, or uint16 (TUM raw /5000)
        rgbs=None,  # (N, H, W, 3) float32 [0,1] or uint8
        timestamps=None,  # sequence of N floats
    ) -> List[FrameStats]:
        """Process N frames in ONE device dispatch (see the block comment
        above). Requires: brick-major mode (single-device, or SPMD with
        the zero-relayout sharded tracker — the runner's default sharded
        configuration), analytic jacobian, no groundtruth-oracle mode, and
        at least one frame already fused (frame 0 bootstraps via
        process_frame). Sharded chunks run the shard-mapped fuse/track
        inside the one jitted fori_loop, so a pod amortizes dispatch
        exactly like a single chip.

        Numerics: bit-equivalent to the per-frame loop at a FIXED brick
        cap (measured 6e-8 m pose delta over a 6-frame dataset). The
        per-frame loop adapts the cap each frame while a chunk holds one
        cap throughout; differing scatter paddings reassociate f32 sums,
        drifting poses by ~1e-4 m over a few frames — the same accepted
        noise class as the sharded==dense psum tolerance."""
        cfg = self.config
        if not self._chunk_supported() or self.frame_num < 1:
            raise ValueError(
                "process_chunk needs mode='brickmajor' (single-device or "
                "sharded with the brick-view tracker), "
                "jacobian='analytic', use_groundtruth=False, and one "
                "process_frame call first (frame 0 bootstraps the grid)")
        depths = jnp.asarray(depths)
        raw = depths.dtype == jnp.uint16
        n = int(depths.shape[0])
        has_color = cfg.fusion.fuse_color and rgbs is not None
        rgbs = jnp.asarray(rgbs) if has_color else jnp.zeros((n, 0))
        if timestamps is None:
            timestamps = [float(self.frame_num + 1 + i) for i in range(n)]
        # chunks always run at the MAX cap: per-frame cap adaptation lags
        # one frame (one frame of reported drops); a chunk would lag a
        # WHOLE chunk (measured: 2.7k drops over the first desk chunk
        # before escalation), while the trim only saves part of the
        # merge's padded rows. Sharded mode has no adaptive ladder — the
        # config cap, on every shard, is the max.
        cap = (self._cap_levels[-1] if getattr(self, "_cap_levels", None)
               else cfg.fusion.brick_cap)
        ce = getattr(cfg.fusion, "color_every", 1)
        # static-unroll the color cadence when the chunk aligns to it
        # (instead of a lax.cond gate; run() picks aligned chunk sizes, so
        # this is the common case)
        off_mod = ((self.frame_num + 1) % ce
                   if has_color and ce > 1 and n % ce == 0 else None)
        fn = self._chunk_fn(n, has_color, raw, cap, off_mod)

        t0 = time.perf_counter()
        prev = self._pose_prev if self._pose_prev is not None else self.pose
        have_prev = self._pose_prev is not None
        bgrid, pose, prev_out, have_out, out, sat_out = fn(
            self._bgrid, self.pose, prev, jnp.bool_(have_prev),
            depths, rgbs, jnp.int32(self.frame_num + 1),
            getattr(self, "_sat", None))
        if sat_out is not None:
            self._sat = sat_out
        (Rs, ts, iters, nvalid, mres, rej, n_full, overflow) = out
        Rs, ts = np.asarray(Rs), np.asarray(ts)
        iters, nvalid = np.asarray(iters), np.asarray(nvalid)
        mres, rej = np.asarray(mres), np.asarray(rej)
        n_full, overflow = np.asarray(n_full), np.asarray(overflow)
        wall_ms = (time.perf_counter() - t0) * 1e3 / n

        self._bgrid = bgrid
        self.pose = Pose(jnp.asarray(Rs[-1]), jnp.asarray(ts[-1]))
        self._pose_prev = (Pose(jnp.asarray(prev_out.R),
                                jnp.asarray(prev_out.t))
                           if bool(have_out) else None)
        if getattr(self, "_bm_view", None) is not None:
            self._dm = self._bm_view(self._bgrid)
        # restore the per-phase split (reference parity: per-phase couts,
        # sdf.cpp:306): one cached calibration pair of on-device loops
        # measures prep/fuse per frame; the track pool (wall - prep - fuse)
        # is distributed over frames by GN iteration count. Disable with
        # chunk_phase_metrics=False (falls back to wall/n in track_ms).
        fuse_i = np.zeros(n)
        track_i = np.full(n, wall_ms)
        if getattr(self, "chunk_phase_metrics", True):
            try:
                prep_ms, fuse_cal = self._chunk_calibrate(
                    n, has_color, raw, cap, depths, rgbs,
                    jnp.int32(self.frame_num + 1))
                # NOTE: fuse_cal is the chunk-AVERAGE fuse
                # cost assigned uniformly to every non-rejected frame; on
                # color-cadence chunks this overstates fuse_ms for
                # non-color frames and understates it for color frames
                # (per-frame split would need a calibration pair per color
                # mode). Totals are preserved; per-frame fuse_ms is an
                # average, not a per-mode measurement.
                fuse_i = np.where(rej, 0.0, fuse_cal)
                track_pool = max(
                    wall_ms * n - prep_ms * n - float(fuse_i.sum()), 0.0)
                w_it = np.maximum(iters.astype(np.float64), 1.0)
                track_i = track_pool * w_it / w_it.sum()
            except Exception as e:  # calibration must never sink a run
                import warnings

                warnings.warn(f"chunk phase calibration failed "
                              f"({type(e).__name__}: {e}); metrics carry "
                              f"wall/n in track_ms", RuntimeWarning,
                              stacklevel=2)
        stats_out: List[FrameStats] = []
        for i in range(n):
            self.frame_num += 1
            if self._writer is not None and not rej[i]:
                self._writer.write(
                    float(timestamps[i]),
                    Pose(jnp.asarray(Rs[i]), jnp.asarray(ts[i])))
            stat = FrameStats(
                index=self.frame_num, timestamp=float(timestamps[i]),
                track_ms=float(track_i[i]), fuse_ms=float(fuse_i[i]),
                gn_iterations=int(iters[i]), num_valid=int(nvalid[i]),
                mean_abs_residual=float(mres[i]), rejected=bool(rej[i]))
            self.stats.append(stat)
            stats_out.append(stat)
        if int(overflow.sum()):
            import warnings

            warnings.warn(
                f"process_chunk: {int(overflow.sum())} brick-cap overflow "
                f"drops across the chunk (cap {cap} = the preset max; "
                f"peak n_full {int(n_full.max())} — raise "
                f"FusionConfig.brick_cap to cover it)",
                RuntimeWarning, stacklevel=2)
        if self._publisher is not None:
            now = time.perf_counter()
            if now - self._last_publish >= self._publisher.effective_interval:
                self._publisher.publish(self.grid)
                self._last_publish = now
        return stats_out

    def _extract_mesh(self, grid, with_colors: bool, color_mode: str):
        """Mesh extraction with the layout-appropriate strategy: per-slab
        for sharded grids (P3), slab-chunked at m >= 512 (bounds peak device
        memory next to the live brick grid), one-shot otherwise.

        Vertices come to the host u16-quantized when
        PipelineConfig.mesh_vertex_quant (error <= extent/131070, ~30 um).
        PLY output is f32 world coordinates either way."""
        from tracking_sdf_tpu.render.marching_cubes import (
            marching_cubes, marching_cubes_chunked, marching_cubes_sharded)

        vq = getattr(self.config, "mesh_vertex_quant", True)
        if self._mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            grid = jax.device_put(
                grid, NamedSharding(self._mesh, P("d", None, None)))
            return marching_cubes_sharded(
                grid, params=self.config.grid, with_colors=with_colors,
                color_mode=color_mode, vertex_quant=vq)
        if self.config.grid.m >= 512:
            return marching_cubes_chunked(
                grid, params=self.config.grid, with_colors=with_colors,
                color_mode=color_mode, vertex_quant=vq)
        return marching_cubes(grid, params=self.config.grid,
                              with_colors=with_colors,
                              color_mode=color_mode, vertex_quant=vq)

    def start_mesh_publisher(self, path: str, with_colors: bool = True):
        """Start the async mesh export thread (the reference's 1 Hz
        visualization thread, sdf_reconstruction.cpp:97 — race-free here
        because grid snapshots are immutable pytrees). Rate comes from
        config.mesh_hz (0 -> default 1 Hz)."""
        from tracking_sdf_tpu.pipeline.visualizer import MeshPublisher
        from tracking_sdf_tpu.render.marching_cubes import export_ply

        interval = 1.0 / (self.config.mesh_hz or 1.0)
        dec = int(getattr(self.config, "mesh_decimate", 0))
        if dec == 0:  # auto policy (PipelineConfig.mesh_decimate)
            m = self.config.grid.m
            dec = 4 if m >= 512 else (2 if m >= 256 else 1)
        dec = max(1, dec)
        while self.config.grid.m % dec:
            dec -= 1

        def export(grid):
            if dec > 1:
                # D is metric (meters), so voxel decimation preserves the
                # field; the live mesh is dec-times coarser and the MC pass
                # ~dec^3 cheaper (config.mesh_decimate; final --mesh exports
                # never decimate)
                from tracking_sdf_tpu.render.marching_cubes import (
                    marching_cubes,
                )

                grid = jax.tree.map(lambda a: a[::dec, ::dec, ::dec], grid)
                params = self.config.grid._replace(
                    m=self.config.grid.m // dec)
                mesh = marching_cubes(
                    grid, params=params, with_colors=with_colors,
                    color_mode="trilinear",
                    vertex_quant=getattr(self.config,
                                         "mesh_vertex_quant", True))
            else:
                mesh = self._extract_mesh(grid, with_colors, "trilinear")
            export_ply(mesh, path)

        self._publisher = MeshPublisher(export, interval=interval)
        self._last_publish = float("-inf")  # first frame always publishes
        return self._publisher

    # ------------------------------------------------------------------ #

    def run(
        self,
        dataset,
        max_frames: Optional[int] = None,
        mesh_every: int = 0,
        mesh_path: Optional[str] = None,
        progress: bool = False,
        checkpoint_every: int = 0,
        checkpoint_path: Optional[str] = None,
        metrics_log: Optional[str] = None,
        skip_frames: int = 0,
        chunk: int = 0,
    ) -> List[FrameStats]:
        """Consume a TUMDataset (or any iterable of TUMFrame-likes).

        ``skip_frames`` skips already-processed frames after a checkpoint
        restore (pass ``self.frame_num``). ``metrics_log`` appends one JSON
        line of FrameStats per frame — the machine-readable version of the
        reference's per-phase cout timings (sdf.cpp:306 etc.).
        ``chunk`` > 1 batches that many frames per device dispatch via
        process_chunk (frame 0 and tail/odd batches run per-frame) —
        device-rate throughput over high-latency links.
        """
        import json as _json

        if chunk > 1 and not self._chunk_supported():
            import warnings

            warnings.warn(
                "chunked processing needs mode='brickmajor' + "
                "jacobian='analytic' (single-device or default sharded "
                "setup, no groundtruth oracle); falling back to per-frame",
                RuntimeWarning, stacklevel=2)
            chunk = 0
        mf = open(metrics_log, "a") if metrics_log else None
        pend = []  # (frame, timestamp) buffered for the next chunk

        def emit(stat):
            if progress:
                print(
                    f"frame {stat.index}: track {stat.track_ms:.1f} ms "
                    f"({stat.gn_iterations} GN iters, {stat.num_valid} px), "
                    f"fuse {stat.fuse_ms:.1f} ms", flush=True,
                )
            if mf is not None:
                mf.write(_json.dumps(dataclasses.asdict(stat)) + "\n")
                mf.flush()
            if mesh_every and stat.index % mesh_every == 0 and mesh_path:
                self.export_mesh(mesh_path)
            # chunked runs emit stats after the chunk: only the LATEST
            # frame's stat triggers a save (mid-chunk indices would save
            # the same end-of-chunk state repeatedly)
            if (checkpoint_every and checkpoint_path
                    and stat.index % checkpoint_every == 0
                    and stat.index == self.frame_num):
                self.save_checkpoint(checkpoint_path)

        def flush_pend(final=False):
            if not pend:
                return
            if final and len(pend) < chunk:
                # odd tail: per-frame (a fresh chunk-size compile costs
                # more than the dispatches it would save)
                for f, t in pend:
                    emit(self.process_frame(f.depth, f.rgb, timestamp=t))
                pend.clear()
                return
            depths = jnp.stack([jnp.asarray(f.depth) for f, _ in pend])
            rgbs = None
            if (self.config.fusion.fuse_color
                    and all(f.rgb is not None for f, _ in pend)):
                rgbs = jnp.stack([jnp.asarray(f.rgb) for f, _ in pend])
            for stat in self.process_chunk(
                    depths, rgbs, timestamps=[t for _, t in pend]):
                emit(stat)
            pend.clear()

        try:
            for i, frame in enumerate(dataset):
                if i < skip_frames:
                    continue
                if max_frames is not None and i >= max_frames:
                    break
                gt = None
                if getattr(frame, "gt_pose", None) is not None:
                    t, q = frame.gt_pose
                    gt = Pose(matrix_from_quaternion(jnp.asarray(q)), jnp.asarray(t))
                # gt poses only force the per-frame path when the oracle
                # mode actually consumes them (tracked mode ignores gt)
                gt_blocks = gt is not None and self.config.use_groundtruth
                if chunk > 1 and not gt_blocks and self.frame_num >= 1:
                    pend.append((frame, frame.timestamp))
                    if len(pend) == chunk:
                        flush_pend()
                    continue
                # keep frame order if a gt/oracle frame interrupts a chunk
                flush_pend(final=True)
                stat = self.process_frame(
                    frame.depth, frame.rgb, timestamp=frame.timestamp, gt_pose=gt
                )
                emit(stat)
            flush_pend(final=True)
        finally:
            if mf is not None:
                mf.close()
        return self.stats

    def export_mesh(self, path: str, with_colors: bool = True,
                    color_mode: str = "trilinear") -> int:
        """Marching-cubes the current grid snapshot to a PLY file.

        color_mode="shepard" reproduces the reference's per-vertex
        interpolate_color exactly (sdf.cpp:377-382)."""
        from tracking_sdf_tpu.render.marching_cubes import export_ply

        mesh = self._extract_mesh(self.grid, with_colors, color_mode)
        export_ply(mesh, path)
        return mesh.num_triangles

    def render(self, pose: Optional[Pose] = None, stride: int = 1,
               with_color: bool = True, t_init=None):
        """Raycast a depth/normal/color view of the current model.

        ``t_init``: previous render's ``range_t`` for the temporal
        warm-start fast path (sequential live viewing; see
        RaycastConfig.warm_backoff — measured -27%/render).

        Warns when the grazing-recovery compaction capacity overflowed
        (RenderResult.dropped > 0): those rays are reported as misses in
        the default sample="nearest_far" mode; sample="trilinear" is the
        exact 100%-coverage mode.

        On the SPMD runner (mesh passed) renders are RAY-SHARDED over the
        mesh (parallel.render.sharded_raycast — equal to single-device
        within the tolerances stated there) unless a ``t_init`` warm start
        is given (the sharded path has no warm start; it falls back to
        single-device)."""
        from tracking_sdf_tpu.render.raycast import raycast

        p = pose if pose is not None else self.pose
        if self._mesh is not None and t_init is None:
            from tracking_sdf_tpu.parallel import sharded_raycast
            from tracking_sdf_tpu.parallel.mesh import grid_sharding

            key = (stride, with_color)
            cache = getattr(self, "_render_sharded", None)
            if cache is None:
                cache = self._render_sharded = {}
            fn = cache.get(key)
            if fn is None:
                fn = cache[key] = sharded_raycast(
                    self._mesh, params=self.config.grid, cam=self.cam,
                    cfg=self.config.raycast, stride=stride,
                    with_color=with_color)
            grid = jax.device_put(self.grid,
                                  grid_sharding(self._mesh))
            result = fn(grid, p)
        else:
            result = raycast(
                self.grid, p,
                params=self.config.grid, cam=self.cam,
                cfg=self.config.raycast,
                stride=stride, with_color=with_color, t_init=t_init,
            )
        n_dropped = int(result.dropped)
        if n_dropped > 0:
            import warnings

            warnings.warn(
                f"raycast: {n_dropped} rays exceeded the fine-phase recovery "
                "capacity and render as misses; use "
                "RaycastConfig(sample='trilinear') for exact coverage",
                RuntimeWarning, stacklevel=2)
        return result

    def save_checkpoint(self, path: str) -> None:
        """Snapshot grid + pose + frame counter (reference has none; §5)."""
        from tracking_sdf_tpu.pipeline.checkpoint import save_checkpoint

        grid = self.grid
        if self._mesh is not None:
            grid = TSDFGrid(*(jnp.asarray(jax.device_get(l)) for l in grid))
        save_checkpoint(path, grid, self.pose, self.frame_num,
                        pose_prev=self._pose_prev)

    def restore_checkpoint(self, path: str) -> None:
        from tracking_sdf_tpu.pipeline.checkpoint import load_checkpoint

        grid, pose, frame_num, _, pose_prev = load_checkpoint(path)
        if self._writer is not None and not self._writer.started:
            # preserve the pre-resume trajectory (the lazy writer has not
            # opened/truncated the file yet)
            self._writer.set_append(True)
        if self._mesh is not None:
            from tracking_sdf_tpu.parallel import shard_grid

            grid = shard_grid(grid, self._mesh)
        self.grid = grid
        self.pose = pose
        self._pose_prev = pose_prev
        self.frame_num = frame_num

    def close(self) -> None:
        if self._publisher is not None:
            self._publisher.close()
            self._publisher = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def summary(self) -> Dict[str, float]:
        if not self.stats:
            return {}
        # stats[1:] everywhere: frame 1 carries the jit compiles and would
        # swamp fps
        track = np.asarray([s.track_ms for s in self.stats[1:]] or [0.0])
        fuse = np.asarray([s.fuse_ms for s in self.stats[1:]]
                          or [s.fuse_ms for s in self.stats])
        return {
            "frames": float(len(self.stats)),
            "track_ms_mean": float(track.mean()),
            "fuse_ms_mean": float(fuse.mean()),
            "gn_iters_mean": float(np.mean([s.gn_iterations for s in self.stats[1:]] or [0])),
            "fps": 1e3 / float(track.mean() + fuse.mean()),
        }
