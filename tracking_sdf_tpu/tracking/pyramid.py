"""Coarse-to-fine Gauss-Newton tracking pyramid.

The reference subsamples pixels at a fixed stride 3 (camera_tracking.cpp:
162-163) and relies on small inter-frame motion. The pyramid replaces that
with the standard coarse-to-fine schedule (SURVEY.md §5 "long-context":
"coarse-to-fine pyramid replaces stride subsampling"): run GN on heavily
decimated points first — each coarse step is cheap and has a wide
convergence basin — then refine at finer decimation from the coarse result.
Decimation (not averaging) mirrors the reference's nodelet pipeline, which
decimates the depth image 2x before tracking (launch/kinect_normal.launch),
and never invents depth values across discontinuities.

All levels reuse the same jit'd track_frame; each (level-shape, config)
pair compiles once.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import jax.numpy as jnp

from tracking_sdf_tpu.config import GridParams, TrackingConfig
from tracking_sdf_tpu.core.lie import Pose
from tracking_sdf_tpu.grid.grid import TSDFGrid
from tracking_sdf_tpu.tracking.gauss_newton import TrackResult, track_frame


def pyramid_schedule(cfg: TrackingConfig, levels: Sequence[int],
                     coarse_iterations: int = 10
                     ) -> List[Tuple[int, TrackingConfig]]:
    """(pixel stride, tracking config) per level, coarsest first.

    ``levels`` are extra decimation factors multiplied onto
    ``cfg.pixel_stride``, ending at 1 (= the reference's stride). Coarse
    levels get capped iterations and no min-iteration floor (the floor
    exists to make the FINE level re-optimize past the coarse level's
    decimation-biased optimum — see TrackingConfig)."""
    if not levels or levels[-1] != 1:
        raise ValueError("levels must be non-empty and end at 1 "
                         "(finest = cfg.pixel_stride)")
    return [(cfg.pixel_stride * mult,
             cfg if mult == 1 else cfg._replace(
                 max_iterations=coarse_iterations, min_iterations=0))
            for mult in levels]


def track_frame_pyramid(
    grid: TSDFGrid,
    pose0: Pose,
    points_img: jnp.ndarray,  # (H, W, 3) organized camera-frame points
    *,
    params: GridParams,
    cfg: TrackingConfig = TrackingConfig(),
    levels: Sequence[int] = (4, 2, 1),
    coarse_iterations: int = 10,
    Dm: jnp.ndarray = None,  # precomputed masked_view; built ONCE here
    # otherwise (the per-level track_frame would rebuild this full-grid
    # pass at every pyramid level)
) -> Tuple[TrackResult, Tuple[TrackResult, ...]]:
    """Track one frame coarse-to-fine.

    ``levels``: see pyramid_schedule. Returns (finest-level result,
    per-level results).
    """
    schedule = pyramid_schedule(cfg, levels, coarse_iterations)
    if Dm is None and cfg.jacobian == "analytic":
        from tracking_sdf_tpu.grid.interp import masked_view

        Dm = masked_view(grid.D, grid.W)
    pose = pose0
    results = []
    for stride, level_cfg in schedule:
        pts = points_img[::stride, ::stride].reshape(-1, 3)
        res = track_frame(grid, pose, pts, params=params, cfg=level_cfg, Dm=Dm)
        pose = res.pose
        results.append(res)
    return results[-1], tuple(results)
