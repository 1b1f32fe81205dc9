"""Render-result image export (PNG panels) — the RViz-replacement artifact.

The reference's only visualization is the live RViz marker stream
(sdf.cpp:386). Here a raycast RenderResult saves as a side-by-side PNG of
depth (turbo-less grayscale with NaN=black), world-space normals
(n*0.5+0.5), and color when present.
"""
from __future__ import annotations

import numpy as np

from tracking_sdf_tpu.render.raycast import RenderResult


def render_panels(result: RenderResult) -> np.ndarray:
    """(H, W*k, 3) uint8 panel image from a RenderResult."""
    depth = np.asarray(result.depth)
    finite = np.isfinite(depth)
    if finite.any():
        lo = float(np.percentile(depth[finite], 2))
        hi = float(np.percentile(depth[finite], 98))
        hi = hi if hi > lo else lo + 1.0
    else:
        lo, hi = 0.0, 1.0
    d01 = np.clip((depth - lo) / (hi - lo), 0.0, 1.0)
    d_img = np.where(finite, 1.0 - d01 * 0.9, 0.0)  # near = bright, miss = black
    panels = [np.repeat(d_img[..., None], 3, axis=-1)]

    n = np.asarray(result.normal_world)
    n_img = np.where(np.isfinite(n), n * 0.5 + 0.5, 0.0)
    panels.append(n_img)

    if result.rgb is not None:
        c = np.asarray(result.rgb)
        panels.append(np.where(np.isfinite(c), c, 0.0))

    img = np.concatenate(panels, axis=1)
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def save_render_png(result: RenderResult, path: str) -> None:
    from tracking_sdf_tpu.data.png import write_png

    write_png(path, render_panels(result))
