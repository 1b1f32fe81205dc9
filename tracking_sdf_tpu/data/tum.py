"""TUM RGB-D dataset reader (depth/rgb PNGs + associations + groundtruth).

Replaces the reference's data source — a rosbag replayed into
/camera/depth_registered/points (sdf_reconstruction.cpp:89; the nodelet
pipeline in launch/kinect_normal.launch converts depth images to organized
point clouds). Here frames come straight from the standard TUM on-disk
layout:

    rgb.txt / depth.txt      "timestamp filename" listings ('#' headers)
    rgb/*.png                8-bit RGB
    depth/*.png              16-bit, depth in meters = value / 5000
    groundtruth.txt          TUM trajectory (timestamp tx ty tz qx qy qz qw)

Decoding uses the native C++ loader (tracking_sdf_tpu.data.native) when its
shared library is built — a threaded prefetching pipeline that overlaps PNG
decode with device compute — and falls back to the numpy codec in
tracking_sdf_tpu.data.png.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from tracking_sdf_tpu.data.png import read_png, write_png
from tracking_sdf_tpu.pipeline.trajectory import Trajectory, associate, read_trajectory

DEPTH_SCALE = 5000.0  # TUM convention: png_value / 5000 = meters


def _read_listing(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            stamp, name = line.split()[:2]
            out.append((float(stamp), name))
    return out


@dataclasses.dataclass
class TUMFrame:
    timestamp: float
    depth: np.ndarray  # (H, W) float32 meters, NaN holes
    rgb: Optional[np.ndarray]  # (H, W, 3) float32 in [0, 1] or None
    gt_pose: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (t(3,), q(4,)) if available


class TUMDataset:
    """Random-access + iterable view of a TUM sequence directory."""

    def __init__(self, root: str, with_rgb: bool = True, max_dt: float = 0.02):
        self.root = root
        self.with_rgb = with_rgb
        depth_list = _read_listing(os.path.join(root, "depth.txt"))
        self._depth = depth_list
        self._rgb_for_depth: List[Optional[str]] = [None] * len(depth_list)
        if with_rgb and os.path.exists(os.path.join(root, "rgb.txt")):
            rgb_list = _read_listing(os.path.join(root, "rgb.txt"))
            pairs = associate(
                np.asarray([t for t, _ in depth_list]),
                np.asarray([t for t, _ in rgb_list]),
                max_dt=max_dt,
            )
            for di, ri in pairs:
                self._rgb_for_depth[di] = rgb_list[ri][1]
        gt_path = os.path.join(root, "groundtruth.txt")
        self.groundtruth: Optional[Trajectory] = (
            read_trajectory(gt_path) if os.path.exists(gt_path) else None
        )
        self._gt_for_depth: List[Optional[int]] = [None] * len(depth_list)
        if self.groundtruth is not None:
            pairs = associate(
                np.asarray([t for t, _ in depth_list]),
                self.groundtruth.timestamps,
                max_dt=max_dt,
            )
            for di, gi in pairs:
                self._gt_for_depth[di] = gi

    def __len__(self) -> int:
        return len(self._depth)

    def __getitem__(self, i: int) -> TUMFrame:
        stamp, depth_name = self._depth[i]
        depth = load_depth_png(os.path.join(self.root, depth_name))
        rgb = None
        if self.with_rgb and self._rgb_for_depth[i] is not None:
            rgb = load_rgb_png(os.path.join(self.root, self._rgb_for_depth[i]))
        gt = None
        if self._gt_for_depth[i] is not None:
            g = self.groundtruth
            gi = self._gt_for_depth[i]
            gt = (g.translations[gi].astype(np.float32),
                  g.quaternions[gi].astype(np.float32))
        return TUMFrame(timestamp=stamp, depth=depth, rgb=rgb, gt_pose=gt)

    def __iter__(self) -> Iterator[TUMFrame]:
        for i in range(len(self)):
            yield self[i]

    def frame_paths(self, i: int) -> Tuple[str, Optional[str]]:
        """Absolute (depth_path, rgb_path_or_None) for frame i (native loader)."""
        d = os.path.join(self.root, self._depth[i][1])
        r = self._rgb_for_depth[i]
        return d, (os.path.join(self.root, r) if r is not None else None)

    def stream(self, prefetch: int = 8, threads: int = 0,
               raw: bool = False) -> Iterator[TUMFrame]:
        """Iterate frames through the native prefetching loader when built
        (C++ thread pool overlapping PNG decode with device compute); falls
        back to the numpy codec otherwise.

        ``raw=True`` yields TUM wire formats (depth uint16 with 0 = hole,
        rgb uint8) — 6x fewer host->device bytes for chunked processing,
        which decodes on-device; the runner's per-frame path converts on
        host transparently."""
        from tracking_sdf_tpu.data import native

        if not native.available():
            yield from self
            return
        dp = [self.frame_paths(i)[0] for i in range(len(self))]
        rp = [self.frame_paths(i)[1] for i in range(len(self))] if self.with_rgb else None
        with native.PrefetchingLoader(dp, rp, prefetch=prefetch,
                                      threads=threads, raw=raw) as ld:
            for idx, depth, rgb in ld:
                stamp = self._depth[idx][0]
                gt = None
                if self._gt_for_depth[idx] is not None:
                    g = self.groundtruth
                    gi = self._gt_for_depth[idx]
                    gt = (g.translations[gi].astype(np.float32),
                          g.quaternions[gi].astype(np.float32))
                yield TUMFrame(timestamp=stamp, depth=depth, rgb=rgb, gt_pose=gt)


def load_depth_png(path: str) -> np.ndarray:
    """16-bit depth PNG -> float32 meters with NaN holes (value 0 = no data).

    Uses the native C++ decoder when built — this is the INDEXED access
    path, which --realtime pacing uses to skip dropped frames, so its
    per-frame host cost counts as processing lag. Falls back to the numpy
    codec."""
    from tracking_sdf_tpu.data import native

    if native.available():
        try:
            return native.decode_depth(path)
        except (ValueError, RuntimeError):
            pass  # corrupt/odd PNG variant: let the numpy codec try
    raw = read_png(path).astype(np.float32)
    if raw.ndim == 3:
        raw = raw[..., 0]
    depth = raw / DEPTH_SCALE
    depth[raw == 0] = np.nan
    return depth


def load_rgb_png(path: str) -> np.ndarray:
    """8-bit RGB PNG -> float32 in [0, 1] (native decoder when built)."""
    from tracking_sdf_tpu.data import native

    if native.available():
        try:
            return native.decode_rgb(path)
        except (ValueError, RuntimeError):
            pass
    img = read_png(path).astype(np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):  # grey or grey+alpha
        img = np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3] / 255.0


def write_synthetic_tum(
    root: str,
    depths: List[np.ndarray],
    rgbs: Optional[List[np.ndarray]] = None,
    poses: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None,
    t0: float = 1000.0,
    dt: float = 1.0 / 30.0,
) -> None:
    """Write arrays as an on-disk TUM sequence (test fixture / exporter)."""
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    if rgbs is not None:
        os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    depth_lines, rgb_lines, gt_lines = [], [], []
    for i, depth in enumerate(depths):
        stamp = t0 + i * dt
        raw = np.nan_to_num(depth, nan=0.0) * DEPTH_SCALE
        # round, not truncate: truncation biases every written depth low
        # by up to 1/DEPTH_SCALE (0.2 mm), visible in sub-mm roundtrips
        raw = np.clip(np.round(raw), 0, 65535).astype(np.uint16)
        name = f"depth/{stamp:.6f}.png"
        write_png(os.path.join(root, name), raw)
        depth_lines.append(f"{stamp:.6f} {name}")
        if rgbs is not None:
            img = np.clip(rgbs[i] * 255.0, 0, 255).astype(np.uint8)
            rname = f"rgb/{stamp:.6f}.png"
            write_png(os.path.join(root, rname), img)
            rgb_lines.append(f"{stamp:.6f} {rname}")
        if poses is not None:
            t, q = poses[i]
            gt_lines.append(
                f"{stamp:.6f} " + " ".join(f"{v:.6f}" for v in list(t) + list(q))
            )
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("# depth maps\n# file: synthetic\n# timestamp filename\n")
        f.write("\n".join(depth_lines) + "\n")
    if rgb_lines:
        with open(os.path.join(root, "rgb.txt"), "w") as f:
            f.write("# color images\n# file: synthetic\n# timestamp filename\n")
            f.write("\n".join(rgb_lines) + "\n")
    if gt_lines:
        with open(os.path.join(root, "groundtruth.txt"), "w") as f:
            f.write("# ground truth trajectory\n# file: synthetic\n"
                    "# timestamp tx ty tz qx qy qz qw\n")
            f.write("\n".join(gt_lines) + "\n")
