"""Command-line entry point: `python -m tracking_sdf_tpu.cli ...`.

The reference's process entry is main.cpp + roslaunch configs (SURVEY.md C12,
C15); here a single CLI covers replaying a TUM sequence (or a synthetic
scene), tracking/fusing, trajectory + ATE output, and mesh export.

Examples
--------
Synthetic smoke run (no dataset needed; BASELINE config #1):
    python -m tracking_sdf_tpu.cli --preset synthetic64 --synthetic --frames 10 \
        --mesh /tmp/scene.ply

TUM sequence at the reference's configuration (config #3):
    python -m tracking_sdf_tpu.cli --preset tum256 --dataset /data/fr1_plant \
        --trajectory trajectory.txt --eval
"""
from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tracking_sdf_tpu",
        description="TSDF camera tracking & reconstruction in JAX",
    )
    p.add_argument("--preset", default="tum256",
                   help="config preset: synthetic64|tum128|tum256|tum512")
    p.add_argument("--dataset", help="TUM sequence directory (depth.txt, ...)")
    p.add_argument("--camera", default=None,
                   help="dataset intrinsics: 'fr1' (default) | 'kinect' | "
                        "'fx,fy,cx,cy[,width,height]'")
    p.add_argument("--synthetic", action="store_true",
                   help="run on a generated synthetic orbit instead of a dataset")
    p.add_argument("--frames", type=int, default=None, help="max frames")
    p.add_argument("--chunk", type=int, default=0,
                   help="batch N frames per device dispatch (brickmajor "
                        "only): one host round trip per chunk instead of "
                        "per frame; frame 0 and odd tails run per-frame")
    p.add_argument("--frame-step", type=int, default=1,
                   help="process every Nth frame (the paper's §V-D "
                        "robustness study runs every 6th)")
    p.add_argument("--realtime", type=float, default=0.0, metavar="HZ",
                   help="paced replay at HZ frames/s wall-clock with the "
                        "reference's queue-size-1 drop-stale-when-behind "
                        "semantics (sdf_reconstruction.cpp:89): when "
                        "processing lags the sensor, every frame but the "
                        "newest is dropped and the tracker must bridge the "
                        "gap. The first 2 frames are delivered un-paced "
                        "(jit warmup) before the arrival clock starts. "
                        "Drops are reported. Incompatible with --chunk. "
                        "With --multihost, rank 0 owns the arrival clock "
                        "and broadcasts the frame-index stream so every "
                        "rank drops the SAME frames.")
    p.add_argument("--trajectory", default="trajectory.txt",
                   help="output TUM trajectory path ('' disables)")
    p.add_argument("--mesh", help="export marching-cubes PLY to this path at the end")
    p.add_argument("--render",
                   help="raycast the final model from the last pose and save "
                        "a depth|normals|color PNG panel to this path")
    p.add_argument("--mesh-every", type=int, default=0,
                   help="also export every N frames (synchronous)")
    p.add_argument("--mesh-async",
                   help="export the mesh to this PLY from an async snapshot "
                        "thread at config.mesh_hz (default 1 Hz) — the "
                        "reference's concurrent visualization thread, "
                        "sdf_reconstruction.cpp:97, race-free here")
    p.add_argument("--mesh-hz", type=float, default=0.0,
                   help="async publisher rate (default 1 Hz; auto-degrades "
                        "when one export exceeds the interval — reported)")
    p.add_argument("--mesh-decimate", type=int, default=0,
                   help="mesh every Nth voxel in the ASYNC publisher only "
                        "(coarser live mesh, ~N^3 cheaper; final --mesh "
                        "stays full-res). The 512^3 1 Hz policy knob.")
    p.add_argument("--debug-nans", action="store_true",
                   help="jax.config.update('jax_debug_nans'): fail fast at "
                        "the op that produced a NaN — the reference's "
                        "valgrind/memcheck launch analog (sdf.launch.memcheck)")
    p.add_argument("--eval", action="store_true",
                   help="print ATE RMSE vs the dataset's groundtruth.txt")
    p.add_argument("--groundtruth-poses", action="store_true",
                   help="fusion-only oracle mode: poses from groundtruth "
                        "(sdf_reconstruction.cpp:51-66)")
    p.add_argument("--no-color", action="store_true", help="skip color fusion")
    p.add_argument("--no-bilateral", action="store_true")
    p.add_argument("--pixel-stride", type=int, default=None)
    p.add_argument("--color-every", type=int, default=0,
                   help="fuse COLOR on every Nth frame only (geometry "
                        "fuses every frame; 1 = reference cadence). "
                        "Presets pick the measured default.")
    p.add_argument("--brick-cap", type=int, default=0,
                   help="override FusionConfig.brick_cap (FULL-brick "
                        "capacity per frame; overflow is reported, wider "
                        "scenes than the preset's sizing may want more)")
    p.add_argument("--brick-cap-free", type=int, default=-1,
                   help="override FusionConfig.brick_cap_free (FREE-brick "
                        "row capacity; overflow reported). 0 = follow "
                        "brick_cap; negative = keep preset")
    p.add_argument("--pixel-share", type=int, default=None,
                   help="approximate fast fusion: k-voxel groups of this "
                        "size share one gathered pixel (1 = exact)")
    p.add_argument("--share-safe-classify", choices=("on", "off"),
                   default=None,
                   help="exact-under-share FREE/OCCLUDED proof bounds "
                        "(FusionConfig.share_safe_classify; DEFAULT ON "
                        "since round 4 — measured free). 'off' restores "
                        "the historical share-1-exact bounds for A/Bs")
    p.add_argument("--fusion-mode",
                   choices=("dense", "bricked", "brickmajor", "packed"),
                   default=None,
                   help="override the preset's fusion path (config.py "
                        "FusionConfig.mode)")
    p.add_argument("--distance", choices=("point_to_plane", "point_to_point"),
                   default=None,
                   help="fusion distance (paper Table I ablation axis): "
                        "point_to_plane is the reference's shipped mode "
                        "(sdf.cpp:272), point_to_point its commented-out "
                        "alternative (sdf.h:169-172)")
    p.add_argument("--storage-dtype", choices=("float32", "bfloat16"),
                   default=None,
                   help="grid value-leaf storage dtype (brickmajor mode): "
                        "bfloat16 halves D/RGB memory traffic, weights and all "
                        "arithmetic stay float32")
    p.add_argument("--weight-dtype", choices=("float32", "bfloat16"),
                   default=None,
                   help="weight-accumulator storage dtype (brickmajor "
                        "mode): bfloat16 halves W/Wc merge traffic but "
                        "quantizes the running sum — pair with "
                        "--max-weight (flagged approximation)")
    p.add_argument("--max-weight", type=float, default=-1.0,
                   help="clamp the stored fusion weight (KinectFusion-"
                        "style; the reference never clamps). 0 DISABLES "
                        "the clamp — overriding preset defaults like "
                        "tum256/tum512's 128; negative = keep preset")
    p.add_argument("--distributed", action="store_true",
                   help="shard grid+tracking over all visible devices")
    p.add_argument("--progress", action="store_true")
    p.add_argument("--json", action="store_true", help="print summary as JSON")
    p.add_argument("--profile",
                   help="capture a jax.profiler trace of the run into this "
                        "directory (view with xprof/tensorboard) — the "
                        "reference's callgrind wrapper "
                        "(sdf.launch.valgrind)")
    p.add_argument("--checkpoint",
                   help="checkpoint directory; resumes from it when present")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save the checkpoint every N frames")
    p.add_argument("--metrics-log",
                   help="append per-frame stats as JSON lines to this file")
    p.add_argument("--native-loader", action="store_true",
                   help="stream frames through the C++ prefetching loader")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend instead of JAX's default "
                        "accelerator")
    p.add_argument("--multihost", action="store_true",
                   help="call jax.distributed.initialize() first so "
                        "jax.devices() spans all hosts; combine with "
                        "--distributed to shard over the full pod slice")
    p.add_argument("--coordinator", default=None,
                   help="host:port of the jax.distributed coordinator for "
                        "--multihost (with --num-processes/--process-id); "
                        "omit to auto-detect from the cluster environment "
                        "(e.g. SLURM)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count for --multihost --coordinator")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank for --multihost --coordinator")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import dataclasses

    import jax

    if args.cpu:
        # must happen before any backend touch
        jax.config.update("jax_platforms", "cpu")
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)

    from tracking_sdf_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.multihost:
        # before ANY backend touch — importing the pipeline below builds
        # module-level jnp constants (runner.REFERENCE_INITIAL_POSE),
        # which initializes XLA and makes a later initialize() raise
        if args.coordinator:
            jax.distributed.initialize(
                coordinator_address=args.coordinator,
                num_processes=args.num_processes,
                process_id=args.process_id)
        else:
            jax.distributed.initialize()

    from tracking_sdf_tpu.config import preset
    from tracking_sdf_tpu.pipeline import Reconstruction, ate_rmse, read_trajectory

    cfg = preset(args.preset)
    changes = {}
    fusion = cfg.fusion
    if args.no_color:
        fusion = fusion._replace(fuse_color=False)
    if args.pixel_share:
        fusion = fusion._replace(pixel_share=args.pixel_share)
    if args.share_safe_classify is not None:
        fusion = fusion._replace(
            share_safe_classify=args.share_safe_classify == "on")
    if args.brick_cap:
        fusion = fusion._replace(brick_cap=args.brick_cap)
    if args.brick_cap_free >= 0:
        fusion = fusion._replace(brick_cap_free=args.brick_cap_free)
    if args.color_every:
        fusion = fusion._replace(color_every=args.color_every)
    if args.fusion_mode:
        switched = args.fusion_mode != cfg.fusion.mode
        fusion = fusion._replace(mode=args.fusion_mode)
        if args.fusion_mode in ("brickmajor", "packed") and switched \
                and cfg.grid.m % 8 == 0:
            # presets not already in a brick-major mode carry the
            # flat-layout (1, 8, 128) shape; brick-major wants the compact
            # classifier optimum (config.FusionConfig.brick_shape)
            fusion = fusion._replace(brick_shape=(8, 8, 8))
    if args.storage_dtype:
        fusion = fusion._replace(storage_dtype=args.storage_dtype)
    if args.weight_dtype:
        fusion = fusion._replace(weight_dtype=args.weight_dtype)
    if args.max_weight >= 0:
        # 0 = clamp OFF (None) — must be expressible now that presets
        # ship max_weight=128 (a falsy-zero check would silently no-op)
        fusion = fusion._replace(max_weight=args.max_weight or None)
    if args.distance:
        fusion = fusion._replace(distance=args.distance)
    if fusion is not cfg.fusion:
        changes["fusion"] = fusion
    if args.no_bilateral:
        changes["bilateral_filter"] = False
    if args.pixel_stride:
        changes["tracking"] = cfg.tracking._replace(pixel_stride=args.pixel_stride)
    if args.groundtruth_poses:
        changes["use_groundtruth"] = True
    changes["trajectory_path"] = args.trajectory or None
    if args.mesh_hz:
        changes["mesh_hz"] = args.mesh_hz
    if args.mesh_decimate:
        changes["mesh_decimate"] = args.mesh_decimate
    cfg = dataclasses.replace(cfg, **changes)

    mesh = None
    if args.distributed:
        from tracking_sdf_tpu.parallel import make_mesh

        mesh = make_mesh()

    if args.synthetic:
        dataset, cam, init_pose = _synthetic_dataset(cfg, args.frames or 20)
    elif args.dataset:
        from tracking_sdf_tpu.data.tum import TUMDataset

        dataset = TUMDataset(args.dataset, with_rgb=not args.no_color)
        if args.frame_step > 1:
            dataset = _SubsampledDataset(dataset, args.frame_step)
        cam = _parse_camera(args.camera)
        init_pose = None
        if cfg.use_groundtruth and dataset.groundtruth is None:
            print("error: --groundtruth-poses needs groundtruth.txt", file=sys.stderr)
            return 2
    else:
        print("error: need --dataset DIR or --synthetic", file=sys.stderr)
        return 2

    recon = Reconstruction(cam, cfg, initial_pose=init_pose, mesh=mesh)
    skip = 0
    if args.checkpoint:
        from tracking_sdf_tpu.pipeline import checkpoint as ckpt

        if ckpt.exists(args.checkpoint):
            recon.restore_checkpoint(args.checkpoint)
            skip = recon.frame_num
            print(f"resumed from {args.checkpoint} at frame {skip}",
                  file=sys.stderr)

    # capture before the native-loader rebinding below: the stream()
    # generator has no .groundtruth and is exhausted after run(), which
    # would silently skip --eval
    gt_source = getattr(dataset, "groundtruth", None)
    pacer = None
    if args.realtime:
        if args.chunk > 1:
            print("warning: --realtime is arrival-driven per-frame; "
                  "ignoring --chunk", file=sys.stderr)
            args.chunk = 0
        if args.multihost:
            # rank 0 owns the arrival clock; every rank replays the
            # broadcast frame-index stream in lockstep (identical drops,
            # identical trajectories — the SPMD program never diverges)
            from tracking_sdf_tpu.pipeline import MultihostRealtimePacer

            dataset = pacer = MultihostRealtimePacer(dataset,
                                                     hz=args.realtime)
        else:
            from tracking_sdf_tpu.pipeline import RealtimePacer

            dataset = pacer = RealtimePacer(dataset, hz=args.realtime)
    elif args.native_loader and hasattr(dataset, "stream"):
        # chunked runs take the raw u16/u8 wire path (6x fewer
        # host->device bytes; decoded on-device by process_chunk)
        dataset = dataset.stream(raw=args.chunk > 1)

    if args.mesh_async:
        recon.start_mesh_publisher(args.mesh_async,
                                   with_colors=not args.no_color)

    profile_cm = None
    if args.profile:
        profile_cm = jax.profiler.trace(args.profile)
        profile_cm.__enter__()
    try:
        recon.run(dataset, max_frames=args.frames, progress=args.progress,
                  mesh_every=args.mesh_every, mesh_path=args.mesh,
                  checkpoint_every=args.checkpoint_every,
                  checkpoint_path=args.checkpoint,
                  metrics_log=args.metrics_log, skip_frames=skip,
                  chunk=args.chunk)
        if args.mesh:
            n_tri = recon.export_mesh(args.mesh)
            print(f"mesh: {n_tri} triangles -> {args.mesh}", file=sys.stderr)
        if args.render:
            from tracking_sdf_tpu.render.image_io import save_render_png

            save_render_png(recon.render(with_color=not args.no_color),
                            args.render)
            print(f"render -> {args.render}", file=sys.stderr)
    finally:
        if profile_cm is not None:
            profile_cm.__exit__(None, None, None)
        recon.close()

    summary = recon.summary()
    if pacer is not None:
        summary["realtime_dropped"] = float(pacer.dropped)
        summary["realtime_yielded"] = float(pacer.yielded)
        print(f"realtime: {pacer.yielded} frames processed, "
              f"{pacer.dropped} dropped stale at {args.realtime:g} Hz",
              file=sys.stderr)
    if args.eval and args.trajectory:
        gt = gt_source
        if gt is None:
            # synthetic mode: build the groundtruth from the frames' poses
            import numpy as np

            from tracking_sdf_tpu.pipeline import Trajectory

            frames_with_gt = [f for f in dataset
                              if getattr(f, "gt_pose", None) is not None]
            if frames_with_gt:
                gt = Trajectory(
                    np.asarray([f.timestamp for f in frames_with_gt]),
                    np.stack([f.gt_pose[0] for f in frames_with_gt]),
                    np.stack([f.gt_pose[1] for f in frames_with_gt]),
                )
        if gt is not None:
            from tracking_sdf_tpu.pipeline.trajectory import rpe_rmse

            est = read_trajectory(args.trajectory)
            rmse, n = ate_rmse(est, gt)
            summary["ate_rmse_m"] = rmse
            summary["ate_pairs"] = float(n)
            rpe_t, rpe_r = rpe_rmse(est, gt, delta=1)
            summary["rpe_trans_m"] = rpe_t
            summary["rpe_rot_rad"] = rpe_r

    if args.json:
        # NaN (e.g. ate_rmse with <2 associated pairs) is not valid JSON —
        # json.dumps would emit the bare token `NaN` that strict parsers
        # reject; map non-finite floats to null
        import math

        print(json.dumps({
            k: (None if isinstance(v, float) and not math.isfinite(v) else v)
            for k, v in summary.items()
        }))
    else:
        for k, v in summary.items():
            print(f"{k}: {v:.4f}")
    return 0


class _SubsampledDataset:
    """Every-Nth-frame view of a TUMDataset (paper §V-D robustness study:
    the tracker must survive 6x the inter-frame motion)."""

    def __init__(self, ds, step: int):
        self._ds = ds
        self._idx = list(range(0, len(ds), step))
        self.groundtruth = ds.groundtruth

    def __len__(self):
        return len(self._idx)

    def __getitem__(self, i):
        return self._ds[self._idx[i]]

    def __iter__(self):
        for i in self._idx:
            yield self._ds[i]

    def stream(self, **kw):
        # index-subset prefetching isn't plumbed through the native loader;
        # fall back to per-frame decoding (correctness identical)
        return iter(self)


def _parse_camera(spec):
    """'fr1' | 'kinect' | 'fx,fy,cx,cy[,width,height]' -> PinholeCamera."""
    from tracking_sdf_tpu.core.camera import (
        PinholeCamera, ros_default_camera, tum_fr1_camera)

    if spec in (None, "fr1"):
        return tum_fr1_camera()
    if spec == "kinect":
        return ros_default_camera()
    vals = [float(v) for v in spec.split(",")]
    if len(vals) not in (4, 6):
        raise SystemExit(f"--camera: expected 4 or 6 comma-separated values, "
                         f"got {len(vals)}")
    kw = dict(zip(("fx", "fy", "cx", "cy"), vals[:4]))
    if len(vals) == 6:
        kw.update(width=int(vals[4]), height=int(vals[5]))
    return PinholeCamera(**kw)


def _synthetic_dataset(cfg, n_frames):
    """Orbit around the default two-object synthetic scene."""
    import jax.numpy as jnp
    import numpy as np

    from tracking_sdf_tpu.core.camera import PinholeCamera
    from tracking_sdf_tpu.core.lie import quaternion_from_matrix
    from tracking_sdf_tpu.data.synthetic import (
        CuboidScene, SphereScene, look_at, render_scene_depth,
    )
    from tracking_sdf_tpu.data.tum import TUMFrame

    g = cfg.grid
    cx = g.origin[0] + g.width / 2
    cy = g.origin[1] + g.height / 2
    cz = g.origin[2] + g.depth / 2
    r = min(g.width, g.height, g.depth)
    sphere = SphereScene(center=(cx + 0.1 * r, cy + 0.05 * r, cz), radius=0.2 * r)
    box = CuboidScene(
        min_corner=(cx - 0.35 * r, cy - 0.2 * r, cz - 0.25 * r),
        max_corner=(cx - 0.15 * r, cy + 0.2 * r, cz + 0.1 * r),
    )

    class Scene:
        def sdf(self, x):
            return jnp.minimum(sphere.sdf(x), box.sdf(x))

        def color(self, x):
            return sphere.color(x)

        def intersect(self, o, d):
            ta, tb = sphere.intersect(o, d), box.intersect(o, d)
            return jnp.where(jnp.isnan(ta), tb,
                             jnp.where(jnp.isnan(tb), ta, jnp.minimum(ta, tb)))

    scene = Scene()
    cam = PinholeCamera(fx=220.0, fy=220.0, cx=127.5, cy=95.5, width=256, height=192)

    frames = []
    poses = []
    for i in range(n_frames):
        # gentle orbit: inter-frame motion a few cm, trackable frame-to-model
        a = 0.08 * np.sin(2 * np.pi * i / max(n_frames, 2))
        eye = (cx + 0.45 * r * np.sin(a), cy - 0.45 * r * np.cos(a), cz + 0.1 * r)
        pose = look_at(eye, (cx, cy, cz))
        depth = render_scene_depth(scene, cam, pose)
        rgb = jnp.broadcast_to(jnp.asarray([0.6, 0.5, 0.4]), depth.shape + (3,))
        q = np.asarray(quaternion_from_matrix(pose.R))
        frames.append(TUMFrame(
            timestamp=1000.0 + i / 30.0,
            depth=np.asarray(depth),
            rgb=np.asarray(rgb),
            gt_pose=(np.asarray(pose.t), q),
        ))
        poses.append(pose)
    return frames, cam, poses[0]


if __name__ == "__main__":
    sys.exit(main())
