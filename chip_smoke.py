"""Smoke test of the tracking + fusion pipeline on one NVIDIA GPU.

Drives the main path once at full size through the entry points a user
calls, and checks what comes out:

1. device: the default JAX device must be a GPU (there is no CPU
   fallback); prints the card's name and power limit, the JAX version and
   the compile-cache directory;
2. tum256 end to end: a seeded 640x480 TUM-layout sequence
   (data.make_sequence.generate) through ``cli.main --eval``; gates the
   ATE, rejected frames, the exported mesh and the final render; then the
   same sequence with ``--chunk 8``, whose trajectory must match;
3. tum512 on the same path, and the compiled memory of its frame step;
4. brick-major fusion and brick-view tracking against the dense reference
   (fusion/fuse.py, dense track_frame) on one 640x480 frame at 256^3;
5. the tum256 run's frame rate and track/fuse split (printed, not gated).

Any failing phase raises and the script exits nonzero; only when all pass
is the last stdout line ``{"ok": true, "device": {...}}``.

``--four-cards`` runs only the sharded path instead: tum256 over a 1-D
mesh of four GPUs (``cli --distributed``) against device 0 alone, and
``__graft_entry__.dryrun_multichip(4)``.

Usage (from the checkout root):  python chip_smoke.py [--four-cards]
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, ".chip_smoke")  # listed in .gitignore

# The paper's fr1/plant ATE (BASELINE.md): every end-to-end run must do
# at least as well on the synthetic sequence.
ATE_GATE_M = 0.047
# Brick-major vs dense fusion of one frame. Both run the same per-voxel
# float32 math, but a GPU scatter-add sums colliding updates in no fixed
# order and XLA fuses the two programs differently, so the last bits may
# differ; 1e-5 is the bound the CPU equivalence tests use
# (tests/test_brick_fusion.py).
FUSE_TOL = 1e-5
# Brick-view vs dense tracking: the bound tests/test_parallel.py uses for
# tracking over two storage layouts (f32 reassociation in the J^T J sums).
POSE_TOL = 5e-5
# Per-frame vs chunked run of one sequence, and sharded vs single device:
# different programs (padded caps, psum order, scatter order) reassociate
# float32 sums and can flip bf16 roundings of the stored SDF, and the
# closed tracking loop carries those differences forward. Measured on
# H100s over the 57-frame tum256 run: 2.0e-6 m and 2.8e-6 (per-frame vs
# chunk), 2.2e-6 m and 1.6e-6 (four GPUs vs one). The bound leaves >200x
# for run-to-run order and stays ~1% of the ATE gate.
TRAJ_TOL_M = 5e-4
TRAJ_TOL_ROT = 5e-4  # max |dR| entry

SEQ_FRAMES = 57  # frame 0 per frame, then seven chunks of 8
TUM512_FRAMES = 12  # a multiple of tum512's color_every=3
CHUNK = 8


class SmokeFailure(AssertionError):
    """A phase produced a wrong or missing result."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ---- phase 1 ---------------------------------------------------------------

def device_phase(n_cards: int = 1) -> dict:
    """Fails unless JAX's default backend is a GPU with ``n_cards`` cards."""
    import jax

    from tracking_sdf_tpu.utils.compile_cache import enable_compile_cache
    from tracking_sdf_tpu.utils.gpu import card_line, require_gpu

    cache = enable_compile_cache()
    d = require_gpu("chip_smoke")
    devs = jax.devices()
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, found {len(devs)}")
    card = card_line()
    print(f"card: {card}")
    print(f"device_kind: {d.device_kind}; jax {jax.__version__}; "
          f"{len(devs)} device(s); compile cache: {cache}")
    return {"card": card, "platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


# ---- phases 2 and 3 ---------------------------------------------------------

def make_sequence(root: str, n_frames: int, width: int = 640,
                  height: int = 480, seed: int = 0) -> str:
    """Seeded TUM-layout sequence (default noise and dropout) -> the
    ``--camera`` spec of the generator's intrinsics."""
    from tracking_sdf_tpu.data.make_sequence import generate

    shutil.rmtree(root, ignore_errors=True)
    stats = generate(root, n_frames=n_frames, width=width, height=height,
                     seed=seed)
    fx, fy, cx, cy, w, h = stats["camera"]
    return f"{fx},{fy},{cx},{cy},{w},{h}"


def _ply_faces(path: str) -> int:
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode("ascii", "replace").strip()
            if line.startswith("element face"):
                return int(line.split()[2])
            if line == "end_header":
                break
    raise SmokeFailure(f"{path}: no face count in the PLY header")


def _render_hits(path: str, width: int) -> int:
    """Hit pixels of a saved render panel: its leftmost ``width`` columns
    are the depth image, black exactly where a ray missed."""
    from tracking_sdf_tpu.data.png import read_png

    return int(np.count_nonzero(read_png(path)[:, :width].max(axis=-1)))


def cli_phase(preset_name: str, data_dir: str, camera: str, out_dir: str,
              frames: int, chunk: int = 0, extra=()) -> dict:
    """One ``cli.main --eval`` run; gates ATE, rejected frames, mesh and
    render. Returns the JSON summary plus the gate values."""
    from tracking_sdf_tpu import cli

    tag = f"{preset_name}_c{chunk}" + ("_dist" if "--distributed" in extra
                                       else "")
    paths = {k: os.path.join(out_dir, f"{tag}.{ext}") for k, ext in
             (("traj", "txt"), ("log", "jsonl"), ("mesh", "ply"),
              ("render", "png"))}
    for p in paths.values():
        if os.path.exists(p):
            os.remove(p)
    argv = ["--preset", preset_name, "--dataset", data_dir,
            "--camera", camera, "--frames", str(frames), "--eval", "--json",
            "--trajectory", paths["traj"], "--metrics-log", paths["log"],
            "--mesh", paths["mesh"], "--render", paths["render"],
            *(["--chunk", str(chunk)] if chunk else []), *extra]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"{tag}: cli exited {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    with open(paths["log"]) as f:
        stats = [json.loads(line) for line in f if line.strip()]
    rejected = sum(bool(s["rejected"]) for s in stats)
    # medians over the frames after the first: the mean would carry the
    # compiles that land on early frames
    out = dict(summary, tag=tag, wall_s=wall, rejected=rejected,
               track_ms_median=float(np.median([x["track_ms"]
                                                for x in stats[1:]])),
               fuse_ms_median=float(np.median([x["fuse_ms"]
                                               for x in stats[1:]])),
               triangles=_ply_faces(paths["mesh"]),
               render_hits=_render_hits(paths["render"],
                                        int(camera.split(",")[4])),
               trajectory=paths["traj"])
    print(f"{tag}: frames {len(stats)}, ATE {out.get('ate_rmse_m')} m, "
          f"rejected {rejected}, mesh {out['triangles']} triangles, render "
          f"hits {out['render_hits']} px, wall {wall:.1f} s incl. compile")
    check(len(stats) == frames, f"{tag}: {len(stats)} frames ran, "
          f"expected {frames}")
    ate = out.get("ate_rmse_m")
    check(ate is not None and ate <= ATE_GATE_M,
          f"{tag}: ATE {ate} m above the {ATE_GATE_M} m gate")
    check(rejected == 0, f"{tag}: {rejected} rejected frames")
    check(out["triangles"] > 0, f"{tag}: empty mesh")
    check(out["render_hits"] > 0, f"{tag}: render has no hits")
    return out


def compare_trajectories(path_a: str, path_b: str, what: str) -> dict:
    """Max translation and rotation-entry gaps of two runs' trajectories."""
    from tracking_sdf_tpu.core.lie import matrix_from_quaternion
    from tracking_sdf_tpu.pipeline import read_trajectory

    a, b = read_trajectory(path_a), read_trajectory(path_b)
    check(len(a.timestamps) == len(b.timestamps)
          and np.array_equal(a.timestamps, b.timestamps),
          f"{what}: the runs wrote different frame sets")
    dt = float(np.max(np.linalg.norm(a.translations - b.translations,
                                     axis=1)))
    ra = np.asarray(matrix_from_quaternion(np.asarray(a.quaternions,
                                                      np.float32)))
    rb = np.asarray(matrix_from_quaternion(np.asarray(b.quaternions,
                                                      np.float32)))
    dr = float(np.max(np.abs(ra - rb)))
    print(f"{what}: max |dt| {dt:.3e} m (tol {TRAJ_TOL_M}), max |dR| "
          f"{dr:.3e} (tol {TRAJ_TOL_ROT}) over {len(a.timestamps)} poses")
    check(dt <= TRAJ_TOL_M and dr <= TRAJ_TOL_ROT,
          f"{what}: trajectories differ beyond tolerance")
    return {"max_dt_m": dt, "max_dR": dr}


def memory_phase(preset_name: str) -> dict:
    """Compiled memory of the preset's frame step (track + fuse)."""
    import jax

    import __graft_entry__

    fn, args = __graft_entry__.entry(preset_name)
    ma = jax.jit(fn).lower(*args).compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    out = {k: int(getattr(ma, k)) for k in fields if hasattr(ma, k)}
    print(f"{preset_name} frame step memory_analysis: "
          + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in out.items()))
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        out["peak_bytes_in_use"] = int(stats["peak_bytes_in_use"])
        print(f"device peak_bytes_in_use so far: "
              f"{out['peak_bytes_in_use'] / 2**30:.2f} GiB")
    return out


# ---- phase 4 ---------------------------------------------------------------

def compare_phase(cfg, data_dir: str, cam) -> dict:
    """Brick-major fusion (exact settings) vs dense fuse_frame, then
    brick-view vs dense tracking, on the sequence's first two frames."""
    import jax
    import jax.numpy as jnp

    from tracking_sdf_tpu.data.tum import TUMDataset
    from tracking_sdf_tpu.fusion.brickmajor import (
        brick_masked_view, dense_from_brick_grid, empty_brick_grid,
        fuse_frame_brickmajor)
    from tracking_sdf_tpu.fusion.fuse import fuse_frame
    from tracking_sdf_tpu.grid.grid import empty_grid
    from tracking_sdf_tpu.pipeline.runner import REFERENCE_INITIAL_POSE
    from tracking_sdf_tpu.tracking.gauss_newton import track_frame
    from tracking_sdf_tpu.tracking.preprocess import preprocess_frame

    params, tcfg = cfg.grid, cfg.tracking
    bs = (8, 8, 8)
    # exact settings: one pixel row per voxel, float32 storage and
    # weights, no weight clamp, color every frame
    exact = cfg.fusion._replace(pixel_share=1, pixel_share_j=1,
                                storage_dtype="float32",
                                weight_dtype="float32", max_weight=None,
                                color_every=1, fuse_color=True)
    ds = TUMDataset(data_dir)
    f0, f1 = ds[0], ds[1]

    def prep(frame):
        return preprocess_frame(
            jnp.asarray(frame.depth), cam=cam, bilateral=cfg.bilateral_filter,
            bilateral_mode=cfg.bilateral_mode)

    pts0, nrm0 = prep(f0)
    rgb0 = jnp.asarray(f0.rgb)
    pose0 = REFERENCE_INITIAL_POSE
    n_bricks = (params.m // bs[0]) * (params.m // bs[1]) * (params.m // bs[2])
    bg, _, st = fuse_frame_brickmajor(
        empty_brick_grid(params, bs), pose0, pts0, nrm0, rgb0,
        params=params, cam=cam, cfg=exact._replace(mode="brickmajor"), bs=bs,
        cap=n_bricks, cap_free=n_bricks, emit_dm=False)
    check(int(st.overflow) == 0 and int(st.overflow_active) == 0,
          "brick caps overflowed in the reference comparison")
    gd = fuse_frame(empty_grid(params), pose0, pts0, nrm0, rgb0,
                    params=params, cam=cam, cfg=exact._replace(mode="dense"))
    gb = dense_from_brick_grid(bg, params, bs)
    Wb, Wd = np.asarray(gb.W), np.asarray(gd.W)
    seen = (Wb > 0) & (Wd > 0)
    colored = np.asarray(gb.Wc) > 0
    res = {
        "n_full": int(st.n_full),
        "W_support_mismatch": int(np.count_nonzero((Wb > 0) != (Wd > 0))),
        "W_bitwise_equal": bool(np.array_equal(Wb, Wd)),
        "W_max_diff": float(np.max(np.abs(Wb - Wd))),
        "D_max_diff": float(np.max(np.abs(np.asarray(gb.D)[seen]
                                          - np.asarray(gd.D)[seen]))),
        "rgb_max_diff": max(float(np.max(np.abs(
            np.asarray(getattr(gb, c))[colored]
            - np.asarray(getattr(gd, c))[colored]))) for c in "RGB"),
        "observed_voxels": int(np.count_nonzero(seen)),
        "colored_voxels": int(np.count_nonzero(colored)),
    }
    # color fuses in surface-band bricks only (fusion/brick.py); the dense
    # path's near-surface colored voxels must all be covered
    near = (np.abs(np.asarray(gd.D)) < params.delta / 2) \
        & (np.asarray(gd.Wc) > 0)
    res["band_color_uncovered"] = int(np.count_nonzero(near & ~colored))
    print(f"fusion brick-major vs dense at {params.m}^3, precision HIGHEST, "
          f"tol {FUSE_TOL}: " + json.dumps(res))
    check(res["observed_voxels"] > 0 and res["colored_voxels"] > 0,
          "reference comparison fused nothing")
    check(res["W_support_mismatch"] == 0 and res["W_max_diff"] <= FUSE_TOL,
          "W differs between brick-major and dense fusion")
    check(res["D_max_diff"] <= FUSE_TOL, "D differs beyond tolerance")
    check(res["rgb_max_diff"] <= FUSE_TOL, "RGB differs beyond tolerance")
    check(res["band_color_uncovered"] == 0,
          "surface-band voxels left without color")

    pts1, _ = prep(f1)
    s = tcfg.pixel_stride
    pts_s = pts1[::s, ::s].reshape(-1, 3)
    r_bv = track_frame(None, pose0, pts_s, params=params, cfg=tcfg,
                       Dm=brick_masked_view(bg, params, bs))
    r_d = track_frame(gd, pose0, pts_s, params=params, cfg=tcfg)
    jax.block_until_ready((r_bv.pose, r_d.pose))
    trk = {
        "dt": float(np.max(np.abs(np.asarray(r_bv.pose.t)
                                  - np.asarray(r_d.pose.t)))),
        "dR": float(np.max(np.abs(np.asarray(r_bv.pose.R)
                                  - np.asarray(r_d.pose.R)))),
        "num_valid": [int(r_bv.num_valid), int(r_d.num_valid)],
        "iterations": [int(r_bv.iterations), int(r_d.iterations)],
    }
    print(f"tracking brick-view vs dense, precision HIGHEST, tol {POSE_TOL}: "
          + json.dumps(trk))
    check(trk["num_valid"][0] == trk["num_valid"][1] > 0,
          "tracking num_valid differs")
    check(trk["dt"] <= POSE_TOL and trk["dR"] <= POSE_TOL,
          "tracked poses differ beyond tolerance")
    res.update(track=trk)
    return res


# ---- drivers ---------------------------------------------------------------

def print_timing(r: dict, card: str) -> None:
    """Host-clock per-frame split of one CLI run (not gated). Chunked runs
    report the chunk's wall time spread over its frames as track time
    and a separately calibrated on-device fuse time."""
    ms = r["track_ms_median"] + r["fuse_ms_median"]
    print(f"timing {r['tag']} [{card}]: median track "
          f"{r['track_ms_median']:.2f} ms + fuse {r['fuse_ms_median']:.2f} ms"
          f" = {ms:.2f} ms/frame ({1e3 / ms:.1f} frames/s); host clock "
          f"per frame, frames after the first, compiles included in "
          f"{r['wall_s']:.1f} s wall")


def _sequence():
    """The seeded 640x480 sequence every driver runs: (dir, camera spec)."""
    os.makedirs(WORK_DIR, exist_ok=True)
    data = os.path.join(WORK_DIR, "tum_seq")
    t0 = time.perf_counter()
    camera = make_sequence(data, SEQ_FRAMES)
    print(f"generated {SEQ_FRAMES} frames 640x480 in "
          f"{time.perf_counter() - t0:.1f} s")
    return data, camera


def run_one_card() -> dict:
    dev = device_phase(1)
    from tracking_sdf_tpu.cli import _parse_camera
    from tracking_sdf_tpu.config import preset

    data, camera = _sequence()
    r256 = cli_phase("tum256", data, camera, WORK_DIR, SEQ_FRAMES)
    r256c = cli_phase("tum256", data, camera, WORK_DIR, SEQ_FRAMES,
                      chunk=CHUNK)
    compare_trajectories(r256["trajectory"], r256c["trajectory"],
                         f"tum256 per-frame vs --chunk {CHUNK}")

    cli_phase("tum512", data, camera, WORK_DIR, TUM512_FRAMES)
    memory_phase("tum512")

    compare_phase(preset("tum256"), data, _parse_camera(camera))

    for r in (r256, r256c):
        print_timing(r, dev["card"])
    return dev


def run_four_cards() -> dict:
    import __graft_entry__

    dev = device_phase(4)
    data, camera = _sequence()
    single = cli_phase("tum256", data, camera, WORK_DIR, SEQ_FRAMES)
    sharded = cli_phase("tum256", data, camera, WORK_DIR, SEQ_FRAMES,
                        extra=("--distributed",))
    compare_trajectories(single["trajectory"], sharded["trajectory"],
                         "tum256 4-GPU mesh vs device 0")

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    print(f"dryrun_multichip(4) passed in {time.perf_counter() - t0:.1f} s")
    for r in (single, sharded):
        print_timing(r, dev["card"])
    return dev


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded path on four GPUs")
    args = p.parse_args(argv)
    dev = run_four_cards() if args.four_cards else run_one_card()
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
