"""chip_smoke.py's phase functions, run on the CPU at a small size.

The script runs tum256/tum512 on 640x480 frames on the card; here the same
functions run on a 160x120 sequence with the 128^3 preset switched to the
brick-major path (and a 64^3 grid for the reference comparison), so every
gate and every parser is exercised without a GPU.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

FRAMES = 6
BRICKMAJOR = ("--fusion-mode", "brickmajor")


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke")
    data = str(root / "seq")
    camera = chip_smoke.make_sequence(data, FRAMES, width=160, height=120)
    return data, camera, str(root)


def _phase_device(data, camera, out):
    # the suite runs on the CPU: the device phase must refuse it
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.device_phase(1)


def _phase_sequence(data, camera, out):
    fx, fy, cx, cy, w, h = camera.split(",")
    assert (int(w), int(h)) == (160, 120) and float(fx) > 0
    for name in ("depth.txt", "rgb.txt", "groundtruth.txt"):
        assert os.path.exists(os.path.join(data, name))
    with open(os.path.join(data, "depth.txt")) as f:
        assert sum(not ln.startswith("#") for ln in f) == FRAMES


def _phase_cli(data, camera, out):
    r = chip_smoke.cli_phase("tum128", data, camera, out, FRAMES,
                             extra=BRICKMAJOR)
    assert r["rejected"] == 0 and r["triangles"] > 0
    assert 0 < r["render_hits"] <= 160 * 120
    assert r["ate_rmse_m"] <= chip_smoke.ATE_GATE_M
    assert r["track_ms_median"] > 0 and r["fuse_ms_median"] > 0
    chip_smoke.print_timing(r, "cpu")


def _phase_reference(data, camera, out):
    from tracking_sdf_tpu.cli import _parse_camera
    from tracking_sdf_tpu.config import GridParams, preset

    cfg = dataclasses.replace(preset("tum256"), grid=GridParams(m=64))
    res = chip_smoke.compare_phase(cfg, data, _parse_camera(camera))
    assert res["W_support_mismatch"] == 0
    assert res["D_max_diff"] <= chip_smoke.FUSE_TOL
    assert res["track"]["num_valid"][0] == res["track"]["num_valid"][1] > 0


def _phase_memory(data, camera, out):
    res = chip_smoke.memory_phase("tum128")
    assert res["argument_size_in_bytes"] > 0
    assert res["output_size_in_bytes"] > 0


def _phase_trajectories(data, camera, out):
    from tracking_sdf_tpu.core.lie import Pose, se3_exp
    from tracking_sdf_tpu.pipeline.trajectory import TrajectoryWriter

    def write(path, shift):
        w = TrajectoryWriter(path)
        for i in range(4):
            p = se3_exp(np.asarray([0.01 * i, 0, 0, 0, 0.02 * i, 0],
                                   np.float32))
            w.write(float(i), Pose(p.R, p.t + np.float32(shift)))
        w.close()

    a, b, c = (os.path.join(out, f"traj_{k}.txt") for k in "abc")
    write(a, 0.0)
    write(b, 0.0)
    write(c, 10 * chip_smoke.TRAJ_TOL_M)
    same = chip_smoke.compare_trajectories(a, b, "identical")
    assert same == {"max_dt_m": 0.0, "max_dR": 0.0}
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.compare_trajectories(a, c, "shifted")


@pytest.mark.parametrize("phase", [
    _phase_device, _phase_sequence, _phase_cli, _phase_reference,
    _phase_memory, _phase_trajectories,
], ids=["device", "sequence", "cli", "reference", "memory", "trajectories"])
def test_chip_smoke_phase(phase, sequence):
    phase(*sequence)
