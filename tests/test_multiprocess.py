"""REAL multi-process jax.distributed equivalence (SURVEY §4.6).

Everything else in the suite runs ONE process with a virtual 8-device mesh;
this test spawns an actual 2-process CPU 'pod' (4 virtual devices each,
jax.distributed.initialize + Gloo collectives) running scripts/mp_worker.py:
SPMD brickmajor fusion, zero-relayout tracking whose ppermute halo and psum
cross the process boundary, and marching_cubes_sharded exercising the
cross-process halo-plane collective (the branch that previously dropped an
(m-1)^2 cell plane). Outputs must match a single-process dense run.

Reference context: the reference is single-process shared memory
(sdf_reconstruction.cpp:89-91); this is the multi-host testability tier
SURVEY §4.6 mandates on top of it.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import mp_worker  # noqa: E402  (scripts/mp_worker.py)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_pod(n_procs: int, devices_per_proc: int, outdir):
    """Spawn an n-rank jax.distributed pod of mp_worker.py and return the
    per-rank npz outputs (shared by the 2- and 4-rank tests)."""
    port = _free_port()
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=(f"--xla_force_host_platform_device_count="
                   f"{devices_per_proc}"),
    )
    env.pop("PYTHONPATH", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "mp_worker.py"),
             f"localhost:{port}", str(n_procs), str(pid), str(outdir)],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(n_procs)
    ]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    return [np.load(outdir / f"out_{pid}.npz") for pid in range(n_procs)]


@pytest.fixture(scope="module")
def mp_outputs(tmp_path_factory):
    """Run the 2-process pod once; yield the two ranks' npz outputs."""
    return _launch_pod(2, 4, tmp_path_factory.mktemp("mp"))


def test_multiprocess_pod_shape(mp_outputs):
    for out in mp_outputs:
        assert int(out["n_dev"]) == 8  # 2 procs x 4 local devices
        assert int(out["n_procs"]) == 2
        assert int(out["overflow"]) == 0
        assert int(out["n_full"]) > 0


def test_multiprocess_grid_and_pose_match_dense(mp_outputs):
    """Cross-process SPMD fuse+track == single-process dense (the same
    tolerance class as the virtual-mesh tests: fusion is per-voxel local,
    tracking differs only by psum/Gloo reduction order)."""
    ref_grid, ref_res = mp_worker.reference_outputs()
    out0, out1 = mp_outputs
    # both ranks gathered the same replicated global grid
    for name in ("D", "W", "R", "G", "B", "Wc"):
        np.testing.assert_array_equal(out0[name], out1[name], err_msg=name)
    np.testing.assert_allclose(out0["W"], np.asarray(ref_grid.W), atol=1e-5)
    np.testing.assert_allclose(out0["D"], np.asarray(ref_grid.D), atol=1e-4)
    ok = np.asarray(ref_grid.Wc) > 0
    np.testing.assert_allclose(out0["R"][ok], np.asarray(ref_grid.R)[ok],
                               atol=1e-4)
    assert int(out0["num_valid"]) == int(ref_res.num_valid)
    np.testing.assert_allclose(out0["pose_t"], np.asarray(ref_res.pose.t),
                               atol=2e-4)
    np.testing.assert_allclose(out0["pose_R"], np.asarray(ref_res.pose.R),
                               atol=2e-4)


def test_multihost_cli_end_to_end(tmp_path):
    """`cli.py --multihost --coordinator ... --distributed` runs a real
    2-process reconstruction end to end (executes cli.py's
    jax.distributed.initialize branch + parallel.make_mesh over both
    processes): both ranks must converge (ATE gate) and produce the SAME
    trajectory (the SPMD program is replicated — pose results are
    identical on every rank)."""
    import json

    port = _free_port()
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    env.pop("PYTHONPATH", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "tracking_sdf_tpu.cli", "--cpu",
             "--multihost", "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "--distributed", "--preset", "synthetic64",
             "--fusion-mode", "brickmajor", "--synthetic", "--frames", "4",
             "--trajectory", str(tmp_path / f"traj_{pid}.txt"),
             "--eval", "--json"],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        outs.append((out, err))
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"cli rank failed:\n{err[-4000:]}"
    summaries = [json.loads(out.splitlines()[-1]) for out, _ in outs]
    for s in summaries:
        assert s["frames"] == 4.0
        assert s["ate_rmse_m"] is not None and s["ate_rmse_m"] < 0.05
    t0 = (tmp_path / "traj_0.txt").read_text()
    t1 = (tmp_path / "traj_1.txt").read_text()
    assert t0 == t1 and len(t0.splitlines()) == 4


def test_four_process_pod_meshing_exact(tmp_path):
    """Generality at 4 ranks x 2 local devices (THREE cross-process slab
    boundaries): the halo collective + sharded meshing must stay exact
    when most boundaries cross ranks, not just the single 2-rank split."""
    outs = _launch_pod(4, 2, tmp_path)
    from tracking_sdf_tpu.grid.grid import TSDFGrid
    from tracking_sdf_tpu.render.marching_cubes import marching_cubes

    assert all(int(o["n_procs"]) == 4 for o in outs)
    assert all(int(o["dropped"]) == 0 for o in outs)
    grid = TSDFGrid(*(outs[0][n] for n in ("D", "W", "R", "G", "B", "Wc")))
    ref = marching_cubes(grid, params=mp_worker.build_workload()[0],
                         with_colors=True)
    tris = np.concatenate([o["tris"] for o in outs], axis=0)
    cols = np.concatenate([o["cols"] for o in outs], axis=0)
    assert tris.shape[0] == ref.num_triangles
    np.testing.assert_allclose(tris, ref.vertices, atol=1e-6)
    np.testing.assert_allclose(cols, ref.colors, atol=1e-6)


def test_multiprocess_sharded_meshing_exact(mp_outputs):
    """Concatenated per-rank triangle slabs == the unsharded mesher run on
    the SAME (gathered) grid — including the cross-process boundary plane
    the old halo branch skipped. dropped_cells must be 0 on both ranks."""
    from tracking_sdf_tpu.grid.grid import TSDFGrid
    from tracking_sdf_tpu.render.marching_cubes import marching_cubes

    out0, out1 = mp_outputs
    assert int(out0["dropped"]) == 0
    assert int(out1["dropped"]) == 0
    grid = TSDFGrid(*(out0[name] for name in ("D", "W", "R", "G", "B", "Wc")))
    ref = marching_cubes(grid, params=mp_worker.build_workload()[0],
                         with_colors=True)
    tris = np.concatenate([out0["tris"], out1["tris"]], axis=0)
    cols = np.concatenate([out0["cols"], out1["cols"]], axis=0)
    assert tris.shape[0] == ref.num_triangles
    np.testing.assert_allclose(tris, ref.vertices, atol=1e-6)
    np.testing.assert_allclose(cols, ref.colors, atol=1e-6)


def test_multihost_cli_realtime(tmp_path):
    """--realtime --multihost: rank 0 owns the
    arrival clock and broadcasts the frame-index stream. Both ranks must
    produce IDENTICAL trajectories and IDENTICAL drop counts — the proof
    that the pod never desynchronized on frame choice."""
    import json

    port = _free_port()
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    env.pop("PYTHONPATH", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "tracking_sdf_tpu.cli", "--cpu",
             "--multihost", "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "--distributed", "--preset", "synthetic64",
             "--fusion-mode", "brickmajor", "--synthetic", "--frames", "8",
             "--realtime", "120",
             "--trajectory", str(tmp_path / f"traj_{pid}.txt"),
             "--eval", "--json"],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        outs.append((out, err))
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"cli rank failed:\n{err[-4000:]}"
    summaries = [json.loads(out.splitlines()[-1]) for out, _ in outs]
    s0, s1 = summaries
    # CPU frames take >> 1/120 s: drops must occur, and IDENTICALLY
    assert s0["realtime_dropped"] > 0
    assert s0["realtime_dropped"] == s1["realtime_dropped"]
    assert s0["realtime_yielded"] == s1["realtime_yielded"]
    assert s0["realtime_yielded"] + s0["realtime_dropped"] == 8
    for s in summaries:
        assert s["frames"] == s["realtime_yielded"]
        assert s["ate_rmse_m"] is not None and s["ate_rmse_m"] < 0.08
    # identical trajectories byte-for-byte (replicated SPMD + same frames)
    t0 = (tmp_path / "traj_0.txt").read_text()
    t1 = (tmp_path / "traj_1.txt").read_text()
    assert t0 == t1 and len(t0.splitlines()) == s0["realtime_yielded"]
