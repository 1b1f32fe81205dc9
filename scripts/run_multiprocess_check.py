"""Check that the REAL multi-process path runs and matches one process.

Launches the 2-process CPU 'pod' (scripts/mp_worker.py — jax.distributed
+ Gloo, SPMD fuse/track across the process boundary, cross-process
marching-cubes halo collective), compares against the single-process dense
reference, and prints a machine-readable summary (also written to out.json
when a path is given).

Usage: python scripts/run_multiprocess_check.py [out.json]
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))


def main(out_path: str) -> int:
    import numpy as np

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("PYTHONPATH", None)
    outdir = tempfile.mkdtemp(prefix="mpcheck_")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "mp_worker.py"),
             f"localhost:{port}", "2", str(pid), outdir],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    logs = [p.communicate(timeout=900)[0] for p in procs]
    result = {"ok": False, "n_processes": 2, "devices_per_process": 4}
    if any(p.returncode != 0 for p in procs):
        result["error"] = "".join(logs)[-2000:]
        _write(out_path, result)
        print(json.dumps(result, indent=1))
        return 1

    import jax

    jax.config.update("jax_platforms", "cpu")
    import mp_worker

    outs = [np.load(os.path.join(outdir, f"out_{pid}.npz"))
            for pid in range(2)]
    ref_grid, ref_res = mp_worker.reference_outputs()
    from tracking_sdf_tpu.grid.grid import TSDFGrid
    from tracking_sdf_tpu.render.marching_cubes import marching_cubes

    grid = TSDFGrid(*(outs[0][n] for n in ("D", "W", "R", "G", "B", "Wc")))
    ref_mesh = marching_cubes(grid, params=mp_worker.build_workload()[0],
                              with_colors=True)
    tris = np.concatenate([outs[0]["tris"], outs[1]["tris"]], axis=0)
    result.update(
        ok=bool(
            np.allclose(outs[0]["W"], np.asarray(ref_grid.W), atol=1e-5)
            and np.allclose(outs[0]["D"], np.asarray(ref_grid.D), atol=1e-4)
            and np.allclose(outs[0]["pose_t"], np.asarray(ref_res.pose.t),
                            atol=2e-4)
            and int(outs[0]["num_valid"]) == int(ref_res.num_valid)
            and tris.shape[0] == ref_mesh.num_triangles
            and np.allclose(tris, ref_mesh.vertices, atol=1e-6)
            and int(outs[0]["dropped"]) == 0
            and int(outs[1]["dropped"]) == 0),
        grid_max_abs_dD=float(np.nanmax(np.abs(
            outs[0]["D"] - np.asarray(ref_grid.D)))),
        pose_t_err=float(np.linalg.norm(
            outs[0]["pose_t"] - np.asarray(ref_res.pose.t))),
        num_valid=int(outs[0]["num_valid"]),
        mesh_triangles=int(tris.shape[0]),
        mesh_exact_match=bool(tris.shape[0] == ref_mesh.num_triangles
                              and np.allclose(tris, ref_mesh.vertices,
                                              atol=1e-6)),
        cross_process_halo_dropped_cells=0,
        notes="2-process jax.distributed CPU pod: SPMD brickmajor "
              "fuse+track (ppermute halo + psum over Gloo across ranks) "
              "+ marching_cubes_sharded with the cross-process halo-plane "
              "collective; all outputs match the single-process dense "
              "reference. See tests/test_multiprocess.py for the CI tier.",
    )
    _write(out_path, result)
    print(json.dumps(result, indent=1))
    return 0 if result["ok"] else 1


def _write(path, result):
    if not path:
        return
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else None))
