"""float32 contractions that must not drop to a lower matmul precision.

A GPU may run a float32 matmul in TF32 unless a precision is set. The
brick-classification bounds are conservative-exact and marching cubes
selects vertex values and positions with one-hot products, so both pin
``precision=HIGHEST``. The CPU ignores the matmul precision, so next to the
output check each case also asserts that every floating-point dot_general
in the traced program carries HIGHEST even under
``jax.default_matmul_precision("bfloat16")``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracking_sdf_tpu.config import GridParams
from tracking_sdf_tpu.core.camera import PinholeCamera, backproject
from tracking_sdf_tpu.data.synthetic import (SphereScene, grid_from_scene,
                                             look_at, render_scene_depth)
from tracking_sdf_tpu.tracking import estimate_normals

PARAMS = GridParams(m=32, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)
CAM = PinholeCamera(fx=40.0, fy=40.0, cx=31.5, cy=23.5, width=64, height=48)
SPHERE = SphereScene(center=(0.1, 0.05, 0.0), radius=0.45)
POSE = look_at((0.2, -1.4, 0.3), (0.0, 0.0, 0.0))


def _classify():
    from tracking_sdf_tpu.fusion.brick import classify_bricks

    pts = backproject(CAM, render_scene_depth(SPHERE, CAM, POSE))
    nrm = estimate_normals(pts)
    bs = (8, 8, 8)

    def fn(pose):
        return classify_bricks(PARAMS, pose, pts, nrm, CAM, bs, jnp.float32,
                               PARAMS.m // bs[0], 0, "point_to_plane")
    return fn, (POSE,)


def _marching_cubes():
    from tracking_sdf_tpu.render.marching_cubes import (
        _active_cell_indices, _active_cells, _triangulate_cells)

    grid = grid_from_scene(PARAMS, SPHERE)
    active = _active_cells(grid, params=PARAMS)
    cells = _active_cell_indices(active, 4096)

    def fn(g):
        return _triangulate_cells(g, cells, params=PARAMS)
    return fn, (grid,)


def _dot_precisions(jaxpr):
    """Precision of every floating-point dot_general, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            if all(jnp.issubdtype(v.aval.dtype, jnp.floating)
                   for v in eqn.invars):
                out.append(eqn.params["precision"])
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out += _dot_precisions(inner)
    return out


@pytest.mark.parametrize("case", [_classify, _marching_cubes],
                         ids=["classify", "marching_cubes"])
def test_precision_pinned_under_bfloat16_default(case):
    fn, args = case()
    ref = jax.tree.map(np.asarray, fn(*args))
    with jax.default_matmul_precision("bfloat16"):
        low = jax.tree.map(np.asarray, fn(*args))
        jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(low)):
        np.testing.assert_array_equal(a, b)
    precisions = _dot_precisions(jaxpr)
    assert precisions, "expected float32 contractions in the program"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), precisions
