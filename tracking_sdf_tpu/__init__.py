"""tracking_sdf_tpu — differentiable TSDF camera tracking & reconstruction in JAX.

A from-scratch JAX/XLA/Pallas/pjit framework with the capabilities of the
reference C++/ROS implementation of Bylow et al., RSS 2013
(`mees/tracking_sdf`): weighted TSDF depth+color fusion into a device-resident
voxel grid, direct Gauss-Newton camera tracking against the SDF, marching-cubes
meshing, and (new capability) a differentiable sphere-tracing raycaster —
designed SPMD-first over `jax.sharding.Mesh` device meshes.

Sign convention
---------------
The canonical SDF stored in :class:`~tracking_sdf_tpu.grid.TSDFGrid` is
**positive in free space** (outside surfaces, toward the camera) and negative
behind surfaces — the standard convention for sphere tracing. The reference
code (src/src/sdf.cpp:272-292) stores the *negated* field (free space
negative); every parity test therefore compares ``D_ours ≈ -D_ref``. Tracking
is invariant to this sign (both J and r flip, so JᵀJ and Jᵀr are unchanged)
and the marching-cubes zero crossing is identical.
"""

__version__ = "0.1.0"

from tracking_sdf_tpu import config as config
from tracking_sdf_tpu.config import (
    GridParams,
    TrackingConfig,
    FusionConfig,
    RaycastConfig,
    PipelineConfig,
    preset,
)

# Lazy submodule access keeps `import tracking_sdf_tpu` light; the heavy
# modules (jax tracing caches etc.) load on first touch.
_SUBMODULES = (
    "core", "grid", "fusion", "tracking", "render",
    "parallel", "pipeline", "data", "utils",
)


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"tracking_sdf_tpu.{name}")
    raise AttributeError(f"module 'tracking_sdf_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals().keys()) + list(_SUBMODULES))
