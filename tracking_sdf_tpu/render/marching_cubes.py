"""Device-side isosurface meshing (marching tetrahedra) + PLY export.

Plays the role of the reference's pcl::MarchingCubesSDF
(marching_cubes_sdf.cpp:100-287): extract the zero isosurface of D over all
interior cells whose 8 corners are observed (W > 0 — getNeighborList1D's
gate, marching_cubes_sdf.cpp:228-241), with vertices linearly interpolated
along cell edges to the iso level, and per-vertex colors interpolated from
the color grid (sdf.cpp:377-382).

Deliberate accelerator-first redesign rather than a port:

* **Marching tetrahedra, not the 256-case cube table.** Each cell splits
  into 6 tetrahedra around the main diagonal; a tet has 16 trivially
  derivable cases (at most 2 triangles), so the whole table is 16x2x3 ints —
  register-resident, no 256x16 table gathers, and no ambiguous-face cases.
  The extracted surface is the same zero crossing; only the triangulation
  differs (~2x triangles).
* **Two-pass, fixed-capacity, device-compacted.** Marching cubes'
  variable-size output is hostile to XLA's static shapes. Pass 1 (device)
  computes per-cell corner min/max/validity with pure SLICES of D and W
  (zero gathers) and reduces to an active-cell bitmask, compacted to
  indices ON DEVICE (pow2 buckets); pass 2 (device) triangulates the
  padded active list into a fixed-shape buffer, also compacted on device —
  only exact-count triangle/color slices and two scalars ever cross
  host-device (the padded buffers were ~70 MB of transfer per mesh).
* **Winding by gradient.** Triangle orientation is fixed globally by
  aligning each face normal with the interpolated SDF gradient (+grad points
  outside) instead of case-by-case table ordering.
* Vertices live at the true voxel-center world coordinates (grid.voxel_to_world)
  — the reference has a half-voxel-offset quirk here (createSurface uses
  index/res * extent with no +0.5 shift, marching_cubes_sdf.cpp:122-141,
  while fusion uses centers, sdf.h:153-157). We follow the fusion convention
  so meshes align with the fused geometry.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tracking_sdf_tpu.config import GridParams
from tracking_sdf_tpu.grid.grid import TSDFGrid, voxel_to_world
from tracking_sdf_tpu.grid.interp import interp_color

_HI = jax.lax.Precision.HIGHEST

# Cube corners in binary (x, y, z) bit order.
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
    dtype=np.int32,
)
# column c of an interp._OFFSETS-ordered corner fetch holding _CORNERS[c]
_CORNERS_TO_OFFSETS = np.array(
    [4 * di + 2 * dj + dk for di, dj, dk in _CORNERS], dtype=np.int32
)

# Six tetrahedra around the main diagonal c0 -> c7 (each face of the path
# cube walk): a standard 6-tet decomposition with consistent diagonal.
_TETS = np.array(
    [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
     [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]],
    dtype=np.int32,
)

# Tet edges: pairs of local tet-vertex indices.
_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int32
)

# case bit i set <=> tet vertex i is INSIDE (d < iso). Each case lists up to
# 2 triangles as triples of edge ids (-1 = unused). Winding is normalized
# later via the SDF gradient, so only the cut-edge sets matter here.
_TRI_TABLE = np.full((16, 2, 3), -1, dtype=np.int32)
_TRI_TABLE[1, 0] = (0, 1, 2)            # v0
_TRI_TABLE[2, 0] = (0, 3, 4)            # v1
_TRI_TABLE[3] = ((1, 3, 4), (1, 4, 2))  # v0 v1
_TRI_TABLE[4, 0] = (1, 3, 5)            # v2
_TRI_TABLE[5] = ((0, 3, 5), (0, 5, 2))  # v0 v2
_TRI_TABLE[6] = ((0, 1, 5), (0, 5, 4))  # v1 v2
_TRI_TABLE[7, 0] = (2, 4, 5)            # v0 v1 v2
_TRI_TABLE[8, 0] = (2, 4, 5)            # v3
_TRI_TABLE[9] = ((0, 1, 5), (0, 5, 4))  # v0 v3
_TRI_TABLE[10] = ((0, 3, 5), (0, 5, 2))  # v1 v3
_TRI_TABLE[11, 0] = (1, 3, 5)           # v0 v1 v3
_TRI_TABLE[12] = ((1, 3, 4), (1, 4, 2))  # v2 v3
_TRI_TABLE[13, 0] = (0, 3, 4)           # v0 v2 v3
_TRI_TABLE[14, 0] = (0, 1, 2)           # v1 v2 v3


class Mesh(NamedTuple):
    """Triangle soup from marching tetrahedra.

    WINDING NOTE: triangle winding is normalized against a
    CELL-CONSTANT central-difference SDF gradient, not the exact trilinear
    gradient at each triangle centroid. In multi-sheet cells (two surface
    sheets crossing one cell) the sign can disagree and flip a triangle's
    winding; measured agreement with the exact gradient is > 99% of
    triangles on the probe scenes. Geometry (vertex positions) is exact
    either way — only the orientation convention of rare sliver triangles
    is approximate."""

    vertices: np.ndarray  # (T, 3, 3) float32 world-space triangle vertices
    colors: Optional[np.ndarray]  # (T, 3, 3) float32 in [0,1] or None
    # surface cells beyond max_cells, not triangulated (overflow is
    # REPORTED, never silent — same discipline as FuseStats)
    dropped_cells: int = 0

    @property
    def num_triangles(self) -> int:
        return int(self.vertices.shape[0])


@partial(jax.jit, static_argnames=("params",))
def _active_cells(grid: TSDFGrid, *, params: GridParams) -> jnp.ndarray:
    """Pass 1: (shape-1) bool — cells with all 8 corners observed AND a sign
    change. Pure slices, no gathers. Works on full grids and on i-slab
    sub-volumes (shapes derive from D, not params)."""
    D, W = grid.D, grid.W
    s0, s1, s2 = (s - 1 for s in D.shape)
    shape = (s0, s1, s2)
    lo = jnp.full(shape, jnp.inf, D.dtype)
    hi = -lo
    valid = jnp.ones(shape, dtype=bool)
    for dx, dy, dz in _CORNERS:
        d = D[dx:dx + s0, dy:dy + s1, dz:dz + s2]
        w = W[dx:dx + s0, dy:dy + s1, dz:dz + s2]
        lo = jnp.minimum(lo, d)
        hi = jnp.maximum(hi, d)
        valid = valid & (w > 0)
    return valid & (lo < 0.0) & (hi >= 0.0)


@partial(jax.jit, static_argnames=("params", "i_offset"))
def _triangulate_cells(
    grid: TSDFGrid, cells: jnp.ndarray, *, params: GridParams,
    i_offset: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pass 2: cells (A, 3) int32 -> (verts (A*6, 2, 3, 3), valid (A*6, 2)).

    ``cells`` index grid's ARRAYS (which may be an i-slab sub-volume);
    ``i_offset`` is the slab's global first voxel i, so world positions
    stay global."""
    from tracking_sdf_tpu.grid.interp import _corner_fetch

    corners = cells[:, None, :] + jnp.asarray(_CORNERS)[None, :, :]  # (A, 8, 3)
    # width-128 row gathers (interp._corner_fetch_rows; not tuned on the
    # H100).
    # _corner_fetch returns interp._OFFSETS order (k fastest); remap to
    # this module's _CORNERS order (i fastest): offsets idx = 4di+2dj+dk.
    d = _corner_fetch(grid.D, cells)[:, jnp.asarray(_CORNERS_TO_OFFSETS)]
    goff = jnp.asarray([i_offset, 0, 0], jnp.int32)
    pos = voxel_to_world(params, (corners + goff).astype(grid.D.dtype))

    tets = jnp.asarray(_TETS)  # (6, 4)
    d_t = d[:, tets]  # (A, 6, 4)
    p_t = pos[:, tets]  # (A, 6, 4, 3)
    A = d.shape[0]
    d_t = d_t.reshape(A * 6, 4)
    p_t = p_t.reshape(A * 6, 4, 3)

    inside = (d_t < 0.0).astype(jnp.int32)
    case = inside[:, 0] + 2 * inside[:, 1] + 4 * inside[:, 2] + 8 * inside[:, 3]

    # Case/edge/vertex selection via ONE-HOT masked sums over STATIC
    # unrolls (16 cases, 4 tet vertices), not small-table gathers
    # (tri_table[case] / edge_verts[e] / take_along_axis on width-4 dims).
    # The one-hot form was chosen for another backend's gather costs; its
    # cost against small-table gathers is not measured on the H100. The
    # float selections run at HIGHEST precision: a one-hot product must
    # return the selected float32 value exactly, never a TF32/bf16 rounding.
    tri_np = _TRI_TABLE  # (16, 2, 3) numpy, static
    onehot = jnp.stack([(case == c) for c in range(16)], axis=-1)  # (N, 16)
    edges = jnp.einsum(
        "nc,cte->nte", onehot.astype(jnp.int32), jnp.asarray(tri_np)
    )  # (N, 2, 3) edge ids, -1 = unused
    valid_tri = edges[:, :, 0] >= 0  # (N, 2)

    # per-edge endpoint ids are static: _EDGES[e] for e in 0..5; select
    # d/p at endpoints by one-hot over the 4 tet vertices
    e_sel = jnp.stack([(edges == e) for e in range(6)], axis=-1)  # (N,2,3,6)
    # av/bv: (N, 2, 3, 4) one-hot over the 4 tet vertices (edge endpoints
    # are static per edge id: np.eye(4)[_EDGES[:, a_or_b]])
    av = jnp.einsum("ntes,sv->ntev", e_sel.astype(jnp.float32),
                    jnp.asarray(np.eye(4, dtype=np.float32)[_EDGES[:, 0]]),
                    precision=_HI)
    bv = jnp.einsum("ntes,sv->ntev", e_sel.astype(jnp.float32),
                    jnp.asarray(np.eye(4, dtype=np.float32)[_EDGES[:, 1]]),
                    precision=_HI)
    da = jnp.einsum("ntev,nv->nte", av, d_t, precision=_HI)
    db = jnp.einsum("ntev,nv->nte", bv, d_t, precision=_HI)
    pa = jnp.einsum("ntev,nvx->ntex", av, p_t, precision=_HI)
    pb = jnp.einsum("ntev,nvx->ntex", bv, p_t, precision=_HI)
    denom = da - db
    mu = jnp.where(jnp.abs(denom) > 1e-12, da / jnp.where(denom == 0, 1.0, denom), 0.5)
    mu = jnp.clip(mu, 0.0, 1.0)
    verts = pa + mu[..., None] * (pb - pa)  # (N, 2, 3, 3)

    # normalize winding: face normal aligned with +grad(D) (outward). The
    # gradient comes from the ALREADY-FETCHED 8 corner values (per-cell
    # central differences: mean of the 4 axis-edge deltas) instead of a
    # trilinear_with_grad at each triangle centroid — the latter cost 12
    # extra interpolation points (96 gather rows) per cell and was the
    # dominant device cost of pass 2 where it was measured. Orientation only
    # needs the gradient's SIGN along the face normal; the cell-constant
    # gradient agrees with the centroid gradient except in pathological
    # multi-sheet cells (sphere-winding regression test pins > 99%).
    c = jnp.asarray(_CORNERS)  # (8, 3) in (x, y, z) bit order
    gx = jnp.sum(d * jnp.where(c[:, 0] == 1, 1.0, -1.0), axis=-1) / 4.0
    gy = jnp.sum(d * jnp.where(c[:, 1] == 1, 1.0, -1.0), axis=-1) / 4.0
    gz = jnp.sum(d * jnp.where(c[:, 2] == 1, 1.0, -1.0), axis=-1) / 4.0
    scale = jnp.asarray(
        [params.m / params.width, params.m / params.height, params.m / params.depth],
        dtype=d.dtype,
    )
    g_cell = jnp.stack([gx, gy, gz], axis=-1) * scale  # (A, 3) world units
    g_tet = jnp.repeat(g_cell, 6, axis=0)[:, None, :]  # (A*6, 1, 3)

    v0, v1, v2 = verts[:, :, 0], verts[:, :, 1], verts[:, :, 2]
    face_n = jnp.cross(v1 - v0, v2 - v0)
    flip = jnp.sum(face_n * g_tet, axis=-1) < 0
    verts = jnp.where(flip[:, :, None, None], verts[:, :, ::-1, :], verts)

    return verts, valid_tri


def marching_cubes(
    grid: TSDFGrid,
    *,
    params: GridParams,
    with_colors: bool = False,
    max_cells: Optional[int] = None,
    color_mode: str = "trilinear",
    i_offset: int = 0,
    vertex_quant: bool = False,
) -> Mesh:
    """Extract the zero-isosurface triangle mesh (host-compacted).

    Functionally equivalent to SDF::visualize's meshing step
    (sdf.cpp:317-391) with `with_colors=True` matching its per-vertex
    interpolate_color. ``color_mode`` selects the vertex-color scheme:
    "trilinear" (default, smooth) or "shepard" — the reference's exact
    inverse-L1 interpolate_color semantics (sdf.cpp:377-382 calls
    interpolate_color per mesh vertex), for parity.

    ``vertex_quant``: quantize vertices to u16 per-axis bbox coordinates
    ON DEVICE and dequantize host-side — u16 halves the device->host
    vertex bytes (colors already cross as u8); whether that pays over the
    H100 host link is not measured. Max position error is half a
    quantum = extent / 131070 (~30 um at 4 m — two orders of magnitude
    under the voxel size; bound pinned by
    tests/test_render.py::test_marching_cubes_vertex_quant_bound). The
    reference published full f32 meshes over localhost where transport
    was free (sdf.cpp:355-382); ours is not.
    """
    if color_mode not in ("trilinear", "shepard"):
        raise ValueError(f"unknown color_mode: {color_mode!r}")
    # Active-cell discovery stays ON DEVICE end to end: the old host
    # argwhere needed the full (m-1)^3 bool mask transferred (16.6 MB at
    # 256^3); now only one scalar count crosses.
    active = _active_cells(grid, params=params)
    n_act = int(jnp.sum(active))
    if n_act == 0:
        empty = np.zeros((0, 3, 3), np.float32)
        return Mesh(empty, empty.copy() if with_colors else None)
    dropped = 0
    n_cells = n_act
    if max_cells is not None and n_act > max_cells:
        dropped = n_act - max_cells
        n_cells = max_cells

    # pad to a fixed bucket so recompilation is rare
    cap = 1 << max(10, int(np.ceil(np.log2(n_cells))))
    idx_d = _active_cell_indices(active, cap)
    verts, valid = _triangulate_cells(grid, idx_d, params=params,
                                      i_offset=i_offset)

    # Compact ON DEVICE before any transfer: the padded (cap, 6, 2, 3, 3)
    # buffer is ~56 MB at 256^3, most of it padding. Triangle order
    # matches the old boolean-mask compaction (row-major over (cell, tet,
    # tri)).
    n_tri = int(_count_tris(valid, n_cells))
    tri_cap = 1 << max(10, int(np.ceil(np.log2(max(n_tri, 2)))))
    tri_d = _compact_triangles(verts, valid, n_cells, tri_cap)
    colors = None
    if with_colors:
        # color at the pow2 bucket shape (compile cached per bucket), then
        # slice to the EXACT count on device (eager slice of a concrete
        # int) before fetching — the bucket's padding would be pure
        # transfer waste. Colors cross as u8 (4x
        # fewer bytes): PLY export quantizes to u8 anyway, and the
        # device-side rounding matches export_ply's exactly.
        rgb = _vertex_colors(grid, tri_d, params=params,
                             color_mode=color_mode, i_offset=i_offset)
        colors = (np.asarray(rgb[:n_tri]).astype(np.float32) / 255.0)
    if vertex_quant:
        lo = np.asarray(params.origin, np.float32)
        ext = np.asarray(params.extent, np.float32)
        q = _quantize_tris(tri_d, params)  # u16 at the bucket shape (jit)
        tri = (np.asarray(q[:n_tri]).astype(np.float32) * (ext / 65535.0)
               + lo)
    else:
        tri = np.asarray(tri_d[:n_tri]).astype(np.float32)
    return Mesh(tri, colors, dropped_cells=dropped)


@partial(jax.jit, static_argnames=("params",))
def _quantize_tris(tri: jnp.ndarray, params: GridParams) -> jnp.ndarray:
    """f32 world vertices -> u16 per-axis bbox coords (transfer format)."""
    lo = jnp.asarray(params.origin, jnp.float32)
    ext = jnp.asarray(params.extent, jnp.float32)
    q = jnp.round((tri.astype(jnp.float32) - lo) / ext * 65535.0)
    return jnp.clip(q, 0.0, 65535.0).astype(jnp.uint16)


@partial(jax.jit, static_argnames=("cap",))
def _active_cell_indices(active: jnp.ndarray, cap: int) -> jnp.ndarray:
    """(cap, 3) int32 indices of the first cap active cells in row-major
    order (= np.argwhere order); padded slots point at cell 0 and are
    masked downstream via n_cells."""
    n0, n1, n2 = active.shape
    flat = jnp.nonzero(active.reshape(-1), size=cap, fill_value=0)[0]
    i = flat // (n1 * n2)
    j = (flat // n2) % n1
    k = flat % n2
    return jnp.stack([i, j, k], axis=-1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_cells",))
def _count_tris(valid: jnp.ndarray, n_cells: int) -> jnp.ndarray:
    v = valid.reshape(-1, 12) & (jnp.arange(valid.shape[0] // 6)[:, None] < n_cells)
    return jnp.sum(v.astype(jnp.int32))


@partial(jax.jit, static_argnames=("n_cells", "tri_cap"))
def _compact_triangles(verts, valid, n_cells: int, tri_cap: int):
    ncap = valid.shape[0] // 6
    v = (valid.reshape(ncap, 12)
         & (jnp.arange(ncap)[:, None] < n_cells)).reshape(-1)
    idx = jnp.nonzero(v, size=tri_cap, fill_value=v.shape[0])[0]
    ok = idx < v.shape[0]
    tri = jnp.take(verts.reshape(-1, 3, 3), jnp.where(ok, idx, 0), axis=0)
    return jnp.where(ok[:, None, None], tri, 0.0)


@partial(jax.jit, static_argnames=("params", "color_mode", "i_offset"))
def _vertex_colors(grid: TSDFGrid, tri: jnp.ndarray, *, params: GridParams,
                   color_mode: str, i_offset: int = 0) -> jnp.ndarray:
    from tracking_sdf_tpu.grid.grid import world_to_voxel
    from tracking_sdf_tpu.grid.interp import shepard_color

    color_fn = shepard_color if color_mode == "shepard" else interp_color
    flat = tri.reshape(-1, 3)
    coords = world_to_voxel(params, flat)
    if i_offset:
        coords = coords - jnp.asarray([i_offset, 0, 0], coords.dtype)
    rgb, cvalid = color_fn(
        grid.R, grid.G, grid.B, grid.Wc, coords
    )
    # Vertices with no color observation (Wc = 0 on every corner) keep
    # the grid's 0.4 default grey (sdf.cpp:38-40 init parity) instead of
    # interp_color's 0/0 -> black. Quantize to u8 ON DEVICE — the same
    # clip+round export_ply applies — so the host transfer is 4x smaller.
    rgb = jnp.where(cvalid[..., None], rgb, 0.4)
    rgb8 = jnp.clip(rgb * 255.0, 0, 255).astype(jnp.uint8)
    return rgb8.reshape(tri.shape)


def marching_cubes_chunked(
    grid: TSDFGrid,
    *,
    params: GridParams,
    n_chunks: int = 4,
    with_colors: bool = False,
    max_cells: Optional[int] = None,
    color_mode: str = "trilinear",
    vertex_quant: bool = False,
) -> Mesh:
    """Single-device meshing in i-slab chunks: bounds peak device memory.

    At 512^3 the one-shot path's active-cell bucket reaches 262144 cells
    and its (cap*6, 2, 3, 3) triangle buffer alone is ~1.1 GB on top of
    the 3.2 GB dense grid — RESOURCE_EXHAUSTED next to a live brick grid.
    Chunking meshes (slab + 1 halo plane) sub-volumes sequentially;
    triangle order matches the one-shot path (slabs ascend in i)."""
    m = params.m
    step = -(-m // n_chunks)
    parts = []
    dropped = 0
    for i0 in range(0, m, step):
        i1 = min(i0 + step, m)
        hi = min(i1 + 1, m)  # halo plane for the last owned cell row
        sub = TSDFGrid(*(leaf[i0:hi] for leaf in grid))
        part = marching_cubes(sub, params=params, with_colors=with_colors,
                              max_cells=max_cells, color_mode=color_mode,
                              i_offset=i0, vertex_quant=vertex_quant)
        dropped += part.dropped_cells
        parts.append(part)
    tri = np.concatenate([p.vertices for p in parts], axis=0)
    colors = (np.concatenate([p.colors for p in parts], axis=0)
              if with_colors else None)
    return Mesh(tri, colors, dropped_cells=dropped)


def _cross_host_halo_planes(grid: TSDFGrid) -> dict:
    """Slab-boundary i-planes that cross a PROCESS boundary, fetched once
    via a collective gather: {global_i: {leaf_name: (1, m, m) np.ndarray}}.

    The set of needed planes is derived from the GLOBAL sharding (not local
    addressability), so every process computes the same set and executes
    the same jitted collective program — the symmetric-participation rule
    of multi-process jax. Single-process (fully-addressable) grids return
    {} and pay nothing. The fetch itself is one jnp.take of a handful of
    (m, m) planes per leaf with a replicated out_sharding — XLA inserts
    the all-gather (over DCN on a real multi-host pod; ~24 KB/plane at
    m=64 test scale, 1 MB at 512)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    D = grid.D
    if D.is_fully_addressable:
        return {}
    sh = D.sharding
    if not isinstance(sh, NamedSharding):
        return {}
    m = D.shape[0]
    # slab (start, stop) -> set of owning process ids
    bounds: dict = {}
    for dev, idx in sh.devices_indices_map(D.shape).items():
        start = idx[0].start or 0
        stop = idx[0].stop if idx[0].stop is not None else m
        bounds.setdefault((start, stop), set()).add(dev.process_index)
    by_start = {s0: procs for (s0, s1), procs in bounds.items()}
    needed = sorted({
        s1 for (s0, s1), procs in bounds.items()
        if s1 < m and not (by_start.get(s1, set()) & procs)
    })
    if not needed:
        return {}
    idx = jnp.asarray(needed, jnp.int32)
    rep = NamedSharding(sh.mesh, P())
    fetch = jax.jit(lambda leaf: jnp.take(leaf, idx, axis=0),
                    out_shardings=rep)
    out: dict = {i: {} for i in needed}
    for name in grid._fields:
        planes = np.asarray(fetch(getattr(grid, name)))
        for j, i in enumerate(needed):
            out[i][name] = planes[j:j + 1]
    return out


def marching_cubes_sharded(
    grid: TSDFGrid,
    *,
    params: GridParams,
    with_colors: bool = False,
    max_cells: Optional[int] = None,
    color_mode: str = "trilinear",
    vertex_quant: bool = False,
) -> Mesh:
    """Per-slab meshing of an i-slab-sharded dense grid + concatenation —
    the reference's voxel-DP meshing structure (per-thread output clouds +
    concat, marching_cubes_sdf.cpp:264-284) mapped to devices.

    Each shard owns the cells whose BASE voxel it holds; the last owned
    i-plane's cells need one halo plane from the next shard, so each
    sub-problem is (slab + 1 plane). No full-grid materialization anywhere:
    peak host memory is one slab. On multi-host, each process meshes its
    addressable shards; boundary planes owned by ANOTHER process are
    fetched up front by one collective gather (_cross_host_halo_planes),
    so sharded meshing is exact across process boundaries — the
    process-local result is this process's slabs' triangles, in global
    slab order (concatenate across processes by process id for the full
    mesh; see tests/test_multiprocess.py).

    Triangle order matches the unsharded function (slabs ascend in i;
    within a slab, row-major) — equality pinned by tests.
    """
    halo_planes = _cross_host_halo_planes(grid)
    shards = sorted(grid.D.addressable_shards, key=lambda s: s.index[0].start)
    leaves = {name: getattr(grid, name) for name in grid._fields}
    m = params.m
    parts = []
    dropped = 0
    for si, sh in enumerate(shards):
        i0 = sh.index[0].start or 0
        i1 = sh.index[0].stop if sh.index[0].stop is not None else m
        halo = i1 < m  # last slab's cells end at m-2 with no halo needed
        sub = {}
        missing_halo = False
        for name, leaf in leaves.items():
            # fetch this slab (and its halo plane) per leaf
            lsh = sorted(leaf.addressable_shards,
                         key=lambda s: s.index[0].start or 0)[si]
            arr = np.asarray(lsh.data)
            if halo:
                if i1 in halo_planes:  # cross-process boundary, prefetched
                    arr = np.concatenate([arr, halo_planes[i1][name]], 0)
                else:
                    try:
                        nxt = sorted(leaf.addressable_shards,
                                     key=lambda s: s.index[0].start or 0
                                     )[si + 1]
                        arr = np.concatenate(
                            [arr, np.asarray(nxt.data)[:1]], 0)
                    except IndexError:
                        # prefetch couldn't cover this boundary (non-
                        # NamedSharding leaf, or partially overlapping
                        # owner sets): degrade with a REPORT, don't crash
                        missing_halo = True
            sub[name] = jnp.asarray(arr)
        if missing_halo:
            dropped += (m - 1) * (m - 1)  # one skipped cell plane, reported
        sub_grid = TSDFGrid(**sub)
        part = marching_cubes(sub_grid, params=params,
                              with_colors=with_colors, max_cells=max_cells,
                              color_mode=color_mode, i_offset=int(i0),
                              vertex_quant=vertex_quant)
        dropped += part.dropped_cells
        parts.append(part)
    tri = np.concatenate([p.vertices for p in parts], axis=0)
    colors = (np.concatenate([p.colors for p in parts], axis=0)
              if with_colors else None)
    return Mesh(tri, colors, dropped_cells=dropped)


def export_ply(mesh: Mesh, path: str, binary: bool = True) -> None:
    """PLY export (colored if the mesh has colors).

    Binary by default: vectorized numpy serialization handles million-
    triangle 512^3 meshes in well under a second (the ASCII Python loop took
    ~tens of seconds and 5x the bytes)."""
    t = mesh.vertices
    n_v = t.shape[0] * 3
    n_f = t.shape[0]
    has_c = mesh.colors is not None
    verts = np.ascontiguousarray(t.reshape(-1, 3), dtype="<f4")
    if has_c:
        cols = np.clip(mesh.colors.reshape(-1, 3) * 255.0, 0, 255).astype(np.uint8)

    if binary:
        with open(path, "wb") as f:
            hdr = ["ply", "format binary_little_endian 1.0",
                   f"element vertex {n_v}",
                   "property float x", "property float y", "property float z"]
            if has_c:
                hdr += ["property uchar red", "property uchar green",
                        "property uchar blue"]
            hdr += [f"element face {n_f}",
                    "property list uchar int vertex_indices", "end_header"]
            f.write(("\n".join(hdr) + "\n").encode())
            if has_c:
                rec = np.zeros(n_v, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
                rec["xyz"] = verts
                rec["rgb"] = cols
            else:
                rec = np.zeros(n_v, dtype=[("xyz", "<f4", 3)])
                rec["xyz"] = verts
            rec.tofile(f)
            idx = np.arange(3 * n_f, dtype="<i4").reshape(n_f, 3)
            faces = np.zeros(n_f, dtype=[("n", "u1"), ("idx", "<i4", 3)])
            faces["n"] = 3
            faces["idx"] = idx
            faces.tofile(f)
        return

    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n_v}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_c:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {n_f}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if has_c:
            for v, c in zip(verts, cols):
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
        else:
            for v in verts:
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for i in range(n_f):
            f.write(f"3 {3 * i} {3 * i + 1} {3 * i + 2}\n")
