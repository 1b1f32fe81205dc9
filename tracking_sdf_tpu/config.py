"""Typed configuration for the whole framework.

The reference hardcodes every parameter at its call sites (grid m=256,
volume 6.0x6.0x3.5 m, origin (-3,-3,-0.5), delta=0.3, epsilon=0.025 at
sdf_reconstruction.cpp:83-85; GN 20 iters / 0.001 threshold / v_h=1.0 /
w_h=0.01 at :88; pixel stride 3 at camera_tracking.cpp:162-163). Here they
are first-class, hashable configs usable as jit static arguments.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple


class GridParams(NamedTuple):
    """Static geometry of the TSDF voxel volume.

    Mirrors the SDF ctor signature (reference sdf.cpp:8) — ``m`` voxels per
    axis over a ``width x height x depth`` meter box anchored at ``origin``.
    ``delta`` / ``epsilon`` are the truncation band and full-weight band of
    the fusion weighting (paper Eq. 28/31; sdf.cpp:276-287).

    NamedTuple of Python scalars => hashable => usable as a jit static arg.
    """

    m: int = 256
    width: float = 6.0
    height: float = 6.0
    depth: float = 3.5
    origin: Tuple[float, float, float] = (-3.0, -3.0, -0.5)
    delta: float = 0.3
    epsilon: float = 0.025

    @property
    def extent(self) -> Tuple[float, float, float]:
        return (self.width, self.height, self.depth)

    @property
    def voxel_size(self) -> Tuple[float, float, float]:
        return (self.width / self.m, self.height / self.m, self.depth / self.m)

    @property
    def n_voxels(self) -> int:
        return self.m ** 3


class TrackingConfig(NamedTuple):
    """Gauss-Newton tracker settings (reference camera_tracking.cpp:3-17).

    ``jacobian`` selects the derivative scheme:
      * ``"analytic"`` (default): trilinear interpolation with the
        exact analytic grid gradient, chain-ruled to the SE(3) twist.
      * ``"central"``: the reference's 13-probe central-difference scheme
        (camera_tracking.cpp:246-363) over Shepard-L1 interpolation, for
        parity testing.

    ``convergence`` selects the stop rule:
      * ``"norm"`` (default): max |twist component| < max_twist_diff.
      * ``"signed"``: the reference's quirk — stop when all six *signed*
        components are < threshold (camera_tracking.cpp:216-224), which also
        fires when components are very negative.

    ``pose_update`` selects the composition rule:
      * ``"se3"`` (default): exact left-inverse composition
        T <- exp(xi)^-1 ∘ T, i.e. R <- Re' R and t <- Re' (t - te).
      * ``"reference"``: the reference quirk (camera_tracking.cpp:237-238)
        which does NOT rotate t: R <- Re' R, t <- t - Re' te.
    """

    max_iterations: int = 20
    max_twist_diff: float = 0.001
    v_h: float = 1.0  # translation probe step, in *voxel* units
    w_h: float = 0.01  # rotation probe step, radians
    pixel_stride: int = 3
    jacobian: str = "analytic"
    convergence: str = "norm"
    pose_update: str = "se3"
    # Marquardt damping: solve (A + damping*diag(A)) x = b. Pure GN (the
    # reference, camera_tracking.cpp:191) oscillates and can diverge on
    # sparse single-view models (measured: converges to 5 mm by iteration 7,
    # then explodes); 0.1 converges monotonically in ~9 iterations.
    # 0 = pure GN for reference parity.
    damping: float = 0.1
    # Per-iteration multiplier on the damping (LM-style schedule): <1 lets
    # late iterations take full GN steps once near the optimum (measured on
    # the synthetic fixture: decay 0.5 converges in 9 iters to 2.2 mm vs 10
    # iters to 5.3 mm with fixed damping). 1.0 = constant damping (default).
    damping_decay: float = 1.0
    # Convergence may not fire before this many iterations have run.
    # Purpose: after a coarse pyramid level hands over an
    # already-twist-converged pose, a floor forces the fine level to
    # actually re-optimize on the full stride-3 pixel set instead of
    # accepting the coarse level's decimation-biased optimum (a closed-loop
    # ATE A/B). 0 = reference behavior.
    min_iterations: int = 0


class FusionConfig(NamedTuple):
    """TSDF fusion settings (reference sdf.cpp:224-315).

    ``weighting`` is the paper Table II ablation axis: "exponential" (shipped
    code, Eq. 31), "linear", "constant", and the "narrow_*" variants.
    ``distance`` selects point-to-plane (shipped, sdf.cpp:272) or
    point-to-point (present but commented out, sdf.cpp:267).

    ``mode``:
      * "dense": the reference-exact per-voxel gather pass (fuse.fuse_frame).
      * "bricked": brick-compacted fast path over the FLAT grid layout
        (fusion.brick) — identical geometry, color fused in surface-band
        bricks only; ~an order of magnitude fewer gathered rows.
      * "brickmajor": the presets' path (fusion.brickmajor) — same math,
        but the grid is STORED as (NB, BV) brick rows, which makes compact
        (classification-optimal) brick shapes merge as whole rows and
        lets fusion emit tracking's masked Dm view from its own relayout.
    ``brick_shape``/``brick_cap`` size the bricked paths.
    """

    weighting: str = "exponential"
    distance: str = "point_to_plane"
    fuse_color: bool = True
    max_weight: Optional[float] = None  # optional running-weight clamp (ref: none)
    mode: str = "dense"
    # Flat-layout "bricked" default (1, 8, 128): fat k-runs as scatter
    # rows. Brick-MAJOR storage frees the choice: the presets use (8, 8, 8),
    # the classification-optimal shape (fewest FULL voxels -> fewest
    # pixel-row gathers).
    brick_shape: Tuple[int, int, int] = (1, 8, 128)
    brick_cap: int = 6144
    brick_cap_free: int = 0  # FREE-brick row cap for brickmajor (0 = brick_cap)
    # Approximate fast mode for bricked fusion (1 = exact, the default).
    # Groups of ``pixel_share`` adjacent k-voxels share ONE gathered pixel
    # row (the group center's): the random pixel gather shrinks by the
    # same factor. Per-voxel geometry (projection, point-to-plane distance
    # against the shared pixel's plane, weighting, masks) stays per-voxel.
    # Deviation is bounded by the group's image-space footprint (~2-9 px):
    # wrong-plane error away from depth edges is sub-mm; at silhouettes a
    # 1-2 voxel band can take the neighbor surface's update. NOT
    # reference-exact — bricked==dense tests require pixel_share=1.
    pixel_share: int = 1
    # Grid VALUE-leaf storage dtype for mode="brickmajor": "float32" or
    # "bfloat16". bf16 halves the device-memory bytes of D/R/G/B in the
    # merge; all arithmetic stays float32 (upcast at gather, round at
    # scatter). Quantization is ~delta/256 per store (~0.4 mm at
    # delta=0.1) — validate ATE closed-loop before defaulting.
    storage_dtype: str = "float32"
    # Temporal color subsampling: fuse COLOR only on every Nth frame
    # (geometry fuses every frame — tracking reads only D/W, so pose
    # accuracy is untouched; the color running mean just averages fewer
    # samples of a slowly-varying signal). The color merge is a large
    # share of each fused frame, so skipping it on most frames pays.
    # 1 = reference-exact cadence (sdf.cpp:294-304 fuses color every
    # frame); flagged approximation like pixel_share.
    color_every: int = 1
    # Same idea along the j (grid-y) axis, multiplicative with pixel_share:
    # a (pixel_share_j x pixel_share) voxel group shares one gathered row.
    # 2x2 halves the gather again vs k-only share=2 at a smaller worst-case
    # image offset than share=4 along k (group radius ~0.7 voxel diagonal
    # vs 1.5 voxels). Validate closed-loop before defaulting.
    pixel_share_j: int = 1
    # Share-mode HLO shape A/B (numerically inert, cross-checked bitwise):
    # True keeps the shared pixel gather FACTORED (size-1 share dims
    # broadcast inside the arithmetic) instead of materializing the
    # explicit per-voxel broadcast. Which is faster on the H100 is not
    # measured; this stays a jit-cache-keyed switch (an env toggle read at
    # trace time silently kept the stale variant mid-process).
    factored_share: bool = False
    # Hierarchical brick classification for mode="brickmajor" (0/1 = off).
    # When set to a super-brick factor f (e.g. 4), OUT/FREE/OCCLUDED are
    # proven at f^3-brick granularity first and only MIXED super-bricks
    # descend to per-brick proofs — conservative-EXACT (classify_compact_
    # hier docstring) but the fine classify + id compaction run over
    # cap_mixed * f^3 slots instead of all NB bricks. cap_mixed bounds
    # descended supers; overflow is reported in
    # FuseStats.overflow_mixed (never silent). Runs on SPMD slabs too
    # (slab-local super-brick proofs) when the slab's brick count divides
    # the factor; otherwise that shard falls back to the flat classifier.
    hier_classify: int = 0
    cap_mixed: int = 2048
    # Share-SAFE classification: widen the FREE/OCCLUDED proof bounds by
    # the pixel-share group's world radius (x ||n||), making them exact
    # under share semantics — a group voxel's point-to-plane distance
    # differs from its center's by (v-c)·n <= radius * ||n||
    # (fusion.brick.share_classify_margin). point_to_point needs no
    # widening (already exact — see the margin helper), so the shipped p2p
    # presets are unaffected either way. Default ON: exact classification.
    # False restores the share-1-exact bounds (the historical documented
    # approximation).
    share_safe_classify: bool = True
    # Weight-accumulator storage dtype for mode="brickmajor":
    # "float32" (default, exact) or "bfloat16". bf16 weights halve the
    # merge's W/Wc bytes, but quantize the
    # running sum at 2^-8 relative — past ~256x the per-frame increment
    # the accumulator freezes. Pair with max_weight <= ~256 (KinectFusion
    # clamps at 64-255; the reference does not clamp, so this is a
    # FLAGGED approximation like pixel_share — A/B'd closed-loop before
    # any preset adopts it). Arithmetic stays f32 (upcast at gather).
    weight_dtype: str = "float32"
    # brickmajor merge-tail shape: fold the FREE-brick rows into the FULL
    # pass's D/W gather/merge/scatter — one combined row pass instead of
    # two serialized ones. Bitwise-identical arithmetic (a FREE brick's
    # update IS (w=1, d=+delta) per voxel; FULL/FREE id sets are
    # disjoint).
    free_fold: bool = False
    # saturated-FREE skip: carry a per-brick bitset marking FREE
    # bricks whose update is a proven bitwise no-op (W at max_weight AND
    # the stored D at its running-mean fixed point — detected, not
    # assumed), and exclude them from FREE compaction. EXACT (skip-on ==
    # skip-off bitwise, pinned by tests); the payoff is capacity — mature
    # static scenes free nearly all cap_free slots, letting presets trim
    # the compile-time cap_free (the folded merge pass's FREE-row count is
    # static in cap_free). Inert when max_weight is None (W never
    # saturates, no brick ever proves no-op). brickmajor path only.
    sat_skip: bool = False


class RaycastConfig(NamedTuple):
    """Sphere-tracing raycaster (new capability vs the reference)."""

    # 64 covers the worst miss-ray (7 m volume diagonal at delta/2 = 0.15 m
    # auto miss steps) with margin; each step costs a full all-rays gather
    max_steps: int = 64
    hit_epsilon: float = 1e-3  # meters
    step_scale: float = 0.9
    t_near: float = 0.1
    t_far: float = 10.0
    # step (m) through UNOBSERVED space; 0 = auto (delta/2 — cannot tunnel
    # through an observed band, which is >= 2*delta thick along the ray).
    # The old fixed 0.04 m default made rays outside the observed frustum
    # crawl for the full max_steps budget.
    miss_step: float = 0.0
    # Far-field sampling mode for the march:
    #   * "nearest_far" (default): while far from the surface, sample the
    #     SDF at the NEAREST voxel (1 gather row/ray/step instead of 8)
    #     and step (phi - L*(sqrt(3)/2)*h) * step_scale — the Lipschitz
    #     margin (|phi(x) - phi(voxel center)| <= L*h*sqrt(3)/2, L <= 1
    #     for a TSDF) makes the big steps provably non-crossing. Rays
    #     freeze once nearest-phi < fine_threshold voxels; a short
    #     full-batch TRILINEAR phase then finds the exact crossing (the
    #     Newton refinement at the end is trilinear in both modes).
    #   * "trilinear": 8-corner interpolation every step (the original).
    sample: str = "nearest_far"
    # nearest_far: switch to the trilinear finish when nearest-phi falls
    # below this many voxels; budget of the finish phase. At 640x480/256^3
    # nearest_far keeps 97.1% of the trilinear mode's hit pixels (the
    # deficit is grazing silhouette rays that exhaust the finish budget;
    # fine_steps 20 recovers 98.4%; sample="trilinear" is the exact 100%
    # mode). Its speed against "trilinear" is not measured on the H100.
    fine_threshold: float = 1.5
    fine_steps: int = 12
    # nearest_far finish strategy:
    #   * "march": fine_steps masked sphere-tracing steps (full batch).
    #   * "newton": fine_steps//3 implicit-function Newton iterations
    #     (t <- t - phi/(grad.u), the same update as the final
    #     refinement) — frozen rays sit within ~fine_threshold voxels of
    #     the crossing, where Newton lands in 2-3 iterations vs the
    #     march's 12 phi-clipped crawl steps. Grazers (denominator ~ 0)
    #     fall through to the compacted recovery phase exactly as in
    #     march mode. At 640x480/256^3 newton reaches 100.3% of the exact
    #     mode's hit count with ZERO recovery drops vs march's 99.97%; the
    #     default ("march" stays one flag away). Speed not measured on
    #     the H100.
    fine_mode: str = "newton"
    # Temporal warm start (serving path): `raycast(...,
    # t_init=prev.range_t)` starts each ray at max(t_enter,
    # min3x3(prev_range) - warm_backoff) instead of the volume entry —
    # sequential renders skip most of the march (the surface barely moves
    # between frames). 0 = auto (delta: the truncation band is >= 2*delta
    # thick along the ray, so a surface that approached by < delta is
    # still AHEAD of the warm start, and the Newton finish can also pull
    # back to it). FLAGGED approximation: geometry that newly appears
    # closer than prev_range - backoff (fast approach, brand-new
    # occluders) is missed until a cold render; the 3x3 min-pool absorbs
    # small pixel shifts at silhouettes.
    warm_backoff: float = 0.0
    # Brick-level empty-space skipping: a per-render L-inf chamfer distance
    # mip over observed 8^3-voxel bricks lets rays LEAP
    # (dist-1) * brick_extent through unobserved space — provably safe
    # (the leap cannot reach an observed brick). Same hits/depths as the
    # plain march; only step counts differ. Default OFF: rays march in
    # lockstep, so fewer steps only pay when they shorten the LONGEST ray,
    # while the skip lookup taxes every ray every step. Not measured on
    # the H100.
    empty_skip: bool = False
    # Far-field band-chamfer leaps: a (m/8)^3 L-inf chamfer mip
    # to the SURFACE BAND (any voxel with signed D < far_band * delta;
    # NaN never bands — no crossing without a negative corner, proof in
    # raycast._band_skip_mip) lets the nearest_far march leap
    # (s-1)*brick_min_extent per step through far space — observed OR
    # unobserved. Fixes empty_skip's blind spot (observed saturated free
    # space, where its W-based mip never fired). An extended-field variant
    # with zero per-step cost was rejected: it materializes max(D, lead)
    # in full-grid passes on every render. Default "off"; not measured on
    # the H100.
    #   "off"     — plain truncated march (delta-capped steps)
    #   "chamfer" — band-chamfer leaps (sample="nearest_far", m%8==0,
    #               (m/8)^3 % 128 == 0)
    far_field: str = "off"
    far_band: float = 0.75  # band threshold as a fraction of delta
    # March-loop unrolling: execute this many sphere-tracing steps per
    # while-loop iteration. BITWISE-equivalent (per-ray updates are masked
    # and deterministic; the alive-check granularity only affects when the
    # loop STOPS, never any ray's value; loops whose budget U does not
    # divide stay rolled) — the XLA analogue of a persistent kernel for
    # small/strided renders where per-iteration loop overhead (cond reduce
    # + control) rivals the tiny gather. The best U on the H100 is not
    # measured.
    march_unroll: int = 4
    # grazing-recovery compaction phase: "auto" enables it for batches
    # >= 4096 rays (its static cost dwarfs tiny batches). The SPMD
    # renderer (parallel.render.sharded_raycast) pins "on"/"off" to the
    # FULL image's auto decision so every ray follows the same phase
    # structure as the single-device program (the equality contract of
    # the ray-sharded design; tolerances in parallel/render.py).
    two_phase: str = "auto"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end runner configuration; presets mirror BASELINE.json configs."""

    grid: GridParams = GridParams()
    tracking: TrackingConfig = TrackingConfig()
    fusion: FusionConfig = FusionConfig()
    raycast: RaycastConfig = RaycastConfig()
    use_groundtruth: bool = False  # fusion-only oracle mode (sdf_reconstruction.cpp:51)
    bilateral_filter: bool = True
    # "full" = the 2-D (2r+1)^2 kernel; "separable" = vertical+horizontal
    # 1-D passes (2(2r+1) instead of (2r+1)^2 taps, ATE-equivalent on the
    # dataset oracle — see preprocess.bilateral_filter_separable)
    bilateral_mode: str = "full"
    trajectory_path: Optional[str] = "trajectory.txt"
    mesh_hz: float = 0.0  # 0 = no periodic meshing; reference runs 1 Hz async
    # live-mesh decimation factor for the async publisher: mesh every s-th
    # voxel (D is metric so slicing preserves the field; the exported mesh
    # is s-times coarser, the marching-cubes pass ~s^3 cheaper). Final
    # --mesh exports stay full-resolution. 0 = AUTO (m<256 -> full-res,
    # m=256 -> 2, m>=512 -> 4), so that a 1 Hz publisher does not eat the
    # frame budget; the policy's cost on the H100 is not measured.
    # Explicit 1 forces full-res live meshes (the publisher's rate then
    # auto-degrades, reported, visualizer.py).
    mesh_decimate: int = 0
    # u16-quantized vertex transfer for EVERY runner mesh export (final
    # --mesh, 1 Hz publisher, sharded/chunked): halves device->host vertex
    # bytes. Whether that still pays over the H100 host's PCIe link is not
    # measured. Error bound extent/131070 (~30 um at 4 m), two orders
    # under the voxel size; PLY output stays f32 world coordinates.
    # False = exact f32 transfer.
    mesh_vertex_quant: bool = True
    # coarse-to-fine pyramid: extra decimation factors (coarsest first,
    # ending at 1) multiplied onto tracking.pixel_stride; None = single level
    pyramid_levels: Optional[Tuple[int, ...]] = None
    # Tracking-failure detection (reference: none — a diverged pose fuses
    # garbage into the grid, sdf_reconstruction.cpp:69-74). A frame whose
    # track ends with fewer valid pixels or a larger mean |residual| than
    # these gates is REJECTED: the pose reverts to the previous frame's and
    # fusion is skipped (mirroring the tf-timeout drop path, :57-60).
    min_valid_pixels: int = 50
    max_mean_residual: float = 0.25  # meters; <=0 disables the gate
    # Initial pose guess for each frame's GN descent:
    #   * "previous" (default): the reference's behavior — start at the last
    #     pose (camera_tracking.cpp:66-79 never re-initializes).
    #   * "velocity": constant-velocity prediction
    #     T_init = T_{n-1} ∘ (T_{n-2}^{-1} ∘ T_{n-1}). MEASURED UNSTABLE for
    #     this frame-to-model tracker and NOT recommended: the fused model's
    #     residual basin is flat at mm scale (the tracker cannot correct
    #     errors smaller than ~the fusion smear), so an extrapolating init
    #     double-integrates the per-frame error — 20-frame synthetic orbit
    #     ATE degrades 12.5 mm -> 113 mm (and tightening max_twist_diff to
    #     1e-4 only recovers it to 38 mm at 2.5x the iterations). The
    #     prediction itself is accurate (2-7 mm vs 4-22 mm from "previous"
    #     on groundtruth poses); the instability is the closed loop.
    pose_init: str = "previous"


def preset(name: str) -> PipelineConfig:
    """Named presets matching BASELINE.json configs #1-#5."""
    presets = {
        # Single-frame fusion + raycast render, 64^3, synthetic depth.
        "synthetic64": PipelineConfig(
            grid=GridParams(m=64, width=2.0, height=2.0, depth=2.0,
                            origin=(-1.0, -1.0, -1.0), delta=0.1, epsilon=0.01),
        ),
        # 10-frame TUM clip, 128^3.
        "tum128": PipelineConfig(grid=GridParams(m=128)),
        # Full fr1/plant, 256^3 (reference's own configuration). Its
        # approximations were chosen for speed on the machine this code was
        # first tuned on; each is one flag from the exact setting, and none
        # has been re-measured on the H100:
        # * pixel_share 4x4: 120-frame dataset ATE 14.7 mm vs 9.1 mm at
        #   2x2 (both far under the paper's 47 mm fr1/plant bar);
        #   --pixel-share 1 is per-voxel exact, the parity-tested mode.
        #   Share 4 along k alone destabilized tracking (42.8 mm).
        # * pyramid (2, 1): one coarse stride-6 pass absorbs nearly all GN
        #   iterations (59 -> 16 fine iterations over 10 frames, identical
        #   trajectory).
        # * storage_dtype bfloat16: bench |t err| unchanged;
        #   --storage-dtype float32 is exact storage.
        # * bilateral_mode separable: 120-frame oracle ATE 14.8 vs 14.7 mm
        #   (the reference's own PCL FastBilateralFilter is a far coarser
        #   approximation); the exact 2-D kernel is one field away.
        # * distance point_to_point: 120-frame oracle 6.5 vs 14.7 mm,
        #   endurance 40.4 vs 45.4 mm, fewer GN iterations (18 vs 46 over
        #   10 frames). The reference ships p2plane (sdf.cpp:272) with p2p
        #   present but commented (sdf.cpp:267); --distance switches.
        # * color_every=2: color fidelity loss invisible (see tum512); the
        #   cadence is statically unrolled in chunked/bench loops rather
        #   than gated by lax.cond. --color-every 1 restores it.
        # * free_fold: FREE rows merged in the FULL D/W pass —
        #   bitwise-identical, one fewer gather/scatter pair per frame.
        # * weight_dtype bf16 + max_weight 128: 1200-frame endurance
        #   39.6 mm (f32: 40.6), 120-frame pathology 14.7 vs 14.9 — the
        #   clamp's recency weighting helps long runs. The reference never
        #   clamps; --weight-dtype float32 --max-weight 0 is unclamped.
        "tum256": PipelineConfig(
            grid=GridParams(m=256),
            bilateral_mode="separable",
            fusion=FusionConfig(mode="brickmajor", brick_shape=(8, 8, 8),
                                pixel_share=4, pixel_share_j=4,
                                brick_cap_free=2048,
                                distance="point_to_point",
                                color_every=2, free_fold=True,
                                weight_dtype="bfloat16", max_weight=128.0,
                                storage_dtype="bfloat16"),
            pyramid_levels=(2, 1),
        ),
        # 512^3 bricked grid + pyramid + device-side marching cubes. Same
        # caveat as tum256: chosen for speed elsewhere, accuracy-validated,
        # not re-measured on the H100.
        # * pixel_share 4x4 + point_to_point: 120-frame dataset oracle ATE
        #   6.1 mm vs 10.9 (8x4 + p2p) / 10.3 (4x4 p2plane).
        # * pyramid (4, 2, 1).
        # * hier_classify=4: super-brick pruning before the per-brick
        #   proofs; cap_mixed 1536 vs 1044-1094 mixed supers observed
        #   (overflow reported in FuseStats.overflow_mixed). At 256^3 it
        #   would need cap_mixed ~= NB/64, so tum256 leaves it off.
        # * color_every=3: 98.9% colored-voxel coverage and mean |drgb|
        #   0.08/255 vs every-frame color on the desk dataset; geometry
        #   and tracking are untouched (D/W fuse every frame).
        # * caps 28672 / 8192: n_full peaks at 27935 on the bench
        #   trajectory; the runner escalates and reports drops on wider
        #   scenes (every bench bootstrap drops FREE bricks at cap_free).
        # * free_fold, bf16 storage and weights, max_weight 128: endurance
        #   33.4 mm with these caps / 30.0 untrimmed (f32 unclamped: 39.1),
        #   against the paper's 41-43 mm.
        "tum512": PipelineConfig(
            grid=GridParams(m=512),
            bilateral_mode="separable",
            fusion=FusionConfig(mode="brickmajor", brick_shape=(8, 8, 8),
                                brick_cap=28672, pixel_share=4,
                                pixel_share_j=4, brick_cap_free=8192,
                                storage_dtype="bfloat16",
                                weight_dtype="bfloat16", max_weight=128.0,
                                distance="point_to_point",
                                color_every=3, free_fold=True,
                                hier_classify=4, cap_mixed=1536),
            pyramid_levels=(4, 2, 1),
        ),
    }
    return presets[name]
