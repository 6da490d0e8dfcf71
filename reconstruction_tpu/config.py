"""Typed configuration for the whole framework.

The reference scatters its hyperparameters over hard-coded wiring
(`reconstruction/CReconstruction.cpp:17-18`), in-file constants
(`reconstruction/CStereoMatching.cpp:4`, `CStereoMatching.h:9`,
`CStereoMatching.cpp:95`), external-tool command lines (`Demo/mesh.bat:1-2`)
and meshlab scripts (`Demo/meshlab/script1.mlx`, `script2.mlx`).  Here every
one of those knobs is a typed field with the reference's defaults, and the
two wiring variants preserved in the reference's comments are exposed as the
"myself" and "ETH" presets.

The run-level keys mirror the reference's OpenCV-FileStorage YAML config
(`reconstruction/CManageData.cpp:26-43`) so that a reference user's
``config.yml`` loads unchanged (see `reconstruction_tpu.io.opencv_yaml`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Sequence, Tuple

import jax
import numpy as np

# Sentinel for "no match" disparities (`reconstruction/CStereoMatching.h:9`).
NOMATCH = -10000

# Precision of the f32 geometry contractions (triangulation, camera
# projections, normal/MLS covariances, texture projection, dedup).  GPUs
# otherwise run f32 dot products in TF32, whose ~1e-3 relative error is
# the size of the whole surface-RMSE budget; these are 3x3/3x4
# contractions, so full f32 costs next to nothing.
GEOMETRY_PRECISION = jax.lax.Precision.HIGHEST


@dataclass(frozen=True)
class StereoParams:
    """Dense-stereo stage parameters.

    Defaults follow the "new" wiring at `CReconstruction.cpp:17` and the
    constants in `CStereoMatching.cpp`.
    """

    # NCC matching window radius (`CReconstruction.cpp:17`, radii=2).
    block_radius: int = 2
    # Smoothing weight ws in the subpixel refine (`CReconstruction.cpp:17`).
    refine_ws: float = 0.03
    # Guided-search half width around the upsampled coarse disparity
    # (`CStereoMatching.h` disparity_offset default, used at
    # `CStereoMatching.cpp:286-287`).
    disparity_offset: int = 2
    # Per-step decay for disparity-bound propagation
    # (`CStereoMatching.cpp:4`, MAX_DISPARITY).
    max_disparity_step: int = 2
    # Refinement iteration budget per level: base + slope * level
    # (`CStereoMatching.cpp:95`, 30 + 30*level).
    refine_iters_base: int = 30
    refine_iters_per_level: int = 30
    # Smoothness-constraint violation threshold |d - d_neighbor| > 1
    # (`CStereoMatching.cpp:3`).
    smooth_violation_threshold: int = 1
    # Median-filter iterations (`CStereoMatching.cpp:89-90`, 1).
    median_iterations: int = 1
    # Mask-erosion ellipse diameter at full resolution, in units of
    # 3 * 2^(PyrmNum-1) pixels (`CStereoMatching.cpp:157`).
    mask_erode_base: int = 3
    # Extra erosion before triangulation, fraction of image height
    # (`CStereoMatching.cpp:703`).
    cloud_erode_frac: float = 0.02
    # Window re-centering cadence for the refine drift budget: -1 = auto
    # (ONE mid-run re-extraction — raises the usable drift budget from
    # the +-12-slot mini window toward the banded volume's +-16 margin
    # for ~0.24 s extra at 1920x1280), 0 = off, k > 0 = every k sweeps.
    refine_recenter_every: int = -1


@dataclass(frozen=True)
class CloudParams:
    """Point-cloud optimization parameters (`CReconstruction.cpp:18`,
    `CCloudOptimization.cpp:40-56`)."""

    # Statistical outlier removal: k nearest neighbors and std multiplier.
    sor_mean_k: int = 100
    sor_std_thresh: float = 1.0
    # Radius outlier removal (present but commented out in the reference,
    # `CCloudOptimization.cpp:90-96`; kept as an optional stage).
    outrem_neighbors: int = 50
    outrem_radius: float = 2.0
    use_radius_outlier_removal: bool = False
    # Normal-estimation / MLS search radius (`CCloudOptimization.cpp:106,358`).
    # The MLS polynomial order is NOT a knob: the reference hard-codes
    # order 1 (`CCloudOptimization.cpp:360`) and cloud/mls.py implements
    # exactly that (order-1 fit == plane projection).
    mls_radius: float = 2.5
    # Cross-view dedup enabled (`isdelete`, `CReconstruction.cpp:18` false).
    dedup: bool = False
    # Cloud-stage backend: "jax" (device voxel-grid reduces), "native"
    # (multi-threaded C++ exact k-NN on host) or "auto" (= jax, unless
    # RECON_CLOUD_BACKEND says otherwise — cloud/backend.py).
    backend: str = "auto"
    # Fixed-capacity padding for device-side point buffers: points per pair.
    max_points_per_pair: int = 1 << 21
    # Neighbor-search voxel capacity (padded gathers).
    max_neighbors: int = 128


@dataclass(frozen=True)
class SurfaceParams:
    """Surfacing parameters.

    The reference shells out to PoissonRecon/SurfaceTrimmer/meshlabserver
    (`Demo/mesh.bat:1-3`, `Demo/meshlab.bat:1-2`); the in-process
    equivalent solves on a dense device grid with these knobs.
    """

    # Per-pair Poisson octree depth (`Demo/mesh.bat:1`, --depth 9).
    pair_depth: int = 9
    # Global Poisson octree depth (`Demo/meshlab/script1.mlx`, OctDepth 10).
    global_depth: int = 10
    # Dense-grid resolution used by the device Poisson solver.  The octree
    # solvers above are adaptive; a dense 256^3 grid bounds fidelity while
    # staying in HBM (see SURVEY.md section 7 "hard parts" (d)).
    grid_resolution: int = 256
    # Screened-Poisson point weight (`Demo/mesh.bat:1`, --pointWeight 0).
    point_weight: float = 0.0
    # Samples per node analogue: splat support radius in voxels.
    splat_radius: float = 1.5
    # Multigrid V-cycles and relaxation sweeps.
    mg_cycles: int = 8
    mg_pre_smooth: int = 2
    mg_post_smooth: int = 2
    # Density trim quantile (SurfaceTrimmer --trim 7 on octree-depth scale;
    # reformulated as a density quantile on the dense grid).
    trim_quantile: float = 0.05
    # Island removal threshold (`script2.mlx` MinComponentDiag, fraction of
    # bounding-box diagonal).
    min_component_diag_frac: float = 0.10
    # Laplacian smoothing steps (`script1.mlx`, stepSmoothNum 5).
    laplacian_steps: int = 5
    laplacian_cotangent: bool = True
    # Close holes up to this boundary-edge count (`script2.mlx`, 30).
    close_holes_max_edges: int = 30
    # Surface trim smoothing iterations (SurfaceTrimmer --smooth 100,
    # `Demo/mesh.bat:2`) — passed to density_trim by BOTH the per-pair
    # and the global mesh paths.
    trim_smooth_iters: int = 100
    # Per-pair Poisson grid (reference: depth 9 ~= 512^3 effective,
    # `Demo/mesh.bat:1`).  0 = use grid_resolution (r2 silently capped
    # this at 192^3; the fidelity table in BENCH_NOTES.md shows RMSE
    # halves per doubling, so the cap is now explicit config).
    pair_grid_resolution: int = 0

    def __post_init__(self):
        # The density-grid 2x mean-pool in the packed Poisson fetch
        # slices [::2]/[1::2] along every axis, so odd resolutions
        # would crash deep in the pipeline with a broadcast mismatch
        # (ADVICE r4) — fail here with a readable message instead.
        for name in ("grid_resolution", "pair_grid_resolution"):
            v = getattr(self, name)
            if v % 2 != 0:
                raise ValueError(
                    f"SurfaceParams.{name}={v} must be even (the "
                    "density grid is 2x mean-pooled for transfer)")


@dataclass(frozen=True)
class BAParams:
    """Bundle-adjustment stage (new capability; BASELINE.json north star)."""

    max_features_per_view: int = 2048
    harris_k: float = 0.04
    ncc_match_threshold: float = 0.8
    max_track_length: int = 64
    gn_iterations: int = 10
    damping: float = 1e-3
    huber_delta: float = 2.0


@dataclass(frozen=True)
class ParallelParams:
    """Device-mesh layout (SURVEY.md section 5: axes (frame, pair, tile))."""

    frame_axis: str = "frame"
    pair_axis: str = "pair"
    tile_axis: str = "tile"
    # Rows of halo exchanged between tile shards (>= stencil radius).
    halo_rows: int = 4


@dataclass(frozen=True)
class ReconstructionConfig:
    """Top-level run configuration.

    Field names mirror the reference's YAML keys
    (`reconstruction/CManageData.cpp:26-43`).
    """

    filepath: str = ""
    outfilename: str = "out.ply"
    isoutput: bool = False
    camera_calib_name: str = "calib_camera.yml"
    # Pyramid levels (`PyrmNum`).
    pyramid_levels: int = 4
    # Coarsest-level size (`LowestLevelWidth/Height`): (width, height).
    lowest_level_size: Tuple[int, int] = (160, 240)
    # Per-camera relative image/mask paths, indexed by camID.
    imagelist: Tuple[str, ...] = ()
    masklist: Tuple[str, ...] = ()
    # Stereo pair table: rows of (left camID, right camID)
    # (`BatchProcess/main.cpp:30-35`).
    cam_pairs: Tuple[Tuple[int, int], ...] = ((0, 1), (2, 3), (4, 5), (7, 6))

    # Max camera pairs with device work in flight ahead of the fetch
    # pointer (pyramids + level state are ~0.4 GB/pair at the myself
    # shape; deep dispatch overlaps transfer with the NEXT pairs'
    # compute, while the bound keeps device memory O(depth) instead of
    # O(pairs)).  0 = unbounded.
    dispatch_depth: int = 4

    stereo: StereoParams = field(default_factory=StereoParams)
    cloud: CloudParams = field(default_factory=CloudParams)
    surface: SurfaceParams = field(default_factory=SurfaceParams)
    ba: BAParams = field(default_factory=BAParams)
    parallel: ParallelParams = field(default_factory=ParallelParams)

    # Working dtype on device.  The reference computes in float64
    # (`CStereoMatching.cpp:585`); accelerators have no fast f64, so the
    # working dtype is f32 with f32 accumulation for the NCC matmuls.
    dtype: str = "float32"

    @property
    def num_pairs(self) -> int:
        return len(self.cam_pairs)

    @property
    def finest_size(self) -> Tuple[int, int]:
        """(width, height) of the finest pyramid level — the rectified
        working resolution (`CStereoMatching.cpp:120`)."""
        s = 1 << (self.pyramid_levels - 1)
        return (self.lowest_level_size[0] * s, self.lowest_level_size[1] * s)

    def level_size(self, level: int) -> Tuple[int, int]:
        """(width, height) at pyramid ``level`` (0 = coarsest)."""
        s = 1 << level
        return (self.lowest_level_size[0] * s, self.lowest_level_size[1] * s)

    def refine_iterations(self, level: int) -> int:
        """`CStereoMatching.cpp:95`: 30 + 30*level."""
        return self.stereo.refine_iters_base + self.stereo.refine_iters_per_level * level

    def replace(self, **kw) -> "ReconstructionConfig":
        return dataclasses.replace(self, **kw)


def preset(name: str) -> ReconstructionConfig:
    """Named presets.

    "myself": the 10-camera face-rig wiring (`CReconstruction.cpp:17-18`
    active values + `BatchProcess/main.cpp:47-73` shapes).
    "ETH": the commented ETH variant (`CReconstruction.cpp:18` comment:
    sor 100/0.5, outrem 50/2, mls_radius 0.5).
    """
    if name == "myself":
        return ReconstructionConfig()
    if name == "ETH":
        return ReconstructionConfig(
            cloud=CloudParams(sor_mean_k=100, sor_std_thresh=0.5,
                              outrem_neighbors=50, outrem_radius=2.0,
                              mls_radius=0.5),
        )
    if name == "tiny":
        # Small synthetic preset used by unit tests and the dry run.
        # NOTE: cloud radii are WORLD units (the reference's 2.5 suits its
        # mm-scale captures, `CReconstruction.cpp:18`); the synthetic test
        # scene spans ~4 units, so radii scale down accordingly.
        return ReconstructionConfig(
            pyramid_levels=2,
            lowest_level_size=(64, 48),
            cam_pairs=((0, 1),),
            cloud=CloudParams(sor_mean_k=30, mls_radius=0.08,
                              max_points_per_pair=1 << 14),
            surface=SurfaceParams(grid_resolution=64, mg_cycles=4),
        )
    if name == "dome32":
        # Synthetic 32-camera dome at 4K (BASELINE.json configs[3]):
        # 16 adjacent pairs, pair-sharded across hosts.
        return ReconstructionConfig(
            pyramid_levels=5,
            lowest_level_size=(240, 135),
            cam_pairs=tuple((2 * i, 2 * i + 1) for i in range(16)),
        )
    raise KeyError(
        f"unknown preset {name!r}; available: myself, ETH, tiny, dome32")
