"""reconstruction_tpu — a JAX multiview 3D reconstruction framework.

A from-scratch JAX/XLA re-design of the capabilities of the
``seed93/reconstruction`` reference (Beeler et al. 2010-style passive
multiview stereo: calibrated camera pairs -> rectified NCC stereo ->
constraint-filtered disparity -> iterative subpixel refinement ->
triangulated, fused, filtered point cloud -> screened-Poisson surface ->
trimmed, textured mesh), plus first-class distributed execution
(pair/tile/frame sharding over a `jax.sharding.Mesh`) and a new
pose-graph + bundle-adjustment stage.

Layering (see SURVEY.md section 7):
  core/      camera model, rectification, remap, pyramids, morphology
  stereo/    dense matching, constraint passes, refinement, triangulation
  cloud/     point-cloud neighbors, SOR, normals, MLS, cross-view dedup
  surface/   screened Poisson, marching cubes, trim, cleanup, texture
  ba/        feature tracks, pose graph, Schur-complement bundle adjustment
  parallel/  device mesh axes, shardings, halo exchange
  pipeline/  end-to-end orchestration, batch driver, checkpointing
  io/        PLY + OpenCV-YAML + image I/O (host side)
  utils/     logging, timing, metrics
"""

__version__ = "0.1.0"

from reconstruction_tpu.config import (  # noqa: F401
    ReconstructionConfig,
    StereoParams,
    CloudParams,
    SurfaceParams,
    preset,
)
