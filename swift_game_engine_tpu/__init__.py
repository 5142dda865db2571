"""swift_game_engine_tpu — a JAX simulation + rendering framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the reference
Swift/Metal game engine (kelian343/swift-game-engine): ECS simulation stepped
under one jit, Fourier motion-profile animation, capsule-CCD character
physics, and dual render paths (ray traced + raster) with PBR + IBL shading.

Subpackages:
  math3d    — matrices / quaternions / Euler (reference Game/Math.swift)
  assets    — JSON asset schemas + procedural mesh/texture generation
  anim      — Fourier pose evaluation, FK, skinning, locomotion blending
  ecs       — pytree-of-arrays world state
  physics   — vectorized capsule CCD + move-and-slide + agent separation
  render    — LBVH, ray-traced and raster paths, IBL, compositing
  ops       — the GPU BVH traversal kernel (Pallas, Triton route)
  parallel  — device-mesh sharding of the image plane / entity batches
  scene     — demo scene, character factory, input, fixed-step driver
"""

__version__ = "0.1.0"

# Matmul precision: geometry pipelines (matrix inverses, ray transforms,
# FK palettes) are not robust to TF32, which f32 matmuls may use on NVIDIA
# GPUs by default (about three decimal digits). The engine requires true
# f32 matmuls; code that genuinely wants lower precision opts in with an
# explicit `precision` / `preferred_element_type`.
import jax as _jax

_jax.config.update("jax_default_matmul_precision", "float32")
