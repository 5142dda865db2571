"""Multi-chip scaling: shard the image plane (and agent batch) over a mesh.

The reference is strictly single-GPU; its only scalability knobs are
rtResolutionScale and active-chunk culling (SURVEY §5). This engine's
scaling axes (BASELINE.md stretch config "4 devices, 4 camera shards"):

  * pixels — the RT/raster ray pipeline is embarrassingly parallel over the
    image plane; rays are sharded over the mesh's "rays" axis and geometry
    arrays are replicated. XLA inserts no collectives until the final
    gather of the image (an all-gather over NVLink at frame end).
  * entities — the physics substep vmaps over agents; sharding its batch
    axis over the same mesh scales crowd scenes (the demo's ~10 agents are
    kept replicated — sub-chip scale).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding


def make_mesh(devices=None, axis: str = "rays") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def shard_rays(mesh: Mesh, o, d, axis: str = "rays"):
    """Place ray arrays row-sharded over the mesh (pads to device multiple)."""
    n = o.shape[0]
    n_dev = mesh.devices.size
    pad = (-n) % n_dev
    if pad:
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
        d = jnp.concatenate([d, jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (pad, 1))])
    sh = NamedSharding(mesh, P(axis))
    return jax.device_put(o, sh), jax.device_put(d, sh), n


def shard_world_state(mesh: Mesh, state, axis: str = "rays"):
    """Place a WorldState pytree with its ENTITY axis sharded over the mesh
    (the entity scaling axis of SURVEY §5).

    Every leaf whose leading dimension equals the entity count is sharded
    P(axis); all other leaves (palettes (C,B,4,4), scalars) replicate. The
    physics substep is then auto-partitioned by GSPMD under plain jit:
    per-agent stages (intent, mover, ground probe, pose) run on the owning
    device, and the cross-agent couplings (separation candidates, platform
    carry lookups) become XLA-inserted collectives — no manual shard_map
    needed because the substep's batch math is already vmapped arrays.
    GSPMD handles entity counts that don't divide the device count."""
    n = state.alive.shape[0]
    ent = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def put(x):
        if hasattr(x, "shape") and getattr(x, "ndim", 0) >= 1 \
                and x.shape[0] == n:
            return jax.device_put(x, ent)
        return jax.device_put(x, rep)

    return jax.tree.map(put, state)


def sharded_render(mesh: Mesh, geo, ibl, lights, width: int, height: int,
                   max_layers: int = 2, shadow_layers: int = 1):
    """Build a jitted, image-plane-sharded RT frame function.

    Returns fn(transforms, palettes, inv_view_proj, cam_pos) -> (H,W,3).
    Geometry/BVH replicate to every device; the per-ray pipeline runs under
    ``jax.shard_map`` over the "rays" axis, so each device executes the FULL
    per-shard pipeline — including the traversal kernel's custom call — on
    its local rays by construction (jit auto-partitioning would treat the
    custom call as unpartitionable and gather the whole batch onto one
    device). Zero cross-device traffic until the final image assembly
    (an all-gather implied by the replicated output sharding).
    """
    from ..render import rt as RT
    from ..render.scene_geometry import flatten_frame
    from ..render.camera import generate_rays_tiled, untile_image

    axis = mesh.axis_names[0]
    rep = NamedSharding(mesh, P())
    n_dev = mesh.devices.size

    def per_shard(fg, cam_pos, o, d):
        # Runs once per device on the LOCAL ray shard; fg/cam replicate.
        return RT._render_rays(geo, fg, ibl, lights, cam_pos, o, d,
                               max_layers, shadow_layers, True, True)

    # check_vma=False: the traversal while_loops seed their carries from
    # unvarying constants and tighten them with ray-varying values — valid
    # per-device code that the varying-manual-axes type check rejects.
    shard_fn = jax.shard_map(per_shard, mesh=mesh,
                             in_specs=(P(), P(), P(axis), P(axis)),
                             out_specs=P(axis), check_vma=False)

    @partial(jax.jit, out_shardings=rep)
    def render(transforms, palettes, ivp, cam_pos):
        fg = flatten_frame(geo, transforms, palettes)
        # Padded tile-major lane order: each device's contiguous shard is a
        # run of whole pixel tiles, and no permutation gathers exist (see
        # rt.render_frame).
        o, d, _, _ = generate_rays_tiled(ivp, cam_pos, width, height)
        n = o.shape[0]
        pad = (-n) % n_dev
        if pad:
            # Park padded rays far outside the scene (they miss the root
            # box) rather than at the origin.
            o = jnp.concatenate([o, jnp.full((pad, 3), 1.0e9, o.dtype)])
            d = jnp.concatenate([d, jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (pad, 1))])
        img = shard_fn(fg, cam_pos, o, d)
        return untile_image(img[:n], width, height)

    return render


def sharded_fused_step(mesh: Mesh, scene, ibl, width: int, height: int,
                       n_substeps: int = 1, max_layers: int = 1,
                       shadow_layers: int = 1):
    """ONE jitted program over the mesh mirroring the SHIPPED frame
    structure (scene.engine._fused): fixed substeps on the entity-sharded
    WorldState -> render extraction -> frame flatten -> image-plane-sharded
    render. Entities ride GSPMD auto-partitioning (see shard_world_state);
    rays ride shard_map. Returns step(state, ivp, cam_pos, cam_world) ->
    (state, (H, W, 3) image)."""
    import jax.numpy as jnp
    from ..render import rt as RT
    from ..render.scene_geometry import flatten_frame
    from ..render.camera import generate_rays_tiled, untile_image

    geo = scene["geometry"]
    lights = scene["lights"]
    stepper = scene["stepper"]
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size

    def per_shard(fg, cam_pos, o, d):
        return RT._render_rays(geo, fg, ibl, lights, cam_pos, o, d,
                               max_layers, shadow_layers, True, True)

    shard_fn = jax.shard_map(per_shard, mesh=mesh,
                             in_specs=(P(), P(), P(axis), P(axis)),
                             out_specs=P(axis), check_vma=False)

    @jax.jit
    def step(state, ivp, cam_pos, cam_world):
        for _ in range(n_substeps):
            state = stepper._substep_impl(state, jnp.float32(1.0 / 60.0))
        transforms, palettes = stepper._extract(state, jnp.float32(1.0),
                                                cam_world)
        fg = flatten_frame(geo, transforms, palettes)
        o, d, _, _ = generate_rays_tiled(ivp, cam_pos, width, height)
        n = o.shape[0]
        pad = (-n) % n_dev
        if pad:
            o = jnp.concatenate([o, jnp.full((pad, 3), 1.0e9, o.dtype)])
            d = jnp.concatenate(
                [d, jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (pad, 1))])
        img = shard_fn(fg, cam_pos, o, d)
        return state, untile_image(img[:n], width, height)

    return step
