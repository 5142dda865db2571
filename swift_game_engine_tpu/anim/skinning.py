"""Linear-blend skinning as one matmul.

The reference skins on the GPU with a per-vertex 4-bone gather loop
(reference: Game/RayTracing.metalinc:737-776 ``skinningKernel``; semantics:
position by the full 4x4, normal/tangent by the 3x3 block, tangent.w
passthrough). The (V, 4) sparse weights are pre-expanded to a dense (V, B)
matrix (B = bone count) and the per-vertex skinning matrix becomes

    skin_mats[V, 16] = dense_weights[V, B] @ palette[B, 16]

one matmul for the whole mesh (and one batched matmul for all
characters), with the vertex transforms fused by XLA behind it.
"""

from __future__ import annotations

import jax.numpy as jnp


def skin_matrices(dense_weights, palette):
    """Per-vertex LBS matrices.

    Args:
      dense_weights: (V, B) float32.
      palette:       (..., B, 4, 4) skinning palette (model @ invBind).
    Returns:
      (..., V, 4, 4) per-vertex matrices.
    """
    b = palette.shape[-3]
    flat = palette.reshape(*palette.shape[:-3], b, 16)
    mats = jnp.einsum("vb,...bf->...vf", dense_weights, flat,
                      preferred_element_type=jnp.float32)
    return mats.reshape(*mats.shape[:-1], 4, 4)


def skin_vertices(dense_weights, palette, positions, normals=None, tangents=None):
    """Skin positions (+ optional normals/tangents).

    Matches the reference kernel: positions through the full affine matrix,
    normals and tangent.xyz through the 3x3 linear block (no inverse
    transpose), tangent w component passed through.

    Args:
      positions: (V, 3); normals: (V, 3) or None; tangents: (V, 4) or None.
    Returns:
      dict with "positions" (..., V, 3) and optionally "normals", "tangents".
    """
    mats = skin_matrices(dense_weights, palette)          # (..., V, 4, 4)
    rot = mats[..., :3, :3]
    pos = jnp.einsum("...vij,vj->...vi", rot, positions) + mats[..., :3, 3]
    out = {"positions": pos}

    def unit(x):
        return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    if normals is not None:
        # Reference skinningKernel normalizes skinned normals/tangents
        # (RayTracing.metalinc:768, 775).
        out["normals"] = unit(jnp.einsum("...vij,vj->...vi", rot, normals))
    if tangents is not None:
        txyz = unit(jnp.einsum("...vij,vj->...vi", rot, tangents[..., :3]))
        out["tangents"] = jnp.concatenate(
            [txyz, jnp.broadcast_to(tangents[..., 3:], txyz[..., :1].shape)], axis=-1)
    return out
