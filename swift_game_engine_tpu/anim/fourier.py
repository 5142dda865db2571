"""Device-side Fourier motion-profile evaluation.

The reference evaluates each bone axis with a scalar loop per call
(reference: Game/Animation.swift:65-89). Here the whole pose bank is one
matvec: ``values[B, 6] = coeffs[B, 6, C] @ basis(phase)[C]`` — batched over
characters and profiles it becomes a single matmul.
"""

from __future__ import annotations

import jax.numpy as jnp


def fourier_basis(phase, order: int):
    """``[1, cos(2*pi*k*p), sin(2*pi*k*p) for k=1..order]`` with p clamped to [0,1].

    ``phase``: scalar or (...,) array. Returns (..., 2*order+1).
    """
    p = jnp.clip(jnp.asarray(phase, jnp.float32), 0.0, 1.0)
    ks = jnp.arange(1, order + 1, dtype=jnp.float32)
    ang = 2.0 * jnp.pi * ks * p[..., None]
    cos = jnp.cos(ang)
    sin = jnp.sin(ang)
    inter = jnp.stack([cos, sin], axis=-1).reshape(*p.shape, 2 * order)
    return jnp.concatenate([jnp.ones((*p.shape, 1), jnp.float32), inter], axis=-1)


def evaluate_packed(coeffs, has_channel, phase, order: int, default_trans, ):
    """Evaluate a packed profile at ``phase``.

    Args:
      coeffs:      (B, 6, C) float32 — packed Fourier coefficients.
      has_channel: (B, 6) bool — absent channels fall back to defaults
                   (raw rest translation / zero rotation, reference:
                   Game/Animation.swift:80-88 + ProceduralPoseSystem.swift:156-192).
      phase:       scalar phase in [0, 1] (clamped).
      default_trans: (B, 3) raw rest translations.

    Returns:
      trans_raw (B, 3) in FBX-local units, rot_deg (B, 3) Euler degrees.
    """
    basis = fourier_basis(phase, order)           # (C,)
    values = coeffs @ basis                        # (B, 6)
    trans_raw = jnp.where(has_channel[:, :3], values[:, :3], default_trans)
    rot_deg = jnp.where(has_channel[:, 3:], values[:, 3:], 0.0)
    return trans_raw, rot_deg
