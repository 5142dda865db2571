"""Render geometry: pack scene items into flat device arrays per frame.

The reference packs RenderItems into big static/dynamic SoA buffers with
per-instance info + a texture slot registry, GPU-skins the dynamic verts and
(re)builds Metal acceleration structures (reference:
Game/RTGeometryCache.swift:54-577, Game/RTAccelerationBuilder.swift:10-247,
Game/RenderItem.swift:10-28). Here:

  * Geometry is packed ONCE at scene build: one vertex pool
    [static-instanced verts | skinned verts], one index pool, per-triangle
    material ids, a flat material table, and a fixed-size texture bank.
  * Per frame, a single jitted `flatten_frame` produces world-space vertex
    arrays: static verts gather their instance transform; skinned verts are
    produced by the dense-matmul LBS (anim.skinning) and then instanced.
  * One global BVH (render.bvh) is host-built over the bind/build pose and
    device-refit every frame — subsuming BLAS refit + TLAS rebuild.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..assets.mesh_api import MeshDescriptor, compute_tangents
from ..assets.materials import Material
from ..assets.procedural_textures import flat_normal
from ..anim.skinning import skin_vertices
from . import bvh as B
from .textures import TextureBank, TextureBankBuilder


class MaterialTable(NamedTuple):
    """Flat PBR material arrays (K materials)."""

    base_color: jnp.ndarray       # (K,3)
    metallic: jnp.ndarray         # (K,)
    roughness: jnp.ndarray        # (K,)
    emissive: jnp.ndarray         # (K,3)
    occlusion_strength: jnp.ndarray  # (K,)
    alpha: jnp.ndarray            # (K,)
    transmission: jnp.ndarray     # (K,)
    ior: jnp.ndarray              # (K,)
    unlit: jnp.ndarray            # (K,) bool
    normal_scale: jnp.ndarray     # (K,)
    exposure: jnp.ndarray         # (K,)
    tone_mapped: jnp.ndarray      # (K,) bool
    base_tex: jnp.ndarray         # (K,) int32 (-1 none)
    normal_tex: jnp.ndarray
    mr_tex: jnp.ndarray
    emissive_tex: jnp.ndarray
    occlusion_tex: jnp.ndarray
    # One (K,16) f32 row per material packing the hot shading fields, so a
    # hit's material is ONE gather instead of ~12:
    # [0:3] base_color, [3] alpha, [4] metallic, [5] roughness,
    # [6:9] emissive, [9] occlusion_strength, [10] transmission, [11] ior,
    # [12] normal_scale, [13] base_tex, [14] normal_tex, [15] mr_tex
    packed: jnp.ndarray


class TextureUsage(NamedTuple):
    """Static (hashable) per-scene texture-slot usage, used to specialize
    the traced shading code: slots no scene material binds skip their
    gather-heavy bilinear samples entirely. ``alpha_tex`` is True only if
    some bound base texture actually carries alpha < 1 (otherwise the
    shadow filter needs no texture taps at all)."""

    base: bool
    mr: bool
    emissive: bool
    occlusion: bool
    normal: bool
    alpha_tex: bool


_USAGE_CACHE: dict = {}


def texture_usage(geo: "SceneGeometry") -> TextureUsage:
    """Compute (and memoize) TextureUsage for a concrete SceneGeometry.

    Must be called where ``geo`` holds concrete arrays (closure constants
    at trace time) — the result is a static Python value.
    """
    # Single-slot memo keyed on object identity (verified with `is` — a
    # bare id() key would alias recycled addresses). One slot bounds the
    # cache: long sessions that rebuild scenes don't pin every materials
    # object for process lifetime, and a frame renders one scene at a time.
    hit = _USAGE_CACHE.get("slot")
    if hit is not None and hit[0] is geo.materials:
        return hit[1]
    mats = geo.materials

    def used(ids):
        return bool(np.any(np.asarray(ids) >= 0))

    base_ids = np.asarray(mats.base_tex)
    alpha_tex = False
    if np.any(base_ids >= 0):
        amin = np.asarray(geo.textures.data)[..., 3].min(axis=(1, 2))
        alpha_tex = bool(amin[base_ids[base_ids >= 0]].min() < 0.999)
    usage = TextureUsage(base=used(mats.base_tex), mr=used(mats.mr_tex),
                         emissive=used(mats.emissive_tex),
                         occlusion=used(mats.occlusion_tex),
                         normal=used(mats.normal_tex), alpha_tex=alpha_tex)
    _USAGE_CACHE["slot"] = (mats, usage)
    return usage


class SceneGeometry(NamedTuple):
    """Static packing; world-space arrays come from flatten_frame."""

    # vertex pool (S static + D skinned = V)
    static_pos: jnp.ndarray       # (S,3) local
    static_nrm: jnp.ndarray       # (S,3)
    static_tan: jnp.ndarray       # (S,4)
    vert_instance: jnp.ndarray    # (V,) int32 into instance transforms
    uv: jnp.ndarray               # (V,2)
    # triangles
    tri: jnp.ndarray              # (T,3) int32 into vertex pool
    tri_material: jnp.ndarray     # (T,) int32
    materials: MaterialTable
    textures: TextureBank
    # skinned block descriptors (static metadata)
    skinned_blocks: tuple         # tuple of dicts (host data, see builder)
    n_static_verts: int
    topo: B.BVHTopology
    # (T,) bool: triangle's material can pass light (alpha factor < 1 or a
    # base texture with real alpha) — drives the shadow any-hit prepass.
    tri_translucent: jnp.ndarray
    # (T,8) f32 static per-triangle shade row — ONE gather per hit replaces
    # four (tri indices + 3 per-vertex uv gathers + material id):
    # [uv0.x, uv0.y, uv1.x, uv1.y, uv2.x, uv2.y, material id, unlit flag]
    tri_shade: jnp.ndarray


@dataclass
class RenderGeometryBuilder:
    """Host-side accumulation of render items."""

    texture_size: int = 512

    def __post_init__(self):
        # Static and skinned vertex streams are kept separate because the
        # final pool layout is [all static verts | all skinned verts] (the
        # per-frame flatten concatenates LBS outputs after the statics).
        self._pos, self._nrm, self._tan, self._uv, self._inst = [], [], [], [], []
        self._sk_uv, self._sk_inst = [], []
        self._tri, self._tri_mat = [], []           # static, absolute indices
        self._sk_tri, self._sk_tri_mat = [], []     # skinned, skinned-pool-relative
        self._materials: list[Material] = []
        self._mat_ids: dict[int, int] = {}
        self._skinned = []
        self._tex_builder = TextureBankBuilder(self.texture_size)
        self._tex_ids: dict[int, int] = {}
        self._n_verts = 0          # static verts so far
        self._n_sk_verts = 0       # skinned verts so far

    def _material_id(self, mat: Material) -> int:
        key = id(mat)
        if key in self._mat_ids:
            return self._mat_ids[key]

        def tex(t):
            if t is None:
                return -1
            k = id(t)
            if k not in self._tex_ids:
                self._tex_ids[k] = self._tex_builder.add(t)
            return self._tex_ids[k]

        idx = len(self._materials)
        self._materials.append(mat)
        self._mat_ids[key] = idx
        self._mat_tex = getattr(self, "_mat_tex", [])
        self._mat_tex.append((tex(mat.base_color_texture), tex(mat.normal_texture),
                              tex(mat.metallic_roughness_texture),
                              tex(mat.emissive_texture), tex(mat.occlusion_texture)))
        return idx

    def add_static_mesh(self, mesh: MeshDescriptor, material: Material,
                        instance: int, tri_range=None):
        """Add a static mesh bound to instance-transform slot ``instance``.

        ``tri_range``: optional (start, count) in *index units* for submesh
        material splits.
        """
        mesh = mesh.with_tangents() if mesh.uvs is not None and mesh.normals is not None else mesh
        base = self._n_verts
        v = mesh.vertex_count
        self._pos.append(mesh.positions)
        nrm = mesh.normals if mesh.normals is not None else np.tile(
            np.array([[0, 1, 0]], np.float32), (v, 1))
        self._nrm.append(nrm)
        tan = mesh.tangents if mesh.tangents is not None else np.tile(
            np.array([[1, 0, 0, 1]], np.float32), (v, 1))
        self._tan.append(tan)
        uv = mesh.uvs if mesh.uvs is not None else np.zeros((v, 2), np.float32)
        self._uv.append(uv)
        self._inst.append(np.full(v, instance, np.int32))
        self._n_verts += v

        idx = mesh.indices
        if tri_range is not None:
            s, c = tri_range
            idx = idx[s:s + c]
        tris = idx.reshape(-1, 3) + base
        self._tri.append(tris.astype(np.int32))
        self._tri_mat.append(np.full(len(tris), self._material_id(material), np.int32))

    def add_skinned_mesh(self, positions, normals, uvs, indices, dense_weights,
                         materials_per_submesh, submesh_ranges, instance: int,
                         character: int, tangents=None, inv_bind_override=None):
        """Add a skinned mesh: verts come from per-frame LBS of character slot.

        submesh_ranges: list of (start, count) in index units aligned with
        materials_per_submesh.
        """
        if tangents is None:
            tangents = compute_tangents(positions, normals, uvs, indices)
        base = self._n_sk_verts     # relative to the skinned pool; fixed up in build()
        v = len(positions)
        self._sk_uv.append(np.asarray(uvs, np.float32))
        self._sk_inst.append(np.full(v, instance, np.int32))
        self._n_sk_verts += v
        self._skinned.append(dict(
            base_vertex=base,
            positions=jnp.asarray(positions),
            normals=jnp.asarray(normals),
            tangents=jnp.asarray(tangents),
            dense_weights=jnp.asarray(dense_weights),
            character=character,
            inv_bind_override=None if inv_bind_override is None else jnp.asarray(inv_bind_override),
        ))
        for (s, c), mat in zip(submesh_ranges, materials_per_submesh):
            tris = np.asarray(indices[s:s + c]).reshape(-1, 3) + base
            self._sk_tri.append(tris.astype(np.int32))
            self._sk_tri_mat.append(np.full(len(tris), self._material_id(mat), np.int32))

    def build(self) -> SceneGeometry:
        n_static = sum(len(p) for p in self._pos)

        def cat(lists, empty_shape, dtype=np.float32):
            return np.concatenate(lists) if lists else np.zeros(empty_shape, dtype)

        static_pos = cat(self._pos, (0, 3))
        static_nrm = cat(self._nrm, (0, 3))
        static_tan = cat(self._tan, (0, 4))
        # vertex pool layout: [static | skinned]
        uv = np.concatenate([cat(self._uv, (0, 2)), cat(self._sk_uv, (0, 2))])
        inst = np.concatenate([cat(self._inst, (0,), np.int32),
                               cat(self._sk_inst, (0,), np.int32)])
        sk_tri = cat(self._sk_tri, (0, 3), np.int32)
        tri = np.concatenate([cat(self._tri, (0, 3), np.int32),
                              sk_tri + n_static]).astype(np.int32)
        tri_mat = np.concatenate([cat(self._tri_mat, (0,), np.int32),
                                  cat(self._sk_tri_mat, (0,), np.int32)])

        mats = self._materials
        tex = getattr(self, "_mat_tex", [])
        k = max(len(mats), 1)

        def arr(fn, default, dtype=np.float32, dims=None):
            out = np.full((k, *(dims or ())), default, dtype)
            for i, m in enumerate(mats):
                out[i] = fn(m)
            return jnp.asarray(out)

        table = MaterialTable(
            base_color=arr(lambda m: m.base_color_factor, 1.0, dims=(3,)),
            metallic=arr(lambda m: m.metallic_factor, 0.0),
            roughness=arr(lambda m: m.roughness_factor, 0.5),
            emissive=arr(lambda m: m.emissive_factor, 0.0, dims=(3,)),
            occlusion_strength=arr(lambda m: m.occlusion_strength, 1.0),
            alpha=arr(lambda m: m.alpha, 1.0),
            transmission=arr(lambda m: m.transmission_factor, 0.0),
            ior=arr(lambda m: m.ior, 1.5),
            unlit=arr(lambda m: m.unlit, False, bool),
            normal_scale=arr(lambda m: m.normal_scale, 1.0),
            exposure=arr(lambda m: m.exposure, 1.0),
            tone_mapped=arr(lambda m: m.tone_mapped, False, bool),
            base_tex=jnp.asarray(np.array([t[0] for t in tex] or [-1], np.int32)),
            normal_tex=jnp.asarray(np.array([t[1] for t in tex] or [-1], np.int32)),
            mr_tex=jnp.asarray(np.array([t[2] for t in tex] or [-1], np.int32)),
            emissive_tex=jnp.asarray(np.array([t[3] for t in tex] or [-1], np.int32)),
            occlusion_tex=jnp.asarray(np.array([t[4] for t in tex] or [-1], np.int32)),
            packed=jnp.zeros((k, 16)),
        )
        packed = np.zeros((k, 16), np.float32)
        packed[:, 0:3] = np.asarray(table.base_color)
        packed[:, 3] = np.asarray(table.alpha)
        packed[:, 4] = np.asarray(table.metallic)
        packed[:, 5] = np.asarray(table.roughness)
        packed[:, 6:9] = np.asarray(table.emissive)
        packed[:, 9] = np.asarray(table.occlusion_strength)
        packed[:, 10] = np.asarray(table.transmission)
        packed[:, 11] = np.asarray(table.ior)
        packed[:, 12] = np.asarray(table.normal_scale)
        packed[:, 13] = np.asarray(table.base_tex)
        packed[:, 14] = np.asarray(table.normal_tex)
        packed[:, 15] = np.asarray(table.mr_tex)
        table = table._replace(packed=jnp.asarray(packed))

        # Host BVH topology over the build-pose geometry (skinned verts at
        # bind pose positions).
        all_pos = [static_pos]
        for blk in self._skinned:
            all_pos.append(np.asarray(blk["positions"]))
        pos0 = np.concatenate(all_pos) if all_pos else np.zeros((1, 3), np.float32)
        t0 = pos0[tri[:, 0]]
        t1 = pos0[tri[:, 1]]
        t2 = pos0[tri[:, 2]]
        tmin = np.minimum(np.minimum(t0, t1), t2)
        tmax = np.maximum(np.maximum(t0, t1), t2)
        # Native binned-SAH build (best traversal quality); the Python
        # Morton/radix build where no C++ compiler is at hand.
        from .bvh_native import NativeBuildError, build_bvh_sah
        try:
            topo = build_bvh_sah(tmin, tmax, leaf_size=B.LEAF_SLOTS)
        except NativeBuildError as e:
            print(f"scene_geometry: native BVH builder unavailable ({e}); "
                  "using Morton build")
            topo = B.build_bvh_morton(tmin, tmax, leaf_size=B.LEAF_SLOTS)

        # Per-triangle translucency (static): material alpha factor < 1, or a
        # bound base texture whose min alpha < 1.
        tex_bank = self._tex_builder.build()
        mat_alpha = np.asarray(table.alpha)
        mat_base_tex = np.asarray(table.base_tex)
        trans_mat = mat_alpha < 0.999
        if np.any(mat_base_tex >= 0):
            amin = np.asarray(tex_bank.data)[..., 3].min(axis=(1, 2))
            has_tex = mat_base_tex >= 0
            trans_mat = trans_mat | (has_tex & (amin[np.maximum(mat_base_tex, 0)] < 0.999))
        tri_translucent = trans_mat[np.maximum(tri_mat, 0)]

        safe_mat = np.maximum(tri_mat, 0)
        unlit_tri = np.asarray(table.unlit)[safe_mat].astype(np.float32)
        tri_shade = np.concatenate([
            uv[tri[:, 0]], uv[tri[:, 1]], uv[tri[:, 2]],
            safe_mat[:, None].astype(np.float32),
            unlit_tri[:, None],
        ], axis=1).astype(np.float32)

        return SceneGeometry(
            static_pos=jnp.asarray(static_pos),
            static_nrm=jnp.asarray(static_nrm),
            static_tan=jnp.asarray(static_tan),
            vert_instance=jnp.asarray(inst),
            uv=jnp.asarray(uv),
            tri=jnp.asarray(tri),
            tri_material=jnp.asarray(tri_mat),
            materials=table,
            textures=tex_bank,
            skinned_blocks=tuple(self._skinned),
            n_static_verts=n_static,
            topo=topo,
            tri_translucent=jnp.asarray(tri_translucent),
            tri_shade=jnp.asarray(tri_shade),
        )


class FrameGeometry(NamedTuple):
    """Per-frame world-space arrays + refit BVH."""

    pos: jnp.ndarray      # (V,3) world
    nrm: jnp.ndarray      # (V,3) world (plain 3x3 transform, like the reference)
    tan: jnp.ndarray      # (V,4) world xyz + sign
    bvh: B.BVHArrays
    # (T,3) unit geometric face normal — one dense (T,) pass per frame so a
    # hit's normal is ONE gather instead of tri indices + 3 vertex gathers
    # + a per-lane cross product.
    tri_nrm: jnp.ndarray


def flatten_frame(geo: SceneGeometry, instance_transforms, palettes) -> FrameGeometry:
    """Produce world-space geometry for one frame (jit-safe).

    Args:
      instance_transforms: (E,4,4) per-instance model matrices.
      palettes: (C,B,4,4) skinning palettes per character slot (pose.model @
        invBind). If a skinned block carries an inv_bind_override, the
        palette for it is recomputed as model @ override — the reference's
        per-mesh invBind substitution (Systems.swift:2507-2527) must be done
        by the caller passing final palettes per character; here palettes are
        used as-is.
    """
    blocks = []
    for blk in geo.skinned_blocks:
        pal = palettes[blk["character"]]
        out = skin_vertices(blk["dense_weights"], pal, blk["positions"],
                            blk["normals"], blk["tangents"])
        blocks.append(out)

    if blocks:
        pos = jnp.concatenate([geo.static_pos] + [b["positions"] for b in blocks])
        nrm = jnp.concatenate([geo.static_nrm] + [b["normals"] for b in blocks])
        tan = jnp.concatenate([geo.static_tan] + [b["tangents"] for b in blocks])
    else:
        pos, nrm, tan = geo.static_pos, geo.static_nrm, geo.static_tan

    m = instance_transforms[geo.vert_instance]         # (V,4,4)
    rot = m[..., :3, :3]
    pos_w = jnp.einsum("vij,vj->vi", rot, pos) + m[..., :3, 3]
    nrm_w = jnp.einsum("vij,vj->vi", rot, nrm)
    tan_w = jnp.concatenate([jnp.einsum("vij,vj->vi", rot, tan[..., :3]),
                             tan[..., 3:]], axis=-1)

    v0 = pos_w[geo.tri[:, 0]]
    v1 = pos_w[geo.tri[:, 1]]
    v2 = pos_w[geo.tri[:, 2]]
    bvh_arrays = B.refit(geo.topo, v0, v1, v2)
    fn = jnp.cross(v1 - v0, v2 - v0)
    fn = fn / jnp.maximum(jnp.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    return FrameGeometry(pos=pos_w, nrm=nrm_w, tan=tan_w, bvh=bvh_arrays,
                         tri_nrm=fn)
