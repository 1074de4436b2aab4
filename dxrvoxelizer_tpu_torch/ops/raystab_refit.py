"""Per-frame ray-stab accel refit for deforming meshes: the DXR
acceleration-structure update analog.

Port of ``dxrvoxelizer_tpu/ops/raystab_refit.py`` (gen-6) and of the
contract check of ``dxrvoxelizer_tpu/ops/raystab_tiled.py`` (gen-7's
refitter is ``raystab_tiled.RaystabTiledRefitter``). The reference builds
its BLAS/TLAS once for static geometry (Voxelizer.cpp:264-326). A refitter
splits an accel into

- what the geometry's shape decides (strips of rays, each strip's run of
  candidate rows, chunk bounds), built once from the rest pose with a
  deformation ``pad`` (``raystab_fast._cone_keys_np``), conservative for
  every frame within it; and
- the candidate rows themselves, ``fused[ids]`` with ``fused`` the
  per-triangle coefficient + normal matrix of the frame's geometry. They
  are never gathered: a refitted stream holds ``fused`` and the rest
  build's int32 ids (``StripTables.row_ids``), and the fold kernel reads
  each candidate's row through its id. A refit computes ``fused`` alone
  (no gather, no host sync): one launch of X.9 (``csrc/refit_rows.cu``,
  ``raystab_fast.fused_coef_matrix``) on the card, a fresh matrix every
  frame (a frame still queued reads its own).

A refitted accel equals a fresh build of the deformed mesh in every row it
stands for; its candidate sets are a superset, which the exact intersection
test rejects, so its queries equal the radial oracle on the deformed mesh.
The TPU's separate coefficient-only refit (normal tables reused) is not
carried over: a row holds both.
"""

from __future__ import annotations

import dataclasses

import torch

from dxrvoxelizer_tpu_torch.ops.raystab_fast import (
    assemble_raystab_accel2,
    build_raystab_compact2,
    fused_coef_matrix,
)


class RaystabRefitter:
    """Gen-6 refitter: build once from the rest mesh, refit per frame.

    ``pad``: per-vertex displacement bound (normalized space) every frame's
    vertices keep from the rest vertices; with ``pad_dirs`` [V,3] the
    deformation must be directional, v' = v + s * pad_dirs[v] with
    |s| <= pad (the app's ``-deform`` wobble moves along the normals), which
    pads by capsules instead of balls. ``refit(..., check=True)`` verifies
    the contract with one host sync. ``use_cache`` builds the compact
    through the on-disk accel cache (utils/accel_cache.py)."""

    def __init__(self, verts_rest, tris, normals_rest, n: int = 64,
                 pad: float = 0.035, gs: tuple | None = None,
                 use_cache: bool = False, cache_dir: str | None = None,
                 pad_dirs=None):
        if not pad > 0.0:
            raise ValueError("a zero-pad refitter cannot absorb deformation")
        self.n = int(n)
        self.pad = float(pad)
        self.tris = tris
        # the rows' triangles as int32, made once: X.9 reads half the index
        # bytes every frame (the rows are the same for either width)
        self._tris32 = (tris.to(torch.int32) if tris.dtype == torch.int64
                        else tris)
        self._verts_rest = verts_rest
        self._normals_rest = normals_rest
        self._pad_dirs = (None if pad_dirs is None
                          else torch.as_tensor(pad_dirs, dtype=torch.float32,
                                               device=verts_rest.device))
        compact = self._compact(verts_rest, tris, gs, use_cache, cache_dir)
        self.rest_accel = self._assemble(compact, verts_rest, tris,
                                         normals_rest, by_id=True)
        self.stats = self.rest_accel.stats
        # each stream's int32 row ids into the fused matrix [T+1, 24], held
        # to its range once here: the kernel reads through them unchecked
        self._ids = {f: getattr(self.rest_accel, f).row_ids
                     for f in ("main", "ov")
                     if getattr(self.rest_accel, f, None) is not None}
        rows = int(tris.shape[0]) + 1
        for f, ids in self._ids.items():
            if ids.numel() and not 0 <= int(ids.min()) <= int(ids.max()) < rows:
                raise ValueError(f"{f} stream: row ids outside [0, {rows})")

    def _compact(self, verts_rest, tris, gs, use_cache, cache_dir):
        if use_cache:
            from dxrvoxelizer_tpu_torch.utils.accel_cache import cached_compact2

            return cached_compact2(verts_rest, tris, self.n, gs, pad=self.pad,
                                   cache_dir=cache_dir, pad_dirs=self._pad_dirs)
        return build_raystab_compact2(verts_rest, tris, self.n, gs, pad=self.pad,
                                      pad_dirs=self._pad_dirs)

    _assemble = staticmethod(assemble_raystab_accel2)

    def refit(self, verts_norm, normals=None, check: bool = False):
        """Deformed vertices (and normals; None: the rest normals) -> a
        query-ready accel, asynchronously. ``check=True`` host-syncs to
        verify the deformation contract (:func:`check_deform_contract`)."""
        if check:
            check_deform_contract(verts_norm, self._verts_rest, self.pad,
                                  self._pad_dirs)
        fused = fused_coef_matrix(
            verts_norm, self._tris32,
            self._normals_rest if normals is None else normals)
        streams = {f: dataclasses.replace(getattr(self.rest_accel, f), rows=fused)
                   for f in self._ids}
        return dataclasses.replace(self.rest_accel, **streams)


def check_deform_contract(verts_norm, verts_rest, pad: float, pad_dirs) -> None:
    """Host-sync check of the refit's deformation contract; raises
    RuntimeError (the JAX package's messages) when the displacement exceeds
    ``pad``, or, with ``pad_dirs``, leaves the directions' axes or takes a
    parameter |s| above ``pad``."""
    d = verts_norm - verts_rest
    if d.numel() == 0:
        return
    if pad_dirs is None:
        disp = float(torch.linalg.norm(d, dim=-1).max())
        if disp > pad:
            raise RuntimeError(
                f"deformation {disp:.4f} exceeds the refit pad "
                f"{pad:.4f}; rebuild the refitter with more"
            )
        return
    dd = (pad_dirs * pad_dirs).sum(-1)
    s = (d * pad_dirs).sum(-1) / torch.clamp(dd, min=1e-30)
    resid = float(torch.linalg.norm(d - s[:, None] * pad_dirs, dim=-1).max())
    if resid > 1e-5:
        raise RuntimeError(
            f"off-axis deformation {resid:.2e} violates the directional "
            "refit contract (pad_dirs); rebuild with pad_dirs=None for "
            "an isotropic bound"
        )
    # the capsule tables bound the parameter |s|, not the displacement: with
    # directions that are not unit vectors |disp| <= pad can mean |s| > pad
    smax = float(s.abs().max())
    if smax > pad:
        raise RuntimeError(
            f"deformation parameter |s|={smax:.4f} exceeds the refit "
            f"pad {pad:.4f}; rebuild the refitter with more"
        )
