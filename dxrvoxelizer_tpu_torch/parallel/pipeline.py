"""Multi-device frame orchestration: the product surface of ``parallel/``.

Port of ``dxrvoxelizer_tpu/parallel/pipeline.py``.
:class:`ShardedFramePipeline` stands in for
:class:`~dxrvoxelizer_tpu_torch.core.pipeline.FramePipeline` and runs every
frame across the ranks of a device group (parallel/shard.py,
parallel/raystab_shard.py). The reference app has no multi-GPU analog
(SURVEY.md section 2c: single-GPU, single-process); this is the scale-out of
its frame loop (DXRVoxelizer.cpp:258-270).

The shear-warp band render's host statics (view major axis, flip, swap,
intermediate size, light mode) depend on the camera; they are derived from
the frame constants on the host every frame and frames are cached per
statics tuple, so an orbit that has seen each orientation once builds
nothing more.
"""

from __future__ import annotations

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.parallel.mesh import DeviceGroup, make_device_mesh
from dxrvoxelizer_tpu_torch.parallel.shard import (
    frame_statics,
    queue_capacity,
    sharded_frame_fast,
)

FRAME_COUNT = 3  # frames in flight, as core.pipeline (Voxelizer.h:24)


class ShardedFramePipeline:
    """FramePipeline-compatible multi-device frame loop.

    The shear-warp renderer (default) or the gather march
    (``render_impl="gather"``), each with the directional or the point
    light (``cfg.point_light``), with either inside rule: parity (the
    queue voxelize on tile groups, re-binned on the device every frame, so
    deforming meshes work by swapping ``self.mesh``) or ray-stab (the
    strip-sliced query over an accel built once through the accel cache,
    gen-6 below 128^3 and gen-7 from 128^3 on every backend; deforming
    meshes refit it every frame within ``cfg.deform_pad``).

    ``group``: the ranks (default :func:`make_device_mesh`\\ (chips), gloo
    when the mesh lies on the CPU). :meth:`frame` returns this rank's band
    of ``cfg.height // chips`` rows (the whole image on a local group);
    :meth:`gather_image` assembles the whole image on every rank."""

    def __init__(self, cfg, mesh_buffers, chips: int, vox_impl: str = "auto",
                 render_impl: str = "warp", deforming: bool = False,
                 group: DeviceGroup | None = None):
        if cfg.inside_mode not in ("parity", "raystab"):
            raise ValueError(
                "-chips supports the parity and raystab inside modes "
                f"(got {cfg.inside_mode!r})")
        if cfg.inside_mode == "raystab" and deforming and cfg.deform_pad <= 0:
            raise ValueError(
                "-chips deforming raystab needs a positive -deformpad (the "
                "per-frame refit's displacement bound, ops/raystab_refit.py)")
        if render_impl not in ("warp", "fast", "auto", "gather"):
            raise ValueError(
                "-chips supports the warp and gather renderers "
                f"(got {render_impl!r})")
        if cfg.height % chips:
            raise ValueError(
                f"height {cfg.height} not divisible by {chips} chips")
        if group is None:
            group = make_device_mesh(
                chips, cpu=mesh_buffers.device.type == "cpu")
        if group.world != chips:
            raise ValueError(f"{chips} chips, but the group has {group.world} "
                             "ranks")
        self.cfg = cfg
        self.mesh = mesh_buffers
        self.group = group
        self.vox_impl = vox_impl
        self.render_impl = "gather" if render_impl == "gather" else "warp"
        self.deforming = deforming
        self.num_chunks_cap = None
        if cfg.inside_mode == "parity":
            # per-group queue capacity from the rest mesh (the
            # DeformingVoxelizer's headroom rule under deformation)
            self.num_chunks_cap = queue_capacity(
                mesh_buffers.positions_norm, mesh_buffers.tris,
                cfg.grid_size, chips, headroom=1.5 if deforming else 1.1)
        self._frames: dict[tuple, object] = {}  # statics -> frame
        self._clear = np.array(cfg.clear_color, np.float32)
        self._inflight: list[torch.cuda.Event] = []
        self.accel = None
        self.refitter = None
        self._refit_checked = False
        if cfg.inside_mode == "raystab":
            from dxrvoxelizer_tpu_torch.ops import raystab_refit, raystab_tiled

            if deforming:
                # rest-pose padded compact + the per-frame refit (gen-6
                # strips below 128^3, gen-7 tiles from 128^3)
                cls = (raystab_tiled.RaystabTiledRefitter
                       if raystab_tiled.use_tiled_raystab(cfg.grid_size)
                       else raystab_refit.RaystabRefitter)
                m = mesh_buffers
                self.refitter = cls(
                    m.positions_norm, m.tris, m.normals, cfg.grid_size,
                    pad=cfg.deform_pad, use_cache=cfg.accel_cache,
                    # -deform displaces along the vertex normals
                    pad_dirs=(m.normals if cfg.deform_dirs == "normals"
                              else None))
            else:
                # init-built AS through the on-disk accel cache
                # (-noaccelcache builds fresh), on every backend
                from dxrvoxelizer_tpu_torch.core.pipeline import _stab_accel_for

                self.accel = _stab_accel_for(cfg, mesh_buffers)

    def _frame_fn(self, statics: tuple):
        fn = self._frames.get(statics)
        if fn is None:
            cfg = self.cfg
            render_kw = dict(
                render_impl=self.render_impl, n_samples=cfg.num_samples,
                n_light=cfg.num_light_samples, point_light=cfg.point_light)
            st = None if self.render_impl == "gather" else statics
            if self.refitter is not None:
                from dxrvoxelizer_tpu_torch.parallel.raystab_shard import (
                    sharded_frame_raystab_deforming,
                )

                fn = sharded_frame_raystab_deforming(
                    self.group, self.refitter, cfg.grid_size, cfg.width,
                    cfg.height, st, threshold=cfg.inside_threshold,
                    **render_kw)
            elif self.accel is not None:
                from dxrvoxelizer_tpu_torch.parallel.raystab_shard import (
                    sharded_frame_raystab,
                )

                fn = sharded_frame_raystab(
                    self.group, self.accel, self.accel.t_count, cfg.grid_size,
                    cfg.width, cfg.height, st,
                    threshold=cfg.inside_threshold, **render_kw)
            else:
                fn = sharded_frame_fast(
                    self.group, cfg.grid_size, cfg.width, cfg.height,
                    self.mesh.num_triangles,
                    num_chunks_cap=self.num_chunks_cap, statics=st,
                    **render_kw)
            self._frames[statics] = fn
        return fn

    def frame(self, consts) -> torch.Tensor:
        """Voxelize + render one frame (asynchronous on CUDA) -> this rank's
        band of the image."""
        cfg = self.cfg
        if self.render_impl == "gather":
            statics = ("gather",)  # orientation-free: one frame
        else:
            statics = frame_statics(
                consts, cfg.width, cfg.height, m_cap=cfg.intermediate_cap,
                point_light=cfg.point_light, grid_size=cfg.grid_size,
                render_ss=cfg.render_ss)
        fn = self._frame_fn(statics)
        # the deforming ray-stab frame takes NORMALS where the others take
        # tris (the refit regathers the normal rows each frame)
        second = self.mesh.normals if self.refitter is not None else self.mesh.tris
        if self.refitter is not None and not self._refit_checked:
            # the deformation contract on the first refit frame (one host
            # sync); the frames themselves refit with no check
            from dxrvoxelizer_tpu_torch.ops.raystab_refit import (
                check_deform_contract,
            )

            check_deform_contract(self.mesh.positions_norm,
                                  self.refitter._verts_rest, self.refitter.pad,
                                  self.refitter._pad_dirs)
            self._refit_checked = True
        img = fn(self.mesh.positions_norm, second,
                 np.asarray(consts.screen_to_local, np.float32),
                 np.asarray(consts.local_space_eye_pt, np.float32),
                 np.asarray(consts.local_space_light_pt, np.float32),
                 self._clear)
        if img.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            self._inflight.append(done)
            if len(self._inflight) > FRAME_COUNT:
                self._inflight.pop(0).synchronize()  # fence on the oldest
        return img

    def gather_image(self, band: torch.Tensor) -> torch.Tensor:
        """Every rank's band -> the whole image on every rank (one
        all_gather; a local group's frame is already whole)."""
        g = self.group
        if g.local or g.world == 1:
            return band
        return g.all_gather(band)

    def sync(self) -> None:
        for done in self._inflight:
            done.synchronize()
        self._inflight.clear()
