"""Explicit pass functions + frame pipeline.

Port of ``dxrvoxelizer_tpu/core/pipeline.py``: the parity frame for static
meshes at every grid size and deforming meshes (``-deform``), and the
reference's ray-stab inside rule (``-inside raystab``) and the parity grid's
normal channel (``-normals``), static or deforming, routed as the JAX
package routes them: on a GPU through the gen-6 accel at n < 128 and the
gen-7 accel above (refitted every frame when deforming, built through the
on-disk accel cache otherwise); on the CPU, at every n, through the gen-1
accel (``-inside raystab``; rebuilt when the mesh changes) and the
Moller-Trumbore oracle under rule "hit" (``-normals``). ``render`` takes
every renderer of the JAX package (shear-warp, the default; the gather
march; the shader-exact oracle), mip levels (``-showmip``) and the point
light (``-pointlight``).
The reference's per-frame loop (Content/Voxelizer.cpp:108-113) is
``Render = voxelize() ; renderRayCast()`` against triple-buffered grids
(FrameCount = 3, Voxelizer.h:24). Here the two passes are torch functions on
device tensors; CUDA launches are asynchronous, and the ring of frames in
flight holds one CUDA event per frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.models.mesh import MeshBuffers
from dxrvoxelizer_tpu_torch.models.scene import FrameConstants
from dxrvoxelizer_tpu_torch.ops import (
    binning,
    grid_cuda,
    raystab_fast,
    raystab_refit,
    raystab_tiled,
    voxelize_queue,
    voxelize_ref,
)
from dxrvoxelizer_tpu_torch.ops.packing import (
    pack_bits_z,
    quantize_r10g10b10a2,
    unpack_bits_z,
)
from dxrvoxelizer_tpu_torch.ops.mips import mip_level
from dxrvoxelizer_tpu_torch.ops.raymarch_fast import (
    precompute_light_volume,
    raymarch_fast,
)
from dxrvoxelizer_tpu_torch.ops.raymarch_ref import raymarch_ref
from dxrvoxelizer_tpu_torch.ops.raymarch_warp import (
    light_sweep_host,
    light_sweep_point_host,
    light_sweep_ref_host,
    raymarch_shearwarp,
)
from dxrvoxelizer_tpu_torch.ops.voxelize_cuda import (
    TILE,
    voxelize_parity_bruteforce,
)
from dxrvoxelizer_tpu_torch.utils import accel_cache
from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig

FRAME_COUNT = 3  # frames in flight (reference: Voxelizer.h:24)
# ray-stab impl names that run the direction-space accel, as in the JAX
# package (the parity kernels' names select it too)
RAYSTAB_ACCEL_IMPLS = ("auto", "fast", "queue", "pallas")


@dataclass
class VoxelGrid:
    """One voxelization result: packed occupancy bits [N,N,N//32] int32 and,
    in ray-stab mode or with ``-normals``, the [N,N,N,4] float32 normal +
    alpha grid (the reference's R10G10B10A2 texture analog). ``dens``
    (internal): the rgba's alpha as a contiguous [N,N,N] tensor, where the
    kernel that wrote the rgba (X.6, ops/grid_cuda.py) wrote it too."""

    words: torch.Tensor
    rgba: torch.Tensor | None = None
    dens: torch.Tensor | None = field(default=None, repr=False)

    @property
    def n(self) -> int:
        return int(self.words.shape[0])

    def occupancy(self) -> torch.Tensor:
        return unpack_bits_z(self.words, self.n)

    def density(self, use_kernel: bool = True) -> torch.Tensor:
        """The alpha channel as float (the raymarcher's input): X.6's
        density where it wrote one, ``rgba[..., 3]`` otherwise; without
        rgba the words unpacked (X.7 on a CUDA tensor).
        ``use_kernel=False`` recomputes it by the plain versions."""
        if self.rgba is not None:
            if use_kernel and self.dens is not None:
                return self.dens
            return self.rgba[..., 3]
        return grid_cuda.unpack_density(self.words, self.n,
                                        use_kernel=use_kernel)


def _kernel_ok(n: int, device: torch.device) -> bool:
    """The CUDA kernels take every multiple-of-32 grid on a GPU (the JAX
    package's ``_pallas_ok``: false on the CPU, which takes the oracle)."""
    return n % TILE == 0 and device.type == "cuda"


def _auto_impl(n: int, device: torch.device) -> str:
    """What ``impl="auto"`` runs: the work-queue kernel at n >= 128 and the
    binned kernel below on a GPU, the counting oracle elsewhere."""
    if not _kernel_ok(n, device):
        return "xla"
    return "queue" if n >= 128 else "pallas"


def voxelize(
    mesh: MeshBuffers,
    n: int,
    mode: str = "parity",
    impl: str = "auto",
    quantize: bool = True,
    accel: (raystab_fast.RaystabAccel | raystab_fast.RaystabAccel2
            | raystab_tiled.RaystabAccel7 | None) = None,
    with_normals: bool = False,
) -> VoxelGrid:
    """Solid-voxelize a mesh -> :class:`VoxelGrid` on the mesh's device.

    ``mode``: "parity" or "raystab" (the reference's radial back-face rule,
    DXRVoxelizer.hlsl:132-140). Parity ``impl``: "auto" picks, on a GPU, the
    work-queue kernel at n >= 128 and the binned kernel below (the JAX
    package's routing; both give the same words), and the counting oracle on
    the CPU; "queue" and "pallas" force the work-queue and binned paths (the
    kernels' plain versions on the CPU); "pallas_bruteforce" runs the binned
    kernel with every triangle in every tile (no binning); "xla" is always
    the oracle. Ray-stab ``impl``: "auto" (or "fast", "queue", "pallas", as
    in the JAX package) runs a direction-space accel: ``accel`` if
    given (a gen-1 :class:`~raystab_fast.RaystabAccel`, queried with the
    mesh's buffers, a gen-6 ``RaystabAccel2`` or a gen-7 ``RaystabAccel7``),
    else one built for this call as the JAX package routes it (gen-1 on the
    CPU at every n; on a GPU gen-6 at n < 128 and gen-7 above), each through
    its kernel on a GPU and the kernel's
    plain version on the CPU; "xla" the Moller-Trumbore oracle, gen-1's
    ground truth; "xla-radial" the radial oracle, gen-6's. ``quantize``
    rounds rgba through R10G10B10A2. ``with_normals`` adds the parity grid's
    normal channel.
    """
    if mode == "raystab":
        if impl in RAYSTAB_ACCEL_IMPLS:
            stab_grid = _stab_grid(accel)
            if stab_grid is not None:  # gen-6/7: untiled, rounded, packed by X.6
                rgba, words, dens = stab_grid(accel, quantize=quantize)
                return VoxelGrid(words=words, rgba=rgba, dens=dens)
            if accel is None:  # stateless: build the accel for this call
                occ, rgba = raystab_fast.voxelize_raystab_fast(
                    mesh.positions_norm, mesh.normals, mesh.tris, n=n)
            else:
                occ, rgba = raystab_fast.raystab_query(
                    mesh.positions_norm, mesh.normals, mesh.tris, accel)
        elif impl == "xla":
            occ, rgba = voxelize_ref.voxelize_raystab_ref(
                mesh.positions_norm, mesh.normals, mesh.tris, n=n)
        elif impl == "xla-radial":
            occ, rgba = voxelize_ref.voxelize_raystab_radial_ref(
                mesh.positions_norm, mesh.normals, mesh.tris, n=n)
        else:
            raise ValueError(f"unknown raystab impl {impl!r}")
        if quantize:
            rgba = quantize_r10g10b10a2(rgba)
        return VoxelGrid(words=pack_bits_z(occ), rgba=rgba)
    if mode != "parity":
        raise ValueError(f"unknown inside mode {mode!r}")
    if impl == "auto":
        impl = _auto_impl(n, mesh.device)
    if impl == "queue":
        words = voxelize_queue.voxelize_parity_queue(
            mesh.positions_norm, mesh.tris, n
        )
    elif impl == "pallas":
        words = binning.voxelize_parity_binned(mesh.positions_norm, mesh.tris, n)
    elif impl == "pallas_bruteforce":
        words = voxelize_parity_bruteforce(mesh.positions_norm, mesh.tris, n)
    elif impl == "xla":
        words = pack_bits_z(
            voxelize_ref.voxelize_parity_ref(mesh.positions_norm, mesh.tris, n=n)
        )
    else:
        raise ValueError(f"unknown impl {impl!r}")
    if not with_normals:
        return VoxelGrid(words=words)
    rgba, dens = _parity_rgba(mesh, words, n, accel=accel, quantize=quantize)
    return VoxelGrid(words=words, rgba=rgba, dens=dens)


def _stab_grid(accel):
    """The grid function of a gen-6 or gen-7 accel (query, then X.6), None
    for another accel."""
    if isinstance(accel, raystab_tiled.RaystabAccel7):
        return raystab_tiled.raystab_grid7
    if isinstance(accel, raystab_fast.RaystabAccel2):
        return raystab_fast.raystab_grid2
    return None


def _parity_rgba(mesh: MeshBuffers, words: torch.Tensor, n: int, accel=None,
                 quantize: bool = True):
    """Normal channel for a parity grid -> (rgba, its alpha as a contiguous
    density or None): the reference's grid always stores
    float4(Normal, 1.0) (DXRVoxelizer.hlsl:83-84). The normal is the
    first-hit normal under rule "hit" (no back-face test), gated by the
    parity occupancy bit (X.6's words-gated form on a GPU): on a GPU the
    radial one from the gen-6 or gen-7 query (``accel``, or one built here
    as ``use_tiled_raystab`` routes), on the CPU the Moller-Trumbore
    oracle's, as the JAX package does (``accel`` is then unused)."""
    if mesh.device.type == "cuda":
        if accel is None:
            build = (raystab_tiled.build_raystab_accel7
                     if raystab_tiled.use_tiled_raystab(n)
                     else raystab_fast.build_raystab_accel2)
            accel = build(mesh.positions_norm, mesh.tris, mesh.normals, n=n)
        rgba, _, dens = _stab_grid(accel)(accel, rule="hit", quantize=quantize,
                                          gate=words)
        return rgba, dens
    _, rgba_hit = voxelize_ref.voxelize_raystab_ref(
        mesh.positions_norm, mesh.normals, mesh.tris, n=n, rule="hit")
    rgba, _, dens = grid_cuda.untile(rgba_hit.reshape(-1, 4), n, gate=words,
                                     quantize=quantize)
    return rgba, dens


def _stab_accel_for(cfg: VoxelizerConfig, mesh: MeshBuffers):
    """A GPU's static ray-stab accel for (cfg, mesh): gen-7 or gen-6 by
    ``use_tiled_raystab``, through the on-disk accel cache when
    ``cfg.accel_cache`` (``-noaccelcache`` turns it off)."""
    n = cfg.grid_size
    tiled = raystab_tiled.use_tiled_raystab(n)
    if cfg.accel_cache:
        build = (accel_cache.cached_build_raystab_accel7 if tiled
                 else accel_cache.cached_build_raystab_accel2)
    else:
        build = (raystab_tiled.build_raystab_accel7 if tiled
                 else raystab_fast.build_raystab_accel2)
    return build(mesh.positions_norm, mesh.tris, mesh.normals, n=n)


def render(
    grid: VoxelGrid,
    consts: FrameConstants,
    cfg: VoxelizerConfig,
    impl: str = "warp",
    light_volume: torch.Tensor | None = None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Ray-march a grid -> [H,W,3] float32 image on the grid's device.

    ``impl``: "warp" (shear-warp, the production path; "fast" is its alias,
    as in the JAX package), "gather" (the per-pixel march over a light
    volume, ops/raymarch_fast.py) or "ref" (the shader-exact sequential
    oracle, ops/raymarch_ref.py). ``cfg.show_mip`` renders from that mip
    level of the grid (SharedConst.h:5); ``cfg.use_mutex`` selects the
    float-grid sampling (no 2-bit alpha quantization of the mips,
    PSRayCast.hlsl:42-46); ``cfg.point_light`` the _POINT_LIGHT_ branch.
    ``light_volume`` [N,N,N]: a light field to march with ("warp",
    "gather") instead of the one computed here. ``use_kernels=False`` runs
    the plain versions of the kernels (the on-card reference).
    """
    density = grid.density(use_kernel=use_kernels)
    if cfg.show_mip > 0:
        density = mip_level(density, cfg.show_mip,
                            quantize_alpha=not cfg.use_mutex)
    clear = np.array(cfg.clear_color, np.float32)
    light = consts.local_space_light_pt
    if impl == "ref":
        return raymarch_ref(
            density, consts.screen_to_local, consts.local_space_eye_pt, light,
            clear, cfg.width, cfg.height, n_samples=cfg.num_samples,
            n_light=cfg.num_light_samples, point_light=cfg.point_light,
        )
    if light_volume is not None and (
            tuple(light_volume.shape) != tuple(density.shape)):
        raise ValueError(f"light_volume: expected {tuple(density.shape)}, "
                         f"got {tuple(light_volume.shape)}")
    if impl == "gather":
        if light_volume is None:
            light_volume = precompute_light_volume(
                density, light, n_light=cfg.num_light_samples,
                point_light=cfg.point_light, use_kernel=use_kernels,
            )
        return raymarch_fast(
            density, light_volume, consts.screen_to_local,
            consts.local_space_eye_pt, clear, cfg.width, cfg.height,
            n_samples=cfg.num_samples, use_kernel=use_kernels,
        )
    if impl not in ("warp", "fast"):
        raise ValueError(f"unknown renderer impl {impl!r}")
    if light_volume is None:
        if cfg.point_light:
            sweep = light_sweep_point_host
        elif cfg.render_ss > 1:
            # -hq: reference-step light field; -fast: per-slab recurrence
            sweep = light_sweep_ref_host
        else:
            sweep = light_sweep_host
        light_volume = sweep(density, light, density.shape[0],
                             use_kernel=use_kernels)
    return raymarch_shearwarp(
        density, light_volume, consts.screen_to_local,
        consts.local_space_eye_pt, clear, cfg.width, cfg.height,
        m_cap=cfg.intermediate_cap, ss=cfg.render_ss, use_kernels=use_kernels,
    )


class FramePipeline:
    """Explicit per-frame orchestration with FRAME_COUNT frames in flight.

    The reference throttles the CPU to <= 3 recorded frames via a fence ring
    (DXRVoxelizer.cpp:496-529). Here each CUDA frame records an event, and
    the host waits on the oldest event before a fourth frame is queued.
    """

    def __init__(self, cfg: VoxelizerConfig, mesh: MeshBuffers,
                 vox_impl: str = "auto", render_impl: str = "warp",
                 deforming: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.vox_impl = vox_impl
        self.render_impl = render_impl
        self.deforming = deforming
        self._inflight: list[torch.cuda.Event] = []
        self._deformer = None  # lazy DeformingVoxelizer (fixed topology)
        self._static_vox = None  # build-once voxelizer (static mesh)
        self._static_vox_mesh = None
        self._stab_accel = None  # build-once ray-stab accel (static mesh)
        self._stab_mesh = None
        self._rest_mesh = mesh  # the refit pad is anchored to this pose
        self._refitter = None  # lazy ray-stab refitter (deforming, GPU)
        self._refit_checked = False  # first refit frame's contract check

    def _raystab_accel(self):
        """The frame's direction-space accel, as the JAX package picks it.

        Deforming on a GPU with ``cfg.deform_pad > 0``: a refit every frame
        (ops/raystab_refit.py, gen-7 or gen-6 by ``use_tiled_raystab``), its
        padded compact built once from the rest pose (through the accel
        cache when ``cfg.accel_cache``), along the rest normals when
        ``cfg.deform_dirs == "normals"`` (the app's wobble); the first refit
        frame checks the deformation contract (one host sync). Otherwise a
        build once per mesh object, rebuilt when ``self.mesh`` is replaced
        (the reference's build-AS-once, Voxelizer.cpp:264-326): gen-1 on the
        CPU, and on a GPU gen-7 or gen-6, through the accel cache when
        ``cfg.accel_cache``."""
        cfg, m = self.cfg, self.mesh
        if self.deforming and m.device.type == "cuda" and cfg.deform_pad > 0.0:
            if self._refitter is None:
                rest = self._rest_mesh
                cls = (raystab_tiled.RaystabTiledRefitter
                       if raystab_tiled.use_tiled_raystab(cfg.grid_size)
                       else raystab_refit.RaystabRefitter)
                self._refitter = cls(
                    rest.positions_norm, rest.tris, rest.normals, cfg.grid_size,
                    pad=cfg.deform_pad, use_cache=cfg.accel_cache,
                    pad_dirs=(rest.normals if cfg.deform_dirs == "normals"
                              else None))
            check = not self._refit_checked
            self._refit_checked = True
            return self._refitter.refit(m.positions_norm, m.normals, check=check)
        if self._stab_accel is None or self._stab_mesh is not m:
            if m.device.type == "cuda":
                self._stab_accel = _stab_accel_for(cfg, m)
            else:
                self._stab_accel = raystab_fast.build_raystab_accel(
                    m.positions_norm, m.tris, n=cfg.grid_size)
            self._stab_mesh = m
        return self._stab_accel

    def frame(self, consts: FrameConstants) -> torch.Tensor:
        """Voxelize + render one frame (asynchronous on CUDA) -> image."""
        n = self.cfg.grid_size
        device = self.mesh.device
        raystab = self.cfg.inside_mode == "raystab"
        want_normals = not raystab and self.cfg.parity_normals
        quantize = not self.cfg.use_mutex
        accel = None
        # the CPU's -normals takes the Moller-Trumbore oracle, no accel
        if ((raystab and self.vox_impl in RAYSTAB_ACCEL_IMPLS)
                or (want_normals and device.type == "cuda")):
            accel = self._raystab_accel()
        if (not raystab and not want_normals and self.deforming
                and self.vox_impl in ("auto", "queue") and _kernel_ok(n, device)):
            # fixed-topology deforming path: device-only queue rebuild, no
            # host sync per frame (ops/voxelize_queue.py)
            if self._deformer is None:
                self._deformer = voxelize_queue.DeformingVoxelizer(
                    self.mesh.positions_norm, self.mesh.tris, n
                )
            grid = VoxelGrid(words=self._deformer(self.mesh.positions_norm))
        elif (not raystab and not self.deforming
              and self.vox_impl in ("auto", "queue", "pallas")
              and _kernel_ok(n, device)):
            # STATIC parity path: bin once, per frame only launch the
            # kernel — the reference's build-AS-once (Voxelizer.cpp:264-326)
            # + per-frame DispatchRays-only (:351-369) split. Rebuilds only
            # when the mesh object is swapped.
            if self._static_vox is None or self._static_vox_mesh is not self.mesh:
                impl = (_auto_impl(n, device) if self.vox_impl == "auto"
                        else self.vox_impl)
                cls = (voxelize_queue.StaticVoxelizer if impl == "queue"
                       else binning.StaticBinnedVoxelizer)
                self._static_vox = cls(self.mesh.positions_norm,
                                       self.mesh.tris, n)
                self._static_vox_mesh = self.mesh
            words = self._static_vox()
            rgba = dens = None
            if want_normals:
                rgba, dens = _parity_rgba(self.mesh, words, n, accel=accel,
                                          quantize=quantize)
            grid = VoxelGrid(words=words, rgba=rgba, dens=dens)
        else:
            grid = voxelize(self.mesh, n, mode=self.cfg.inside_mode,
                            impl=self.vox_impl, quantize=quantize, accel=accel,
                            with_normals=want_normals)
        img = render(grid, consts, self.cfg, impl=self.render_impl)
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            self._inflight.append(done)
            if len(self._inflight) > FRAME_COUNT:
                self._inflight.pop(0).synchronize()  # fence on the oldest
        return img

    def sync(self) -> None:
        for done in self._inflight:
            done.synchronize()
        self._inflight.clear()
