"""Entry points: one frame step, and a multi-device dry run.

Port of the repository's ``__graft_entry__.py`` (``entry`` and
``dryrun_multichip``) for the CUDA build.

- :func:`entry` returns one forward frame step (oracle voxelize + gather
  render of a tetrahedron at 32^3, 64x64) and example arguments for it, on
  the card unless the caller asks for the CPU.
- :func:`dryrun_multichip` runs every multi-device frame kind once on a gloo
  group of N CPU ranks (spawned processes): the reference frame, the
  production queue frame, gen-6 and gen-7 ray-stab, both deforming
  refitters, and the ``-hq`` frame, each checked for shape and finite
  values, rank 0's whole image included.
- :func:`sharded_orbit` runs ``ShardedFramePipeline`` over a few orbit
  frames of a mesh on N spawned ranks and saves rank 0's whole last image;
  :func:`orbit_image` is that orbit on a given group (a local one for the
  in-process result it is checked against).
"""

from __future__ import annotations

import numpy as np
import torch


def _tet():
    v = np.array(
        [
            (0.61, 0.53, 0.47),
            (-0.67, 0.41, -0.29),
            (0.13, -0.59, -0.63),
            (-0.11, -0.37, 0.71),
        ],
        dtype=np.float32,
    ) * np.float32(0.8)
    t = np.array([(0, 1, 2), (0, 3, 1), (0, 2, 3), (1, 3, 2)], dtype=np.int32)
    return v, t


def _frame_inputs(w: int, h: int):
    from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
    from dxrvoxelizer_tpu_torch.utils import dxmath as dxm

    cam = OrbitCamera(w, h)
    bound = np.array([0.0, 4.0, 0.0, 2.0], dtype=np.float32)
    world = dxm.world_matrix(bound, np.array([0, 0, 0, 1], dtype=np.float32))
    world_inv = dxm.inverse(world)
    s2l = dxm.screen_to_local(world, cam.view_proj, w, h)
    eye = dxm.transform_coord(cam.eye, world_inv)
    light = dxm.transform_coord(np.array([-10.0, 45.0, -75.0], np.float32),
                                world_inv)
    clear = np.array([0.0, 0.2, 0.4], dtype=np.float32)
    return s2l, eye, light, clear


def entry(device: torch.device | str | None = None):
    """(fn, example_args): one forward frame step (voxelize + render) on
    ``device`` (default the card; raises without one)."""
    from dxrvoxelizer_tpu_torch.ops.raymarch_fast import (
        precompute_light_volume,
        raymarch_fast,
    )
    from dxrvoxelizer_tpu_torch.ops.voxelize_ref import voxelize_parity_ref
    from dxrvoxelizer_tpu_torch.utils.device import select_device

    device = select_device() if device is None else torch.device(device)
    n, w, h = 32, 64, 64

    def frame(verts_norm, tris, s2l, eye, light, clear):
        density = voxelize_parity_ref(verts_norm, tris, n=n).to(torch.float32)
        lv = precompute_light_volume(density, light, n_light=8)
        return raymarch_fast(density, lv, s2l, eye, clear, w, h, n_samples=32)

    v, t = _tet()
    args = (torch.from_numpy(v).to(device),
            torch.from_numpy(t.astype(np.int64)).to(device),
            *_frame_inputs(w, h))
    return frame, args


def _dryrun_rank(n_devices: int) -> None:
    """One rank of :func:`dryrun_multichip` (the group is initialised)."""
    from dxrvoxelizer_tpu_torch.models.scene import FrameConstants
    from dxrvoxelizer_tpu_torch.ops.raystab_fast import build_raystab_accel2
    from dxrvoxelizer_tpu_torch.ops.raystab_refit import RaystabRefitter
    from dxrvoxelizer_tpu_torch.ops.raystab_tiled import (
        RaystabTiledRefitter,
        build_raystab_accel7,
    )
    from dxrvoxelizer_tpu_torch.parallel import (
        make_device_mesh,
        sharded_frame,
        sharded_frame_fast,
    )
    from dxrvoxelizer_tpu_torch.parallel.raystab_shard import (
        sharded_frame_raystab,
        sharded_frame_raystab_deforming,
    )
    from dxrvoxelizer_tpu_torch.parallel.shard import frame_statics

    group = make_device_mesh(n_devices, cpu=True)
    n, w = 32, 64
    h = 8 * n_devices  # rows divisible by the ranks
    v_h, t_h = _tet()
    s2l, eye, light, clear = _frame_inputs(w, h)
    verts = torch.from_numpy(v_h)
    tris = torch.from_numpy(t_h.astype(np.int64))
    consts = FrameConstants(local_space_light_pt=light, local_space_eye_pt=eye,
                            screen_to_local=s2l)
    # area-weighted vertex normals (every tet vertex is on 3 faces)
    e1 = v_h[t_h[:, 1]] - v_h[t_h[:, 0]]
    e2 = v_h[t_h[:, 2]] - v_h[t_h[:, 0]]
    vn = np.zeros_like(v_h)
    np.add.at(vn, t_h.reshape(-1), np.repeat(np.cross(e1, e2), 3, axis=0))
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-20)
    normals = torch.from_numpy(vn.astype(np.float32))
    statics = frame_statics(consts, w, h)

    frames = {
        "ref+gather": (sharded_frame(group, n, w, h, n_samples=16, n_light=4),
                       tris),
        "fast": (sharded_frame_fast(group, n, w, h, int(t_h.shape[0]), consts,
                                    num_chunks_cap=128), tris),
    }
    for name, build in (("raystab gen-6", build_raystab_accel2),
                        ("raystab gen-7", build_raystab_accel7)):
        accel = build(verts, tris, normals, n=16)
        frames[name] = (sharded_frame_raystab(group, accel, int(t_h.shape[0]),
                                              16, w, h, statics), tris)
    for name, cls in (("deforming gen-6", RaystabRefitter),
                      ("deforming gen-7", RaystabTiledRefitter)):
        rf = cls(verts, tris, normals, n=16, pad=0.02, use_cache=False,
                 pad_dirs=normals)
        frames[name] = (sharded_frame_raystab_deforming(group, rf, 16, w, h,
                                                        statics), normals)
    statics_hq = frame_statics(consts, w, h, grid_size=n, render_ss=2)
    frames["-hq"] = (sharded_frame_fast(group, n, w, h, int(t_h.shape[0]),
                                        num_chunks_cap=128, statics=statics_hq),
                     tris)
    verts_d = verts + np.float32(0.005) * normals
    for name, (frame, second) in frames.items():
        v_in = verts_d if name.startswith("deforming") else verts
        band = frame(v_in, second, s2l, eye, light, clear)
        if tuple(band.shape) != (h // n_devices, w, 3):
            raise RuntimeError(f"{name}: band {tuple(band.shape)}")
        img = group.all_gather(band)
        if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"{name}: image {tuple(img.shape)} not finite")
    if group.rank == 0:
        print(f"dryrun_multichip({n_devices}): OK, image ({h}, {w}, 3), "
              f"{len(frames)} frame kinds on {group.world} gloo ranks")


def dryrun_multichip(n_devices: int) -> None:
    """Run one step of every multi-device frame kind on ``n_devices`` gloo
    ranks on the CPU (spawned processes); raises if a rank fails."""
    from dxrvoxelizer_tpu_torch.parallel.mesh import spawn_ranks

    spawn_ranks(_dryrun_rank, n_devices, args=(n_devices,), cpu=True)


def orbit_image(mesh_path: str, cfg_kwargs: dict, chips: int, frames: int,
                group=None, deforming: bool = False,
                render_impl: str = "warp") -> torch.Tensor:
    """``frames`` frames of the app's orbit (12 degrees of yaw a frame) of
    the OBJ at ``mesh_path`` through ``ShardedFramePipeline`` on ``group``
    (default: the process group's ranks) -> the whole last image (every
    rank's band gathered). ``cfg_kwargs``: ``VoxelizerConfig`` fields (the
    CPU is taken when ``backend="cpu"``)."""
    from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
    from dxrvoxelizer_tpu_torch.models.scene import Scene
    from dxrvoxelizer_tpu_torch.parallel import ShardedFramePipeline
    from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
    from dxrvoxelizer_tpu_torch.utils.device import select_device
    from dxrvoxelizer_tpu_torch.utils.objloader import load_obj

    cfg = VoxelizerConfig(**cfg_kwargs)
    device = (group.device if group is not None
              else select_device("cpu" if cfg.backend == "cpu" else "default"))
    scene = Scene(load_obj(mesh_path), device)
    pipe = ShardedFramePipeline(cfg, scene.buffers, chips, deforming=deforming,
                                render_impl=render_impl, group=group)
    cam = OrbitCamera(cfg.width, cfg.height)
    img = None
    for frame in range(frames):
        if frame:
            cam.orbit(12.0, 0.0)
        img = pipe.frame(scene.update_frame(cam.eye, cam.view_proj, cfg.width,
                                            cfg.height))
    pipe.sync()
    return pipe.gather_image(img)


def _orbit_rank(mesh_path: str, cfg_kwargs: dict, chips: int, frames: int,
                out: str, render_impl: str) -> None:
    import torch.distributed as dist

    img = orbit_image(mesh_path, cfg_kwargs, chips, frames,
                      render_impl=render_impl)
    if dist.get_rank() == 0:
        np.save(out, img.cpu().numpy())


def sharded_orbit(mesh_path: str, cfg_kwargs: dict, chips: int, frames: int,
                  out: str, render_impl: str = "warp") -> None:
    """:func:`orbit_image` on ``chips`` spawned ranks (gloo on the CPU when
    ``cfg_kwargs["backend"] == "cpu"``, else NCCL, one card a rank); rank 0
    saves the whole last image to ``out`` (``.npy``)."""
    from dxrvoxelizer_tpu_torch.parallel.mesh import spawn_ranks

    spawn_ranks(_orbit_rank, chips,
                args=(mesh_path, cfg_kwargs, chips, frames, out, render_impl),
                cpu=cfg_kwargs.get("backend") == "cpu")
