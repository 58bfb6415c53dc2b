"""Entry points of the port (the counterparts of `__graft_entry__.py`).

entry()             -> (fn, example_args): one differentiable surfel render
                       (the all-pairs renderer `render_xla`, SH 0) plus the
                       mapping loss on a populated map; the caller may
                       differentiate `fn` or wrap it as it likes.
dryrun_multichip(n) -> the product pipeline (`EGGFusion.reconstruct`) over a
                       mesh of n devices: every frame's window optimization
                       runs the window-batched, keyframe-sharded step
                       (`parallel.mesh.run_multichip_dryrun`).

Both run on CUDA unless `device` says otherwise (`device="cpu"` for the
tests).

    python -c "from eggfusion_tpu_torch.entry import dryrun_multichip; dryrun_multichip(1)"
"""
from __future__ import annotations

import numpy as np
import torch

from eggfusion_tpu_torch.core import surfels as sf
from eggfusion_tpu_torch.core.mapper import MapperConfig, compute_loss
from eggfusion_tpu_torch.ops.raster_xla import render_xla
from eggfusion_tpu_torch.utils.device import resolve_device


def _example_state(width=128, height=96, n_surfels=2048, capacity=4096, device=None):
    """(map, intrinsics, width, height): `n_surfels` random surfels in front
    of the camera, appended at time 0 into an empty map of `capacity` slots.
    The arrays are drawn from `np.random.default_rng(0)` in the order of the
    JAX package's `_example_state`, so both packages build the same map."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    scfg = sf.SurfelConfig(capacity=capacity, max_sh_degree=0, active_sh_degree=0)
    xyz = np.concatenate(
        [rng.uniform(-0.8, 0.8, (n_surfels, 2)), rng.uniform(1.2, 3.0, (n_surfels, 1))], -1
    ).astype(np.float32)
    nrm = rng.normal(size=(n_surfels, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    lam = np.full((n_surfels, 2), 4.0, np.float32)
    color = rng.uniform(size=(n_surfels, 3)).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, device=dev)

    batch = sf.SpawnBatch(
        xyz=t(xyz),
        normal=t(nrm),
        color=t(color),
        dist=torch.full((n_surfels, 3), 0.02, device=dev),
        eta=t(np.concatenate([xyz * lam[:, :1], nrm * lam[:, 1:]], -1)),
        sigma2=t(1.0 / lam),
        valid=torch.ones(n_surfels, dtype=torch.bool, device=dev),
    )
    s = sf.append_surfels(sf.SurfelMap.empty(scfg, dev), batch, 0, 0.99)
    intr = torch.tensor([0.9 * width, 0.9 * width, width / 2 - 0.5, height / 2 - 0.5], dtype=torch.float32,
                        device=dev)
    return s, intr, width, height


def _loss_fn(s: sf.SurfelMap, intr: torch.Tensor, width: int, height: int):
    """fn(xyz, features_dc, opacity, w2c, color_ref, depth_ref) -> loss: the
    map `s` with those three fields replaced, rendered by `render_xla` from
    w2c and held to the reference images by `compute_loss` (the rendered
    normals as the normal target, the map itself as the drift snapshot)."""
    mcfg = MapperConfig()

    def fn(xyz, features_dc, opacity, w2c, color_ref, depth_ref):
        s2 = s.replace(xyz=xyz, features_dc=features_dc, opacity=opacity)
        out = render_xla(sf.render_params(s2), w2c, intr, width, height, sh_degree=0)
        kf = {
            "color": color_ref,
            "depth": depth_ref,
            "normal": out["normal"],
            "rgb_mask": torch.ones((height, width, 1), dtype=torch.bool, device=xyz.device),
            "geo_mask": depth_ref > 0,
        }
        geo = {"position": s2.xyz.detach(), "normal": s2.get_normal().detach()}
        return compute_loss(out, kf, s2, geo, mcfg)

    return fn


def entry(device=None):
    """(fn, example_args): the render + mapping loss of `_loss_fn` on the
    example map, and its arguments (the map's optimized fields, the
    identity pose, a flat gray image and a 2 m depth) on `device`."""
    s, intr, width, height = _example_state(device=device)
    dev = s.device
    example_args = (
        s.xyz,
        s.features_dc,
        s.opacity,
        torch.eye(4, device=dev),
        torch.full((height, width, 3), 0.5, device=dev),
        torch.full((height, width, 1), 2.0, device=dev),
    )
    return _loss_fn(s, intr, width, height), example_args


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """`run_multichip_dryrun(n_devices)`: on CUDA over `n_devices` GPUs
    (raises when fewer are visible), on the CPU over `n_devices` shards of
    the CPU device."""
    from eggfusion_tpu_torch.parallel.mesh import run_multichip_dryrun

    return run_multichip_dryrun(n_devices, device=device)
