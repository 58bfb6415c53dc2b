"""Keyframe-parallel window optimization across GPUs (port of
`eggfusion_tpu/parallel/mesh.py`).

`System.mesh_devices >= 1` switches the mapper to the window-BATCHED
optimization step: every Adam step renders the whole sliding window (or a
batch of keyframes in `finish()`), one block of keyframes per device, and
applies the mean of their image losses plus the drift regularizer. The
same algorithm runs at any device count, so a run on one device and a run
on N give the same trajectory up to the order of float sums.

One process drives every device, as JAX's single-controller mesh does. The
surfel map lives on the first device. Each step copies the six optimized
fields to every device; each device renders its keyframes with the
production renderer and differentiates its share of the loss w.r.t. its own
copy; the partial losses and gradients are summed on the first device in
device order (so a run is deterministic, with no collective library),
where the regularizer and Adam run. Nothing in the step synchronizes the
host with a device. The step runs as the system's programs
(`utils.graphs`): on CUDA one captured graph per device that holds
members ("window_shard", keyed by its shard's index and members) and one
on the first device ("window_reduce"); the copies between devices are the
loads of the programs' inputs, between the replays. On the CPU a mesh is
`n` shards on the one CPU device: the split and the reduction run as on
GPUs, which is how the tests hold this module to the JAX step on the
virtual CPU mesh.

`run_multichip_dryrun` is the JAX module's dryrun: the product pipeline at
128x64 for 8 frames on a mesh of n, with the JAX assertions; it waits for
every device of the mesh after each frame to time it (`frame_s`), which
`mesh_scaling` reads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from eggfusion_tpu_torch.core import surfels as sf
from eggfusion_tpu_torch.core.mapper import (
    OPT_FIELDS, MapperConfig, _adam_update, compute_image_loss, compute_reg_loss,
)
from eggfusion_tpu_torch.utils.graphs import Programs


def make_mesh(n_devices: int, device) -> list[torch.device]:
    """The devices of an `n_devices` mesh: on CUDA `cuda:0` .. `cuda:n-1`
    (raises when fewer GPUs are visible; it never shrinks), on the CPU `n`
    shards on the CPU device."""
    dev = torch.device(device)
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"mesh_devices must be >= 1, got {n}")
    if dev.type == "cuda":
        visible = torch.cuda.device_count()
        if n > visible:
            raise ValueError(f"mesh_devices={n} but only {visible} GPUs are visible")
        return [torch.device("cuda", i) for i in range(n)]
    if dev.type == "cpu":
        return [dev] * n
    raise ValueError(f"no mesh on device {dev}")


class WindowBatch(NamedTuple):
    """A batch of B keyframes (B a multiple of the device count) split into
    contiguous blocks of B / n, one per device: each block holds the
    (maps, w2c, intr) of its real members, on its device. Padding members
    (v = 0 in the JAX batch) are left out: their masked image loss is 0
    and its weight is 0, so they add exactly nothing."""

    shards: list
    n_valid: int


def window_batch(kfs: list, batch_size: int, devices: list) -> WindowBatch:
    """The first `batch_size` keyframes of `kfs` as a `WindowBatch`."""
    n = len(devices)
    per = batch_size // n
    kfs = kfs[:batch_size]
    shards = []
    for i, d in enumerate(devices):
        members = []
        for kf in kfs[i * per:(i + 1) * per]:
            maps = {k: v.to(d, non_blocking=True) for k, v in kf.device_maps().items()}
            members.append((maps, kf.w2c.to(d, non_blocking=True), kf.intr.to(d, non_blocking=True)))
        shards.append(members)
    return WindowBatch(shards, len(kfs))


# the fields of a map that `sf.render_params` does not read
_UNRENDERED = ("eta", "sigma2", "observe_count", "tic", "error_count", "stable", "count")


def make_window_opt_step(render_at, mcfg: MapperConfig, devices: list, opt_cap: int | None = None,
                         programs=None):
    """The window-batched, keyframe-sharded map-optimization step.

    Returns step(s, moments, step_count, batch, geo_snapshot, lrs, width,
    height) -> (s, moments, step_count, loss): loss = sum_k v_k loss_k /
    max(sum_k v_k, 1) + the drift regularizer (computed once, on the first
    device), then one Adam step there. The map's fields, the moments and
    the step count are updated in place.

    The step runs as programs of `programs` (a `utils.graphs.Programs`;
    eager when None): "window_shard" on each device that holds members (the
    map's six optimized fields and its active mask loaded into the
    program's inputs on that device, its members rendered with the
    production renderer, the six gradients and the partial loss out) and
    "window_reduce" on the first device (the partials summed in device
    order, the regularizer, Adam in place). A batch's members are loaded
    into the shard programs once: after the first call the batch holds the
    programs' copies, which later calls find in place. `step.prepare(...)`,
    with the arguments of `step`, captures the programs ahead."""
    dev0 = devices[0]
    programs = programs or Programs(dev0, graphs=False)

    def shard_fn(_state, x, *, shard, width, height, scale):
        d = x["members"][0][1].device
        p = {k: v.to(d, non_blocking=True).detach().requires_grad_(True) for k, v in x["params"].items()}
        with torch.enable_grad():
            rp = sf.render_params(sf.SurfelMap(**p, active=x["active"].to(d, non_blocking=True),
                                               **dict.fromkeys(_UNRENDERED)))
            loss_d = sum(compute_image_loss(render_at(rp, w2c, intr, width, height, cap=opt_cap), maps, mcfg)
                         for maps, w2c, intr in x["members"]) * scale
            g = torch.autograd.grad(loss_d, [p[k] for k in OPT_FIELDS])
        return list(g), loss_d.detach()

    def reduce_fn(state, x, *, lrs):
        s, moments, step_count = state
        base = {k: getattr(s, k).detach() for k in OPT_FIELDS}
        grads = None
        img = torch.zeros((), device=dev0)
        for g, loss_d in zip(x["grads"], x["losses"]):
            g = [t.to(dev0, non_blocking=True) for t in g]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            img = img + loss_d.to(dev0, non_blocking=True)
        p = {k: v.detach().requires_grad_(True) for k, v in base.items()}
        with torch.enable_grad():
            reg = compute_reg_loss(s.replace(**p), x["geo"], mcfg)
            # the regularizer reads positions and rotations only
            g_reg = torch.autograd.grad(reg, [p[k] for k in OPT_FIELDS], allow_unused=True,
                                        materialize_grads=True)
        grads = g_reg if grads is None else [a + b for a, b in zip(grads, g_reg)]
        with torch.no_grad():
            new_params, new_moments = _adam_update(base, dict(zip(OPT_FIELDS, grads)), moments, step_count,
                                                   dict(lrs))
            for k in OPT_FIELDS:
                getattr(s, k).copy_(new_params[k])
                for buf, new in zip(moments[k], new_moments[k]):
                    buf.copy_(new)
            step_count.add_(1)
        return img + reg.detach()

    shard_prog = programs.program("window_shard", shard_fn)
    reduce_prog = programs.program("window_reduce", reduce_fn)

    def shard_calls(s, batch, width, height):
        """(device, static, inputs) of each shard program the batch runs."""
        scale = 1.0 / max(batch.n_valid, 1)
        params = {k: getattr(s, k) for k in OPT_FIELDS}
        return [(d, {"shard": i, "width": width, "height": height, "scale": scale},
                 {"params": params, "active": s.active, "members": members})
                for i, (d, members) in enumerate(zip(devices, batch.shards)) if members]

    def keep_members(entry, members) -> None:
        """The batch keeps the program's copies of its members: later calls
        find them in place (loaded once per window generation)."""
        members[:] = entry.input_tree()["members"]

    def step(s: sf.SurfelMap, moments: dict, step_count: torch.Tensor, batch: WindowBatch,
             geo_snapshot: dict, lrs: dict, width: int, height: int):
        grads, losses = [], []
        for d, static, x in shard_calls(s, batch, width, height):
            g, loss_d = shard_prog(static, None, x, rung=s.capacity, device=d)
            if programs.enabled:
                keep_members(shard_prog.last, x["members"])
            grads.append(g)
            losses.append(loss_d)
        loss = reduce_prog({"lrs": tuple(sorted(lrs.items()))}, (s, moments, step_count),
                           {"grads": grads, "losses": losses, "geo": geo_snapshot}, rung=s.capacity, device=dev0)
        return s, moments, step_count, loss

    def prepare(s: sf.SurfelMap, moments: dict, step_count: torch.Tensor, batch: WindowBatch,
                geo_snapshot: dict, lrs: dict, width: int, height: int) -> None:
        """Capture `step`'s programs for these arguments now, without
        running them (the map, the moments, the step and the batch stay as
        they are). The reduction is captured where the shards' captures
        give its inputs (on CUDA graphs; the CPU plumbing makes it at its
        first call)."""
        parts = []
        for d, static, x in shard_calls(s, batch, width, height):
            e = shard_prog.prepare(static, None, x, rung=s.capacity, device=d)
            if e is None:
                return
            parts.append(e.outputs)
        if all(p is not None for p in parts):
            reduce_prog.prepare({"lrs": tuple(sorted(lrs.items()))}, (s, moments, step_count),
                                {"grads": [g for g, _ in parts], "losses": [loss for _, loss in parts],
                                 "geo": geo_snapshot}, rung=s.capacity, device=dev0)

    step.prepare = prepare
    return step


def sync_devices(devices) -> None:
    """Wait until every CUDA device of `devices` has drained its work (a
    no-op for CPU devices)."""
    for d in dict.fromkeys(torch.device(x) for x in devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def dryrun_config(n_devices: int, width: int, height: int, n_frames: int, max_surfels: int,
                  overrides: dict | None = None):
    """The configuration of `run_multichip_dryrun` (the JAX dryrun's
    overrides of `default_config`), with `overrides` merged on top."""
    from eggfusion_tpu_torch import config as cfglib

    cfg = cfglib.default_config(
        Dataset={
            "type": "synthetic", "n_frames": n_frames, "preload": False,
            "Calibration": {
                "fx": 0.75 * width, "fy": 0.75 * width,
                "cx": width / 2 - 0.5, "cy": height / 2 - 0.5,
                "width": width, "height": height, "depth_scale": 1.0,
            },
        },
        Viewer={"max_surfels_num": max_surfels},
        # local_map_iter 6: one batched amortized step per frame, plus the
        # 3-step burst of frame 0
        Mapping={"local_map_iter_init": 3, "local_map_iter": 6,
                 "sample_ratio": 0.05, "sample_ratio_init": 0.2},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        # the tile compositor ("pallas") at the JAX dryrun's small slab caps
        System={"mesh_devices": n_devices, "render_backend": "pallas",
                "save_dir": "results/multichip_dryrun_torch",
                "raster_cap": 256, "opt_raster_cap": 128,
                "adaptive_model_cap": False, "final_global_opt": False},
    )
    return cfglib.merge(cfg, overrides or {})


def dryrun(cfg, device=None, verbose: bool = True, graphs=None) -> tuple:
    """`run_multichip_dryrun` on configuration `cfg` (`dryrun_config`), its
    programs run as `EGGFusion(graphs=graphs)` runs them (None: CUDA graphs
    on CUDA, False: eagerly); returns (its result, the `EGGFusion` it ran,
    the sliding window's size after each frame)."""
    import time

    import numpy as np

    from eggfusion_tpu_torch.data.datasets import load_dataset
    from eggfusion_tpu_torch.main import build_frame
    from eggfusion_tpu_torch.system import EGGFusion
    from eggfusion_tpu_torch.utils import eval as evalu

    n_devices = int(cfg.System.mesh_devices)
    n_frames = int(cfg.Dataset.n_frames)
    t0 = time.perf_counter()
    ef = EGGFusion(cfg, device=device, graphs=graphs)
    dataset = load_dataset(cfg, ef.device)
    mesh = ef.mapper.devices
    frame_s, window, captures = [], [], []
    for fid in range(n_frames):
        t_frame = time.perf_counter()
        ef.reconstruct(build_frame(dataset, fid, False, ef.device, nlevel=ef.nlevel_frame, programs=ef.programs))
        sync_devices(mesh)
        frame_s.append(time.perf_counter() - t_frame)
        window.append(len(ef.mapper.keyframe_manager.sliding_window))
        captures.append(ef.programs.captures())
    wall = time.perf_counter() - t0

    ref = ef._traj_np("ref")[:, :3, 3]
    est = ef._traj_np("est")[:, :3, 3]
    ate = evalu.ate_rmse(ref, est)
    fused = max((f for f, _e in ef.mapper.fusion_stats.values()), default=0)
    n_surf = int(ef.mapper.surfels.num_active())
    assert np.isfinite(ate), "multichip run produced a non-finite trajectory"
    assert fused > 100, f"sharded window optimization ran but fusion only associated {fused} px"
    assert n_surf > 500, f"map did not populate ({n_surf} surfels)"
    opt_steps = ef.mapper.opt_steps_total
    assert opt_steps >= 4, f"dryrun must exercise >= 4 sharded opt steps (got {opt_steps})"
    result = {
        "n_devices": n_devices, "width": int(cfg.Dataset.Calibration.width),
        "height": int(cfg.Dataset.Calibration.height),
        "n_frames": n_frames, "ate_cm": round(float(ate), 4),
        "surfels": n_surf, "max_fused_px": int(fused),
        "wall_s": round(wall, 1),
        "opt_steps": opt_steps,
        "frame_s": frame_s,
        "captures": captures,
    }
    if verbose:
        print(f"multichip dryrun ok on {n_devices} devices: {result}")
    return result, ef, window


def run_multichip_dryrun(n_devices: int, width: int = 128, height: int = 64, n_frames: int = 8,
                         max_surfels: int = 8192, verbose: bool = True, device=None) -> dict:
    """Drive the product pipeline (`EGGFusion.reconstruct`) over a mesh of
    `n_devices` (the JAX `run_multichip_dryrun`): the synthetic corner
    sequence with `System.mesh_devices = n`, so every frame's window
    optimization runs the window-batched, keyframe-sharded step. On CUDA the
    mesh is `n` GPUs (raises when fewer are visible) and the tile compositor
    renders; on the CPU, `n` shards of the CPU device. Asserts the JAX
    dryrun's bounds (finite ATE, > 100 fused px, > 500 surfels, >= 4 opt
    steps) and returns its dict plus `frame_s`: each frame's wall seconds,
    taken after every device of the mesh has drained, and `captures`: the
    system's program captures after each frame."""
    cfg = dryrun_config(n_devices, width, height, n_frames, max_surfels)
    result, _ef, _window = dryrun(cfg, device, verbose)
    return result
