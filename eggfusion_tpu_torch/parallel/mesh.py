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
device order (so a run is deterministic), where the regularizer and Adam
run. Nothing here synchronizes the host with a device. On the CPU a mesh is
`n` shards on the one CPU device: the split and the reduction run as on
GPUs, which is how the tests hold this module to the JAX step on the
virtual CPU mesh.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from eggfusion_tpu_torch.core import surfels as sf
from eggfusion_tpu_torch.core.mapper import (
    OPT_FIELDS, MapperConfig, _adam_update, compute_image_loss, compute_reg_loss,
)


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


def make_window_opt_step(render_at, mcfg: MapperConfig, devices: list, opt_cap: int | None = None):
    """The window-batched, keyframe-sharded map-optimization step.

    Returns step(s, moments, step_count, batch, geo_snapshot, lrs, width,
    height) -> (s, moments, step_count + 1, loss): loss = sum_k v_k
    loss_k / max(sum_k v_k, 1) + the drift regularizer (computed once, on
    the first device), then one Adam step there. The map's fields are
    updated in place."""
    dev0 = devices[0]

    def step(s: sf.SurfelMap, moments: dict, step_count: torch.Tensor, batch: WindowBatch,
             geo_snapshot: dict, lrs: dict, width: int, height: int):
        base = {k: getattr(s, k).detach() for k in OPT_FIELDS}
        scale = 1.0 / max(batch.n_valid, 1)
        grads = None
        img = torch.zeros((), device=dev0)
        for d, members in zip(devices, batch.shards):
            if not members:
                continue
            p = {k: v.to(d, non_blocking=True).detach().requires_grad_(True) for k, v in base.items()}
            with torch.enable_grad():
                rp = sf.render_params(s.replace(**p, active=s.active.to(d, non_blocking=True)))
                loss_d = sum(compute_image_loss(render_at(rp, w2c, intr, width, height, cap=opt_cap), maps, mcfg)
                             for maps, w2c, intr in members) * scale
                g = torch.autograd.grad(loss_d, [p[k] for k in OPT_FIELDS])
            g = [x.to(dev0, non_blocking=True) for x in g]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            img = img + loss_d.detach().to(dev0, non_blocking=True)
        p = {k: v.detach().requires_grad_(True) for k, v in base.items()}
        with torch.enable_grad():
            reg = compute_reg_loss(s.replace(**p), geo_snapshot, mcfg)
            # the regularizer reads positions and rotations only
            g_reg = torch.autograd.grad(reg, [p[k] for k in OPT_FIELDS], allow_unused=True,
                                        materialize_grads=True)
        grads = g_reg if grads is None else [a + b for a, b in zip(grads, g_reg)]
        with torch.no_grad():
            new_params, moments = _adam_update(base, dict(zip(OPT_FIELDS, grads)), moments, step_count, lrs)
            for k in OPT_FIELDS:
                getattr(s, k).copy_(new_params[k])
        return s, moments, step_count + 1, img + reg.detach()

    return step
