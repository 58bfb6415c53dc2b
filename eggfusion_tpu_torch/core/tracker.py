"""Frame-to-model dense camera tracking (port of
`eggfusion_tpu/core/tracker.py`).

Coarse-to-fine pyramid Gauss-Newton over point-to-plane ICP + weighted
photometric terms, with the reference's commit rule: the dense result is
committed only if an iteration converged, otherwise the pose falls back to
the seed delta. The per-level iterations are a Python loop (the JAX
`while_loop`); without `Tracking.early_exit` nothing in it reads the
device: the converged flag stays a device tensor, and the host reads it
`readback_lag` frames late through an async copy. With `Tracking.use_sparse`
the seed comes from the sparse frontend (`core.sparse_init`) where it
solves, which reads the frame's image back to the host every frame.
`Tracking.model_view_down` pairs a model pyramid rendered at 1/down with
the frame pyramid from level log2(down) on; under `System.mesh_devices`
each GN iteration is built over row shards on every device.

`dense_track_pose` runs as one program (`utils.graphs`, one CUDA graph for
the whole coarse-to-fine solve, keyed by the pyramids' shapes and the
config), also on a mesh of one device, the tracker's own; its pose and
flags are cloned where they outlive the frame. Pixel-sharded tracking on a
mesh of several devices (or shards of one) runs as three programs:
"track_prep" builds a shard's constraint rows and the frame's resampling
pack on its device once a level, "track_shard" its partial normal
equations every GN iteration, and "track_reduce" on the first device sums
them in device order and updates the pose. The pose
delta and the partials cross devices between the replays, as peer copies
into the programs' static inputs (`copy_`). `Tracking.early_exit` stays
eager: it reads the device back every iteration.
"""
from __future__ import annotations

from collections import deque
from typing import NamedTuple, Tuple

import torch

from eggfusion_tpu_torch.geometry import lie
from eggfusion_tpu_torch.ops import reduce as gn
from eggfusion_tpu_torch.ops.pyramid import PyramidLevel
from eggfusion_tpu_torch.utils import trace
from eggfusion_tpu_torch.utils.device import HostReadback
from eggfusion_tpu_torch.utils.graphs import Programs


class TrackerConfig(NamedTuple):
    """Tracking configuration (the config's `Tracking:` section)."""

    pyramid_level: int = 3
    pyramid_iters: Tuple[int, ...] = (3, 3, 3)
    angle_threshold: float = 20.0  # degrees
    distance_threshold: float = 0.1
    residual_thres: float = 0.01
    dx_threshold: float = 0.001
    use_rgb: bool = True
    rgb_weight: float = 1e-4
    lm_damping: float = 1e-6
    solver_stride: int = 1
    solver_stride_fine: int = 0
    commit_min_count: int = 0
    commit_rms_m: float = 0.005
    min_valid_frac: float = 0.02
    # stop a level's GN iterations once an iteration converged and moved the
    # pose by less than early_exit_factor * dx_threshold (see the JAX class)
    early_exit: bool = False
    early_exit_factor: float = 0.05


# GN iterations run under `TrackerConfig.early_exit` since the last reset (a
# host count; without the early exit every level runs all its iterations)
EARLY_EXIT_ITERATIONS = {"run": 0}


def _one_device(devices, dev) -> bool:
    """Whether a mesh is the single device `dev` (a tensor's device)."""
    return len(devices) == 1 and torch.device(devices[0]) == dev


def _rows(level: PyramidLevel, r0: int, r1: int) -> PyramidLevel:
    """Rows [r0, r1) of every map of a pyramid level (views)."""
    return level._replace(**{f: getattr(level, f)[r0:r1] for f in level._fields if f != "intr"})


def _shard_prep(_state, x, *, shard, stride, k0, k1, full_hw, device):
    """One device's part of a level under a mesh, built on `device`: the
    constraint grid of the strided rows [k0, k1) (`gn.constraint_grid` of
    the model level's rows [k0 * stride, k1 * stride), `x[0]`, and the same
    rows of the frame level `x[1]`) and the frame level's resampling pack.
    `shard` keys the program apart from the other shards."""
    model, frame = (PyramidLevel(*(t.to(device, non_blocking=True) for t in lvl)) for lvl in x)
    grid = gn.constraint_grid(model, _rows(frame, k0 * stride, k1 * stride), stride)
    grid = grid._replace(row0=k0, full_hw=full_hw, **{f: v.contiguous() for f, v in grid._asdict().items()
                                                      if isinstance(v, torch.Tensor)})
    return grid, gn.sampling_pack(frame)


def _level_shards(model_lvl, frame_lvl, stride: int, devices, prep=None):
    """(constraint grid, resampling pack) of one level for each device:
    the whole grid on one device, or under a mesh (`devices`) each
    device's contiguous block of strided rows with the frame's pack, built
    on that device from the model level's rows and the frame level
    (`_shard_prep`, through the program `prep` when given: pixel-sharded
    tracking)."""
    if not devices or _one_device(devices, frame_lvl.intensity.device):
        return [(gn.constraint_grid(model_lvl, frame_lvl, stride), gn.sampling_pack(frame_lvl))]
    n = len(devices)
    H, W = model_lvl.disp.shape[:2]
    hs, ws = -(-H // stride), -(-W // stride)
    bounds = [hs * i // n for i in range(n + 1)]
    out = []
    for i, (d, k0, k1) in enumerate(zip(devices, bounds, bounds[1:])):
        x = (_rows(model_lvl, k0 * stride, k1 * stride), frame_lvl)
        static = dict(shard=i, stride=stride, k0=k0, k1=k1, full_hw=(hs * stride, ws * stride), device=str(d))
        out.append(_shard_prep(None, x, **static) if prep is None else prep(static, None, x, device=d))
    return out


def _sum_on(dev, xs):
    """x0 + x1 + ... on `dev`, in list order (a fixed reduction order)."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x.to(dev, non_blocking=True)
    return out


def _shard_normal_equations(_state, x, *, cfg, shard):
    """The partial normal equations of one shard's rows at pose delta
    `x["delta"]` (moved to the shard's device). `shard` keys the program
    apart from the other shards on the same device."""
    pack = x["pack"]
    return gn.grid_normal_equations(x["grid"], pack, x["delta"].to(pack.device, non_blocking=True),
                                    cfg.angle_threshold, cfg.distance_threshold, cfg.use_rgb, cfg.rgb_weight)


def _gn_step(_state, x, *, cfg, min_n):
    """One GN update from the shards' partials (`x["parts"]`), summed in
    device order on the pose's device: returns (delta, converged, icp rms,
    icp count), plus the early-exit stop flag with `cfg.early_exit`."""
    delta = x["delta"]
    A, b, n, r2_icp, n_icp = (_sum_on(delta.device, [p[i] for p in x["parts"]]) for i in range(5))
    dx = gn.solve_gn(A, b, cfg.lm_damping)
    delta = lie.update_transform(delta, dx)
    residual_est = torch.linalg.vector_norm(b) / torch.sqrt(torch.clamp(n, min=1.0))
    dx_norm = torch.linalg.vector_norm(dx)
    rms = torch.sqrt(r2_icp / torch.clamp(n_icp, min=1.0))
    # n > min_n: an empty solve must not count as converged
    conv_i = (residual_est < cfg.residual_thres) & (dx_norm < cfg.dx_threshold) & (n > min_n)
    out = (delta, x["converged"] | conv_i, rms, n_icp)
    if cfg.early_exit:
        out += (conv_i & (dx_norm < cfg.early_exit_factor * cfg.dx_threshold),)
    return out


def dense_track(pyr_model, pyr_frame, init_delta: torch.Tensor, cfg: TrackerConfig, devices=None, programs=None):
    """Full coarse-to-fine GN optimization, coarse (level L-1) to fine (0).

    With `cfg.early_exit` a level stops after the first iteration that
    converged and moved the pose by less than `early_exit_factor *
    dx_threshold` (the flag resets at every level, and is read back after
    every iteration); the result is the last iteration's that ran.
    `devices` (a mesh, `parallel.mesh.make_mesh`) shards each level's
    constraint rows over the devices; the partial normal equations are
    summed on the first, in device order, every iteration, and the pose
    stays there. `programs` (a `utils.graphs.Programs`; eager when None)
    runs the sharded pieces as its programs "track_prep" (a shard's grid
    and pack, once a level), "track_shard" (a shard's partials) and
    "track_reduce" (the sum and the update).

    Returns (delta (4, 4), converged (bool tensor), icp_rms_m, icp_count)."""
    dev = init_delta.device
    programs = programs or Programs(dev, graphs=False)
    prep = programs.program("track_prep", _shard_prep)
    shard = programs.program("track_shard", _shard_normal_equations)
    reduce = programs.program("track_reduce", _gn_step)
    delta = init_delta
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    last_rms = torch.full((), float("inf"), device=dev)
    last_n = torch.zeros((), device=dev)
    for l in range(cfg.pyramid_level):
        level = cfg.pyramid_level - 1 - l
        model_lvl = pyr_model[level]
        frame_lvl = pyr_frame[level]
        stride = (cfg.solver_stride_fine if level == 0 and cfg.solver_stride_fine > 0
                  else cfg.solver_stride)
        Hl, Wl = model_lvl.intensity.shape[:2]
        min_n = max(1.0, cfg.min_valid_frac * (Hl // stride) * (Wl // stride))
        shards = _level_shards(model_lvl, frame_lvl, stride, devices, prep)
        for _ in range(cfg.pyramid_iters[l]):
            parts = []
            for i, (grid, pack) in enumerate(shards):
                parts.append(shard({"cfg": cfg, "shard": i}, None, {"grid": grid, "pack": pack, "delta": delta},
                                   device=pack.device))
                if programs.enabled:  # the level's later iterations find its grid and pack in place
                    staged = shard.last.input_tree()
                    shards[i] = (staged["grid"], staged["pack"])
            delta, converged, last_rms, last_n, *stop = reduce(
                {"cfg": cfg, "min_n": min_n}, None, {"parts": parts, "delta": delta, "converged": converged},
                device=dev)
            if cfg.early_exit:
                EARLY_EXIT_ITERATIONS["run"] += 1
                with trace.waiting("readback"):
                    stop = bool(stop[0])
                if stop:
                    break
    return delta, converged, last_rms, last_n


def _motion_delta(prev_w2c, prev_prev_w2c, damping: float):
    """Damped constant-velocity seed: Exp(damping * Log(T_{k-1} T_{k-2}^-1))."""
    rel = prev_w2c @ lie.invert_se3(prev_prev_w2c)
    xi = lie.SE3_to_se3(rel)
    return lie.se3_to_SE3(damping * xi)


def dense_track_pose(pyr_model, pyr_frame, seed_delta, prev_transform, cfg: TrackerConfig, devices=None,
                     programs=None):
    """`dense_track` + on-device commit: returns (new w2c, committed, rms,
    n_icp); the commit is a select, no host readback."""
    delta, converged, rms, n_icp = dense_track(pyr_model, pyr_frame, seed_delta, cfg, devices, programs)
    committed = converged
    if cfg.commit_min_count > 0:
        committed = committed | ((rms < cfg.commit_rms_m) & (n_icp >= cfg.commit_min_count))
    curr = torch.where(committed, delta @ prev_transform, seed_delta @ prev_transform)
    return curr, committed, rms, n_icp


def _track_program(_state, x, *, cfg):
    return dense_track_pose(*x, cfg)


class Tracker:
    """Host-side tracking orchestrator: frame 0 and `only_mapping` take the
    GT pose; the dense result is committed only on convergence, seeded by
    the sparse frontend (`Tracking.use_sparse`) or a damped constant-velocity
    motion model; converged flags are folded into a failure streak
    `readback_lag` frames late."""

    def __init__(self, cfg, device, programs=None):
        t = cfg.Tracking
        self.device = torch.device(device)
        # pixel-sharded tracking under a mesh (System.mesh_devices; off with
        # Tracking.shard_tracking false): each device builds the normal
        # equations of its block of constraint rows
        self.devices = None
        mesh_devices = int(cfg.System.get("mesh_devices", 0))
        if mesh_devices >= 1 and bool(t.get("shard_tracking", True)):
            from eggfusion_tpu_torch.parallel.mesh import make_mesh

            self.devices = make_mesh(mesh_devices, self.device)
        self.config = TrackerConfig(
            pyramid_level=int(t.pyramid_level),
            pyramid_iters=tuple(int(i) for i in t.pyramid_iters),
            angle_threshold=float(t.angle_threshold),
            distance_threshold=float(t.distance_threshold),
            residual_thres=float(t.residual_thres),
            dx_threshold=float(t.dx_threshold),
            use_rgb=bool(t.use_rgb),
            rgb_weight=float(t.rgb_weight),
            solver_stride=int(t.get("solver_stride", 2)),
            solver_stride_fine=int(t.get("solver_stride_fine", 0)),
            commit_min_count=int(t.get("commit_min_count", 0)),
            min_valid_frac=float(t.get("min_valid_frac", 0.02)),
            commit_rms_m=float(t.get("commit_rms_m", 0.005)),
            early_exit=bool(t.get("early_exit", False)),
            early_exit_factor=float(t.get("early_exit_factor", 0.05)),
        )
        # model-view downsample (Tracking.model_view_down, a power of 2): the
        # model pyramid's base is the 1/down view, so the frame pyramid is
        # built `view_off` levels deeper and paired from level view_off on
        down = int(t.get("model_view_down", 1))
        if down < 1 or down & (down - 1):
            raise ValueError(f"Tracking.model_view_down must be a power of 2, got {down}")
        self.view_off = down.bit_length() - 1
        self.only_mapping = bool(cfg.System.only_mapping)
        self.use_motion_model = bool(t.get("use_motion_model", True))
        self.motion_damping = float(t.get("motion_damping", 0.5))
        self.recover_after = int(t.get("recover_after", 3))
        self.chronic_fails = 0
        self.gate_residual_factor = float(t.get("gate_residual_factor", 0.0))
        self._fail_streak = 0
        self.readback_lag = max(1, int(t.get("readback_lag", 3)))
        self._conv_pending: deque = deque()  # (HostReadback of converged, pose)
        self.last_good_w2c = None
        self.seed_override = None  # one-shot delta seed (the recovery rotation sweep)
        self.sparse_seeds = 0  # frames whose delta seed came from the sparse frontend
        self.initialized = False
        self._prev_w2c = None
        self._prev_prev_w2c = None
        self._sparse = None
        if bool(t.get("use_sparse", False)):
            from eggfusion_tpu_torch.core.sparse_init import SparseInitializer

            self._sparse = SparseInitializer(cfg)
        # the programs (none with the early exit, which reads the device
        # back every iteration): the whole solve as "track", or under a mesh
        # of several devices (or shards) `dense_track`'s sharded programs
        self._programs = None if self.config.early_exit else programs
        self._track = None if self._programs is None else programs.program("track", _track_program)

    def _mesh(self, dev):
        """The devices to shard the solve over: None without a mesh or on a
        mesh of the one device `dev` (the same operations as unsharded)."""
        return None if self.devices is None or _one_device(self.devices, dev) else self.devices

    def track_pose(self, pyr_model, pyr_frame, seed_delta, prev_transform):
        """`dense_track_pose` with this tracker's config, through its
        programs where it has them. The outputs are the programs': clone
        what outlives their next call."""
        devices = self._mesh(seed_delta.device)
        if self._track is None or devices is not None:
            return dense_track_pose(pyr_model, pyr_frame, seed_delta, prev_transform, self.config, devices,
                                    self._programs)
        return self._track({"cfg": self.config}, None, (tuple(pyr_model), tuple(pyr_frame), seed_delta,
                                                       prev_transform))

    def capture(self, pyr_model, pyr_frame) -> None:
        """Capture the tracking programs for pyramids like these (`warmup`):
        the "track" program without running it, or under a mesh of several
        devices the sharded programs by one solve, whose result is
        dropped (the programs hold no state)."""
        if self._track is None:
            return
        eye = torch.eye(4, device=self.device)
        if self._mesh(eye.device) is None:
            self._track.prepare({"cfg": self.config}, None, (tuple(pyr_model), tuple(pyr_frame), eye, eye))
        else:
            dense_track(pyr_model, pyr_frame, eye, self.config, self.devices, self._programs)

    def _seed_delta(self, frame, prev_transform):
        """Initial delta: a pending one-shot override first; without a
        sparse frontend, identity mid-failure-streak; then the sparse
        frontend's estimate, else constant velocity."""
        if self.seed_override is not None:
            seed, self.seed_override = self.seed_override, None
            return seed.to(torch.float32)
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        if self._fail_streak > 0 and self._sparse is None:
            return eye
        if self._sparse is not None:
            seed = self._sparse.track(frame)
            if seed is not None:
                frame.sparse_tracking = True
                self.sparse_seeds += 1
                return torch.as_tensor(seed, device=self.device) @ lie.invert_se3(prev_transform)
        if self.use_motion_model and self._prev_prev_w2c is not None:
            return _motion_delta(self._prev_w2c, self._prev_prev_w2c, self.motion_damping)
        return eye

    def _update_fail_streak(self) -> None:
        """Fold in converged flags at least `readback_lag` frames old."""
        while len(self._conv_pending) >= self.readback_lag:
            conv, pose = self._conv_pending.popleft()
            if bool(conv.numpy()):
                self._fail_streak = 0
                self.chronic_fails = 0
                self.last_good_w2c = pose
            else:
                self._fail_streak += 1
                self.chronic_fails += 1

    def needs_recovery(self) -> bool:
        self._update_fail_streak()
        return self.recover_after > 0 and self._fail_streak >= self.recover_after

    def reset_motion(self) -> None:
        """Clear the constant-velocity state and the failure streak (after a
        recovery re-anchor the previous velocity is meaningless)."""
        self._prev_prev_w2c = None
        self._fail_streak = 0
        self._conv_pending.clear()

    def tracking(self, frame, model_map) -> None:
        with trace.span("track"):
            self._tracking(frame, model_map)

    def _tracking(self, frame, model_map) -> None:
        if self.only_mapping or not self.initialized:
            self.initialized = True
            frame.update_transform_gt()
            if self._sparse is not None:
                self._sparse.track(frame)  # keep the frontend's previous frame current
            self._push_pose(frame.w2c_matrix())
            return
        prev_transform = model_map["transform"]
        seed_delta = self._seed_delta(frame, prev_transform)
        curr, converged, rms, n_icp = self.track_pose(model_map["pyramid"], frame.pyramid[self.view_off:],
                                                      seed_delta, prev_transform)
        # the pose and the flag outlive the program's next call
        curr, converged = curr.clone(), converged.clone()
        frame.tracking_converged = converged  # device scalar
        if self.gate_residual_factor > 0:
            frame.tracking_map_ok = converged | (
                (rms < self.gate_residual_factor * self.config.commit_rms_m) & (n_icp > 0))
        else:
            frame.tracking_map_ok = converged
        if self.recover_after > 0:
            self._conv_pending.append((HostReadback(converged), curr))
        frame.update_transform_matrix(curr)
        self._push_pose(curr)

    def _push_pose(self, w2c):
        self._prev_prev_w2c = self._prev_w2c
        self._prev_w2c = w2c.to(torch.float32)
