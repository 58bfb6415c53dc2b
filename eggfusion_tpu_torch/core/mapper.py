"""Mapping backend: keyframing, surfel spawning, fusion orchestration and
sliding-window map optimization (port of `eggfusion_tpu/core/mapper.py`).

`MapperConfig`, Adam and the losses, `KeyFrame` (device or host storage) /
`KeyFrameManager`, the keyframe-map NaN check, and in `Mapping` the
per-frame `map_update` (with the model view at 1/`Tracking.model_view_down`
and the settled fuse-only frame of `Mapping.settled_skip`), `opt_step`,
spawn sampling, the binning cache, `mapping`, the adaptive model cap, map
maintenance (prune + compact), the map's moves between the rungs that
`self.ladder` (`core/capacity.py`) decides, the amortized and burst
optimization schedules, the window-batched step across devices
(`System.mesh_devices`, `parallel.mesh`), the global keyframe optimization
of `finish` and the full model render of the evaluations.

The JAX module's programs (`map_update`, `opt_step`, `bin_cache`,
`render_model`, map maintenance's `prune` and `compact`) run through the
system's program cache (`utils.graphs`): on CUDA one captured graph per key
and rung tag, the map and the Adam moments their state, updated in place in
one set of buffers per rung. A rung's programs are captured when the map
first stands on it (`capture_rung`, the JAX module's bucket compile), or
ahead of it by `precompile_ladder`; leaving a rung drops its programs and
those of its work rungs. Under a mesh the window-batched step runs as
`parallel.mesh`'s programs: one per device holding window members, and the
reduction with Adam on the first device, captured when a member joins the
window (`_prepare_window_step`). The spawn and tile-subset draws are made
outside the programs and passed in.

Device scalars the host needs (fusion stats and the tile renderer's binning
counters, losses, pose deltas, map counts) are read `count_lag` frames late
(`utils.device.Lagged`), as in the JAX module. The map is updated in place
where the JAX code donates it.

`mapping` runs its phases under the spans "map_update" (the rung, the
update program and its lagged reads), "maintain" (prune, compaction) and
"window_opt" (the window's members, keyframe decisions and the
optimization's steps) of `utils/trace.py`; a read that blocks the host runs
under "readback".
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from eggfusion_tpu_torch.core import surfels as sf
from eggfusion_tpu_torch.core.capacity import CapacityLadder
from eggfusion_tpu_torch.ops import fusion
from eggfusion_tpu_torch.ops import raster_tile as rt
from eggfusion_tpu_torch.utils import trace
from eggfusion_tpu_torch.utils.device import HostReadback, Lagged
from eggfusion_tpu_torch.utils.graphs import Programs


class MapperConfig(NamedTuple):
    """Static mapping configuration (see the JAX class for each field)."""

    local_map_iter: int = 3
    local_map_iter_init: int = 20
    final_global_opt_iter: int = 60
    add_opacity_thres: float = 0.8
    add_depth_thres: float = 0.05
    sample_ratio: float = 0.025
    sample_ratio_init: float = 0.2
    init_scale_ratio: float = 2.0
    fusion_dist_thres: float = 0.03
    sw_optimize_freq: int = 6
    sw_add_freq: int = 3
    color_weight: float = 1.0
    depth_weight: float = 1.0
    normal_weight: float = 1.0
    reg_weight: float = 10.0
    reg_weight_n: float = 1.0
    stable_confidence: float = 10.0
    spawn_cap: int = 32768
    spawn_cap_init: int = 262144
    border_pad: int = 7
    prune_freq: int = 30
    prune_max_age: int = 30
    compact_frag: float = 0.125
    opt_schedule: str = "amortized"
    opt_tile_fraction: float = 1.0
    opt_step_scale: float = 1.0


OPT_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

# what `Mapping.mapping` returns on a settled fuse-only frame
# (Mapping.settled_skip): the system keeps the previous tracking model view
KEEP_MODEL_MAP = "__keep_model_map__"

# the tile renderer's binning counters of a frame (`take_render_counts`),
# each the renders' `bin_stats` (`ops/raster_tile.py::_bin_entries`): the
# map update's model render, and with `_opt` the window optimization's steps
RENDER_COUNTS = ("binned_entries", "tail_entries", "max_run")


def _adam_init(params: dict) -> dict:
    return {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in params.items()}


def _adam_update(params: dict, grads: dict, moments: dict, step: torch.Tensor, lrs: dict):
    """torch.optim.Adam semantics (lr per group, betas (0.9, 0.999), eps
    1e-8); `step` is a device scalar, so nothing here syncs."""
    new_params, new_moments = {}, {}
    t = step.to(torch.float32) + 1.0
    for k, p in params.items():
        g = grads[k]
        m, v = moments[k]
        m = ADAM_B1 * m + (1 - ADAM_B1) * g
        v = ADAM_B2 * v + (1 - ADAM_B2) * g * g
        mhat = m / (1 - torch.pow(ADAM_B1, t))
        vhat = v / (1 - torch.pow(ADAM_B2, t))
        new_params[k] = p - lrs[k] * mhat / (torch.sqrt(vhat) + ADAM_EPS)
        new_moments[k] = (m, v)
    return new_params, new_moments


def _masked_mean(x, mask):
    num = torch.sum(torch.where(mask, x, torch.zeros_like(x)))
    den = torch.clamp(torch.sum(mask.to(torch.float32)) * (x.numel() / mask.numel()), min=1.0)
    return num / den


def _safe_norm(x, dim=None, eps=1e-12):
    """sqrt(sum(x^2) + eps): finite gradient at ||x|| = 0."""
    if dim is None:
        return torch.sqrt(torch.sum(x * x) + eps)
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def compute_image_loss(render_out: dict, kf: dict, mcfg: MapperConfig, pix_mask=None):
    """Masked L1 color + L1 depth + (1 - cosine) normal of one keyframe."""
    est_color = render_out["color"]
    est_depth = render_out["depth"]
    est_normal = render_out["normal"]
    mask = (kf["rgb_mask"] & kf["geo_mask"])[..., 0]
    if pix_mask is not None:
        mask = mask & pix_mask
    m3 = mask[..., None]
    color_loss = _masked_mean(torch.abs(kf["color"] - est_color), m3)
    depth_loss = _masked_mean(torch.abs(kf["depth"] - est_depth), mask[..., None])
    cos = torch.sum(kf["normal"] * est_normal, dim=-1) / (
        _safe_norm(kf["normal"], dim=-1) * _safe_norm(est_normal, dim=-1))
    cos = torch.clamp(cos, -1 + 1e-6, 1 - 1e-6)
    normal_loss = _masked_mean(torch.abs(1.0 - cos), mask)
    return (mcfg.color_weight * color_loss + mcfg.depth_weight * depth_loss
            + mcfg.normal_weight * normal_loss)


def compute_reg_loss(s: sf.SurfelMap, geo_snapshot: dict, mcfg: MapperConfig):
    """Drift regularizer vs the round-start geometry (global L2 position
    norm + masked-mean normal cosine), pre-weighted by `reg_weight`."""
    reg_pos = _safe_norm(geo_snapshot["position"] - s.xyz)
    ncos = torch.sum(geo_snapshot["normal"] * s.get_normal(), dim=0)
    ncos = torch.clamp(ncos, -1 + 1e-6, 1 - 1e-6)
    reg_norm = _masked_mean(torch.abs(1.0 - ncos), s.active)
    return mcfg.reg_weight * (reg_pos + mcfg.reg_weight_n * reg_norm)


def compute_loss(render_out: dict, kf: dict, s: sf.SurfelMap, geo_snapshot: dict,
                 mcfg: MapperConfig, pix_mask=None):
    """Full mapping loss = image terms + drift regularizer."""
    return compute_image_loss(render_out, kf, mcfg, pix_mask) + compute_reg_loss(s, geo_snapshot, mcfg)


def _finite_fractions(kfm: dict) -> dict:
    """The share of finite values of each keyframe map (device scalars)."""
    return {k: torch.mean(torch.isfinite(v.to(torch.float32)).to(torch.float32)) for k, v in kfm.items()}


def _check_nan_maps(kfm: dict, uid) -> None:
    """Raise on a keyframe map holding a NaN or an infinity (one host read
    per map: `System.check_nan` is a debug mode)."""
    for k, frac in _finite_fractions(kfm).items():
        if float(frac) < 1.0:
            raise FloatingPointError(f"non-finite values in keyframe uid={uid} map '{k}'")


def _work_state(s: sf.SurfelMap, moments: dict, geo: dict, n: int):
    """The map, the Adam moments and the geometry snapshot as views of their
    leading `n` slots (themselves when that is every slot): a write through
    them writes the whole."""
    if n >= s.capacity:
        return s, moments, geo
    return (sf.prefix(s, n), {k: (m[..., :n], v[..., :n]) for k, (m, v) in moments.items()},
            {k: g[..., :n] for k, g in geo.items()})


def _pad_binning(b: rt.Binning, n: int) -> rt.Binning:
    """Binning `b` of a map's leading slots as the binning of its first `n`
    (at least as many): the back-map padded with rows of -1, slots with no
    entries, as every slot past the watermark."""
    bm = b.back_map
    return b._replace(back_map=torch.cat([bm, bm.new_full((n - bm.shape[0], bm.shape[1]), -1)]))


def _geo_snapshot(s: sf.SurfelMap) -> dict:
    """Round-start geometry for the drift regularizer (fresh tensors: the
    optimizer updates the map in place)."""
    with torch.no_grad():
        return {"position": s.xyz.clone(), "normal": s.get_normal()}


def _relative_pose_mag(w2c_a, w2c_b):
    """[rotation angle deg, translation dist] between two poses as ONE (2,)
    device tensor."""
    a = torch.linalg.inv_ex(w2c_a)[0]
    b = torch.linalg.inv_ex(w2c_b)[0]
    R = a[:3, :3].T @ b[:3, :3]
    cos_theta = torch.clamp((R[0, 0] + R[1, 1] + R[2, 2] - 1) / 2, -1, 1)
    dR = torch.rad2deg(torch.arccos(cos_theta))
    dt = torch.linalg.vector_norm(a[:3, 3] - b[:3, 3])
    return torch.stack([dR, dt])


class RandomSource:
    """The mapper's random draws: per-pixel spawn uniforms (one (H, W) draw
    per frame time) and per-step tile-subset uniforms. Each draw reseeds a
    device `torch.Generator` from (seed, counter), mirroring the JAX
    module's `fold_in(key, counter)`: the same counter gives the same draw.
    A test may substitute any object with these two methods."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.seed = int(seed)
        self._gen = torch.Generator(device=self.device)

    def _draw(self, stream: int, counter: int, shape) -> torch.Tensor:
        self._gen.manual_seed((self.seed * 1_000_003 + stream * 7_919 + int(counter)) % (1 << 62))
        return torch.rand(shape, generator=self._gen, device=self.device)

    def spawn(self, time: int, height: int, width: int) -> torch.Tensor:
        return self._draw(1, time, (height, width))

    def tiles(self, step: int, n_tiles: int) -> torch.Tensor:
        return self._draw(2, step, (n_tiles,))


class KeyFrame:
    """Snapshot of a frame and its maps. `storage` "device" keeps copies of
    the maps on the frame's device (the frame's own belong to the programs
    that made them, whose next call overwrites them); "host"
    (`System.keyframe_storage: host`, for long sequences) keeps numpy copies
    that `device_maps()` uploads on demand."""

    def __init__(self, frame, frame_map: dict, time: int, fid: int, storage: str = "device"):
        self.fid = fid
        self.time = time
        self.uid = frame.uid
        self.w2c = frame.w2c_matrix()
        self.intr = frame.intr
        self.width, self.height = frame.width, frame.height
        maps = {
            "color": frame_map["color_map"],
            "depth": frame_map["depth_map"],
            "normal": frame_map["normal_map_c"],
            "rgb_mask": frame_map["rgb_mask"],
            "geo_mask": frame_map["geo_mask"],
        }
        self.storage = storage
        self.device = frame.intr.device
        if storage == "host":
            with trace.waiting("readback"):
                self.maps = {k: v.cpu().numpy() for k, v in maps.items()}
        else:
            self.maps = {k: v.clone() for k, v in maps.items()}

    def device_maps(self) -> dict:
        if self.storage == "host":
            return {k: torch.as_tensor(v, device=self.device) for k, v in self.maps.items()}
        return self.maps


class KeyFrameManager:
    """Keyframe policy: accept when rotation > check_keyframe_R deg or
    translation > check_keyframe_t vs the previous keyframe; frame 0
    always. The pose delta is observed each frame and consumed `check_lag`
    frames later (async copy); holds the sliding window deque."""

    def __init__(self, cfg):
        self.keyframes: dict[int, KeyFrame] = {}
        self.check_R = float(cfg.Tracking.check_keyframe_R)
        self.check_t = float(cfg.Tracking.check_keyframe_t)
        self.window_size = int(cfg.Tracking.sliding_window_size)
        self.sliding_window: deque = deque(maxlen=self.window_size)
        self.storage = str(cfg.System.get("keyframe_storage", "device"))
        self.check_lag = max(1, int(cfg.Tracking.get("keyframe_check_lag", 2)))
        self._pending_mag: deque = deque(maxlen=16)  # (time, HostReadback)

    def observe(self, frame, time: int) -> None:
        if not self.keyframes:
            return
        prev = self.keyframes[self.ids()[-1]]
        mag = _relative_pose_mag(prev.w2c, frame.w2c_matrix())
        self._pending_mag.append((time, HostReadback(mag)))

    def _accept(self, kf) -> None:
        self.keyframes[kf.uid] = kf
        self._pending_mag.clear()  # the deltas to the previous keyframe

    def check_keyframe(self, frame, frame_map, time: int) -> bool:
        kf = KeyFrame(frame, frame_map, time, len(self.keyframes), self.storage)
        if time == 0 or not self.keyframes:
            self._accept(kf)
            return True
        ready = [m for t, m in self._pending_mag if t <= time - self.check_lag]
        if ready:
            mag = ready[-1].numpy()
        else:  # no aged observation: synchronous check
            with trace.waiting("readback"):
                mag = _relative_pose_mag(self.keyframes[self.ids()[-1]].w2c, kf.w2c).cpu().numpy()
        if float(mag[0]) > self.check_R or float(mag[1]) > self.check_t:
            self._accept(kf)
            return True
        return False

    def ids(self):
        return sorted(self.keyframes.keys())

    def __len__(self):
        return len(self.keyframes)


class Mapping:
    """Mapping orchestrator. `programs` (a `utils.graphs.Programs`, eager
    when None) runs the per-frame programs."""

    def __init__(self, cfg, renderer, device, random_source=None, programs=None):
        m = cfg.Mapping
        self.device = torch.device(device)
        H = int(cfg.Dataset.Calibration.height)
        W = int(cfg.Dataset.Calibration.width)
        # model-view downsample (Tracking.model_view_down): the per-frame
        # spawn / tracking model render runs at 1/down resolution
        self.view_down = int(cfg.Tracking.get("model_view_down", 1))
        if self.view_down > 1 and (W % self.view_down or H % self.view_down):
            raise ValueError(f"model_view_down={self.view_down} must divide the frame size ({W}x{H})")
        # settled-frame render skip (Mapping.settled_skip): on settled frames
        # (lag-N counts flat within max(tol, tol_frac * count), slow lag-N
        # motion, no failure streak, never two in a row) the model render
        # and the spawn are skipped and tracking keeps the previous view
        self.settled_skip = bool(m.get("settled_skip", False))
        self.settled_skip_tol = int(m.get("settled_skip_tol", 64))
        self.settled_skip_tol_frac = float(m.get("settled_skip_tol_frac", 5e-4))
        self.settled_skip_max_rot = float(m.get("settled_skip_max_rot", 0.3))
        self.settled_skip_max_trans = float(m.get("settled_skip_max_trans", 0.025))
        self._skip_last = False
        self.render_skips = 0
        self.skip_frames: list[int] = []  # the frame times that skipped
        self._prev_w2c_skip = None
        self._known_motion = None  # the freshest consumed (deg, m)
        self._known_motion_time = -10
        self.mcfg = MapperConfig(
            local_map_iter=int(m.local_map_iter),
            local_map_iter_init=int(m.local_map_iter_init),
            final_global_opt_iter=int(m.final_global_opt_iter),
            add_opacity_thres=float(m.add_opacity_thres),
            add_depth_thres=float(m.add_depth_thres),
            sample_ratio=float(m.sample_ratio),
            sample_ratio_init=float(m.sample_ratio_init),
            init_scale_ratio=float(m.init_scale_ratio),
            fusion_dist_thres=float(m.fusion_dist_thres),
            sw_optimize_freq=int(m.sw_optimize_freq),
            sw_add_freq=int(m.sw_add_freq),
            color_weight=float(m.color_weight),
            depth_weight=float(m.depth_weight),
            normal_weight=float(m.normal_weight),
            reg_weight=float(m.reg_weight),
            reg_weight_n=float(m.reg_weight_n),
            spawn_cap=min(int(H * W * float(m.sample_ratio) * 2.0) + 256, H * W),
            spawn_cap_init=min(int(H * W * float(m.sample_ratio_init) * 1.5) + 256, H * W),
            opt_tile_fraction=float(m.get("opt_tile_fraction", 1.0)),
            opt_step_scale=float(m.get("opt_step_scale", 1.0)),
            prune_freq=int(m.get("prune_freq", 30)),
            prune_max_age=int(m.get("prune_max_age", 30)),
            compact_frag=float(m.get("compact_frag", 0.125)),
            opt_schedule=str(m.get("opt_schedule", "amortized")),
        )
        if not self.mcfg.opt_step_scale > 0:
            raise ValueError(f"Mapping.opt_step_scale must be > 0 (got {self.mcfg.opt_step_scale})")
        if not 0 < self.mcfg.opt_tile_fraction <= 1:
            raise ValueError(f"Mapping.opt_tile_fraction must be in (0, 1] (got {self.mcfg.opt_tile_fraction})")
        self.gate_fusion = bool(m.get("gate_fusion_on_tracking", True))
        self.gate_leak_streak = int(m.get("gate_leak_streak", 6))
        self.scfg = sf.SurfelConfig(
            capacity=int(cfg.Viewer.max_surfels_num),
            max_sh_degree=int(cfg.Surfel.max_sh_degree),
            active_sh_degree=int(cfg.Surfel.active_sh_degree),
            init_opacity=float(cfg.Surfel.init_opacity),
            alpha_p=float(cfg.Surfel.alpha_p),
            alpha_n=float(cfg.Surfel.alpha_n),
        )
        self.sw_lrs = {
            "xyz": float(m.position_lr),
            "features_dc": float(m.feature_lr),
            "features_rest": float(m.feature_lr) / 20.0,
            "opacity": float(m.opacity_lr),
            "scaling": float(m.scaling_lr),
            "rotation": float(m.rotation_lr),
        }
        self.global_lrs = {
            "xyz": float(m.final_position_lr),
            "features_dc": float(m.final_feature_lr),
            "features_rest": float(m.final_feature_lr) / 20.0,
            "opacity": float(m.final_opacity_lr),
            "scaling": float(m.final_scaling_lr),
            "rotation": float(m.final_rotation_lr),
        }
        self.renderer = renderer
        self.keyframe_manager = KeyFrameManager(cfg)
        # System.mesh_devices >= 1: the window-batched, keyframe-sharded
        # optimization step (`parallel.mesh`), the same algorithm at any
        # device count; 0 keeps the sequential per-keyframe schedule
        self.devices = None
        self._window_opt_step = None
        self._window_batch_cache = None  # (uids, WindowBatch)
        mesh_devices = int(cfg.System.get("mesh_devices", 0))
        if mesh_devices >= 1:
            from eggfusion_tpu_torch.parallel import mesh as pmesh

            self.devices = pmesh.make_mesh(mesh_devices, self.device)
        self.debug_nan = bool(cfg.System.get("check_nan", False))
        self._system_cfg = {
            "reco_normal_thres": float(cfg.System.reco_normal_threshold),
            "reco_depth_thres": float(cfg.System.reco_depth_threshold),
            "reco_opacity_thres": float(cfg.System.reco_opacity_threshold),
            "depth_min": float(cfg.System.depth_range_min),
            "depth_max": float(cfg.System.depth_range_max),
            "nlevel": int(cfg.Tracking.pyramid_level),
            "bilateral": str(cfg.System.get("bilateral_mode", "exact")),
        }
        # the map's slots (every per-frame cost is O(capacity)); the slots of
        # the frame's optimization steps, None with no step
        self.ladder = CapacityLadder.from_config(cfg, self.mcfg.spawn_cap, self.mcfg.spawn_cap_init,
                                                 prefix=self.devices is None)
        self.surfels = sf.SurfelMap.empty(self.scfg._replace(capacity=self.ladder.start()), device=self.device)
        self.frame_opt_slots = None
        self._count_hist: deque = deque(maxlen=3)  # the last counts the ladder read (settled skip)
        # read `count_lag` frames late: fusion stats and binning counters,
        # losses, pose deltas; maintenance's two counts one frame later still
        self.count_lag = self.ladder.counts.lag
        self._stats, self._losses, self._motion = (Lagged(self.count_lag) for _ in range(3))
        self._maint = Lagged(self.count_lag + 1)
        self._opt_acc = 0.0
        self._opt_cache_map: dict = {}
        self.opt_steps_total = 0
        self.opt_losses: dict[int, float] = {}
        self._opt_geo = None
        self._opt_moments = None
        self._opt_stepno = None
        self._host_step = 0  # host mirror of the Adam step counter (tile draws)
        self.fusion_stats: dict[int, tuple[int, int]] = {}
        # binning counters: the tile backend's renders bin; the update
        # render's come in the fusion stats, the opt steps' are summed on the
        # device into `_opt_bins` (3,) while `mapping` runs, and both are
        # read with the fusion stats `count_lag` frames later
        self._count_renders = self.renderer.backend == "pallas"
        self._opt_bins = None
        self._render_counts: list = []  # the counters read, not yet taken
        self._adaptive_cap = self.renderer.adaptive_model_cap
        self.model_cap = self.renderer.raster_cap if self._adaptive_cap else 0
        self._occ_streak = 0
        self.cap_switches: list[tuple[int, int]] = []
        if self._adaptive_cap:
            capsub = self.renderer.model_cap_min // rt.N_SUB
            near = capsub * 3 // 4
            ceiling = near + (capsub - near) * rt.TAIL_STRIDE
            self._occ_down = int(ceiling * 0.80)
            self._occ_up = int(ceiling * 0.96)
            self._occ_streak_need = 20
        self.time = 0
        self.random = random_source or RandomSource(int(cfg.System.get("seed", 0)), self.device)
        self.use_tile_subset = (self.mcfg.opt_tile_fraction < 1.0 and self.renderer.backend == "pallas")
        # the program cache: the per-frame programs, the rungs whose programs
        # are captured, the Adam buffers of each (schedule, rung) and the maps
        # `precompile_ladder` allocated ahead for the rungs above (`maps_ahead`)
        self.programs = programs or Programs(self.device, graphs=False)
        self._p_update = self.programs.program("map_update", self._map_update_program)
        self._p_opt = self.programs.program("opt_step", self._opt_step_program)
        self._p_bin = self.programs.program("bin_cache", self._bin_cache_program)
        self._p_render = self.programs.program("render_model", self._render_program)
        self._p_prune = self.programs.program("prune", self._prune_program)
        self._p_compact = self.programs.program("compact", self._compact_program)
        if self.devices is not None:
            from eggfusion_tpu_torch.parallel import mesh as pmesh

            self._window_opt_step = pmesh.make_window_opt_step(
                renderer.render_at, self.mcfg, self.devices, opt_cap=renderer.opt_raster_cap, programs=self.programs)
        self._captured_rungs: set = set()
        self._adam_bufs: dict = {}  # (schedule, capacity) -> (moments, step)
        self.maps_ahead: dict = {}  # capacity -> empty SurfelMap
        self.capture_hooks: list = []  # hook(s, frame_map, w2c, intr, width, height)

    # ---------------------------------------------------------- programs --

    def map_update(self, s: sf.SurfelMap, frame_map: dict, w2c, intr, time, width: int,
                   height: int, first: bool, full_post: bool, model_cap: int = 0, conv=None,
                   down: int = 1, do_render: bool = True, spawn_u=None):
        """Per-frame map update: fuse, render the model once at 1/`down`
        resolution (full with `full_post`, else geometry-only), then spawn
        where the model is thin or in front of the measurement (the mask
        computed on the 1/down grid and nearest-upsampled; fusion stays
        full-res). `do_render=False` is the settled fuse-only frame: no
        render, no spawn. `time` is the frame time (an int or an int32
        device scalar); `spawn_u` the frame's spawn uniforms, drawn here
        when None. Returns (s, model_map or None, stats_vec (6,) int32
        [fused, error, occupancy or -1, the model render's `bin_stats` (0 0 0
        with no render, -1 -1 -1 with a backend that does not bin)] or
        None)."""
        from eggfusion_tpu_torch.system import postprocess_model_map

        mcfg, scfg, sys_cfg = self.mcfg, self.scfg, self._system_cfg
        depth = frame_map["depth_map"]
        stats_vec = None
        model_map = None
        if conv is None:
            conv = torch.ones((), dtype=torch.bool, device=self.device)
        if not first:
            geo_gate = frame_map["geo_mask"] & conv
            s, stats = fusion.fuse_frame(
                s, w2c, intr, frame_map["vertex_map_w"], frame_map["normal_map_w"],
                frame_map["color_map"], depth, geo_gate, mcfg.fusion_dist_thres, scfg)
            if not do_render:
                s = sf.update_stability(s, mcfg.stable_confidence)
                no_occ = torch.full((), -1, dtype=torch.int32, device=self.device)
                return s, None, torch.cat([torch.stack([stats.fused_pixels, stats.error_pixels, no_occ]),
                                           torch.zeros(3, dtype=torch.int32, device=self.device)])
            model = self.renderer.render_at(
                sf.render_params(s), w2c, intr / down if down > 1 else intr, width // down, height // down,
                geom_only=not full_post, need_grad=False, cap=model_cap or None,
                with_occupancy=self._adaptive_cap, with_stats=True)
            occ = model.pop("max_occupancy", torch.full((), -1, dtype=torch.int32, device=self.device))
            bins = model.pop("bin_stats", None)
            if bins is None:
                bins = torch.full((3,), -1, dtype=torch.int32, device=self.device)
            stats_vec = torch.cat([torch.stack([stats.fused_pixels, stats.error_pixels, occ.to(torch.int32)]),
                                   bins])
            depth_d = depth[::down, ::down] if down > 1 else depth
            opacity_mask = model["opacity"] < mcfg.add_opacity_thres
            depth_err = model["depth"] - depth_d
            sample_mask = (opacity_mask | (depth_err > mcfg.add_depth_thres)) & (depth_d > 0) & conv
            if down > 1:  # nearest-upsample: spawn picks full-res pixels
                sample_mask = sample_mask.repeat_interleave(down, dim=0).repeat_interleave(down, dim=1)
            ratio = mcfg.sample_ratio
            cap = mcfg.spawn_cap
            if full_post:
                rendered = {
                    "render_color": model["color"],
                    "render_depth": model["depth"],
                    "render_normal": model["normal"],
                    "render_opacity": model["opacity"],
                }
                model_map = postprocess_model_map(
                    rendered, frame_map, intr, w2c, sys_cfg["reco_normal_thres"],
                    sys_cfg["reco_depth_thres"], sys_cfg["reco_opacity_thres"],
                    sys_cfg["depth_min"], sys_cfg["depth_max"], sys_cfg["nlevel"], down=down,
                    bilateral=sys_cfg["bilateral"])
        else:
            sample_mask = depth > 0
            ratio = mcfg.sample_ratio_init
            cap = mcfg.spawn_cap_init
        batch = self._sample_spawn(frame_map, sample_mask[..., 0], ratio, cap, time, intr, spawn_u)
        s = sf.append_surfels(s, batch, time, scfg.init_opacity)
        s = sf.update_stability(s, mcfg.stable_confidence)
        return s, model_map, stats_vec

    def _sample_spawn(self, frame_map, sample_mask, ratio: float, cap: int, time, intr, u=None):
        """Bernoulli per-pixel spawn selection at probability `ratio` with a
        border exclusion, compacted to at most one pixel per group of G
        consecutive pixels (the max-u selected one) into a SpawnBatch. `u`:
        the uniforms, drawn for `time` when None."""
        mcfg, scfg = self.mcfg, self.scfg
        depth = frame_map["depth_map"][..., 0]
        normal = frame_map["normal_map_w"]
        H, W = depth.shape
        pad = mcfg.border_pad
        border = torch.zeros((H, W), dtype=torch.bool, device=self.device)
        border[pad:-pad, pad:-pad] = True
        invalid_normal = torch.all(normal == 0, dim=-1)
        mask = sample_mask & border & ~invalid_normal

        if u is None:
            u = self.random.spawn(time, H, W).to(self.device)
        sel = mask & (u < ratio)
        HW = H * W
        G = -(-HW // cap)
        u_flat = torch.where(sel, u, torch.full_like(u, -1.0)).reshape(-1)
        u_flat = torch.cat([u_flat, torch.full((cap * G - HW,), -1.0, device=self.device)])
        groups = u_flat.reshape(cap, G)
        gmax, g_arg = torch.max(groups, dim=1)
        valid = gmax >= 0.0
        idx = torch.clamp(torch.arange(cap, device=self.device) * G + g_arg, max=HW - 1)

        fx, fy = intr[0], intr[1]
        d = depth.reshape(-1)[idx]
        p = frame_map["vertex_map_w"].reshape(-1, 3)[idx]
        n = normal.reshape(-1, 3)[idx]
        c = frame_map["color_map"].reshape(-1, 3)[idx]
        dist = torch.stack([mcfg.init_scale_ratio * d / fx, mcfg.init_scale_ratio * d / fy,
                            torch.zeros_like(d)], dim=-1)
        s2p = torch.clamp((d * scfg.alpha_p) ** 2, min=1e-12)
        s2n = torch.clamp((d * scfg.alpha_n) ** 2, min=1e-12)
        eta = torch.cat([p / s2p[:, None], n / s2n[:, None]], dim=-1)
        return sf.SpawnBatch(xyz=p, normal=n, color=c, dist=dist, eta=eta,
                             sigma2=torch.stack([s2p, s2n], dim=-1), valid=valid)

    def opt_step(self, s: sf.SurfelMap, moments: dict, step: torch.Tensor, kf: dict, w2c, intr,
                 geo_snapshot: dict, lrs: dict, width: int, height: int, cache=None):
        """One render + loss + Adam step on one keyframe. The surfel fields
        are updated in place; returns (s, moments, step + 1, loss)."""
        tile_u = self._tile_draw(width, height)
        return self._opt_step_body(s, moments, step, kf, w2c, intr, geo_snapshot, lrs, width, height,
                                   cache, tile_u)[:4]

    def _tile_draw(self, width: int, height: int):
        """The next step's tile-subset uniforms (None without a subset); the
        host step counter advances."""
        u = None
        if self.use_tile_subset:
            u = self.random.tiles(int(self._host_step), rt.n_tiles_static(width, height)).to(self.device)
        self._host_step += 1
        return u

    def _opt_step_body(self, s, moments, step, kf, w2c, intr, geo_snapshot, lrs, width, height, cache, tile_u):
        """`opt_step` given the tile-subset uniforms `tile_u`; returns also
        the render's `bin_stats` (-1 -1 -1 with a backend that does not
        bin)."""
        params = {k: getattr(s, k).detach().requires_grad_(True) for k in OPT_FIELDS}
        tile_keep = pix_mask = None
        if tile_u is not None:
            tile_keep = tile_u < self.mcfg.opt_tile_fraction
            pix_mask = rt.tile_pixel_mask(tile_keep, width, height)
        with torch.enable_grad():
            s2 = s.replace(**params)
            out = self.renderer.render_at(sf.render_params(s2), w2c, intr, width, height,
                                          cache=cache, tile_keep=tile_keep,
                                          cap=self.renderer.opt_raster_cap, with_stats=True)
            bins = out.pop("bin_stats", None)
            if bins is None:
                bins = torch.full((3,), -1, dtype=torch.int32, device=self.device)
            loss = compute_loss(out, kf, s2, geo_snapshot, self.mcfg, pix_mask)
            grads = dict(zip(OPT_FIELDS, torch.autograd.grad(loss, [params[k] for k in OPT_FIELDS])))
        with torch.no_grad():
            new_params, moments = _adam_update({k: v.detach() for k, v in params.items()}, grads,
                                               moments, step, lrs)
            for k in OPT_FIELDS:
                getattr(s, k).copy_(new_params[k])
        return s, moments, step + 1, loss.detach(), bins

    def render_model(self, s: sf.SurfelMap, w2c, intr, width: int, height: int) -> dict:
        """A full forward render of the map (no gradient) at the renderer's
        `raster_cap`: the re-anchor of recovery and resume, and the
        evaluations."""
        with torch.no_grad():
            return self.renderer.render_at(sf.render_params(s), w2c, intr, width, height, need_grad=False)

    def bin_cache(self, s: sf.SurfelMap, w2c, intr, width: int, height: int):
        """Tile binning of the map from a keyframe, at the optimization cap."""
        with torch.no_grad():
            return self.renderer.precompute_cache(sf.render_params(s), w2c, intr, width, height,
                                                  cap=self.renderer.opt_raster_cap)

    # the program bodies: `fn(state, inputs, **static)` of `utils.graphs`;
    # the map and the Adam state are written back into their own buffers

    def _map_update_program(self, s, x, *, first, full_post, model_cap, down, do_render, width, height):
        # a shallow copy: `map_update` rebinds fields of the map it is given
        s2, model_map, stats_vec = self.map_update(
            dataclasses.replace(s), x["frame_map"], x["w2c"], x["intr"], x["time"], width, height, first,
            full_post, model_cap, x["conv"], down, do_render, x["spawn_u"])
        sf.assign(s, s2)
        return model_map, stats_vec

    def _opt_step_program(self, st, x, *, width, height, lrs):
        s, moments, step = st
        _, new_moments, _, loss, bins = self._opt_step_body(s, moments, step, x["kf"], x["w2c"], x["intr"],
                                                            x["geo"], dict(lrs), width, height, x["cache"],
                                                            x["tile_u"])
        with torch.no_grad():
            for k in OPT_FIELDS:
                for buf, new in zip(moments[k], new_moments[k]):
                    buf.copy_(new)
            step.add_(1)
        return loss, bins

    def _bin_cache_program(self, s, x, *, width, height):
        return self.bin_cache(s, x["w2c"], x["intr"], width, height)

    def _render_program(self, s, x, *, width, height):
        return self.render_model(s, x["w2c"], x["intr"], width, height)

    def _prune_program(self, s, x, *, max_age):
        """`fusion.prune_unstable` at frame time `x` (an int32 device scalar)
        into the map's buffers; returns its (count, active count)."""
        sf.assign(s, fusion.prune_unstable(s, self.scfg, x, max_age))
        return s.count.clone(), s.num_active()

    def _compact_program(self, s, _x):
        sf.assign(s, sf.compact_surfels(s))

    # the program calls

    def _update_args(self, frame_map, w2c, intr, width, height, first, full_post, conv, do_render, model_cap):
        static = dict(first=first, full_post=full_post, model_cap=model_cap, down=self.view_down,
                      do_render=do_render, width=width, height=height)
        spawn_u = None
        if first or do_render:
            spawn_u = self.random.spawn(self.time, height, width).to(self.device)
        x = {"frame_map": frame_map, "w2c": w2c, "intr": intr, "time": self._time_tensor(),
             "conv": conv, "spawn_u": spawn_u}
        return static, x

    def _time_tensor(self):
        return torch.full((), self.time, dtype=torch.int32, device=self.device)

    def render(self, w2c, intr, width: int, height: int) -> dict:
        """`render_model` of the current map through its program: the
        outputs belong to the program (the next render overwrites them)."""
        return self._p_render({"width": width, "height": height}, self.surfels, {"w2c": w2c, "intr": intr},
                              rung=self.surfels.capacity)

    def _binning(self, kf):
        """`bin_cache` of the current map's work rung from keyframe `kf`
        through its program (the program's outputs)."""
        n = self.ladder.opt_slots
        return self._p_bin({"width": kf.width, "height": kf.height}, sf.prefix(self.surfels, n),
                           {"w2c": kf.w2c, "intr": kf.intr}, rung=n)

    def _adam_buffers(self, schedule: str, s=None):
        """The persistent Adam state (moments, step) of `schedule` ("window":
        the amortized steps; "batch": `_optimize`) at the capacity of map
        `s` (default: the current map), allocated at its first request."""
        s = self.surfels if s is None else s
        key = (schedule, s.capacity)
        buf = self._adam_bufs.get(key)
        if buf is None:
            buf = self._adam_bufs[key] = (_adam_init({k: getattr(s, k) for k in OPT_FIELDS}),
                                          torch.zeros((), dtype=torch.int32, device=self.device))
        return buf

    def _adam_state(self, schedule: str):
        """`_adam_buffers` reset to the state `_adam_init` makes."""
        moments, step = self._adam_buffers(schedule)
        for pair in moments.values():
            for t in pair:
                t.zero_()
        step.zero_()
        return moments, step

    def _opt(self, schedule: str, kf, kfm: dict, geo: dict, lrs: dict, cache):
        """One `opt_step` on keyframe `kf` through its program, on the Adam
        state of `schedule` and the work rung's slots of the map, the
        moments and the geometry snapshot `geo`; returns the loss (the
        program's). A step that bins for itself (no `cache`) adds its
        binning's counters to the frame's."""
        moments, step = self._adam_buffers(schedule)
        n = self.ladder.opt_slots
        s, moments, geo = _work_state(self.surfels, moments, geo, n)
        x = {"kf": kfm, "w2c": kf.w2c, "intr": kf.intr, "geo": geo, "cache": cache,
             "tile_u": self._tile_draw(kf.width, kf.height)}
        static = {"width": kf.width, "height": kf.height, "lrs": tuple(sorted(lrs.items()))}
        loss, bins = self._p_opt(static, (s, moments, step), x, rung=n)
        if cache is None:
            self._note_opt_renders(bins, 1)
        return loss

    def capture_rung(self, frame_map: dict, w2c, intr, width: int, height: int, s=None,
                     first: bool = False) -> None:
        """Capture now every program the frame loop runs on the rung of map
        `s` (default: the current map), from a frame's maps and pose: the
        map update of each variant the configuration can take (each model
        cap, the settled fuse-only frame, the burst schedule's geometry-only
        frame), the binning and the opt step of the schedule on the work
        rung and on each rung above it below the capacity, the model render
        and the hooks' programs; with `first`, frame 0's map update and
        optimization too. Nothing runs on `s`."""
        if not self.programs.enabled:
            return
        s = self.surfels if s is None else s
        rung = s.capacity
        conv = torch.ones((), dtype=torch.bool, device=self.device) if self.gate_fusion else None
        caps = {self.model_cap}
        if self._adaptive_cap:
            caps = {self.renderer.raster_cap, self.renderer.model_cap_min}
        amortized = self.mcfg.opt_schedule == "amortized"
        variants = [(False, True, True, c) for c in sorted(caps)]
        if not amortized:
            variants += [(False, False, True, c) for c in sorted(caps)]
        if self.settled_skip:
            variants += [(False, True, False, c) for c in sorted(caps)]
        if first:
            variants.append((True, True, True, self.model_cap))
        for is_first, full_post, do_render, cap in variants:
            static, x = self._update_args(frame_map, w2c, intr, width, height, is_first, full_post,
                                          None if is_first else conv, do_render, cap)
            self._p_update.prepare(static, s, x, rung=rung)
        view = {"width": width, "height": height}
        self._p_render.prepare(view, s, {"w2c": w2c, "intr": intr}, rung=rung)
        if self.mcfg.prune_freq > 0:
            self._p_prune.prepare({"max_age": self.mcfg.prune_max_age}, s, self._time_tensor(), rung=rung)
            self._p_compact.prepare({}, s, None, rung=rung)
        # under a mesh the window step's programs are captured as members
        # join the window (`_prepare_window_step`): their keys follow them
        if self.devices is None:
            kfm = {"color": frame_map["color_map"], "depth": frame_map["depth_map"],
                   "normal": frame_map["normal_map_c"], "rgb_mask": frame_map["rgb_mask"],
                   "geo_mask": frame_map["geo_mask"]}
            u = (torch.zeros(rt.n_tiles_static(width, height), device=self.device)
                 if self.use_tile_subset else None)
            static = {**view, "lrs": tuple(sorted(self.sw_lrs.items()))}
            geo = _geo_snapshot(s)
            # in a fixed order: a set's would follow the process's string hash
            # seed, and so would the order of the captures and their memory
            schedules = ["window" if amortized else "batch"]
            now = list(dict.fromkeys(schedules + (["batch"] if first else [])))
            # the work rung and each work rung above it, as the frame loop runs
            # them: a capture on a map grown with the run's keyframes and
            # binnings would add its transient (a clone of the state, the
            # step's intermediates) to the device's peak
            n0 = self.ladder.opt_slots if s is self.surfels else rung
            for n in [n0] + [r for r in self.ladder.work_tags(rung) if r > n0]:
                cache = self._p_bin(view, sf.prefix(s, n), {"w2c": w2c, "intr": intr}, rung=n)
                for schedule in now if n == n0 else schedules:
                    moments, step = self._adam_buffers(schedule, s)
                    sw, moments, gw = _work_state(s, moments, geo, n)
                    x = {"kf": kfm, "w2c": w2c, "intr": intr, "geo": gw, "cache": cache, "tile_u": u}
                    self._p_opt.prepare(static, (sw, moments, step), x, rung=n)
        for hook in self.capture_hooks:
            hook(s, frame_map, w2c, intr, width, height)
        self._captured_rungs.add(rung)

    def precompile_ladder(self, frame_map: dict, w2c, intr, width: int, height: int) -> int:
        """Allocate an empty map on every ladder rung above the current
        capacity and capture its programs (`System.precompile_ladder`, off
        by default as in the JAX package): growing onto such a rung moves
        the map into those buffers and captures nothing. Returns the number
        of rungs."""
        if not (self.programs.enabled and self.ladder.bucketing):
            return 0
        n = 0
        for cap in self.ladder.rungs:
            if cap > self.surfels.capacity and cap not in self.maps_ahead:
                m = self.maps_ahead[cap] = sf.SurfelMap.empty(self.scfg._replace(capacity=cap), device=self.device)
                self.capture_rung(frame_map, w2c, intr, width, height, s=m)
                n += 1
        return n

    # -------------------------------------------------------------- host --

    def fit_capacity(self) -> None:
        """Move the map to the frame's capacity (`CapacityLadder.plan`); a
        work-rung move drops the programs of the rung it leaves and pads the
        cached binnings (up) or drops them (down: they index slots past it)."""
        plan = self.ladder.plan(self.time, self.surfels.capacity, self._watermark)
        self._count_hist.extend(plan.read)
        if plan.invalidate:
            self._move_to_rung(plan.capacity)
        new, old = plan.opt_slots, plan.work_from
        if new != old:
            for p in (self._p_opt, self._p_bin):
                p.drop(old)
            self._opt_cache_map = ({uid: None if b is None else _pad_binning(b, new)
                                    for uid, b in self._opt_cache_map.items()} if new > old else {})

    def _watermark(self) -> int:
        with trace.waiting("readback"):
            return int(self.surfels.count)

    def _move_to_rung(self, capacity: int) -> None:
        """Grow or shrink the map to `capacity` (into the buffers
        `precompile_ladder` allocated for it, if any), drop the programs and
        Adam buffers of the rung it leaves, and the state of the old slots
        (also when the map stays, at the maximum)."""
        old = self.surfels
        if capacity != old.capacity:
            dst = self.maps_ahead.pop(capacity, None)
            with torch.no_grad():
                if dst is not None:
                    self.surfels = sf.resize_into(old, dst)
                elif capacity > old.capacity:
                    self.surfels = sf.grow_surfels(old, capacity)
                else:
                    self.surfels = sf.shrink_surfels(old, capacity)
            self._leave_rung(old.capacity)
        self._invalidate_capacity_state()

    def _leave_rung(self, capacity=None) -> None:
        """Forget the programs and Adam buffers of rung `capacity` and its work
        rungs' programs; of every rung, and the maps allocated ahead, with None."""
        self.programs.drop(capacity)
        if capacity is None:
            self._captured_rungs, self._adam_bufs, self.maps_ahead = set(), {}, {}
            return
        for r in self.ladder.work_tags(capacity):
            self._p_opt.drop(r)
            self._p_bin.drop(r)
        self._captured_rungs.discard(capacity)
        self._adam_bufs = {k: v for k, v in self._adam_bufs.items() if k[1] != capacity}

    def _invalidate_capacity_state(self) -> None:
        """A capacity change or a compaction moves slots: the cached
        binnings and the Adam moments refer to the old ones."""
        self._opt_cache_map = {}
        self._opt_moments = None

    def _skip_render_ok(self, fail_streak: int) -> bool:
        """The settledness gate of the fuse-only frame (settled_skip), from
        the lag-N readbacks alone: the last three consumed counts within
        max(tol, tol_frac * count) of each other and fresh, a fresh motion
        reading under the slow-motion limits, no failure streak and no skip
        on the frame before. Any doubt renders."""
        if not self.settled_skip or self._skip_last or fail_streak > 0:
            return False
        h, lad = self._count_hist, self.ladder
        if len(h) < h.maxlen or lad.known_time < self.time - 3 * self.count_lag:
            return False
        tol = max(self.settled_skip_tol, int(self.settled_skip_tol_frac * lad.known_count))
        if max(h) - min(h) > tol:
            return False
        if self._known_motion is None or self._known_motion_time < self.time - 3 * self.count_lag:
            return False
        rot, trans = self._known_motion
        return rot <= self.settled_skip_max_rot and trans <= self.settled_skip_max_trans

    def _observe_motion(self, frame) -> None:
        """Settled skip's motion gate: the pose delta to the previous frame
        as an async readback, consumed `count_lag` frames later."""
        w2c_now = frame.w2c_matrix()
        if self._prev_w2c_skip is not None:
            self._motion.push(self.time, _relative_pose_mag(w2c_now, self._prev_w2c_skip))
        self._prev_w2c_skip = w2c_now
        for t, v in self._motion.ready(self.time):
            self._known_motion = (float(v[0]), float(v[1]))
            self._known_motion_time = t

    def mapping(self, frame, frame_map: dict, fail_streak: int = 0):
        """Per-frame mapping entry. Returns the postprocess model map when
        this frame's map update produced it, None on burst-schedule
        optimization frames (the caller renders after the optimization), and
        KEEP_MODEL_MAP on a settled fuse-only frame (the caller keeps the
        previous model view)."""
        first = self.time == 0
        amortized = self.mcfg.opt_schedule == "amortized"
        opt_frame = self.time % self.mcfg.sw_optimize_freq == 0
        steps0 = self.opt_steps_total
        if self._count_renders:
            self._opt_bins = torch.zeros(3, dtype=torch.int32, device=self.device)
        with trace.span("map_update"):
            self.fit_capacity()
            if self.programs.enabled and self.surfels.capacity not in self._captured_rungs:
                self.capture_rung(frame_map, frame.w2c_matrix(), frame.intr, frame.width, frame.height, first=first)
            if self.settled_skip:
                self._observe_motion(frame)
            full_post = True if amortized else not opt_frame
            leak = fail_streak >= self.gate_leak_streak > 0
            suspect = 0 < fail_streak and not leak
            conv = None
            if self.gate_fusion and not leak:
                conv = getattr(frame, "tracking_map_ok", getattr(frame, "tracking_converged", None))
            # only on fused-model-map frames: burst-schedule optimization frames
            # render after the optimization anyway
            skip = not first and full_post and self._skip_render_ok(fail_streak)
            static, x = self._update_args(frame_map, frame.w2c_matrix(), frame.intr, frame.width, frame.height,
                                          first, full_post, conv, not skip, self.model_cap)
            with torch.no_grad():
                model_map, stats_vec = self._p_update(static, self.surfels, x, rung=self.surfels.capacity)
            self._skip_last = skip
            if skip:
                self.render_skips += 1
                self.skip_frames.append(self.time)
                model_map = KEEP_MODEL_MAP
            for t, v in self._stats.ready(self.time):
                if int(v[0]) >= 0:
                    self.fusion_stats[t] = (int(v[0]), int(v[1]))
                if self._count_renders:
                    self._render_counts.append({"render_frame": t, **dict(zip(RENDER_COUNTS, map(int, v[3:6]))),
                                                **{k + "_opt": int(n) for k, n in zip(RENDER_COUNTS, v[6:9])}})
                if int(v[2]) >= 0:
                    self._observe_occupancy(int(v[2]))
            if self.ladder.bucketing or self.settled_skip:
                self.ladder.observe(self.time, self.surfels.count)

        with trace.span("maintain"):
            self._maintain_finish()
            if self.mcfg.prune_freq > 0 and self.time > 0 and self.time % self.mcfg.prune_freq == 0:
                self.maintain_map(defer=True)

        with trace.span("window_opt"):
            if self.time % self.mcfg.sw_add_freq == 0 and not suspect:
                self.keyframe_manager.sliding_window.append(
                    KeyFrame(frame, frame_map, self.time, -1, self.keyframe_manager.storage))
                if self.devices is not None and self.programs.enabled and not first:
                    self._prepare_window_step(amortized)
            if suspect:
                pass  # no keyframe decisions from a failure-streak pose
            elif opt_frame:
                self.keyframe_manager.check_keyframe(frame, frame_map, self.time)
            else:
                self.keyframe_manager.observe(frame, self.time)
            if first or not amortized:
                if opt_frame:
                    self.frame_batch_optimization(frame)
            else:
                self._amortized_opt()
        if self._count_renders:
            # frame 0 fuses and renders nothing: no fusion stats, no counters
            upd = stats_vec
            if upd is None:
                upd = torch.full((6,), -1, dtype=torch.int32, device=self.device)
                upd[3:] = 0
            stats_vec, self._opt_bins = torch.cat([upd, self._opt_bins]), None
        if stats_vec is not None:
            self._stats.push(self.time, stats_vec)
        self.frame_opt_slots = self.ladder.opt_slots if self.opt_steps_total > steps0 else None
        self.time += 1
        return model_map

    def _note_opt_renders(self, bin_stats: torch.Tensor, steps: int) -> None:
        """Add `steps` optimization renders that used a binning whose
        counters are `bin_stats` to the frame's (inside `mapping` only):
        entries and tail entries summed, `max_run` the longest."""
        acc = self._opt_bins
        if acc is not None:
            acc[:2] += steps * bin_stats[:2]
            torch.maximum(acc[2:], bin_stats[2:], out=acc[2:])

    def take_render_counts(self) -> dict:
        """The binning counters read since the last call, summed over their
        frames (`max_run`, `max_run_opt`: the longest), with `render_frames`
        the number of frames, the newest `render_frame`; {} when none was
        read."""
        recs, self._render_counts = self._render_counts, []
        if not recs:
            return {}
        out = {"render_frames": len(recs), "render_frame": recs[-1]["render_frame"]}
        for k in RENDER_COUNTS + tuple(k + "_opt" for k in RENDER_COUNTS):
            vals = [r[k] for r in recs if k in r]
            if vals:
                out[k] = max(vals) if k.startswith("max_run") else sum(vals)
        return out

    def _observe_occupancy(self, occ: int) -> None:
        """Adaptive model-render cap: drop to model_cap_min after a streak
        of healthy readings, escalate back at once near the ceiling."""
        if not self._adaptive_cap:
            return
        full = self.renderer.raster_cap
        if occ >= self._occ_up:
            self._occ_streak = 0
            if self.model_cap != full:
                self.model_cap = full
                self.cap_switches.append((self.time, full))
        elif occ < self._occ_down:
            self._occ_streak += 1
            if self.model_cap != self.renderer.model_cap_min and self._occ_streak >= self._occ_streak_need:
                self.model_cap = self.renderer.model_cap_min
                self.cap_switches.append((self.time, self.model_cap))
        else:
            self._occ_streak = 0

    def maintain_map(self, defer: bool = False) -> None:
        """Cull error-dominated / stale unstable surfels, then compact when
        fragmentation exceeds `compact_frag` of capacity. `defer` reads the
        two counts `count_lag` + 1 frames later. Prune and compact run as the
        rung's programs "prune" and "compact"."""
        with torch.no_grad():
            cnt, act = self._p_prune({"max_age": self.mcfg.prune_max_age}, self.surfels, self._time_tensor(),
                                     rung=self.surfels.capacity)
        if defer:
            self._maint.clear()  # one decision pending: a later prune's supersedes it
            self._maint.push(self.time, (cnt, act))
            return
        with trace.waiting("readback"):
            cnt, act = int(cnt), int(act)
        self._maintain_decide(cnt, act, self.time)

    def _maintain_finish(self) -> None:
        for t, (cnt, act) in self._maint.ready(self.time):
            self._maintain_decide(int(cnt), int(act), t, immediate=False)

    def adopt(self, s: sf.SurfelMap, count: int) -> None:
        """Make `s` the map (resume, reload), `count` slots in use as of the
        frame before `time`: what refers to the old map's slots is dropped."""
        self.surfels = s
        for q in (self._stats, self._losses, self._maint):
            q.clear()
        self._invalidate_capacity_state()
        self._leave_rung()
        self.ladder.forget(count, self.time, s.capacity)

    def _maintain_decide(self, count: int, n_active: int, known_time: int, immediate: bool = True) -> None:
        """Compact when fragmentation exceeds `compact_frag` of capacity;
        what is left, as of frame `known_time`, is the ladder's count
        (`CapacityLadder.maintained`, `immediate`: a direct call)."""
        if count - n_active > self.mcfg.compact_frag * self.surfels.capacity:
            with torch.no_grad():
                self._p_compact({}, self.surfels, None, rung=self.surfels.capacity)
            count = n_active
            self._invalidate_capacity_state()
        cap = self.ladder.maintained(count, known_time, self.time, self.surfels.capacity, immediate)
        if cap != self.surfels.capacity:
            self._move_to_rung(cap)

    def _window_batch(self, kfs: list):
        """The keyframes as the mesh step's batch: B = the window size
        rounded up to a multiple of the device count, padding members
        masked out; cached per window generation (the members' maps and
        poses are frozen snapshots), each shard's tensors on its device."""
        from eggfusion_tpu_torch.parallel import mesh as pmesh

        key = tuple(kf.uid for kf in kfs)
        cached = self._window_batch_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        n = len(self.devices)
        B = -(-max(self.keyframe_manager.window_size, 1, n) // n) * n
        batch = pmesh.window_batch(kfs, B, self.devices)
        self._window_batch_cache = (key, batch)
        return batch

    def _prepare_window_step(self, amortized: bool) -> None:
        """Capture the mesh's window step for the window as it now stands,
        on the Adam state of the frame loop's schedule: a new member changes
        the step's keys, and the step may first run frames later (the
        amortized schedule steps every few frames), so the frames after
        the one that fills the window capture nothing. Frame 0 optimizes
        its one-member window at once."""
        window = list(self.keyframe_manager.sliding_window)
        moments, step = self._adam_buffers("window" if amortized else "batch")
        self._window_opt_step.prepare(self.surfels, moments, step, self._window_batch(window),
                                      _geo_snapshot(self.surfels), self.sw_lrs, window[0].width, window[0].height)

    def _amortized_opt(self) -> None:
        """local_map_iter * |window| steps per sw_optimize_freq frames, run
        1-2 at a time against a rotating window member whose tile binning is
        cached for its stay in the window. Under a mesh each step renders the
        whole window batched, so the accumulator advances local_map_iter /
        sw_optimize_freq steps per frame: the same keyframe renders."""
        window = list(self.keyframe_manager.sliding_window)
        if not window:
            return
        mcfg = self.mcfg
        per_frame = mcfg.local_map_iter / mcfg.sw_optimize_freq
        if self.devices is None:
            per_frame *= len(window)
        per_frame *= mcfg.opt_step_scale
        self._opt_acc += per_frame
        n = int(self._opt_acc)
        if n == 0:
            return
        self._opt_acc -= n
        if self._opt_moments is None or self.time % mcfg.sw_optimize_freq == 0:
            self._opt_moments, self._opt_stepno = self._adam_state("window")
            self._host_step = 0
            self._opt_geo = _geo_snapshot(self.surfels)
        if self.devices is not None:
            batch = self._window_batch(window)
            for _ in range(n):
                self.surfels, self._opt_moments, self._opt_stepno, loss = self._window_opt_step(
                    self.surfels, self._opt_moments, self._opt_stepno, batch, self._opt_geo, self.sw_lrs,
                    window[0].width, window[0].height)
                if self.debug_nan and not np.isfinite(float(loss)):
                    raise FloatingPointError("NaN/Inf batched map-optimization loss")
            self._note_opt(n, loss)
            return
        rot = max(1, mcfg.sw_optimize_freq // len(window))
        kf = window[(self.time // rot) % len(window)]
        live_uids = {k.uid for k in window}
        for uid in [u for u in self._opt_cache_map if u not in live_uids]:
            del self._opt_cache_map[uid]
        if kf.uid not in self._opt_cache_map:
            # kept while the keyframe stays in the window: a copy of the
            # program's output, which the next binning overwrites
            cache = self._binning(kf)
            self._opt_cache_map[kf.uid] = None if cache is None else rt.Binning(*(t.clone() for t in cache))
        cache = self._opt_cache_map[kf.uid]
        kfm = kf.device_maps()
        if self.debug_nan:
            _check_nan_maps(kfm, kf.uid)
        for _ in range(n):
            loss = self._opt("window", kf, kfm, self._opt_geo, self.sw_lrs, cache)
            if self.debug_nan and not np.isfinite(float(loss)):
                raise FloatingPointError(f"NaN/Inf map-optimization loss at keyframe uid={kf.uid}")
        if cache is not None:
            self._note_opt_renders(cache.stats, n)
        self._note_opt(n, loss)

    def _note_opt(self, n: int, loss) -> None:
        self.opt_steps_total += n
        self._losses.push(self.time, loss)
        for t, v in self._losses.ready(self.time):
            self.opt_losses[t] = float(v)

    def _optimize(self, runs: list, lrs: dict):
        """Adam over a schedule of (keyframe, n_iters) runs; multi-step runs
        bin once."""
        geo_snapshot = _geo_snapshot(self.surfels)
        self._adam_state("batch")
        self._host_step = 0
        loss = torch.full((), float("nan"), device=self.device)
        for kf, n in runs:
            kfm = kf.device_maps()
            if self.debug_nan:
                _check_nan_maps(kfm, kf.uid)
            cache = self._binning(kf) if n > 1 else None
            if cache is not None:
                self._note_opt_renders(cache.stats, n)
            for _ in range(n):
                loss = self._opt("batch", kf, kfm, geo_snapshot, lrs, cache)
                self.opt_steps_total += 1
                if self.debug_nan and not np.isfinite(float(loss)):
                    raise FloatingPointError(f"NaN/Inf map-optimization loss at keyframe uid={kf.uid}")
        return loss.clone()

    def _optimize_batched(self, batches: list, n_steps_each: int, lrs: dict):
        """The mesh path of `_optimize`: each element of `batches` is a list
        of keyframes rendered together (one block per device) for
        `n_steps_each` Adam steps."""
        geo = _geo_snapshot(self.surfels)
        moments, step = self._adam_state("batch")
        loss = torch.full((), float("nan"), device=self.device)
        for kfs in batches:
            batch = self._window_batch(kfs)
            for _ in range(n_steps_each):
                self.surfels, moments, step, loss = self._window_opt_step(
                    self.surfels, moments, step, batch, geo, lrs, kfs[0].width, kfs[0].height)
                self.opt_steps_total += 1
                if self.debug_nan and not np.isfinite(float(loss)):
                    raise FloatingPointError("NaN/Inf batched map-optimization loss")
        return loss.clone()

    def frame_batch_optimization(self, frame):
        """local_map_iter steps on each window member (local_map_iter_init
        at frame 0); under a mesh, as many steps on the window rendered as
        one batch."""
        window = list(self.keyframe_manager.sliding_window)
        if not window:
            return float("nan")
        per_kf = self.mcfg.local_map_iter if self.time > 0 else self.mcfg.local_map_iter_init
        if self.devices is not None:
            return self._optimize_batched([window], per_kf, self.sw_lrs)
        return self._optimize([(kf, per_kf) for kf in window], self.sw_lrs)

    def keyframe_optimization(self, keyframe_num: int = -1):
        """The global keyframe optimization of `finish`:
        `final_global_opt_iter` Adam steps per keyframe at the final learning
        rates, in runs of min(4, steps) on keyframes drawn uniformly, in
        `ids()` order, by `np.random.default_rng(self.time)` (the JAX
        schedule, draw for draw); under a mesh, steps // window_size batched
        steps on batches drawn the same way. Returns the last loss (device
        scalar)."""
        ids = self.keyframe_manager.ids()
        if not ids:
            return float("nan")
        if keyframe_num == -1:
            keyframe_num = len(ids)
        keyframe_num = min(keyframe_num, len(ids))
        kfs = [self.keyframe_manager.keyframes[i] for i in ids[:keyframe_num]]
        iters = self.mcfg.final_global_opt_iter * keyframe_num
        rng = np.random.default_rng(self.time)
        if self.devices is not None:
            # each batched step renders a window-sized batch of keyframes
            # drawn uniformly: the same keyframe renders in all
            B = max(self.keyframe_manager.window_size, 1)
            batches = [[kfs[rng.integers(len(kfs))] for _ in range(min(B, len(kfs)))]
                       for _ in range(max(1, iters // B))]
            return self._optimize_batched(batches, 1, self.global_lrs)
        run_len = min(4, iters)
        runs = [(kfs[rng.integers(len(kfs))], run_len) for _ in range(iters // run_len)]
        return self._optimize(runs, self.global_lrs)
