"""Descriptor-indexed relocalization (port of `eggfusion_tpu/core/reloc.py`).

After tracking loss, the lost frame's FAST + BRIEF descriptors (the
repository's `native/sparse_frontend.cpp`) are matched against stored
keyframes; the keyframe with the most RANSAC inliers gives the relocalized
pose `delta @ kf.w2c`. Host numpy, and lazy: a keyframe's descriptors are
computed at the first recovery that looks at it (one map pull per keyframe,
cached by uid), never on the per-frame path.

The gray images of the two sides come from different routes on purpose, as
in the JAX module: a keyframe's from its color map through `_to_gray_u8`,
the lost frame's from its tracking pyramid's intensity.
"""
from __future__ import annotations

import numpy as np
import torch

from eggfusion_tpu_torch.ops.pyramid import RGB_COEFF
from eggfusion_tpu_torch.utils import trace


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        with trace.waiting("readback"):
            return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_gray_u8(color_map) -> np.ndarray:
    """(H, W, 3) float color in [0, 1] -> (H, W) uint8 gray, with the
    reversed coefficients of the tracking pyramid."""
    c = np.asarray(_host(color_map), np.float32)
    gray = c[..., 0] * RGB_COEFF[2] + c[..., 1] * RGB_COEFF[1] + c[..., 2] * RGB_COEFF[0]
    return np.clip(gray * 255.0, 0, 255).astype(np.uint8)


class DescriptorRelocalizer:
    """Appearance-based keyframe retrieval and pose solve for recovery."""

    def __init__(self, cfg):
        from eggfusion_tpu_torch.native import sparse as nsp

        self._nsp = nsp
        t = cfg.Tracking
        self.max_kp = int(t.get("orb_features", 1500))
        self.threshold = int(t.get("fast_threshold", 15))
        self.min_inliers = int(t.get("reloc_min_inliers", 20))
        self.max_candidates = int(t.get("reloc_max_candidates", 24))
        self.inlier_thresh = float(t.get("sparse_inlier_thresh", 0.05))
        cal = cfg.Dataset.Calibration
        self.fx, self.fy = float(cal.fx), float(cal.fy)
        self.cx, self.cy = float(cal.cx), float(cal.cy)
        self._nsp.detect(np.zeros((32, 32), np.uint8))  # build the library now, or raise
        self._db: dict[int, tuple] = {}  # kf.uid -> (kps, desc, depth, w2c)

    def _describe_keyframe(self, kf):
        cached = self._db.get(kf.uid)
        if cached is not None:
            return cached
        depth = _host(kf.maps["depth"])[..., 0].astype(np.float32)
        kps, desc = self._nsp.detect(_to_gray_u8(kf.maps["color"]), threshold=self.threshold,
                                     max_kp=self.max_kp)
        entry = (kps, desc, depth, np.asarray(_host(kf.w2c), np.float64))
        self._db[kf.uid] = entry
        return entry

    def relocalize(self, frame, keyframes: dict):
        """(w2c 4x4 float32, kf_uid, n_inliers) or None.

        `keyframes` is `KeyFrameManager.keyframes` ({uid: KeyFrame}). Scans
        at most `reloc_max_candidates` keyframes: half the budget on the most
        recent, half spread evenly over the older ones."""
        uids = sorted(keyframes.keys())
        if not uids:
            return None
        if len(uids) > self.max_candidates:
            recent = uids[-self.max_candidates // 2:]
            older = uids[: -self.max_candidates // 2]
            stride = max(1, len(older) // (self.max_candidates - len(recent)))
            uids = sorted(set(older[::stride] + recent))

        gray = (_host(frame.pyramid[0].intensity)[..., 0] * 255).astype(np.uint8)
        depth = _host(frame.depth)[..., 0].astype(np.float32)
        cur_kps, cur_desc = self._nsp.detect(gray, threshold=self.threshold, max_kp=self.max_kp)
        if len(cur_kps) < 3:
            return None

        best = None  # (n_inliers, w2c, uid)
        for uid in uids:
            kf_kps, kf_desc, kf_depth, kf_w2c = self._describe_keyframe(keyframes[uid])
            if len(kf_kps) < 3:
                continue
            delta, n = self._nsp.track(kf_kps, kf_desc, cur_kps, cur_desc, kf_depth, depth,
                                       self.fx, self.fy, self.cx, self.cy,
                                       min_inliers=self.min_inliers, inlier_thresh=self.inlier_thresh)
            if delta is None:
                continue
            if best is None or n > best[0]:
                best = (n, (delta @ kf_w2c).astype(np.float32), uid)
        if best is None:
            return None
        return best[1], best[2], best[0]
