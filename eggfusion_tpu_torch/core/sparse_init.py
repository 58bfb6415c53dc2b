"""Sparse feature-based pose seed of the dense tracker (port of
`eggfusion_tpu/core/sparse_init.py`), on the host CPU.

`NativeSparseInitializer` runs the C++ frontend `native/sparse_frontend.cpp`
(FAST corners, steered binary descriptors, 3D-3D RANSAC between this
frame's and the previous frame's keypoints) through the port's binding
`native/sparse.py`. `SparseInitializer` honours `Tracking.sparse_backend`:
"native" (the default) only. A failed native build raises; the OpenCV
backend is not ported.
"""
from __future__ import annotations

import numpy as np


class NativeSparseInitializer:
    """The C++ frontend: `track(frame)` returns the frame's w2c estimated
    from the previous frame's (the delta chained onto the previous
    estimate), or None when the solve fails."""

    def __init__(self, cfg):
        from eggfusion_tpu_torch.native import sparse as nsp

        nsp._get()  # build and load now: a failed build raises here, not mid-run
        self._nsp = nsp
        t = cfg.Tracking
        self.max_kp = int(t.get("orb_features", 1500))
        self.threshold = int(t.get("fast_threshold", 15))
        self.min_matches = int(t.get("orb_min_matches", 25))
        self.inlier_thresh = float(t.get("sparse_inlier_thresh", 0.05))
        calib = cfg.Dataset.Calibration
        self.fx, self.fy = float(calib.fx), float(calib.fy)
        self.cx, self.cy = float(calib.cx), float(calib.cy)
        self.prev = None  # (keypoints, descriptors, depth, w2c)

    @staticmethod
    def gray_u8(frame) -> np.ndarray:
        """The frontend's image: the frame's intensity * 255, truncated."""
        return (frame.pyramid[0].intensity[..., 0] * 255).cpu().numpy().astype(np.uint8)

    def track(self, frame) -> np.ndarray | None:
        gray = self.gray_u8(frame)
        depth = frame.depth[..., 0].cpu().numpy().astype(np.float32)
        kps, desc = self._nsp.detect(gray, threshold=self.threshold, max_kp=self.max_kp)
        result = None
        if self.prev is not None and len(kps) >= 3 and len(self.prev[0]) >= 3:
            kp0, d0, depth0, w2c0 = self.prev
            delta, _ = self._nsp.track(kp0, d0, kps, desc, depth0, depth, self.fx, self.fy, self.cx, self.cy,
                                       min_inliers=self.min_matches, inlier_thresh=self.inlier_thresh)
            if delta is not None:
                result = (delta @ np.asarray(w2c0, np.float64)).astype(np.float32)
        state = result
        if state is None:
            # no solve: carry the best-known pose forward — the frame's
            # committed pose when it has one (frame 0, ground-truth poses),
            # else the previous state
            if frame._w2c is not None:
                state = frame.w2c_matrix().cpu().numpy().astype(np.float64)
            elif self.prev is not None:
                state = self.prev[3]
            else:
                state = np.eye(4)
        self.prev = (kps, desc, depth, state)
        return result


def SparseInitializer(cfg):
    """The frontend `Tracking.sparse_backend` names."""
    backend = str(cfg.Tracking.get("sparse_backend", "native"))
    if backend == "native":
        return NativeSparseInitializer(cfg)
    if backend == "opencv":
        raise NotImplementedError("Tracking.sparse_backend 'opencv' is not ported; use 'native'")
    raise ValueError(f"unknown Tracking.sparse_backend {backend!r}")
