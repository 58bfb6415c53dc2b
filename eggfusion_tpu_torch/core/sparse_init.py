"""Sparse feature-based pose seed of the dense tracker (port of
`eggfusion_tpu/core/sparse_init.py`), on the host CPU.

`NativeSparseInitializer` runs the C++ frontend `native/sparse_frontend.cpp`
(FAST corners, steered binary descriptors, 3D-3D RANSAC between this
frame's and the previous frame's keypoints) through the port's binding
`native/sparse.py`. `OpenCVSparseInitializer` runs OpenCV's ORB, a
ratio-tested brute-force match and PnP RANSAC (3D points of the previous
frame against this frame's keypoints); it needs `cv2`, imported when the
class is built. `SparseInitializer` honours `Tracking.sparse_backend`:
"native" (the default) or "opencv". A failed native build raises: unlike
the JAX factory, "native" never falls back to OpenCV.
"""
from __future__ import annotations

import numpy as np

from eggfusion_tpu_torch.utils import trace


def gray_u8(frame) -> np.ndarray:
    """A frontend's image: the frame's intensity * 255, truncated."""
    return (frame.pyramid[0].intensity[..., 0] * 255).cpu().numpy().astype(np.uint8)


def carried_state(result, frame, prev):
    """The pose a frontend keeps for the next frame: the solve's, or with no
    solve the best-known pose carried forward — the frame's committed pose
    when it has one (frame 0, ground-truth poses), else the previous state."""
    if result is not None:
        return result
    if getattr(frame, "_w2c", None) is not None:
        with trace.waiting("readback"):
            return frame.w2c_matrix().cpu().numpy().astype(np.float64)
    if prev is not None:
        return prev[3]
    return np.eye(4)


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

    gray_u8 = staticmethod(gray_u8)

    def track(self, frame) -> np.ndarray | None:
        with trace.waiting("readback"):
            gray = gray_u8(frame)
            depth = frame.depth[..., 0].cpu().numpy().astype(np.float32)
        kps, desc = self._nsp.detect(gray, threshold=self.threshold, max_kp=self.max_kp)
        result = None
        if self.prev is not None and len(kps) >= 3 and len(self.prev[0]) >= 3:
            kp0, d0, depth0, w2c0 = self.prev
            delta, _ = self._nsp.track(kp0, d0, kps, desc, depth0, depth, self.fx, self.fy, self.cx, self.cy,
                                       min_inliers=self.min_matches, inlier_thresh=self.inlier_thresh)
            if delta is not None:
                result = (delta @ np.asarray(w2c0, np.float64)).astype(np.float32)
        self.prev = (kps, desc, depth, carried_state(result, frame, self.prev))
        return result


class OpenCVSparseInitializer:
    """OpenCV's frontend: ORB keypoints, a brute-force Hamming match with
    the 0.75 ratio test, the previous frame's matched keypoints
    back-projected at their depth (0.1, 20] m, then PnP RANSAC
    (reprojection error 3 px, 100 iterations) against this frame's.
    `track(frame)` returns the frame's w2c (the delta chained onto the
    previous estimate) or None when the solve fails."""

    def __init__(self, cfg):
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError("OpenCVSparseInitializer requires OpenCV") from e
        self._cv2 = cv2
        self.orb = cv2.ORB_create(nfeatures=int(cfg.Tracking.get("orb_features", 1500)))
        self.matcher = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=False)
        self.prev = None  # (keypoints, descriptors, depth, w2c)
        calib = cfg.Dataset.Calibration
        self.K = np.array([[calib.fx, 0, calib.cx], [0, calib.fy, calib.cy], [0, 0, 1]], np.float64)
        self.min_matches = int(cfg.Tracking.get("orb_min_matches", 25))

    def track(self, frame) -> np.ndarray | None:
        cv2 = self._cv2
        with trace.waiting("readback"):
            gray = gray_u8(frame)
            depth = frame.depth[..., 0].cpu().numpy()
        kps, desc = self.orb.detectAndCompute(gray, None)
        result = None
        if self.prev is not None and desc is not None and self.prev[1] is not None:
            kps0, desc0, depth0, w2c0 = self.prev
            matches = self.matcher.knnMatch(desc0, desc, k=2)
            good = [m for m, n in (p for p in matches if len(p) == 2) if m.distance < 0.75 * n.distance]
            if len(good) >= self.min_matches:
                fx, fy, cx, cy = self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2]
                pts3d, pts2d = [], []
                for m in good:
                    u0, v0 = kps0[m.queryIdx].pt
                    d = depth0[int(round(v0)), int(round(u0))]
                    if d <= 0.1 or d > 20.0:
                        continue
                    # back-projected into the previous camera's frame
                    pts3d.append([(u0 - cx) * d / fx, (v0 - cy) * d / fy, d])
                    pts2d.append(kps[m.trainIdx].pt)
                if len(pts3d) >= self.min_matches:
                    ok, rvec, tvec, inliers = cv2.solvePnPRansac(
                        np.asarray(pts3d, np.float64), np.asarray(pts2d, np.float64), self.K, None,
                        reprojectionError=3.0, iterationsCount=100)
                    if ok and inliers is not None and len(inliers) >= self.min_matches // 2:
                        delta = np.eye(4)
                        delta[:3, :3] = cv2.Rodrigues(rvec)[0]
                        delta[:3, 3] = tvec[:, 0]
                        # delta maps previous-camera to current-camera coordinates
                        result = (delta @ np.asarray(w2c0, np.float64)).astype(np.float32)
        self.prev = (kps, desc, depth, carried_state(result, frame, self.prev))
        return result


def SparseInitializer(cfg):
    """The frontend `Tracking.sparse_backend` names: "native" (a failed
    build raises) or "opencv" (raises without `cv2`)."""
    backend = str(cfg.Tracking.get("sparse_backend", "native"))
    if backend == "native":
        return NativeSparseInitializer(cfg)
    if backend == "opencv":
        return OpenCVSparseInitializer(cfg)
    raise ValueError(f"unknown Tracking.sparse_backend {backend!r}")
