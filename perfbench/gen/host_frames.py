"""Generator of host-resident frames, as a decoder would yield them: every
unique frame of the mix rendered once on the device, then kept on the host
as uint8 color and uint16 depth in the configuration's depth scale.
No noise: the frames stand for Replica's renders."""
from __future__ import annotations

import numpy as np
import torch

from perfbench.gen.stream import Stream, intrinsics, render_frame, scene_planes, texture_offset, unique_poses


def make(calib: dict, traffic: dict, seed: int, device, workdir: str) -> Stream:
    intr = intrinsics(calib)
    scale = float(calib["depth_scale"])
    poses = unique_poses(traffic)
    W, H = intr[4], intr[5]
    color = np.empty((len(poses), H, W, 3), np.uint8)
    depth = np.empty((len(poses), H, W), np.uint16)
    for u, w2c in enumerate(poses):
        c, d = render_frame(traffic, seed, intr, w2c, device)
        color[u] = (torch.clamp(c, 0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()
        depth[u] = torch.clamp(torch.round(d * scale), 0, 65535).to(torch.int32).cpu().numpy().astype(np.uint16)
    return Stream(planes=scene_planes(traffic), detail=float(traffic["detail"]), offset=texture_offset(seed),
                  intr=intr, depth_scale=scale, ramp=int(traffic["ramp"]), period=int(traffic["period"]), rate_hz=float(traffic["rate_hz"]),
                  gt_w2c=poses, color=color, depth=depth)
