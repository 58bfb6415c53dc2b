"""Binary PLY export/import in the 3DGS-compatible layout (port of
`eggfusion_tpu/io/ply.py`; numpy only, byte for byte the same files).

Attribute order: x y z, f_dc_*, f_rest_*, scale_*, rot_*, opacity. The
reader accepts both the `scale_*` / `rot_*` prefixes this writer uses and
the `scaling_*` / `rotation_*` ones some 3DGS tools write.
"""
from __future__ import annotations

import os

import numpy as np


def save_ply(path: str, xyz, features_dc, features_rest, scaling, rotation, opacity) -> None:
    """xyz (N,3), features_dc (N,1,3), features_rest (N,R,3), scaling (N,3),
    rotation (N,4), opacity (N,1); all array-likes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    xyz = np.asarray(xyz, np.float32)
    N = len(xyz)
    # (N, K, 3) flattens channel-major, as the 3DGS writer does
    f_dc = np.asarray(features_dc, np.float32).transpose(0, 2, 1).reshape(N, -1)
    f_rest = np.asarray(features_rest, np.float32).transpose(0, 2, 1).reshape(N, -1)
    scaling = np.asarray(scaling, np.float32)
    rotation = np.asarray(rotation, np.float32)
    opacity = np.asarray(opacity, np.float32).reshape(N, -1)

    names = ["x", "y", "z"]
    names += [f"f_dc_{i}" for i in range(f_dc.shape[1])]
    names += [f"f_rest_{i}" for i in range(f_rest.shape[1])]
    names += [f"scale_{i}" for i in range(scaling.shape[1])]
    names += [f"rot_{i}" for i in range(rotation.shape[1])]
    names += ["opacity"]

    data = np.concatenate([xyz, f_dc, f_rest, scaling, rotation, opacity], axis=1)
    rec = np.rec.fromarrays(data.T, dtype=[(n, "<f4") for n in names])

    header = "\n".join(
        ["ply", "format binary_little_endian 1.0", f"element vertex {N}"]
        + [f"property float {n}" for n in names]
        + ["end_header", ""]
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def load_ply(path: str) -> dict:
    """Returns dict(xyz, features_dc (N,1,3), features_rest (N,R,3), scaling,
    rotation, opacity) of float32 numpy arrays."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = f.readline().strip()
        names, count = [], 0
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                count = int(line.split()[-1])
            elif line.startswith(b"property"):
                names.append(line.split()[-1].decode())
            elif line == b"end_header":
                break
        if b"ascii" in fmt:
            data = np.loadtxt(f, dtype=np.float32, max_rows=count)
            rec = {n: data[:, i] for i, n in enumerate(names)}
        else:
            raw = np.fromfile(f, dtype=np.dtype([(n, "<f4") for n in names]), count=count)
            rec = {n: raw[n] for n in names}

    def group(prefixes):
        for p in prefixes:
            keys = sorted((n for n in names if n.startswith(p)), key=lambda s: int(s.rsplit("_", 1)[-1]))
            if keys:
                return np.stack([rec[k] for k in keys], axis=1)
        return np.zeros((count, 0), np.float32)

    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1)
    f_dc = group(["f_dc_"])  # (N, 3)
    f_rest = group(["f_rest_"])  # (N, 3R)
    R = f_rest.shape[1] // 3
    return {
        "xyz": xyz,
        "features_dc": f_dc.reshape(count, 3, 1).transpose(0, 2, 1),
        "features_rest": f_rest.reshape(count, 3, R).transpose(0, 2, 1),
        "scaling": group(["scale_", "scaling_"]),
        "rotation": group(["rot_", "rotation_"]),
        "opacity": rec["opacity"][:, None],
    }
