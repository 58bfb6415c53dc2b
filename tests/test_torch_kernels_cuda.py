"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked `cuda`: they skip where `torch.cuda.is_available()` is False (the
kernels have no CPU mode; the CPU tests hold the plain versions against
JAX). On a machine with an NVIDIA GPU:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(`--noconftest`: the suite's conftest imports JAX, which a GPU machine
running only the port need not have.)

Inputs are random entry slabs with ragged per-sub-column counts (zeros
included, as tile subsets produce), at several capacities. Tolerances as in
`chip_smoke.py`: forward outputs 1e-4 of (1 + |value|) (expf and FMA
contraction differ), backward 1e-3 of each gradient column's largest value
(reduction order differs).
"""
import numpy as np
import pytest
import torch

from eggfusion_tpu_torch.ops import raster_tile as rt

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _slab(cap, tx=2, ty=2, seed=0):
    """Random but well-formed entries: splats inside their sub-column,
    positive-definite conics, camera-facing normals, ragged counts."""
    rng = np.random.default_rng(seed)
    n_tiles = tx * ty
    capsub = cap // rt.N_SUB
    e = np.zeros((n_tiles, capsub, rt.N_SUB, rt.N_ATTR), np.float32)
    t = np.arange(n_tiles)[:, None, None]
    c = np.arange(rt.N_SUB)[None, None, :]
    shape = (n_tiles, capsub, rt.N_SUB)
    e[..., rt.A_U] = (t % tx) * rt.TILE_W + c * rt.SUB_W + rng.uniform(-8, 40, shape)
    e[..., rt.A_V] = (t // tx) * rt.TILE_H + rng.uniform(-8, 40, shape)
    e[..., rt.A_CA] = rng.uniform(0.01, 0.2, shape)
    e[..., rt.A_CC] = rng.uniform(0.01, 0.2, shape)
    e[..., rt.A_CB] = rng.uniform(-0.5, 0.5, shape) * np.sqrt(e[..., rt.A_CA] * e[..., rt.A_CC])
    e[..., rt.A_OP] = rng.uniform(0.0, 1.0, shape)
    e[..., rt.A_R:rt.A_B + 1] = rng.uniform(size=shape + (3,))
    n = rng.normal(size=shape + (3,)) * 0.3 + [0, 0, -1]
    e[..., rt.A_NX:rt.A_NZ + 1] = n / np.linalg.norm(n, axis=-1, keepdims=True)
    e[..., rt.A_PX:rt.A_PY + 1] = rng.normal(size=shape + (2,)) * 0.3
    e[..., rt.A_PZ] = np.sort(rng.uniform(0.5, 4.0, shape), axis=1)
    counts = rng.integers(0, capsub + 1, (n_tiles, rt.N_SUB)).astype(np.int32)
    counts[0, 0] = 0
    counts[-1, -1] = capsub
    entries = torch.from_numpy(e.reshape(n_tiles, cap, rt.N_ATTR))
    intr = torch.tensor([300.0, 300.0, tx * rt.TILE_W / 2 - 0.5, ty * rt.TILE_H / 2 - 0.5])
    return entries, torch.from_numpy(counts), intr, tx


@pytest.mark.parametrize("geom", [False, True])
@pytest.mark.parametrize("cap", [32, 256, 2048])
def test_forward_kernel_matches_plain(cuda, cap, geom):
    entries, counts, intr, tx = _slab(cap)
    before = dict(rt.LAUNCHES)
    k_out = rt.composite_fwd(entries.to(cuda), counts.to(cuda), intr.to(cuda), tx, cap, geom=geom)
    name = "composite_geom" if geom else "composite_fwd"
    assert rt.LAUNCHES[name] == before[name] + 1
    p_out = rt.composite_fwd(entries, counts, intr, tx, cap, geom=geom)
    for k, p in zip(k_out, p_out):
        k = k.cpu()
        assert torch.isfinite(k).all()
        assert float(((k - p).abs() / (1 + p.abs())).max()) <= 1e-4


@pytest.mark.parametrize("cap", [32, 256, 1024, 2048])
def test_backward_kernel_matches_plain(cuda, cap):
    entries, counts, intr, tx = _slab(cap, seed=1)
    outs = rt.composite_fwd(entries, counts, intr, tx, cap)
    g = torch.Generator().manual_seed(2)
    cots = [torch.randn(o.shape, generator=g) for o in outs]
    d_p = rt.composite_bwd(entries, counts, intr, *cots, outs[4], tx, cap)
    dev = [x.to(cuda) for x in (entries, counts, intr, *cots, outs[4])]
    d_k = rt.composite_bwd(*dev, tx, cap)
    assert torch.equal(d_k, rt.composite_bwd(*dev, tx, cap))  # deterministic
    d_k = d_k.cpu()
    scale = d_p.abs().amax(dim=(0, 1)).clamp(min=1e-30)
    assert float(((d_k - d_p).abs().amax(dim=(0, 1)) / scale)[:15].max()) <= 1e-3
    assert float(d_k[..., 15].abs().max()) == 0.0


def test_wrapper_rejects_bad_inputs(cuda):
    entries, counts, intr, tx = _slab(256)
    with pytest.raises(ValueError):
        rt.composite_fwd(entries.to(cuda), counts.to(cuda).long(), intr.to(cuda), tx, 256)
    with pytest.raises(ValueError):
        rt.composite_fwd(entries.to(cuda), counts, intr.to(cuda), tx, 256)
    big = torch.zeros(1, 4096, rt.N_ATTR, device=cuda)  # past the backward's checkpoint budget
    imgs = [torch.zeros(s, device=cuda) for s in ((3, 32, 128), (3, 32, 128)) + ((32, 128),) * 4]
    with pytest.raises(ValueError):
        rt.composite_bwd(big, counts.to(cuda)[:1], intr.to(cuda), *imgs, 1, 4096)
