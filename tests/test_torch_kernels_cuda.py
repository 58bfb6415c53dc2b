"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked `cuda`: they skip where `torch.cuda.is_available()` is False (the
kernels have no CPU mode; the CPU tests hold the plain versions against
JAX). On a machine with an NVIDIA GPU:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(`--noconftest`: the suite's conftest imports JAX, which a GPU machine
running only the port need not have.)

Inputs are random entry slabs with ragged per-sub-column counts (zeros
included, as tile subsets produce), at several capacities, and adversarial
slabs for the kernels' row cull (tiny and elongated splats, near-singular
conics, opacities at the 1/255 cut-off, centres off the row and off the
sub-column), including one whose every entry is culled, and on these the
kernels built without the cull, which must give the same bits. Tolerances as in
`chip_smoke.py`: forward outputs 1e-4 of (1 + |value|) (expf and FMA
contraction differ), backward 1e-3 of each gradient column's largest value
(reduction order differs).
"""
import pytest
import torch

from eggfusion_tpu_torch.ops import raster_tile as rt
from eggfusion_tpu_torch.ops.raster_slabs import adversarial_slab, culled_slab, random_slab

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _check_forward(cuda, entries, counts, intr, tx, cap, geom):
    before = dict(rt.LAUNCHES)
    k_out = rt.composite_fwd(entries.to(cuda), counts.to(cuda), intr.to(cuda), tx, cap, geom=geom)
    name = "composite_geom" if geom else "composite_fwd"
    assert rt.LAUNCHES[name] == before[name] + 1
    p_out = rt.composite_fwd(entries, counts, intr, tx, cap, geom=geom)
    for k, p in zip(k_out, p_out):
        k = k.cpu()
        assert torch.isfinite(k).all()
        assert float(((k - p).abs() / (1 + p.abs())).max()) <= 1e-4
    return [k.cpu() for k in k_out]


def _check_backward(cuda, entries, counts, intr, tx, cap):
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
    return d_k


@pytest.mark.parametrize("geom", [False, True])
@pytest.mark.parametrize("cap", [32, 256, 1024, 2048, 4096])  # 4096: two staging windows
def test_forward_kernel_matches_plain(cuda, cap, geom):
    _check_forward(cuda, *random_slab(cap), cap, geom)


@pytest.mark.parametrize("cap", [32, 256, 1024, 2048])
def test_backward_kernel_matches_plain(cuda, cap):
    _check_backward(cuda, *random_slab(cap, seed=1), cap)


@pytest.mark.parametrize("geom", [False, True])
@pytest.mark.parametrize("cap", [32, 256, 1024, 2048])
def test_forward_kernel_adversarial(cuda, cap, geom):
    _check_forward(cuda, *adversarial_slab(cap, seed=cap), cap, geom)


@pytest.mark.parametrize("cap", [32, 256, 1024, 2048])
def test_backward_kernel_adversarial(cuda, cap):
    _check_backward(cuda, *adversarial_slab(cap, seed=cap + 1), cap)


@pytest.mark.parametrize("cap", [256, 2048])
def test_kernels_on_a_fully_culled_slab(cuda, cap):
    """Every entry culled: T = 1 and empty channels forward, zero gradients
    backward, exactly."""
    entries, counts, intr, tx = culled_slab(cap)
    for geom in (False, True):
        out = _check_forward(cuda, entries, counts, intr, tx, cap, geom)
        assert torch.equal(out[-1], torch.ones_like(out[-1]))
        assert all(float(x.abs().max()) == 0.0 for x in out[:-1])
    assert float(_check_backward(cuda, entries, counts, intr, tx, cap).abs().max()) == 0.0


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("cap", [256, 2048])
def test_kernels_equal_their_build_without_the_cull(cuda, cap, wide):
    """A culled pair adds exactly nothing: on the adversarial slabs, the wide
    ones included, the forward (both variants) and the backward give the
    bits of the kernels built without the row cull."""
    from eggfusion_tpu_torch.ops import cuda_build

    entries, counts, intr, tx = adversarial_slab(cap, seed=cap, wide=wide)
    entries, counts, intr = entries.to(cuda), counts.to(cuda), intr.to(cuda)
    fwd_lib = cuda_build.load("composite_fwd", cuda_build.NO_CULL)
    for geom in (False, True):
        culled = rt.composite_fwd(entries, counts, intr, tx, cap, geom=geom)
        whole = rt._launch_fwd(fwd_lib, entries, counts, intr, tx, cap, geom)
        assert all(torch.equal(a, b) for a, b in zip(culled, whole))
    outs = rt.composite_fwd(entries, counts, intr, tx, cap)
    g = torch.Generator(device=cuda).manual_seed(6)
    ins = [entries, counts, intr] + [torch.randn(o.shape, generator=g, device=cuda) for o in outs] + [outs[4]]
    assert torch.equal(rt.composite_bwd(*ins, tx, cap),
                       rt._launch_bwd(cuda_build.load("composite_bwd", cuda_build.NO_CULL), *ins, tx, cap))


def test_kernels_on_an_unaligned_slab(cuda):
    """A slab whose rows are 4-byte but not 16-byte aligned takes the
    kernels' 4-byte copies and gives the same bits as an aligned one."""
    entries, counts, intr, tx = random_slab(256, seed=4)
    flat = torch.empty(entries.numel() + 1, device=cuda)
    shifted = flat[1:].view(entries.shape)
    shifted.copy_(entries)
    assert shifted.data_ptr() % 16 == 4
    ins = [counts.to(cuda), intr.to(cuda)]
    aligned = rt.composite_fwd(entries.to(cuda), *ins, tx, 256)
    for a, b in zip(aligned, rt.composite_fwd(shifted, *ins, tx, 256)):
        assert torch.equal(a, b)
    g = torch.Generator(device=cuda).manual_seed(5)
    cots = [torch.randn(o.shape, generator=g, device=cuda) for o in aligned]
    assert torch.equal(rt.composite_bwd(entries.to(cuda), *ins, *cots, aligned[4], tx, 256),
                       rt.composite_bwd(shifted, *ins, *cots, aligned[4], tx, 256))


def test_wrapper_rejects_bad_inputs(cuda):
    entries, counts, intr, tx = random_slab(256)
    with pytest.raises(ValueError):
        rt.composite_fwd(entries.to(cuda), counts.to(cuda).long(), intr.to(cuda), tx, 256)
    with pytest.raises(ValueError):
        rt.composite_fwd(entries.to(cuda), counts, intr.to(cuda), tx, 256)
    big = torch.zeros(1, 4096, rt.N_ATTR, device=cuda)  # past the backward's checkpoint budget
    imgs = [torch.zeros(s, device=cuda) for s in ((3, 32, 128), (3, 32, 128)) + ((32, 128),) * 4]
    with pytest.raises(ValueError):
        rt.composite_bwd(big, counts.to(cuda)[:1], intr.to(cuda), *imgs, 1, 4096)
