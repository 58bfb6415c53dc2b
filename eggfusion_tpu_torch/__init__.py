"""PyTorch / CUDA port of `eggfusion_tpu` for NVIDIA Hopper GPUs.

The JAX package `eggfusion_tpu/` is the reference this port is held
against. Module layout and names mirror it one to one (`geometry/`,
`core/`, `ops/`, `data/`, `utils/`, `system.py`, `main.py`, `config.py`);
each module's docstring names its JAX counterpart. The three Pallas
compositor kernels of `eggfusion_tpu/ops/raster_pallas.py` are CUDA C++
kernels here (`csrc/`), built with `nvcc` at first use.

This package never imports `jax` nor anything from `eggfusion_tpu`.
"""
