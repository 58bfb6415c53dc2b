"""No run loads JAX or the JAX package, and the reference loads nothing of
the program. Module names are compared by their whole top-level name: the
program's name, `eggfusion_tpu_torch`, begins with the JAX package's."""
import json
import subprocess
import sys

from perfbench.harness import driver, manifest


def test_forbidden_names_compare_whole():
    mods = ["eggfusion_tpu_torch", "eggfusion_tpu_torch.system", "jaxtyping", "numpy", "flaxen"]
    assert driver.forbidden_modules(mods) == []
    assert driver.forbidden_modules(mods + ["eggfusion_tpu.ops", "jax", "jaxlib.xla_client", "flax.linen"]) == [
        "eggfusion_tpu.ops", "flax.linen", "jax", "jaxlib.xla_client"]


def _top_levels(code: str) -> set:
    script = code + "\nimport sys, json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    res = subprocess.run([sys.executable, "-c", script], cwd=manifest.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    tops = _top_levels("import perfbench.reference.check, perfbench.gen.scene")
    assert not tops & {"jax", "jaxlib", "flax", "eggfusion_tpu", "eggfusion_tpu_torch"}, tops


def test_generators_load_nothing_of_the_program():
    tops = _top_levels("import perfbench.gen.host_frames")
    assert not tops & {"jax", "jaxlib", "flax", "eggfusion_tpu", "eggfusion_tpu_torch"}, tops


def test_a_run_loads_no_jax():
    """A whole run on the CPU, at a small size, in a fresh process."""
    script = (
        "import sys, time, json; sys.path.insert(0, '.');"
        "import torch; torch.set_num_threads(2);"
        "from perfbench.harness import driver;"
        "driver.run('replica.sway', 5, 1e9, False, time.perf_counter(), device='cpu', scale=0.1,"
        " max_frames=1)")
    tops = _top_levels(script)
    assert "eggfusion_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "eggfusion_tpu"}, tops
