"""Port parity: the surfel store (`core/surfels.py`), `prune_unstable` and
the numpy converter, against the JAX package on the same numpy inputs.

Integer/bool fields and the slot layout must match exactly; float fields
within 1e-6 (identical float32 formulas, libm rounding apart). The
converter round trip JAX -> numpy -> port -> numpy is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggfusion_tpu.core import surfels as jsf
from eggfusion_tpu.ops import fusion as jfusion
from eggfusion_tpu_torch.convert import surfel_map_from_numpy, surfel_map_to_numpy
from eggfusion_tpu_torch.core import surfels as tsf
from eggfusion_tpu_torch.ops import fusion as tfusion

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

CAP = 64
_j_append = jax.jit(jsf.append_surfels, static_argnums=3)


def _batch_np(k, seed, valid=None):
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(k, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return dict(
        xyz=rng.normal(size=(k, 3)).astype(np.float32),
        normal=n,
        color=rng.uniform(size=(k, 3)).astype(np.float32),
        dist=rng.uniform(0.005, 0.05, (k, 3)).astype(np.float32),
        eta=rng.normal(size=(k, 6)).astype(np.float32),
        sigma2=rng.uniform(0.01, 1.0, (k, 2)).astype(np.float32),
        valid=np.ones(k, bool) if valid is None else np.asarray(valid),
    )


def _jmap(s):
    return {f: np.asarray(getattr(s, f)) for f in tsf.FIELDS}


def _assert_maps_equal(j: dict, t: dict, atol=1e-6):
    for f in tsf.FIELDS:
        a, b = np.asarray(j[f]), np.asarray(t[f])
        assert a.shape == b.shape, f
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=f)


def _append_both(batches, cap=CAP):
    cfg_j = jsf.SurfelConfig(capacity=cap, max_sh_degree=0, active_sh_degree=0)
    cfg_t = tsf.SurfelConfig(capacity=cap, max_sh_degree=0, active_sh_degree=0)
    sj = jsf.SurfelMap.empty(cfg_j)
    st = tsf.SurfelMap.empty(cfg_t)
    for time, b in enumerate(batches):
        sj = _j_append(sj, jsf.SpawnBatch(**{k: jnp.asarray(v) for k, v in b.items()}),
                       jnp.int32(time), 0.95)
        st = tsf.append_surfels(st, tsf.SpawnBatch(**{k: torch.from_numpy(v) for k, v in b.items()}),
                                time, 0.95)
    return sj, st


@pytest.mark.parametrize("case", ["plain", "masked", "capacity_clamp", "multi"])
def test_append_surfels(case):
    if case == "plain":
        batches = [_batch_np(10, 0)]
    elif case == "masked":
        batches = [_batch_np(12, 1, valid=np.arange(12) % 3 != 0)]
    elif case == "capacity_clamp":
        batches = [_batch_np(40, 2), _batch_np(40, 3)]
    else:
        batches = [_batch_np(8, s, valid=np.arange(8) % 2 == 0) for s in range(5)]
    sj, st = _append_both(batches)
    _assert_maps_equal(_jmap(sj), surfel_map_to_numpy(st))


def test_render_params_and_stability():
    sj, st = _append_both([_batch_np(20, 4)])
    pj, pt = jax.jit(jsf.render_params)(sj), tsf.render_params(st)
    for k in pj:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), atol=1e-6, rtol=0, err_msg=k)
    sj = jax.jit(jsf.update_stability)(sj, 10.0)
    st = tsf.update_stability(st, 10.0)
    np.testing.assert_array_equal(st.stable.numpy(), np.asarray(sj.stable))
    assert int(st.stable.sum()) > 0


def test_prune_and_compact():
    sj, _ = _append_both([_batch_np(30, 5)])
    fields = _jmap(sj)
    rng = np.random.default_rng(6)
    fields["error_count"] = rng.integers(0, 12, CAP).astype(np.int32)
    fields["observe_count"] = rng.integers(0, 3, CAP).astype(np.int32)
    fields["tic"] = rng.integers(0, 5, CAP).astype(np.int32)
    sj = jsf.SurfelMap(**{k: jnp.asarray(v) for k, v in fields.items()})
    st = surfel_map_from_numpy(fields, "cpu")
    cfg = jsf.SurfelConfig(capacity=CAP, max_sh_degree=0, active_sh_degree=0)
    cfg_t = tsf.SurfelConfig(capacity=CAP, max_sh_degree=0, active_sh_degree=0)
    sj = jfusion.prune_unstable(sj, cfg, jnp.int32(40), 30)
    st = tfusion.prune_unstable(st, cfg_t, 40, 30)
    _assert_maps_equal(_jmap(sj), surfel_map_to_numpy(st))
    assert 0 < int(st.num_active()) < 30
    _assert_maps_equal(_jmap(jax.jit(jsf.compact_surfels)(sj)), surfel_map_to_numpy(tsf.compact_surfels(st)))


def test_convert_round_trip_exact():
    sj, _ = _append_both([_batch_np(25, 7)])
    fields = _jmap(sj)
    back = surfel_map_to_numpy(surfel_map_from_numpy(fields, "cpu"))
    for f in tsf.FIELDS:
        assert back[f].dtype == fields[f].dtype, f
        np.testing.assert_array_equal(back[f], fields[f], err_msg=f)
