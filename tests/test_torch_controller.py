"""The port's batched dual-loop controller (``core/controller_torch.py``)
against the reference's pure-JAX one (``core/controller_jax.py``), bitwise,
on the same float32 telemetry.

* Single traces at twelve seeds, with the invariants of
  ``tests/test_controller_jax.py`` (clocks on the ladder's range, at most
  one coarse re-band jump per ten ticks).
* The load step: both packages ramp the clock up under load and back down.
* A window's TPS exactly on a grid point takes that point's bucket.
* A fleet of 32 traces under one set of parameters against ``jax.vmap``.
* Per-scenario parameters (SLOs, margins, hysteresis and decode tables
  differing per controller) against ``jax.vmap`` over ``CtlParams``; the
  same grid over one shared trace.
* ``make_params`` asks for CUDA unless told otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import A100_SXM4_40G as JHW, TPSFreqTable as JTable
from repro.core import controller_jax as J

from repro_torch.core import A100_SXM4_40G as HW, TPSFreqTable
from repro_torch.core import controller_torch as C
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

jsimulate = jax.jit(J.simulate)
jfleet = jax.jit(jax.vmap(J.simulate, in_axes=(None, 0, 0)))


def _table(cls, hw, scale=1.0):
    tps = np.asarray([200, 1000, 3000]) * scale
    freqs = hw.ladder()[::4]
    p95 = 0.08 * (tps[:, None] / 3000.0) * (hw.f_max / freqs[None, :])
    ept = np.tile(np.linspace(0.3, 1.0, len(freqs)), (3, 1))
    return cls.from_profile(tps, freqs, p95, ept, 0.1, hw.f_step)


def _params(**kw):
    return (J.make_params(JHW, _table(JTable, JHW), **kw),
            C.make_params(HW, _table(TPSFreqTable, HW), device="cpu", **kw))


def _telemetry(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 60, shape).astype(float),
            rng.uniform(0.0, 0.2, shape))


def _same(jout, tout):
    """Final states and frequencies bitwise equal (dtypes included)."""
    (js, jf), (ts, tf) = jout, tout
    assert np.asarray(jf).dtype == tf.numpy().dtype == np.float32
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    for name, a, b in zip(J.CtlState._fields, js, ts):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 8, 13, 21, 34, 55, 4096,
                                  2 ** 16])
def test_single_trace_bitwise_and_invariants(seed):
    jp, tp = _params()
    tokens, p95s = _telemetry(seed, 200)
    out = C.simulate(tp, tokens, p95s)
    _same(jsimulate(jp, tokens, p95s), out)
    freqs = out[1].numpy()
    assert np.all(freqs >= HW.f_min) and np.all(freqs <= HW.f_max)
    jumps = np.abs(np.diff(freqs)) > HW.f_step + 1e-6
    assert jumps.sum() <= len(freqs) / 10 + 1


def test_load_step_bitwise():
    jp, tp = _params()
    tokens = np.concatenate([np.full(150, 4.0), np.full(150, 70.0),
                             np.full(100, 4.0)])
    p95s = np.concatenate([np.full(150, 0.03), np.full(150, 0.12),
                           np.full(100, 0.03)])
    out = C.simulate(tp, tokens, p95s)
    _same(jsimulate(jp, tokens, p95s), out)
    freqs = out[1].numpy()
    assert freqs[140] < freqs[290]          # ramped up under load
    assert freqs[-1] < freqs[290]           # came back down
    assert len(np.unique(freqs)) > 2


def test_tps_on_a_bucket_edge_takes_the_lower_bucket():
    """``searchsorted(side="left")``: a window whose TPS lands exactly on a
    grid point (the grid holds the float32 TPS of 4 and of 14 tokens a
    tick) takes that point's bucket, not the next."""
    f32 = np.float32
    edge = [float(f32(10 * n) / (f32(10) * f32(0.020))) for n in (4, 14)]
    hw_f = HW.ladder()[::4]
    tps = [edge[0], edge[1], 3000.0]
    p95 = 0.08 * (np.asarray(tps)[:, None] / 3000.0) * (HW.f_max / hw_f)
    ept = np.tile(np.linspace(0.3, 1.0, len(hw_f)), (3, 1))
    jp = J.make_params(JHW, JTable.from_profile(tps, hw_f, p95, ept, 0.1,
                                                HW.f_step))
    tp = C.make_params(HW, TPSFreqTable.from_profile(tps, hw_f, p95, ept, 0.1,
                                                     HW.f_step), device="cpu")
    tokens = np.concatenate([np.full(60, 4.0), np.full(60, 14.0)])
    p95s = np.full(120, 0.05)
    out = C.simulate(tp, tokens, p95s)
    _same(jsimulate(jp, tokens, p95s), out)
    assert out[0].bucket.item() == 1 and out[0].pending.item() == -1


def test_fleet_of_32_against_vmap():
    jp, tp = _params(tbt_slo=0.08, hysteresis=2)
    tokens, p95s = _telemetry(0, (32, 100))
    out = C.simulate(tp, tokens, p95s)
    assert out[1].shape == (32, 100) and out[0].freq.shape == (32,)
    _same(jfleet(jp, jnp.asarray(tokens), jnp.asarray(p95s)), out)


def _scenarios(n):
    """``n`` controllers whose SLO, margins, hysteresis and decode table
    (its TPS grid scaled) all differ, for each package: a list of the
    reference's ``CtlParams`` and the port's."""
    rng = np.random.default_rng(7)
    slo = rng.choice([0.05, 0.08, 0.1, 0.15], n)
    up = rng.choice([0.9, 1.0, 1.1], n)
    down = rng.choice([0.5, 0.65, 0.8], n)
    hyst = rng.integers(1, 5, n)
    scale = rng.choice([0.5, 1.0, 2.0], n)
    jps, tps = [], []
    for a, u, d, h, s in zip(slo, up, down, hyst, scale):
        jps.append(J.make_params(JHW, _table(JTable, JHW, s), tbt_slo=a,
                                 hysteresis=int(h))._replace(
            up_margin=jnp.float32(u), down_margin=jnp.float32(d)))
        tps.append(C.make_params(HW, _table(TPSFreqTable, HW, s), tbt_slo=a,
                                 hysteresis=int(h), device="cpu")._replace(
            up_margin=torch.tensor(u, dtype=torch.float32),
            down_margin=torch.tensor(d, dtype=torch.float32)))
    return jps, tps


def test_per_scenario_params_against_vmap():
    n = 24
    jps, tps = _scenarios(n)
    jp = jax.tree.map(lambda *x: jnp.stack(x), *jps)
    tp = C.CtlParams(*(torch.stack(x) for x in zip(*tps)))
    assert tp.tps_grid.shape[0] == n and tp.tbt_slo.shape == (n,)
    tokens, p95s = _telemetry(3, (n, 150))
    out = C.simulate(tp, tokens, p95s)
    _same(jax.jit(jax.vmap(J.simulate))(jp, jnp.asarray(tokens),
                                        jnp.asarray(p95s)), out)
    # the same grid over one shared trace: parameters carry the fleet dims
    shared = C.simulate(tp, tokens[0], p95s[0])
    _same(jax.jit(jax.vmap(J.simulate, in_axes=(0, None, None)))(
        jp, jnp.asarray(tokens[0]), jnp.asarray(p95s[0])), shared)
    # every scenario alone gives its row of the batched run
    for i in (0, n // 2, n - 1):
        s, f = C.simulate(tps[i], tokens[i], p95s[i])
        assert torch.equal(f, out[1][i])
        assert all(torch.equal(a, b[i]) for a, b in zip(s, out[0]))


def test_make_params_asks_for_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA path runs for real")
    with pytest.raises((RuntimeError, AssertionError)):
        C.make_params(HW, _table(TPSFreqTable, HW))
    p = C.make_params(HW, _table(TPSFreqTable, HW), device="cpu")
    assert all(x.device.type == "cpu" for x in p)
    assert p.hysteresis.dtype == p.ticks_per_coarse.dtype == torch.int32
    assert p.tps_grid.dtype == p.tbt_slo.dtype == torch.float32
