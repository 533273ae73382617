"""Per-request sampling in the port against the reference.

* ``core.prng`` (threefry-2x32, 32-bit seeds, the partitionable layout):
  ``prng_key``, ``fold_in`` over rows, ``random_bits32`` and ``uniform``
  bitwise equal to ``jax.random``'s; ``gumbel`` allclose (rtol 1e-6, atol
  1e-6: the two logarithms round as each library's ``log`` does).
* ``sample_tokens_batched`` against ``repro.models.transformer``'s on the
  same float32 logits and keys (V = 512 and V = 151936, rows mixing greedy,
  temperature, top-k, top-p and both filters, and tied logits): tokens and
  keep masks identical on every seed here.
* The four sampler properties of ``tests/test_properties.py`` on the port.
* The engine: seeded, unseeded and mixed-sampling traces through both
  engines (qwen2-1.5b ``.smoke()`` in float32 on bridged weights,
  ``cache_dtype="float32"``), dense and paged with preemption: the same
  tokens, ``ServingReport``, energy, ``_host_drains`` and ``stats()``.
  Inside the port, bitwise: preemption with recompute and a prefix hit
  change no sampled token, greedy rows do not see their sampled
  neighbours, and seeded rows reproduce run to run.
* The serve CLI's sampling flags: the port's summary equals the
  reference's on the same arguments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import SamplingParams as JSamplingParams
from repro.launch.serve import main as jserve_main
from repro.models import init_params as jinit_params
from repro.models.transformer import sample_tokens_batched as jsample
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Server as JServer
from repro.serving import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.core import SamplingParams, prng
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import params_from_numpy, sample_tokens_batched
from repro_torch.models.transformer import sampling_filter
from repro_torch.serving import EngineConfig, Server, ServingEngine

from test_properties import _keep_mask, _sampler_case
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

SEEDS = [0, 1, 2 ** 31 - 1, -5]
MAXLEN = 96


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x).copy())
    return t if dtype is None else t.to(dtype)


def _keys_t(jkeys):
    return _t(np.asarray(jkeys).astype(np.int64))


# -- threefry -------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_bits_are_bitwise_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    key = prng.prng_key(seed)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey, np.int64))
    data = np.arange(4096)
    jf = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(jkey, data)
    tf = prng.fold_in(key.expand(4096, 2), torch.arange(4096))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf, np.int64))
    jb = jax.random.bits(jkey, (4096,), jnp.uint32)
    np.testing.assert_array_equal(prng.random_bits32(key, 4096).numpy(),
                                  np.asarray(jb, np.int64))
    # a batch of keys draws each row from its own key
    rows = prng.random_bits32(tf[:3], 64).numpy()
    want = [np.asarray(jax.random.bits(k, (64,), jnp.uint32), np.int64)
            for k in jf[:3]]
    np.testing.assert_array_equal(rows, np.stack(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_is_bitwise_and_gumbel_close(seed):
    jkey = jax.random.PRNGKey(seed)
    key = prng.prng_key(seed)
    tiny = np.finfo(np.float32).tiny
    ju = jax.random.uniform(jkey, (8192,), minval=tiny)
    np.testing.assert_array_equal(prng.uniform(key, 8192).numpy(),
                                  np.asarray(ju))
    jg = np.asarray(jax.random.gumbel(jkey, (8192,)))
    tg = prng.gumbel(key, 8192).numpy()
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-6)


# -- the sampler against the reference's ------------------------------------------------

def _jax_keep(logits, temps, top_k, top_p):
    """The reference sampler's keep mask (``src/repro/models/
    transformer.py::sample_tokens_batched`` up to ``filtered``), which the
    reference does not return."""
    V = logits.shape[-1]
    safe_t = jnp.where(temps > 0.0, temps, 1.0)
    scaled = logits / safe_t[:, None]
    order = jnp.argsort(scaled, axis=-1)[:, ::-1]
    s = jnp.take_along_axis(scaled, order, axis=-1)
    ranks = jnp.arange(V, dtype=jnp.int32)[None, :]
    k_eff = jnp.where((top_k <= 0) | (top_k >= V), V, top_k)
    keep = ranks < k_eff[:, None]
    probs = jax.nn.softmax(jnp.where(keep, s, -jnp.inf), axis=-1)
    cum_prev = jnp.cumsum(probs, axis=-1) - probs
    keep &= (cum_prev < top_p[:, None]) | (top_p[:, None] >= 1.0)
    return np.asarray(jnp.take_along_axis(
        keep, jnp.argsort(order, axis=-1), axis=-1))


def _mixed_rows(seed, V, ties):
    """8 rows: greedy, temperature only, top-k, top-p, both filters, and
    disabled filters (k = V, p = 1), from a numpy seed."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, size=(8, V)).astype(np.float32)
    if ties:                      # many equal logits, at every rank
        logits = np.round(logits).astype(np.float32)
    temps = np.array([0.0, 0.8, 0.7, 1.1, 0.9, 1.3, 0.25, 0.0], np.float32)
    topk = np.array([0, 0, 40, 0, 50, V, int(rng.integers(1, 8)), 5],
                    np.int32)
    topp = np.array([1.0, 1.0, 1.0, 0.9, 0.95, 1.0,
                     float(rng.uniform(0.05, 1.0)), 0.5], np.float32)
    return logits, temps, topk, topp


@pytest.mark.parametrize("V,seed,ties", [
    (512, s, t) for s in range(6) for t in (False, True)] + [
    (151936, s, t) for s in range(2) for t in (False, True)])
def test_sampler_equals_the_reference(V, seed, ties):
    logits, temps, topk, topp = _mixed_rows(seed, V, ties)
    jkeys = jax.vmap(jax.random.fold_in)(
        jnp.broadcast_to(jax.random.PRNGKey(seed), (8, 2)), jnp.arange(8))
    want = np.asarray(jsample(jnp.asarray(logits), jnp.asarray(temps),
                              jnp.asarray(topk), jnp.asarray(topp), jkeys))
    got = sample_tokens_batched(_t(logits), _t(temps), _t(topk), _t(topp),
                                _keys_t(jkeys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    _, keep = sampling_filter(_t(logits), _t(temps), _t(topk), _t(topp))
    np.testing.assert_array_equal(
        keep.numpy(), _jax_keep(jnp.asarray(logits), jnp.asarray(temps),
                                jnp.asarray(topk), jnp.asarray(topp)))


# -- the sampler properties of tests/test_properties.py, on the port ---------------

PROPERTY_SEEDS = [0, 7, 123, 4242, 9001, 65535]


def _case_t(seed):
    logits, temps, topk, topp, keys = _sampler_case(seed)
    return (_t(logits), _t(temps), _t(topk), _t(topp), _keys_t(keys))


@pytest.mark.parametrize("seed", PROPERTY_SEEDS)
def test_sampler_never_admits_a_masked_logit(seed):
    logits, temps, topk, topp, keys = _case_t(seed)
    toks = sample_tokens_batched(logits, temps, topk, topp, keys).numpy()
    for r in range(logits.shape[0]):
        if float(temps[r]) == 0.0:
            continue
        keep = _keep_mask(logits[r].numpy(), float(temps[r]), int(topk[r]),
                          float(topp[r]))
        assert keep[toks[r]], (r, toks[r], int(topk[r]), float(topp[r]))


@pytest.mark.parametrize("seed", PROPERTY_SEEDS)
def test_sampler_greedy_rows_bit_identical_to_argmax(seed):
    logits, _, topk, topp, keys = _case_t(seed)
    temps = torch.zeros(logits.shape[0])
    toks = sample_tokens_batched(logits, temps, topk, topp, keys)
    assert torch.equal(toks, logits.argmax(dim=-1).to(torch.int32))
    bf16 = logits.bfloat16()                    # the serving dtype
    assert torch.equal(sample_tokens_batched(bf16, temps, topk, topp, keys),
                       bf16.argmax(dim=-1).to(torch.int32))


@pytest.mark.parametrize("seed,row", [(s, s % 4) for s in PROPERTY_SEEDS])
def test_sampler_rows_are_independent(seed, row):
    logits, temps, topk, topp, keys = _case_t(seed)
    base = sample_tokens_batched(logits, temps, topk, topp, keys)
    logits2, temps2 = logits.clone(), temps.clone()
    topk2, topp2 = topk.clone(), topp.clone()
    logits2[row] = -logits[row] + 1.7
    temps2[row], topk2[row], topp2[row] = 1.9, 3, 0.5
    pert = sample_tokens_batched(logits2, temps2, topk2, topp2, keys)
    others = [r for r in range(logits.shape[0]) if r != row]
    assert torch.equal(base[others], pert[others])


@pytest.mark.parametrize("seed", PROPERTY_SEEDS)
def test_sampler_disabled_filters_reduce_to_plain_temperature(seed):
    logits, temps, _, _, keys = _case_t(seed)
    B, V = logits.shape
    temps = torch.where(temps > 0, temps, torch.full_like(temps, 0.7))
    ones = torch.ones(B)
    a = sample_tokens_batched(logits, temps, torch.zeros(B, dtype=torch.int32),
                              ones, keys)
    b = sample_tokens_batched(logits, temps,
                              torch.full((B,), V, dtype=torch.int32), ones,
                              keys)
    plain = (prng.gumbel(keys, V) + logits / temps[:, None]).argmax(dim=-1)
    assert torch.equal(a, plain.to(torch.int32))
    assert torch.equal(b, plain.to(torch.int32))


# -- the engine ----------------------------------------------------------------------

GREEDY = dict()
SEEDED = dict(temperature=0.8, top_k=50, top_p=0.95)
# (arrival, prompt length, max_tokens, sampling, seed): greedy and sampled
# rows alternate; one sampled row is unseeded (its lane is the engine key
# folded with its rid), one prompt is empty
TRACE = [(0.0, 17, 20, GREEDY, None), (0.0, 9, 24, SEEDED, 5),
         (0.0, 33, 14, GREEDY, None), (0.0, 40, 18, SEEDED, 6),
         (0.01, 0, 12, dict(temperature=1.1), 7),
         (0.02, 12, 16, SEEDED, None),
         (0.02, 28, 10, GREEDY, None), (0.05, 5, 22,
                                        dict(temperature=0.7, top_k=8), 9)]
PAGED = dict(paged=True, page_size=16, num_pages=11, decode_block=8)


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("qwen2-1.5b").smoke().replace(dtype="float32")
    cfg = get_config("qwen2-1.5b").smoke().replace(dtype="float32")
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _drive(server, sampling_cls, vocab, trace=TRACE):
    rng = np.random.default_rng(0)
    hs = [server.submit(rng.integers(0, vocab, size=n),
                        sampling_cls(max_tokens=m, seed=seed, **sp),
                        arrival=t)
          for t, n, m, sp, seed in trace]
    rep = server.run()
    return rep, [list(h.request.tokens) for h in hs]


def _port(model, **kw):
    _, cfg, _, tp = model
    return ServingEngine(cfg, params=tp, ecfg=EngineConfig(
        max_batch=4, max_len=MAXLEN, cache_dtype="float32", **kw),
        plant_cfg=get_config("qwen2-1.5b"), device="cpu")


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "paged"])
def runs(model, request):
    jcfg, cfg, jp, _ = model
    kw = PAGED if request.param else {}
    ref = JServingEngine(jcfg, params=jp, ecfg=JEngineConfig(
        max_batch=4, max_len=MAXLEN, cache_dtype="float32", **kw),
        plant_cfg=jget_config("qwen2-1.5b"))
    port = _port(model, **kw)
    return (ref, _drive(JServer(ref), JSamplingParams, cfg.vocab_size),
            port, _drive(Server(port), SamplingParams, cfg.vocab_size))


def test_engine_tokens_equal_the_reference(runs):
    ref, (_, jtoks), port, (_, ttoks) = runs
    assert ttoks == jtoks
    assert all(len(t) == m for t, (_, _, m, _, _) in zip(ttoks, TRACE))
    assert port._preempted == ref._preempted
    if port.pager is not None:
        assert port._preempted > 0
    # the lanes pinned on the requests are the reference's
    for jr, tr in zip(ref.requests, port.requests):
        np.testing.assert_array_equal(tr.rng_lane, jr.rng_lane)


def test_engine_report_energy_drains_and_stats_equal_the_reference(runs):
    import dataclasses
    ref, (jrep, _), port, (trep, _) = runs
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert trep.total_energy_j == jrep.total_energy_j > 0
    assert port._host_drains == ref._host_drains > 0
    assert port.vtime == ref.vtime and port.energy_j == ref.energy_j
    assert port.stats() == ref.stats()


def test_sampled_rows_sample_and_greedy_rows_ignore_them(model, runs):
    """The sampled rows differ from the greedy run of the same prompts, and
    every greedy row equals the all-greedy burst's row."""
    _, cfg, _, _ = model
    _, _, port, (_, toks) = runs
    kw = PAGED if port.pager is not None else {}
    greedy = [(t, n, m, GREEDY, None) for t, n, m, _, _ in TRACE]
    _, gtoks = _drive(Server(_port(model, **kw)), SamplingParams,
                      cfg.vocab_size, greedy)
    for i, (_, _, _, sp, _) in enumerate(TRACE):
        assert (toks[i] == gtoks[i]) == (sp is GREEDY), i


def test_preempt_recompute_and_prefix_hit_replay_the_same_draws(model):
    """Inside the port, bitwise: the small pool (preemption with
    recompute), a second run of it, a roomy pool (no preemption), the dense
    cache, and with a shared prompt head the small pool with the prefix
    cache (hits) against it without, all give the same sampled tokens."""
    _, cfg, _, _ = model
    small = _port(model, **PAGED)
    toks = _drive(Server(small), SamplingParams, cfg.vocab_size)[1]
    assert small._preempted > 0
    assert _drive(Server(_port(model, **PAGED)), SamplingParams,
                  cfg.vocab_size)[1] == toks
    roomy = _port(model, **{**PAGED, "num_pages": 0})
    assert _drive(Server(roomy), SamplingParams, cfg.vocab_size)[1] == toks
    assert roomy._preempted == 0
    assert _drive(Server(_port(model)), SamplingParams,
                  cfg.vocab_size)[1] == toks

    head = np.random.default_rng(1).integers(0, cfg.vocab_size, size=32)

    def shared(**kw):
        eng = _port(model, **kw)
        srv = Server(eng)
        rng = np.random.default_rng(2)
        hs = [srv.submit(np.concatenate(
            [head, rng.integers(0, cfg.vocab_size, size=n)]),
            SamplingParams(max_tokens=m, seed=seed, **sp), arrival=t)
            for t, n, m, sp, seed in TRACE]
        srv.run()
        return eng, [list(h.request.tokens) for h in hs]
    cold_eng, cold = shared(**PAGED)
    hit_eng, hit = shared(**PAGED, prefix_cache=True)
    assert hit_eng.prefix_cache.stats()["hits"] > 0
    assert hit_eng._preempted > 0
    assert hit == cold


def test_serve_cli_sampling_flags_match_the_reference(capsys):
    args = ["--requests", "4", "--max-len", "64", "--mixed-sampling",
            "--temperature", "0.8", "--top-k", "40", "--top-p", "0.9",
            "--seed", "3"]
    jrep = jserve_main(args)
    jout = capsys.readouterr().out
    rep = serve_main(["--device", "cpu", *args])
    out = capsys.readouterr().out
    assert rep.completed == jrep.completed == 4
    assert out == jout
