"""The plain float32 references against the port's CPU path at a tiny
size, on the harness's own weights mapped by each family's adapter."""
import numpy as np
import pytest
import torch

from chipbench.harness import spec, weights
from chipbench.tests import tiny


def _port_logits(cfg, params, prompt, steps):
    """The port's prefill logits, then ``steps`` greedy decode steps'."""
    from repro_torch.models.transformer import decode_step, init_cache, prefill
    caches = init_cache(cfg, 1, 64, dtype=torch.float32, device="cpu")
    logits, caches, pos = prefill(params, cfg, prompt[None], caches)
    out, tok = [logits[0]], logits.argmax(-1)
    toks = [int(tok)]
    for i in range(steps):
        logits, _ = decode_step(params, cfg, tok[:, None].to(torch.int32),
                                caches, torch.tensor([pos + i],
                                                     dtype=torch.int32))
        out.append(logits[0])
        tok = logits.argmax(-1)
        toks.append(int(tok))
    return torch.stack(out), toks


@pytest.mark.parametrize("config", [tiny.QWEN3, tiny.QWEN2],
                         ids=["qwen3", "qwen2"])
def test_reference_matches_port_prefill_and_decode(config):
    ref = spec.reference_of(config["family"])
    adapter = spec.adapter_of(config["family"])
    cfg = adapter.port_config(config, "float32")
    W = weights.draw(ref.WEIGHTS(config), 3, "cpu", "float32")
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, config["vocab_size"], 20))
    got, toks = _port_logits(cfg, adapter.port_params(W), prompt, 4)
    seq = torch.cat([prompt, torch.tensor(toks[:-1])])
    want = ref.logits(W, config, [seq], [range(19, 24)])[0]
    scale = float(want.abs().max())
    assert torch.allclose(got, want, rtol=0, atol=2e-5 * scale), \
        float((got - want).abs().max())


@pytest.mark.parametrize("family", ["qwen3", "qwen2"])
def test_reference_depends_on_every_weight(family):
    """Each tensor of the layout moves the logits: none is left unread."""
    config = dict(tiny.QWEN3, family=family)
    ref = spec.reference_of(family)
    W = weights.draw(ref.WEIGHTS(config), 5, "cpu", "float32")
    seq = [torch.arange(12) % config["vocab_size"]]
    base = ref.logits(W, config, seq, [range(12)])[0]
    for name in W:
        moved = dict(W)
        moved[name] = W[name] * 1.5
        other = ref.logits(W=moved, config=config, seqs=seq,
                           wanted=[range(12)])[0]
        assert not torch.allclose(base, other), name


def test_control_rounds_to_float8():
    from chipbench.reference.common import fp8_round
    x = torch.tensor([[1.0, 0.3, -448.0, 0.01]])
    y = fp8_round(x, -1)
    assert y[0, 2] == -448.0 and y[0, 0] == 1.0
    assert 0 < abs(float(y[0, 1]) - 0.3) < 0.02
    ref = spec.reference_of("qwen3")
    W = weights.draw(ref.WEIGHTS(tiny.QWEN3), 5, "cpu", "float32")
    seq = [torch.arange(12)]
    exact = ref.logits(W, tiny.QWEN3, seq, [range(12)])[0]
    low = ref.logits(W, tiny.QWEN3, seq, [range(12)], quantized=True)[0]
    err = float((exact - low).abs().max() / exact.abs().max())
    assert 1e-3 < err < 0.2


def _same_tree(got, want, path="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}[{i}]")
    else:
        assert (tuple(got.shape), got.dtype) == (tuple(want.shape),
                                                 want.dtype), path


def test_adapters_give_the_ports_parameter_tree():
    """At the benchmark's full sizes (meta tensors: nothing allocated), each
    adapter's tree has the structure, shapes and dtypes the port inits."""
    from repro_torch.models.transformer import param_shapes
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for c in bench["configs"]:
        config = spec.load_json(spec.ROOT / c["file"])
        ref = spec.reference_of(config["family"])
        adapter = spec.adapter_of(config["family"])
        W = {name: torch.empty(shape, device="meta", dtype=torch.float32
                               if kind == "one_plus" else torch.bfloat16)
             for name, shape, kind, _ in ref.WEIGHTS(config)}
        _same_tree(adapter.port_params(W),
                   param_shapes(adapter.port_config(config)))


def test_benchmark_configs_are_the_ports_registered_models():
    """The adapters give the port the configuration it registers under the
    same name, at every published size."""
    from repro_torch.configs import get_config
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    fields = ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "qkv_bias", "qk_norm",
              "rope_theta", "tie_embeddings", "norm_eps", "block_pattern",
              "arch_type", "dtype")
    for c in bench["configs"]:
        config = spec.load_json(spec.ROOT / c["file"])
        mine = spec.adapter_of(config["family"]).port_config(config)
        theirs = get_config(c["name"])
        assert {f: getattr(mine, f) for f in fields} == \
            {f: getattr(theirs, f) for f in fields}
