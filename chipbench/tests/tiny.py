"""Tiny cells for the CPU tests: the benchmark's families at a size the
CPU serves in seconds, with an energy reader that counts host time."""
import copy
import time

from chipbench.harness import spec

QWEN3 = {
    "name": "tiny-qwen3", "family": "qwen3", "hidden_size": 64,
    "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "vocab_size": 97, "rms_norm_eps": 1e-6, "rope_theta": 1000000,
    "context_length": 512, "dtype": "float32",
    "engine": {"max_batch": 4, "max_len": 256, "page_size": 16,
               "num_pages": 65}}
QWEN2 = dict(QWEN3, name="tiny-qwen2", family="qwen2")

CLOSED = {"loop": "closed", "clients": 4,
          "prompt": {"median": 40, "sigma": 0.5, "min": 16, "max": 100},
          "output": {"median": 8, "sigma": 0.5, "min": 4, "max": 20}}
OPEN = {"loop": "open", "rate": 20.0,
        "prompt": {"median": 40, "sigma": 0.5, "min": 16, "max": 100},
        "output": {"median": 8, "sigma": 0.5, "min": 4, "max": 20}}

CHECK = {"max_logit_gap": 1e-3, "served_tokens": 24}

E2E = [{"name": "ttft_p90_ms", "unit": "ms"},
       {"name": "tpot_p90_ms", "unit": "ms"},
       {"name": "out_tok_s", "unit": "tokens/s"},
       {"name": "j_per_tok", "unit": "J/tok"},
       {"name": "setup_s", "unit": "s"}]


def cell(config=QWEN3, traffic=CLOSED, check=CHECK, **over):
    config = dict(copy.deepcopy(config), **over)
    skip = "ttft_p90_ms" if traffic["loop"] == "closed" else "tpot_p90_ms"
    e2e = [m for m in E2E if m["name"] != skip]
    return spec.Cell(name="tiny", config=config, traffic=dict(traffic),
                     check=dict(check), chips=1, end_to_end=e2e,
                     per_layer=[])


class HostEnergy:
    """Joules as 100 W of host time: stands in for NVML off the card."""
    source = "host_time_test"

    def __init__(self):
        self.t0 = time.perf_counter()

    def joules(self):
        return 100.0 * (time.perf_counter() - self.t0)
