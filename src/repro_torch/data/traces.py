"""Production-trace synthesis (Alibaba ServeGen-like chat, Azure-2024-like
code/conversation) and replay utilities.

The real datasets are not redistributable inside this offline container, so
we synthesize traces matched to their *published characterizations*:

* Alibaba chat (ServeGen, arXiv:2505.09999): bursty arrivals (CV > 1,
  gamma inter-arrivals), log-normal prompt lengths with a mostly-short body
  and a long tail past 4k, moderate output lengths (chatty turns).
* Azure LLM inference 2024 (AzurePublicDataset): *code* slices have long
  prompts (IDE context, median in the thousands) with short completions;
  *conversation* slices have shorter prompts and longer, streamed outputs.
  The paper downsamples to 1/8-1/4 of cluster rate for one node; our
  ``azure_*5`` / ``azure_*8`` variants correspond to the 1/5 and 1/8 rates.

Every generator is seeded and returns plain ``Request`` lists, so trace
replays are exactly reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core import Request


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    name: str
    qps: float
    duration: float
    # gamma inter-arrival burstiness (shape k; k=1 -> Poisson, k<1 -> bursty)
    burst_k: float
    # lognormal prompt lengths
    prompt_mu: float
    prompt_sigma: float
    prompt_clip: tuple
    # lognormal output lengths
    out_mu: float
    out_sigma: float
    out_clip: tuple
    seed: int = 0


def synthesize(spec: TraceSpec) -> List[Request]:
    rng = np.random.default_rng(spec.seed)
    n_est = int(spec.qps * spec.duration * 1.5) + 16
    gaps = rng.gamma(spec.burst_k, 1.0 / (spec.qps * spec.burst_k), n_est)
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < spec.duration]
    n = len(arrivals)
    plen = np.exp(rng.normal(spec.prompt_mu, spec.prompt_sigma, n))
    plen = np.clip(plen, *spec.prompt_clip).astype(int)
    olen = np.exp(rng.normal(spec.out_mu, spec.out_sigma, n))
    olen = np.clip(olen, *spec.out_clip).astype(int)
    return [Request(rid=i, arrival=float(arrivals[i]),
                    prompt_len=int(plen[i]), output_len=int(olen[i]))
            for i in range(n)]


def alibaba_chat(qps: float, duration: float = 300.0, seed: int = 0) -> List[Request]:
    return synthesize(TraceSpec(
        name=f"chat_{qps}qps", qps=qps, duration=duration,
        burst_k=0.6,                       # bursty
        prompt_mu=6.2, prompt_sigma=1.0,   # median ~490, tail past 4k
        prompt_clip=(16, 12288),
        out_mu=6.0, out_sigma=0.8,         # median ~400 output tokens
        out_clip=(16, 2048), seed=seed))


def azure_code(rate_divisor: int, duration: float = 300.0,
               seed: int = 1) -> List[Request]:
    """Azure 2024 code slice at 1/rate_divisor of cluster rate."""
    qps = {8: 1.6, 5: 2.6, 4: 3.2}.get(rate_divisor, 12.8 / rate_divisor)
    return synthesize(TraceSpec(
        name=f"azure_code{rate_divisor}", qps=qps, duration=duration,
        burst_k=0.8,
        prompt_mu=7.6, prompt_sigma=0.9,   # median ~2000, long IDE contexts
        prompt_clip=(128, 16384),
        out_mu=3.9, out_sigma=0.7,         # short completions (~50)
        out_clip=(4, 512), seed=seed))


def azure_conv(rate_divisor: int, duration: float = 300.0,
               seed: int = 2) -> List[Request]:
    qps = {8: 1.9, 5: 3.0, 4: 3.8}.get(rate_divisor, 15.0 / rate_divisor)
    return synthesize(TraceSpec(
        name=f"azure_conv{rate_divisor}", qps=qps, duration=duration,
        burst_k=1.0,
        prompt_mu=6.4, prompt_sigma=1.0,   # median ~600
        prompt_clip=(16, 8192),
        out_mu=5.6, out_sigma=0.7,         # streamed answers (~270)
        out_clip=(16, 2048), seed=seed))


TRACES = {
    **{f"chat_{q}qps": (lambda q=q: alibaba_chat(q)) for q in (1, 3, 5, 8, 10)},
    "azure_code5": lambda: azure_code(5),
    "azure_code8": lambda: azure_code(8),
    "azure_conv5": lambda: azure_conv(5),
    "azure_conv8": lambda: azure_conv(8),
}


def get_trace(name: str, duration: Optional[float] = None,
              seed: Optional[int] = None) -> List[Request]:
    if name.startswith("chat_") and name.endswith("qps"):
        q = float(name[len("chat_"):-len("qps")])
        return alibaba_chat(q, duration or 300.0, seed or 0)
    if name.startswith("azure_code"):
        return azure_code(int(name[len("azure_code"):]), duration or 300.0, seed or 1)
    if name.startswith("azure_conv"):
        return azure_conv(int(name[len("azure_conv"):]), duration or 300.0, seed or 2)
    raise KeyError(name)


def sinusoidal_decode_load(duration: float = 120.0, period: float = 40.0,
                           tps_min: float = 300.0, tps_max: float = 2400.0,
                           step: float = 0.5, seed: int = 3):
    """Synthetic sinusoidal decode TPS target (paper Fig. 1)."""
    t = np.arange(0.0, duration, step)
    tps = tps_min + (tps_max - tps_min) * 0.5 * (1 - np.cos(2 * np.pi * t / period))
    return t, tps
