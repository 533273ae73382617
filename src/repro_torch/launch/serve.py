"""Serving launcher of the port: drive the slot-native engine through the
``serving.api.Server`` front door with the reference launcher's synthetic
burst, and print the typed ``ServingReport``.

  python -m repro_torch.launch.serve                    # qwen2-1.5b smoke, CUDA
  python -m repro_torch.launch.serve --full-width       # the full config
  python -m repro_torch.launch.serve --device cpu --requests 4
  python -m repro_torch.launch.serve --paged            # paged KV pool
  python -m repro_torch.launch.serve --prefix-cache     # + prefix cache

Defaults match ``python -m repro.launch.serve`` (qwen2-1.5b, governor
greenllm, unpaged, greedy, max_batch 8, max_len 192).  ``--prefix-cache``
implies ``--paged`` and, as in the reference, opens every synthetic prompt
with one shared 48-token system prompt.  ``--full-width``
serves ``get_config(arch)`` itself, with random seeded weights, instead of
its ``.smoke()`` reduction; virtual time and energy are accounted on the
full config either way.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import SamplingParams
from repro_torch.serving import EngineConfig, Server, ServingEngine


def workload(args, vocab):
    """(arrival, prompt_tokens, max_tokens) triples of the reference
    launcher's synthetic burst (``repro.launch.serve.workload`` without a
    named trace): the same seed, the same draws."""
    rng = np.random.default_rng(0)
    # with --prefix-cache every prompt opens with the same system prompt;
    # the tail is capped so the engine's prompt truncation (the last
    # max_len // 2 tokens) never cuts into it
    sys_prompt = rng.integers(0, vocab, size=48) if args.prefix_cache \
        else np.empty(0, np.int64)
    cap = max(args.max_len // 2 - len(sys_prompt), 1)
    for _ in range(args.requests):
        plen = min(int(rng.integers(16, 80)), cap)
        yield (0.0,
               np.concatenate([sys_prompt,
                               rng.integers(0, vocab, size=plen)]),
               int(rng.integers(16, 64)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--governor", default="greenllm",
                    choices=["greenllm", "defaultnv"])
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=192)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (page-table data plane)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-addressed prompt prefix cache over the "
                         "paged pool (implies --paged); the synthetic "
                         "workload prepends a shared system prompt")
    ap.add_argument("--chunked", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="chunked prefill admission (always on when paged)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (cuda: the "
                         "port's kernels; cpu: their plain versions)")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the full config instead of its .smoke() "
                         "reduction")
    args = ap.parse_args(argv)

    full = get_config(args.arch)
    served = full if args.full_width else full.smoke()
    ecfg = EngineConfig(max_batch=args.max_batch, max_len=args.max_len,
                        governor=args.governor,
                        paged=args.paged or args.prefix_cache,
                        chunked_prefill=args.chunked,
                        prefix_cache=args.prefix_cache)
    eng = ServingEngine(served, plant_cfg=full, ecfg=ecfg, device=args.device)
    server = Server(eng)
    n = 0
    for arrival, prompt, max_tokens in workload(args, served.vocab_size):
        server.submit(prompt, SamplingParams(max_tokens=max_tokens),
                      arrival=arrival)
        n += 1
    rep = server.run()
    plane = "engine/paged" if args.paged else "engine"
    print(f"arch={args.arch} governor={args.governor} plane={plane} "
          f"trace=synthetic requests={n}")
    print(rep.summary())
    if eng.prefix_cache is not None:
        st = eng.prefix_cache.stats()
        print(f"  prefix-cache[engine]: hit_rate="
              f"{st['hit_rate'] * 100:.0f}% "
              f"({st['hits']} hits / {st['misses']} misses, "
              f"{st['hit_tokens']} prompt tokens served from cache, "
              f"{st['entries']} pages resident, "
              f"{st['evictions']} evictions)")
    if rep.completed != n:
        raise RuntimeError(f"launcher burst must drain completely: "
                           f"{rep.completed}/{n} completed")
    return rep


if __name__ == "__main__":
    main()
