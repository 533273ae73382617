#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py                       # every phase, one GPU
    python3 chip_smoke.py --phases build,kernels

Phases (each raises on failure; nothing is caught):

1. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   with nvcc (sm_90a) into ``build/kernels`` and print the build time and
   ptxas's register / shared-memory report.
2. kernels: hold each kernel against its plain PyTorch version on the card,
   at the serve path's shapes, in bfloat16 (atol/rtol 2e-2, and at most one
   bf16 rounding apart: atol 1e-3 + rtol 1e-2) and float32 (2e-5 for
   rmsnorm, 1e-4 for attention).  TF32 is off so that the float32
   plain versions compute in float32 (TF32 keeps ~3 significant digits).
   Times (CUDA events, median of 21 samples of 20 launches each, after a
   warm-up, inputs rotated through > 100 MB so L2 is cold as in the model)
   for the kernel, its plain version and one PyTorch call computing the
   same function (``library_ms``, a yardstick the port never calls), and
   the bound: max(bytes / 3.35 TB/s, FLOP / 989 TFLOP/s) for bf16 inputs.
3. equivalence: a 4-layer, full-width qwen2-1.5b in float32 runs one
   300-token prompt and 16 greedy decode steps on the card (kernels) and on
   the CPU (plain versions) from the same params: first-token logits
   allclose at 1e-3, the 16 tokens equal.
4. serve: full-width, full-depth qwen2-1.5b in bfloat16 with seeded random
   weights serves 8 greedy requests (prompts of 100-1000 tokens, 64-128 new
   tokens) through ``serving.api.Server`` and the slot-native engine
   (max_batch 8, max_len 2048, governor greenllm).  The kernels' launch
   counts are set to 0 just before and read just after; each must grow.
5. profile (opt-in, not in the default run): the serve burst again under
   ``torch.profiler`` after a warm-up burst, printing the device's busy
   share of the wall time and the kernel time by name.

The line before the last is one JSON object with a ``kernels`` list; the
last line is {"ok": true, "device": {...}}.  Details go to
``<--out>/chip_smoke.json`` (default ``build/chip_smoke``, git-ignored).
Exits non-zero without a CUDA device or outside a checkout of the
repository.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense tensor-core bf16
L2_FLUSH_BYTES = 100 * 2 ** 20   # > the 50 MB L2
BF16_ROUNDING = (1e-3, 1e-2)     # atol, rtol: one bf16 rounding apart
PHASES = ("build", "kernels", "equivalence", "serve")


def log(*a):
    print(*a, flush=True)


# -- timing ---------------------------------------------------------------------

def time_ms(fn, arg_sets, iters=20, reps=21):
    """Median over ``reps`` samples of the mean device time of ``iters``
    calls, rotating through ``arg_sets``.  A sleep kernel queued first lets
    the host enqueue every call before the device reaches them, so host
    launch cost does not show in the device interval."""
    import torch
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    samples = []
    for r in range(reps):
        torch.cuda._sleep(4_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*arg_sets[(r * iters + i) % len(arg_sets)])
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def n_sets(bytes_per_call):
    return max(2, min(64, math.ceil(L2_FLUSH_BYTES / max(bytes_per_call, 1))))


def bound(bytes_, flops):
    """Least time for bf16 work: max(bytes / HBM rate, FLOP / bf16 peak)."""
    t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def max_err(out, want):
    return float((out.float() - want.float()).abs().max())


def check_close(name, out, want, tol):
    """Hold a kernel's output against its plain version at atol = rtol =
    ``tol``.  A bfloat16 output must also pass ``BF16_ROUNDING``: kernel
    and plain version both compute in float32 from the same bf16 inputs and
    round once, so they may differ by one bf16 ulp (<= 2**-7 relative) and
    no more.  2e-2 alone is ~60% of a typical decode output at Sk 2048
    (|out| ~0.03) and would pass a dropped or repeated key chunk.
    Returns (max |err|, the largest share of the bf16 bound used)."""
    import torch
    err = max_err(out, want)
    if not torch.allclose(out.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max |err| {err:.3g} > tol {tol}")
    if out.dtype != torch.bfloat16:
        return err, None
    atol, rtol = BF16_ROUNDING
    share = float(((out.float() - want.float()).abs()
                   / (atol + rtol * want.float().abs())).max())
    if share > 1:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"by more than one bf16 rounding (max |err| "
                             f"{err:.3g}, {share:.2f}x atol {atol} + rtol {rtol})")
    return err, share


# -- phase 1: build ----------------------------------------------------------------

def phase_build(res):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    dt = time.perf_counter() - t0
    log(f"[build] {sorted(libs)} in {dt:.1f}s -> {_build.BUILD_DIR}")
    for name, text in _build.build_logs().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    res["build_s"] = dt


# -- phase 2: kernels ----------------------------------------------------------------

def _rmsnorm_cases(res):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as K
    g = torch.Generator(device="cuda").manual_seed(0)
    rows_main = None
    for rows in (8, 1024):
        d = 1536
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
            x = torch.randn(rows, d, generator=g, device="cuda").to(dt)
            w = torch.randn(d, generator=g, device="cuda") + 1.0
            err, share = check_close(f"rmsnorm {rows}x{d} {dt}",
                                     K.rmsnorm(x, w), K.rmsnorm_plain(x, w), tol)
            case = {"shape": [rows, d], "dtype": str(dt), "max_abs_err": err,
                    "bf16_share": share}
            if dt == torch.bfloat16:
                nbytes = 2 * rows * d * x.element_size() + d * 4
                sets = [(torch.randn(rows, d, generator=g, device="cuda").to(dt), w)
                        for _ in range(n_sets(nbytes))]
                wl = w.to(dt)
                case["ms"] = time_ms(K.rmsnorm, sets)
                case["plain_ms"] = time_ms(K.rmsnorm_plain, sets)
                case["library_ms"] = time_ms(
                    lambda a, _w: F.rms_norm(a, (d,), wl, 1e-6), sets)
                case["bound_ms"], case["bound_by"] = bound(nbytes, 4 * rows * d)
                if rows == 8:
                    rows_main = case
            res["cases"].append({"kernel": "rmsnorm", **case})
            log(f"[kernels] rmsnorm {case}")
    return rows_main


def _decode_inputs(g, B, Sk, KH, Hq, hd, dt, buf):
    """q, k/v as [:, :Sk] views of (B, buf, KH, hd) caches (the serve
    path's ctx slice), k_pos with -1 holes, q_pos."""
    import torch
    q = torch.randn(B, 1, Hq, hd, generator=g, device="cuda").to(dt)
    kc = torch.randn(B, buf, KH, hd, generator=g, device="cuda").to(dt)
    vc = torch.randn(B, buf, KH, hd, generator=g, device="cuda").to(dt)
    q_pos = torch.randint(Sk // 2, Sk, (B,), generator=g, device="cuda",
                          dtype=torch.int32)
    k_pos = torch.arange(Sk, device="cuda", dtype=torch.int32)[None].repeat(B, 1)
    holes = torch.rand(B, Sk, generator=g, device="cuda") < 0.05
    k_pos = torch.where(holes, -1, k_pos).to(torch.int32)
    return q, kc[:, :Sk], vc[:, :Sk], k_pos, q_pos


def _decode_work(k_pos, q_pos, window, Hq, KH, hd, esize, B):
    valid = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window:
        valid &= k_pos > q_pos[:, None] - window
    nv = int(valid.sum())
    nbytes = (nv * 2 * KH * hd * esize + k_pos.numel() * 4 + B * 4
              + 2 * B * Hq * hd * esize)
    return nbytes, 4 * nv * (Hq // KH) * hd * KH


def _decode_cases(res):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as K
    g = torch.Generator(device="cuda").manual_seed(1)
    B, KH, Hq, hd = 8, 2, 12, 128
    main = None
    for Sk, window in ((192, 0), (2048, 0), (2048, 700)):
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            q, k, v, kp, qp = _decode_inputs(g, B, Sk, KH, Hq, hd, dt, 2048)
            err, share = check_close(
                f"decode B={B} Sk={Sk} window={window} {dt}",
                K.decode_attention(q, k, v, kp, qp, window=window),
                K.decode_attention_plain(q, k, v, kp, qp, window=window), tol)
            case = {"shape": [B, Sk, KH, Hq, hd], "window": window,
                    "dtype": str(dt), "max_abs_err": err, "bf16_share": share}
            if dt == torch.bfloat16 and window == 0:
                nbytes, flops = _decode_work(kp, qp, window, Hq, KH, hd, 2, B)
                sets = [_decode_inputs(g, B, Sk, KH, Hq, hd, dt, 2048)
                        for _ in range(n_sets(nbytes))]
                sets = [(q_, k_, v_, kp, qp) for q_, k_, v_, _, _ in sets]
                case["ms"] = time_ms(
                    lambda *a: K.decode_attention(*a, window=window), sets)
                case["plain_ms"] = time_ms(
                    lambda *a: K.decode_attention_plain(*a, window=window), sets)
                # the library yardstick in its own layout (B, H, S, hd)
                valid = ((kp >= 0) & (kp <= qp[:, None]))[:, None, None, :]
                lib_sets = [(q_.transpose(1, 2), k_.transpose(1, 2).contiguous(),
                             v_.transpose(1, 2).contiguous())
                            for q_, k_, v_, _, _ in sets]
                case["library_ms"] = time_ms(
                    lambda q_, k_, v_: F.scaled_dot_product_attention(
                        q_, k_, v_, attn_mask=valid, enable_gqa=True), lib_sets)
                case["bound_ms"], case["bound_by"] = bound(nbytes, flops)
                if Sk == 2048:
                    main = case
            res["cases"].append({"kernel": "decode_attention", **case})
            log(f"[kernels] decode_attention {case}")
    return main


def _flash_cases(res):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K
    g = torch.Generator(device="cuda").manual_seed(2)
    B, KH, Hq, hd = 1, 2, 12, 128
    main = None
    for S, window, softcap in ((96, 0, 0.0), (1024, 0, 0.0), (1024, 256, 30.0)):
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            def mk():
                return (torch.randn(B, S, Hq, hd, generator=g, device="cuda").to(dt),
                        torch.randn(B, S, KH, hd, generator=g, device="cuda").to(dt),
                        torch.randn(B, S, KH, hd, generator=g, device="cuda").to(dt))
            q, k, v = mk()
            kw = dict(causal=True, window=window, softcap=softcap)
            err, share = check_close(
                f"flash S={S} window={window} softcap={softcap} {dt}",
                K.flash_attention(q, k, v, **kw),
                K.flash_attention_plain(q, k, v, **kw), tol)
            case = {"shape": [B, S, KH, Hq, hd], "window": window,
                    "softcap": softcap, "dtype": str(dt), "max_abs_err": err,
                    "bf16_share": share}
            if dt == torch.bfloat16 and window == 0:
                esize = 2
                nbytes = 2 * B * S * Hq * hd * esize + 2 * B * S * KH * hd * esize
                pairs = S * (S + 1) // 2
                flops = 4 * B * Hq * hd * pairs
                sets = [mk() for _ in range(n_sets(nbytes))]
                case["ms"] = time_ms(lambda *a: K.flash_attention(*a, **kw), sets)
                case["plain_ms"] = time_ms(
                    lambda *a: K.flash_attention_plain(*a, **kw), sets)
                lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s)
                            for s in sets]
                case["library_ms"] = time_ms(
                    lambda q_, k_, v_: F.scaled_dot_product_attention(
                        q_, k_, v_, is_causal=True, enable_gqa=True), lib_sets)
                case["bound_ms"], case["bound_by"] = bound(nbytes, flops)
                if S == 1024:
                    main = case
            res["cases"].append({"kernel": "flash_attention", **case})
            log(f"[kernels] flash_attention {case}")
    return main


def _geometry_cases(res):
    """Every head dim / group size the kernels instantiate (the CPU tests'
    case lists), kernel against plain version, untimed."""
    import torch
    from repro_torch.kernels import decode_attention as D
    from repro_torch.kernels import flash_attention as Fl
    g = torch.Generator(device="cuda").manual_seed(3)
    for B, Hq, KH, Sk, hd, window, pos in (
            (2, 8, 2, 512, 64, 0, 300), (1, 16, 8, 256, 128, 0, 255),
            (2, 4, 4, 512, 64, 128, 700), (3, 8, 1, 256, 128, 0, 60),
            (1, 16, 16, 256, 256, 0, 100), (2, 16, 1, 300, 256, 0, 299)):
        j = torch.arange(Sk, device="cuda", dtype=torch.int32)
        last = pos
        kp = last - torch.remainder(last - j, Sk)
        kp = torch.where(kp < 0, -1, kp).to(torch.int32)[None].repeat(B, 1)
        qp = torch.full((B,), pos, device="cuda", dtype=torch.int32)
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            q = torch.randn(B, 1, Hq, hd, generator=g, device="cuda").to(dt)
            k = torch.randn(B, Sk, KH, hd, generator=g, device="cuda").to(dt)
            v = torch.randn(B, Sk, KH, hd, generator=g, device="cuda").to(dt)
            err, share = check_close(
                f"decode geometry {(B, Hq, KH, Sk, hd, window, pos)} {dt}",
                D.decode_attention(q, k, v, kp, qp, window=window),
                D.decode_attention_plain(q, k, v, kp, qp, window=window), tol)
            res["cases"].append({"kernel": "decode_attention", "shape":
                                 [B, Sk, KH, Hq, hd], "window": window,
                                 "dtype": str(dt), "max_abs_err": err,
                                 "bf16_share": share})
    for B, Hq, KH, S, hd, window, softcap, causal in (
            (2, 4, 4, 256, 64, 0, 0.0, True), (1, 16, 1, 128, 128, 0, 0.0, True),
            (2, 4, 2, 384, 64, 128, 0.0, True), (1, 2, 2, 256, 256, 0, 50.0, True),
            (1, 4, 4, 300, 256, 0, 0.0, True), (2, 12, 2, 200, 128, 0, 0.0, False)):
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            q = torch.randn(B, S, Hq, hd, generator=g, device="cuda").to(dt)
            k = torch.randn(B, S, KH, hd, generator=g, device="cuda").to(dt)
            v = torch.randn(B, S, KH, hd, generator=g, device="cuda").to(dt)
            kw = dict(causal=causal, window=window, softcap=softcap)
            err, share = check_close(
                f"flash geometry {(B, Hq, KH, S, hd, window, softcap, causal)} "
                f"{dt}", Fl.flash_attention(q, k, v, **kw),
                Fl.flash_attention_plain(q, k, v, **kw), tol)
            res["cases"].append({"kernel": "flash_attention", "shape":
                                 [B, S, KH, Hq, hd], "window": window,
                                 "softcap": softcap, "causal": causal,
                                 "dtype": str(dt), "max_abs_err": err,
                                 "bf16_share": share})
    log("[kernels] geometry checks passed")


KERNELS = {
    # name: (source, TPU kernel it replaces)
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:24"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:68"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:91"),
}


def phase_kernels(res):
    res["cases"] = []
    res["main_case"] = {"rmsnorm": _rmsnorm_cases(res),
                        "decode_attention": _decode_cases(res),
                        "flash_attention": _flash_cases(res)}
    _geometry_cases(res)


# -- phase 3: equivalence ---------------------------------------------------------------

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def _greedy_run(params, cfg, prompt, steps, device):
    import torch
    from repro_torch.models import decode_step, init_cache, prefill_into_slot
    caches = init_cache(cfg, 1, 512, dtype=torch.float32, device=device)
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=device)[None]
    logits, caches, pos = prefill_into_slot(params, cfg, toks, len(prompt),
                                            caches, 0)
    first = logits.float().cpu()
    out = [int(logits[0].argmax())]
    p = torch.tensor([pos], dtype=torch.int32, device=device)
    for _ in range(steps - 1):
        tok = torch.tensor([[out[-1]]], device=device)
        logits, caches = decode_step(params, cfg, tok, caches, p)
        out.append(int(logits[0].argmax()))
        p = p + 1
    return first, out


def phase_equivalence(res):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("qwen2-1.5b").replace(num_layers=4, dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=300)
    cpu_first, cpu_toks = _greedy_run(params, cfg, prompt, 16, "cpu")
    gpu_first, gpu_toks = _greedy_run(_to(params, "cuda"), cfg, prompt, 16,
                                      "cuda")
    err = max_err(gpu_first, cpu_first)
    log(f"[equivalence] 4-layer full-width qwen2 f32: first-token logits "
        f"max |err| {err:.3g}; tokens cuda {gpu_toks} cpu {cpu_toks}")
    if not torch.allclose(gpu_first, cpu_first, atol=1e-3, rtol=1e-3):
        raise AssertionError(f"first-token logits differ by {err:.3g} > 1e-3")
    if gpu_toks != cpu_toks:
        raise AssertionError("greedy tokens differ between CUDA and CPU")
    res["equivalence"] = {"logits_max_abs_err": err, "tokens": gpu_toks}


# -- phase 4: serve ------------------------------------------------------------------------

def _serve_engine():
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = get_config("qwen2-1.5b")
    return cfg, ServingEngine(cfg, ecfg=EngineConfig(max_batch=8, max_len=2048,
                                                     governor="greenllm"),
                              seed=0, device="cuda")


def _burst(server, vocab):
    """Submit the 8 greedy requests (prompts 100-1000 tokens, 64-128 new
    tokens) and serve them to completion."""
    import numpy as np
    from repro_torch.core import SamplingParams
    rng = np.random.default_rng(0)
    lens = np.linspace(100, 1000, 8).astype(int)
    rng.shuffle(lens)
    handles = [server.submit(rng.integers(0, vocab, size=int(n)),
                             SamplingParams(max_tokens=int(rng.integers(64, 129))))
               for n in lens]
    return lens, handles, server.run()


def phase_profile(res):
    """Opt-in (``--phases ...,profile``): the serve burst once more under
    ``torch.profiler`` (CUDA activity only), after a warm-up burst: the
    device's busy share of the wall time and its kernel time by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.api import Server
    cfg, eng = _serve_engine()
    server = Server(eng)
    _burst(server, cfg.vocab_size)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _burst(server, cfg.vocab_size)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us
    busy = sum(by_name.values()) / 1e6
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log(f"[profile] wall {wall:.3f}s, device busy {busy:.3f}s = "
        f"{100 * busy / wall:.1f}% (idle {100 * (1 - busy / wall):.1f}%)")
    for name, us in top:
        log(f"[profile]   {us / 1e3:9.1f} ms  {100 * us / 1e6 / wall:5.1f}%  "
            f"{name[:90]}")
    res["profile"] = {"wall_s": wall, "device_busy_s": busy,
                      "top_ms": {n: us / 1e3 for n, us in top}}


def phase_serve(res):
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention, flash_attention, rmsnorm
    from repro_torch.serving.api import Server
    mods = {"rmsnorm": rmsnorm, "decode_attention": decode_attention,
            "flash_attention": flash_attention}
    t0 = time.perf_counter()
    cfg, eng = _serve_engine()
    torch.cuda.synchronize()
    log(f"[serve] engine with random bf16 weights built in "
        f"{time.perf_counter() - t0:.1f}s")
    server = Server(eng)
    for m in mods.values():
        m.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lens, handles, rep = _burst(server, cfg.vocab_size)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: m.launches for n, m in mods.items()}
    out_toks = sum(len(h.request.tokens) for h in handles)
    log(rep.summary())
    log(f"[serve] {len(handles)} requests, prompts {sorted(lens.tolist())}, "
        f"{out_toks} tokens out in {wall:.2f}s wall = {out_toks / wall:.1f} "
        f"tokens/s; host drains {eng._host_drains}; launches {counts}")
    if rep.completed != len(handles) or not all(
            h.request.state.name == "FINISHED" for h in handles):
        raise AssertionError(f"only {rep.completed}/{len(handles)} completed")
    for h in handles:
        toks = np.asarray(h.request.tokens)
        if len(toks) != h.request.output_len or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {h.rid}: bad output {toks}")
    for n, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {n} was not launched by the serve path")
    res["serve"] = {"wall_s": wall, "tokens_out": out_toks,
                    "tokens_per_s": out_toks / wall, "launches": counts,
                    "completed": rep.completed, "energy_j": rep.total_energy_j,
                    "host_drains": eng._host_drains}


# -- main ---------------------------------------------------------------------------------

def gpu_name_and_limit():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/chip_smoke",
                    help="directory for the detailed JSON results "
                         "(relative to the checkout)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}, or "
                         "'profile' (a traced serve burst)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no {SRC / 'repro_torch'}; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_limit()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"({card})")
    res = {"card": card}
    fns = {"build": phase_build, "kernels": phase_kernels,
           "equivalence": phase_equivalence, "serve": phase_serve,
           "profile": phase_profile}
    for p in phases:
        t0 = time.perf_counter()
        fns[p](res)
        log(f"[{p}] done in {time.perf_counter() - t0:.1f}s")

    kernels = []
    main_case = res.get("main_case", {})
    launches = res.get("serve", {}).get("launches", {})
    for name, (source, replaces) in KERNELS.items():
        c = main_case.get(name) or {}
        cases = [x for x in res.get("cases", []) if x["kernel"] == name]
        errs = [x["max_abs_err"] for x in cases]
        shares = [x["bf16_share"] for x in cases if x["bf16_share"] is not None]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name),
            "max_abs_err": max(errs) if errs else None,
            "bf16_share": max(shares) if shares else None,
            "ms": c.get("ms"), "plain_ms": c.get("plain_ms"),
            "bound_ms": c.get("bound_ms"), "bound_by": c.get("bound_by"),
            "library_ms": c.get("library_ms"), "shape": c.get("shape")})
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {**res, "kernels": kernels}, indent=1, default=str))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels, "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
