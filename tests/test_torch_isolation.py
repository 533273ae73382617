"""The port stands alone: ``src/repro_torch`` imports no JAX, no
``ml_dtypes``, no ``msgpack`` and nothing of the JAX package ``repro`` (the
GPU machine has none of them), and an entry point asked for CUDA runs on CUDA or raises,
never quietly on the CPU.  ``chip_smoke.py`` refuses to run without a GPU
or outside a checkout."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "msgpack", "repro")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_no_forbidden_import_in_the_port_sources():
    found = []
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    assert {PKG / "serving/cluster.py", PKG / "serving/faults.py",
            PKG / "core/prefill_optimizer.py", PKG / "sim/engine.py",
            PKG / "sim/replay.py", PKG / "core/controller_torch.py",
            PKG / "examples/quickstart.py",
            PKG / "examples/serve_trace_replay.py",
            PKG / "training/optimizer.py", PKG / "training/train_loop.py",
            PKG / "training/checkpoint.py", PKG / "launch/train.py",
            PKG / "examples/train_small.py", PKG / "launch/mesh.py",
            PKG / "launch/shardings.py"} <= set(files)
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.relative_to(ROOT)}: {n}" for n in names
                      if _forbidden(n)]
    assert not found, found


def test_importing_the_port_loads_no_jax_or_reference():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if any(m == f or "
            f"m.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
            "assert not bad, bad\n"
            "assert {'repro_torch.launch.serve', 'repro_torch.sim.engine', "
            "'repro_torch.sim.replay', 'repro_torch.core.controller_torch', "
            "'repro_torch.examples.quickstart', "
            "'repro_torch.examples.serve_trace_replay', "
            "'repro_torch.training.optimizer', "
            "'repro_torch.training.train_loop', "
            "'repro_torch.training.checkpoint', 'repro_torch.launch.train', "
            "'repro_torch.examples.train_small'} <= set(sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_cuda_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA path runs for real")
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main
    from repro_torch.models import init_params
    from repro_torch.serving import (EngineConfig, ServingCluster,
                                     ServingEngine)
    cfg = get_config("qwen2-1.5b").smoke()
    with pytest.raises((RuntimeError, AssertionError)):
        ServingEngine(cfg, ecfg=EngineConfig(max_len=64))       # device="cuda"
    params = init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        ServingEngine(cfg, params=params, ecfg=EngineConfig(max_len=64),
                      device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        ServingEngine(cfg, params=params, ecfg=EngineConfig(
            max_len=64, paged=True, prefix_cache=True))         # device="cuda"
    qcfg = cfg.replace(kv_quant=True)
    for paged in (False, True):                                 # int8 caches
        with pytest.raises((RuntimeError, AssertionError)):
            ServingEngine(qcfg, params=params, ecfg=EngineConfig(
                max_len=64, paged=paged, prefix_cache=paged), device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        main(["--requests", "1"])                                # --device cuda
    with pytest.raises((RuntimeError, AssertionError)):
        main(["--requests", "1", "--prefix-cache"])
    with pytest.raises((RuntimeError, AssertionError)):
        ServingCluster(cfg, ecfg=EngineConfig(max_len=64))     # device="cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        ServingCluster(cfg, params=params, ecfg=EngineConfig(max_len=64))
    with pytest.raises((RuntimeError, AssertionError)):
        main(["--requests", "1", "--cluster"])
    from repro_torch.examples import train_small
    from repro_torch.launch import train
    from repro_torch.training import init_train_state
    with pytest.raises((RuntimeError, AssertionError)):
        train.main(["--arch", "qwen2-1.5b", "--steps", "1"])    # --device cuda
    with pytest.raises((RuntimeError, AssertionError)):
        train_small.main(["--steps", "1"])                      # --device cuda
    with pytest.raises((RuntimeError, AssertionError)):
        init_train_state(torch.Generator(device="cuda"), cfg)


def _counts():
    from repro_torch.kernels import (chunk_attention, decode_attention,
                                     decode_attention_q8, flash_attention,
                                     paged_decode_attention, rmsnorm)
    return (rmsnorm.launches, rmsnorm.add_launches, decode_attention.launches,
            chunk_attention.launches, flash_attention.launches,
            paged_decode_attention.launches,
            paged_decode_attention.q8_launches, decode_attention_q8.launches)


def test_kernel_wrappers_take_the_plain_version_only_on_cpu():
    from repro_torch.kernels import (chunk_attention, decode_attention,
                                     decode_attention_q8, flash_attention,
                                     paged_decode_attention, rmsnorm)
    m = lambda *s, dt=torch.float32: torch.empty(s, device="meta", dtype=dt)
    i8, i32 = torch.int8, torch.int32
    before = _counts()
    with pytest.raises(ValueError, match="needs CUDA"):
        rmsnorm.rmsnorm(m(2, 64), m(64))
    with pytest.raises(ValueError, match="needs CUDA"):
        rmsnorm.add_rmsnorm(m(2, 64), m(2, 64), m(64))
    with pytest.raises(ValueError, match="needs CUDA"):
        decode_attention.decode_attention(
            m(2, 1, 4, 64), m(2, 16, 2, 64), m(2, 16, 2, 64),
            m(2, 16, dt=torch.int32), m(2, dt=torch.int32))
    with pytest.raises(ValueError, match="needs CUDA"):
        flash_attention.flash_attention(m(1, 16, 4, 64), m(1, 16, 2, 64),
                                        m(1, 16, 2, 64))
    with pytest.raises(ValueError, match="needs CUDA"):
        chunk_attention.chunk_attention(
            m(1, 8, 4, 64), m(1, 8, 2, 64), m(1, 8, 2, 64), m(5, 16, 2, 64),
            m(5, 16, 2, 64), m(1, 3, dt=torch.int32), 20, 8)
    with pytest.raises(ValueError, match="needs CUDA"):
        chunk_attention.chunk_attention(                 # the int8 route
            m(1, 8, 4, 64), m(1, 8, 2, 64), m(1, 8, 2, 64),
            m(5, 16, 2, 64, dt=i8), m(5, 16, 2, 64, dt=i8),
            m(1, 3, dt=i32), 20, 8, k_scale=m(5, 16, 2, 1),
            v_scale=m(5, 16, 2, 1))
    with pytest.raises(ValueError, match="needs CUDA"):
        paged_decode_attention.paged_decode_attention(
            m(2, 1, 4, 64), m(5, 16, 2, 64), m(5, 16, 2, 64),
            m(2, 3, dt=torch.int32), m(2, dt=torch.int32))
    with pytest.raises(ValueError, match="needs CUDA"):
        decode_attention_q8.decode_attention_q8(
            m(2, 1, 4, 64), m(2, 16, 2, 64, dt=i8), m(2, 16, 2, 1),
            m(2, 16, 2, 64, dt=i8), m(2, 16, 2, 1), m(2, 16, dt=i32),
            m(2, dt=i32))
    with pytest.raises(ValueError, match="needs CUDA"):
        paged_decode_attention.paged_decode_attention(      # the int8 route
            m(2, 1, 4, 64), m(5, 16, 2, 64, dt=i8), m(5, 16, 2, 64, dt=i8),
            m(2, 3, dt=i32), m(2, dt=i32), k_scale=m(5, 16, 2, 1),
            v_scale=m(5, 16, 2, 1))
    x = torch.randn(3, 64)
    rmsnorm.rmsnorm(x, torch.ones(64))                      # plain, not counted
    rmsnorm.add_rmsnorm(x, x, torch.ones(64))               # plain, not counted
    out = chunk_attention.chunk_attention(                  # plain, not counted
        torch.randn(1, 8, 4, 64), torch.randn(1, 8, 2, 64),
        torch.randn(1, 8, 2, 64), torch.randn(5, 16, 2, 64),
        torch.randn(5, 16, 2, 64), torch.ones(1, 3, dtype=i32), 20, 5)
    assert out.shape == (1, 8, 4, 64)
    paged_decode_attention.paged_decode_attention(          # plain, not counted
        torch.randn(2, 1, 4, 64), torch.randn(5, 16, 2, 64),
        torch.randn(5, 16, 2, 64), torch.ones(2, 3, dtype=i32),
        torch.tensor([3, 40], dtype=i32))
    kq = torch.randint(-127, 128, (5, 16, 2, 64), dtype=i8)
    sc = torch.rand(5, 16, 2, 1) + 0.01
    out = paged_decode_attention.paged_decode_attention(    # plain, not counted
        torch.randn(2, 1, 4, 64), kq, kq, torch.ones(2, 3, dtype=i32),
        torch.tensor([3, 40], dtype=i32), k_scale=sc, v_scale=sc)
    assert out.shape == (2, 1, 4, 64) and out.dtype == torch.float32
    out = decode_attention_q8.decode_attention_q8(          # plain, not counted
        torch.randn(2, 1, 4, 64).bfloat16(), kq[:2], sc[:2], kq[:2], sc[:2],
        torch.arange(16, dtype=i32).repeat(2, 1), torch.tensor([3, 15],
                                                               dtype=i32))
    assert out.shape == (2, 1, 4, 64) and out.dtype == torch.bfloat16
    assert _counts() == before


def test_chip_smoke_refuses_without_gpu_or_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
