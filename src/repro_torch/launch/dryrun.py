"""The multi-pod dry-run (port of ``src/repro/launch/dryrun.py``): one
sharded step of an arch's full config (a train step, the tensor-parallel
prefill, or one decode step, by the shape's kind) traced against the
production mesh, recording memory, cost and collectives per device,
without allocating device memory.

The reference compiles the step for a 16x16 (or 2x16x16) forced device
mesh and reads XLA's analyses.  The port runs the step itself, in one
process, as rank 0 of a fake process group of 256 (or 512) ranks
(``torch.testing``'s ``FakeStore``: collectives move nothing), on fake
tensors (``FakeTensorMode``: shapes and dtypes, no storage).  Parameters
come from shapes alone (``torch.empty``).  Every operator this rank runs
is counted as it runs (``_Counter``): its operations by the formulas of
``torch.utils.flop_counter`` (FlopCounterMode's), its operand and result
bytes (XLA's "bytes accessed"), the result bytes of each collective under
the reference's five names, and the bytes alive at each point, whose
maximum is the peak.  The kernels take their shape-only route on fake
tensors and add their own operations and bytes (``_build.fake_work``), as
their bounds count them.  DTensor's sharding propagation runs operators
on fake tensors of the global shapes too; those are not this rank's work
and are not counted.

The record keeps the reference's keys, nesting and types, so
``benchmarks/roofline.py`` and ``benchmarks/report.py`` read it unchanged;
its values are the port's own.  ``cost_extrapolated`` comes from traces
at depth 2p and 3p (p the block pattern's length; the reference's are at
p and 2p) with one microbatch, extrapolated linearly in the groups of
layers; since the port counts every operator that runs, it equals a
full-depth trace's count with one microbatch.

A forward step writes its caches in place, as the reference's donated
caches alias its outputs: the record's ``alias_bytes`` are the caches'
local bytes, counted in the arguments and in the outputs, and its peak is
arguments + outputs + temporaries - aliased, as the reference's.
``--kv-quant``, ``--moe-impl`` and ``--moe-group`` change the config as
the reference's flags do and are kept in ``variant``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k --device cpu
Outputs JSON to results/dryrun/<mesh>/<arch>__<shape>.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
import weakref

import torch

from repro_torch.configs import get_config
from repro_torch.launch.specs import SHAPES, build_step

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# c10d operator name fragments -> the reference's HLO collective names
_C10D = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
         ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
         ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
         ("send", "collective-permute"), ("recv", "collective-permute"),
         ("permute", "collective-permute"))

# operators whose results are transcendental functions of their inputs,
# counted by result elements (XLA's "transcendentals")
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "sin", "cos", "rsqrt", "sqrt", "erf", "silu",
                   "gelu", "_softmax", "_log_softmax", "logsumexp", "pow"}

# operators that move no data: storage made, or a tensor relabelled
_NO_WORK = {"empty", "empty_strided", "empty_like", "detach", "alias",
            "lift_fresh", "device", "sym_size", "sym_stride", "sym_numel",
            "sym_storage_offset", "wait_tensor"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class _Counter:
    """This rank's work on fake tensors, operator by operator: operations,
    operand + result bytes, transcendentals, collectives, and the peak of
    the storage bytes alive.  ``observe`` is called by ``_CountingMode``
    for each operator run at the top level (not inside DTensor's sharding
    propagation)."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.coll = {op: {"count": 0, "bytes": 0} for op in COLLECTIVE_OPS}
        self.live = 0
        self.peak = 0
        self._alive = {}

    def _free(self, key):
        self.live -= self._alive.pop(key, 0)

    def _track(self, t):
        if t.device.type == "meta":     # a shape's stand-in, not memory
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._alive:
            return
        n = st.nbytes()
        self._alive[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def observe(self, func, args, kwargs, out):
        name = func.__name__.split(".")[0]
        outs = list(_tensors(out))
        for t in outs:
            self._track(t)
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d", "c10d_functional"):
            for frag, op in _C10D:
                if frag in name:
                    self.coll[op]["count"] += 1
                    self.coll[op]["bytes"] += sum(_nbytes(t) for t in outs)
                    break
            return
        if name in _NO_WORK or func.is_view or (outs and all(
                t.device.type == "meta" for t in outs)):
            # no data moved, or shapes' stand-ins made (cache_specs')
            return
        fn = self._flops.get(func._overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) \
            + sum(_nbytes(t) for t in outs)
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)


def _counting_mode(counter: _Counter):
    """A ``FakeTensorMode`` that shows ``counter`` every operator it runs
    at the top level.  DTensor's sharding propagation enters the same mode
    again to run operators on global shapes; those run at depth 2 and are
    not counted (they are not this rank's work, and they are cached, so
    counting them would depend on the cache)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    class _CountingMode(FakeTensorMode):
        depth = 0

        def __enter__(self):
            self.depth += 1
            return super().__enter__()

        def __exit__(self, *exc):
            self.depth -= 1
            return super().__exit__(*exc)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and self.depth == 1:
                counter.observe(func, args, kwargs, out)
            return out

    return _CountingMode()


@contextlib.contextmanager
def fake_world(n: int):
    """A fake default process group of ``n`` ranks in this process, this
    process rank 0 (its collectives move nothing), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import shutdown
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry-run makes its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        shutdown()


def _local_bytes(tree) -> int:
    return sum(_nbytes(t.to_local() if hasattr(t, "to_local") else t)
               for t in _tensors(tree))


def trace_train(cfg, shape, mesh, strategy: str = "tp",
                num_microbatches=None):
    """One train step of ``cfg`` on ``mesh`` traced on fake tensors of the
    mesh's device type: (built, counter, argument bytes, output bytes)."""
    from repro_torch.kernels import _build
    counter = _Counter()
    work0 = dict(_build.fake_work, calls=dict(_build.fake_work["calls"]))
    with _counting_mode(counter):
        built = build_step(cfg, shape, mesh,
                           num_microbatches=num_microbatches,
                           strategy=strategy)
        state, batch = built["args"]
        arg_bytes = _local_bytes((state, batch))
        new_state, metrics = built["fn"](state, batch)
        out_bytes = _local_bytes((new_state, metrics))
    counter.flops += _build.fake_work["flops"] - work0["flops"]
    counter.bytes += _build.fake_work["bytes"] - work0["bytes"]
    counter.kernel_calls = {k: v - work0["calls"].get(k, 0)
                            for k, v in _build.fake_work["calls"].items()}
    return built, counter, arg_bytes, out_bytes


def trace_forward(cfg, shape, mesh):
    """One forward step (``shape.kind`` prefill or decode) of ``cfg`` on
    ``mesh`` traced on fake tensors of the mesh's device type: (built,
    counter, argument bytes, output bytes, aliased bytes: the caches')."""
    from repro_torch.kernels import _build
    counter = _Counter()
    work0 = dict(_build.fake_work, calls=dict(_build.fake_work["calls"]))
    with _counting_mode(counter):
        built = build_step(cfg, shape, mesh)
        params, caches, batch = built["args"]
        arg_bytes = _local_bytes((params, caches, batch))
        out, new_caches = built["fn"](params, caches, batch)
        out_bytes = _local_bytes((out, new_caches))
        alias = _local_bytes(new_caches)
    counter.flops += _build.fake_work["flops"] - work0["flops"]
    counter.bytes += _build.fake_work["bytes"] - work0["bytes"]
    counter.kernel_calls = {k: v - work0["calls"].get(k, 0)
                            for k, v in _build.fake_work["calls"].items()}
    return built, counter, arg_bytes, out_bytes, alias


def _trace(cfg, shape, mesh, strategy="tp", num_microbatches=None):
    """``trace_train`` or ``trace_forward`` by the shape's kind: (built,
    counter, argument bytes, output bytes, aliased bytes)."""
    if shape.kind == "train":
        return (*trace_train(cfg, shape, mesh, strategy, num_microbatches),
                0)
    return trace_forward(cfg, shape, mesh)


def _cost_of(counter):
    return {"flops": counter.flops, "bytes": counter.bytes,
            "coll_bytes": sum(v["bytes"] for v in counter.coll.values())}


def extrapolate_costs(cfg, shape, mesh, strategy="tp"):
    """Per-step costs at full depth from traces at depth 2p and 3p (p the
    block pattern's length), one microbatch each, extrapolated linearly in
    the number of layer groups, as the reference's (whose XLA analysis
    counts a scanned layer once) does from p and 2p.  Not from p: a stack
    of one layer is laid out otherwise by DTensor's collectives (the
    ZeRO-1 all-gathers of its params), so its bytes are off the line that
    every depth from 2p on lies on."""
    p = len(cfg.block_pattern)
    a = _cost_of(_trace(cfg.replace(num_layers=2 * p), shape, mesh,
                        strategy, 1)[1])
    b = _cost_of(_trace(cfg.replace(num_layers=3 * p), shape, mesh,
                        strategy, 1)[1])
    n_groups = cfg.num_layers / p
    out = {}
    for k in a:
        per_group = b[k] - a[k]
        base = a[k] - 2 * per_group
        out[k] = base + per_group * n_groups
        out[k + "_per_group"] = per_group
        out[k + "_base"] = base
    return out


def run_one(arch: str, shape_name: str, multi_pod: bool, outdir: str,
            moe_impl: str = None, verbose: bool = True,
            kv_quant: bool = False, strategy: str = "tp", tag: str = "",
            extrapolate: bool = True, moe_group: int = None,
            device="cuda"):
    """Trace ``arch``'s ``shape_name`` step on the production mesh of fake
    ``device`` tensors and write its record to
    ``<outdir>/<arch>__<shape>[__tag].json``; returns the record.
    ``moe_impl`` / ``moe_group`` (MoE configs) and ``kv_quant`` change the
    config as the reference's do."""
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_config(arch)
    if moe_impl and cfg.is_moe:
        cfg = cfg.replace(moe_impl=moe_impl)
    if moe_group and cfg.is_moe:
        cfg = cfg.replace(moe_group=moe_group)
    if kv_quant:
        cfg = cfg.replace(kv_quant=True)
    shape = SHAPES[shape_name]
    n_chips = 512 if multi_pod else 256
    with fake_world(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        t0 = time.time()
        built, counter, arg_bytes, out_bytes, alias = _trace(
            cfg, shape, mesh, strategy)
        t_trace = time.time() - t0
        extrap = extrapolate_costs(cfg, shape, mesh, strategy=strategy) \
            if extrapolate else {}
    coll = {**counter.coll,
            "total_bytes": sum(v["bytes"] for v in counter.coll.values())}
    # the peak of live storage counts the caches once: it is arguments +
    # new outputs + temporaries
    temp = counter.peak - arg_bytes - (out_bytes - alias)
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "kind": shape.kind,
        "meta": built["meta"],
        "variant": {"kv_quant": kv_quant, "strategy": strategy,
                    "moe_impl": moe_impl, "tag": tag},
        "moe_impl": cfg.moe_impl if cfg.is_moe else None,
        "lower_s": 0.0, "compile_s": round(t_trace, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias,
            "peak_bytes_per_device": arg_bytes + out_bytes + temp - alias,
        },
        "cost": {
            "flops_per_device": float(counter.flops),
            "bytes_per_device": float(counter.bytes),
            "transcendentals": float(counter.transcendentals),
        },
        "cost_extrapolated": extrap,
        "collectives": coll,
        "model": {
            "params_total": cfg.param_count(),
            "params_active": cfg.param_count(active_only=True),
        },
    }
    os.makedirs(outdir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(outdir, f"{arch}__{shape_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {result['mesh']}: "
              f"compile {t_trace:.1f}s  "
              f"peak/device {result['memory']['peak_bytes_per_device']/2**30:.2f} GiB  "
              f"flops/device {result['cost']['flops_per_device']:.3e}  "
              f"collective {coll['total_bytes']/2**20:.1f} MiB")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, "einsum", "scatter"])
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--moe-group", type=int, default=None)
    ap.add_argument("--strategy", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--tag", default="", help="suffix for perf-variant outputs")
    ap.add_argument("--no-extrapolate", action="store_true",
                    help="skip the cost-extrapolation traces")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors (nothing is "
                         "allocated on it)")
    args = ap.parse_args(argv)
    outdir = args.out or os.path.join(
        "results", "dryrun", "2x16x16" if args.multi_pod else "16x16")
    try:
        run_one(args.arch, args.shape, args.multi_pod, outdir,
                args.moe_impl, kv_quant=args.kv_quant,
                strategy=args.strategy, tag=args.tag,
                extrapolate=not args.no_extrapolate,
                moe_group=args.moe_group, device=args.device)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
