"""Run one cell of the port's benchmark on this machine's CUDA device.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (and ``breakdown``
with ``--trace 1``), then ``check``: each compared number with its limit,
which are also the last lines of standard error.  Exits non-zero and prints
no result when there is no CUDA device, fewer than the cell asks for, or
when JAX or the JAX package was loaded.
"""
import os
import sys
import time


def _started() -> float:
    """The ``perf_counter`` reading at which this process started."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return now - max(up - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


STARTED = _started()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
# the port's kernels build into build/kernels/ in this checkout; any other
# cache of a library goes here too, at a fixed path, never a shared one
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden(modules=None):
    """Top-level names of JAX or the JAX package among ``modules`` (this
    process's ``sys.modules``), each compared whole: ``repro_torch`` is not
    ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    import torch
    from chipbench.harness import driver, spec
    cell = spec.load_cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"refused: {a.workload} needs {cell.chips} CUDA device(s), "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from chipbench.harness.energy import NvmlEnergy
    energy = NvmlEnergy(torch.cuda.current_device())
    try:
        res = driver.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                              device="cuda", energy=energy, started=STARTED)
    finally:
        energy.close()
    bad = loaded_forbidden()
    if bad:
        print(f"refused: modules {bad} were loaded in the measured process",
              file=sys.stderr)
        return 3
    keys = ["correct", "attempted", "failed", "metrics", "device",
            "breakdown", "check"]
    print(json.dumps({k: res[k] for k in keys if k in res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
