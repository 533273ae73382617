"""Driver: run every (arch x shape x mesh) dry-run of the port in isolated
subprocesses (port of ``src/repro/launch/dryrun_all.py``).

Each combo runs ``repro_torch.launch.dryrun`` in a fresh process (its fake
process group is made once per process; isolation also bounds the memory
of the traces).  Existing JSON outputs are skipped unless --force.
``--device`` is passed through: the device type of the fake tensors
(``cuda`` by default; ``cpu`` where there is no card).

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--mesh single|multi|both] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from repro_torch.configs import ARCH_IDS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--archs", default=None, help="comma-separated subset")
    ap.add_argument("--shapes", default="train_4k,prefill_32k,decode_32k,long_500k")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors, passed to each "
                         "dry-run (nothing is allocated on it)")
    args = ap.parse_args(argv)

    archs = args.archs.split(",") if args.archs else ARCH_IDS
    shapes = args.shapes.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = []
    t0 = time.time()
    for multi in meshes:
        outdir = os.path.join("results", "dryrun", "2x16x16" if multi else "16x16")
        for arch in archs:
            for shape in shapes:
                path = os.path.join(outdir, f"{arch}__{shape}.json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip] {path}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", outdir,
                       "--device", args.device]
                if multi:
                    cmd.extend(["--multi-pod", "--no-extrapolate"])
                print(f"[run ] {' '.join(cmd[3:])}", flush=True)
                try:
                    r = subprocess.run(cmd, timeout=args.timeout,
                                       capture_output=True, text=True)
                    if r.returncode != 0:
                        failures.append((arch, shape, multi, r.stderr[-2000:]))
                        print(f"[FAIL] {arch} {shape} multi={multi}\n"
                              f"{r.stderr[-800:]}", flush=True)
                    else:
                        print(r.stdout.strip().splitlines()[-1], flush=True)
                except subprocess.TimeoutExpired:
                    failures.append((arch, shape, multi, "timeout"))
                    print(f"[TIMEOUT] {arch} {shape} multi={multi}", flush=True)
    print(f"\ndone in {time.time()-t0:.0f}s; {len(failures)} failures")
    for a, s, m, err in failures:
        print(f"  FAIL {a} x {s} multi={m}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
