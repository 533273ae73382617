"""The readings a cell's ``max_logit_gap`` limit is set from, on the card.

    python3 chipbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds <s>

For each seed, in one process: the cell's set-up and a window at its own
load, the check's sample of the finished requests, and the program's
widest gap (the lower reading is the largest over the seeds).  On the
control seeds the float8 control too: the reference in the program's
place, one precision below bfloat16, its widest gap at the same positions
(the upper reading is the smallest over those seeds).  The benchmark's own
runs never run the control.
"""
import os
import sys

sys.path[:0] = [os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), p) for p in ("src", "")]


def main() -> int:
    import argparse
    import torch
    from chipbench.harness import check, driver, spec
    from chipbench.harness.energy import NvmlEnergy
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("refused: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(a.workload)
    ctrl_seeds = {int(s) for s in a.control_seeds.split(",") if s}
    energy = NvmlEnergy(torch.cuda.current_device())
    out = sys.stderr
    try:
        for seed in (int(s) for s in a.seeds.split(",")):
            run = driver.Run(cell, seed, "cuda", energy=energy, out=out)
            run.warm_up()
            w = run.window(a.seconds, False)
            finished, preempted = run.finished(w)
            run.free()
            rids = check.sample(finished, preempted, seed,
                                cell.check["served_tokens"])
            prompts = [finished[r][0] for r in rids]
            tokens = [finished[r][1] for r in rids]
            if seed in ctrl_seeds:
                prog, ctrl = check.control_gaps(run.ref, run.W, cell.config,
                                                prompts, tokens)
                c = max(float(g.max()) for g in ctrl)
            else:
                prog = check.served_gaps(run.ref, run.W, cell.config,
                                         prompts, tokens)
                c = None
            p = max(float(g.max()) for g in prog)
            n = sum(len(t) for t in tokens)
            print(f"calibrate {a.workload} seed {seed}: program "
                  f"max_logit_gap {p!r} control {c!r} over {n} served "
                  f"tokens of {len(rids)} requests ({len(finished)} "
                  f"finished, {w['preemptions']} preemptions)", flush=True)
            del run
            torch.cuda.empty_cache()
    finally:
        energy.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
