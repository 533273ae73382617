"""The knee of an open-loop cell, by one sweep of rates on the card.

    python3 chipbench/sweep.py --workload <cell> --rates 2,3,4 --seconds <s>

One set-up, then a window at each rate (the cell's traffic, its seed's
schedule at that rate), the engine drained between windows.  For each rate:
the backlog (requests due and without a first token) at the window's
middle and at its end, the share of requests within the TTFT target of
their class (``SLOConfig``'s defaults: 0.4 s for prompts of 1024 tokens or
fewer, 2.0 s above), and the share within a 0.1 s TPOT.  The knee is the
highest rate whose backlog at the end is no larger than at the middle and
whose TTFT attainment is at least 90%; the cell runs at 0.8 times it.
"""
import os
import sys

sys.path[:0] = [os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), p) for p in ("src", "")]

TTFT_SHORT_S, TTFT_LONG_S, SHORT_PROMPT, TPOT_S = 0.4, 2.0, 1024, 0.1


def backlog(records, t) -> int:
    return sum(1 for r in records if r.sent <= t and
               (r.first is None or r.first > t))


def main() -> int:
    import argparse
    import torch
    from chipbench.harness import driver, spec, stats
    from chipbench.harness.energy import NvmlEnergy
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("refused: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(a.workload)
    energy = NvmlEnergy(torch.cuda.current_device())
    try:
        run = driver.Run(cell, a.seed, "cuda", energy=energy, out=sys.stderr)
        run.warm_up()
        for rate in (float(r) for r in a.rates.split(",")):
            run.sink = driver.Sink()
            w = run.window(a.seconds, False, rate)
            t0, t1 = w["t0"], w["t1"]
            recs = [r for r in run.sink.rec.values() if t0 <= r.sent < t1]
            ttft = stats.ttft_s(recs, t0, t1)
            ok = sum(t <= (TTFT_SHORT_S if r.prompt_len <= SHORT_PROMPT
                           else TTFT_LONG_S) for t, r in zip(ttft, recs))
            tpot = stats.tpot_s(run.sink.rec.values(), t0, t1)
            m = stats.window_metrics(list(run.sink.rec.values()),
                                     run.sink.drained, t0, t1, w["joules"])
            print(f"sweep {a.workload} rate {rate}: {len(recs)} due, backlog "
                  f"mid {backlog(recs, t0 + a.seconds / 2)} end "
                  f"{backlog(recs, t1)}, TTFT attainment "
                  f"{100 * ok / len(recs):.1f}%, p90 TTFT "
                  f"{m.get('ttft_p90_ms', float('nan')):.1f} ms, TPOT "
                  f"attainment {100 * sum(t <= TPOT_S for t in tpot) / max(len(tpot), 1):.1f}% "
                  f"of {len(tpot)}, out {m['out_tok_s']:.1f} tok/s, "
                  f"{m['j_per_tok']:.5f} J/tok, {w['preemptions']} "
                  f"preemptions", flush=True)
            while run.engine.has_work():
                run.round()
    finally:
        energy.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
