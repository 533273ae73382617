"""Quickstart: the GreenLLM control plane in ~60 lines.

Profiles a plant, fits the paper's compact models, solves the prefill
frequency optimization (Eq. 14), and runs the dual-loop decode controller
against a step change in load.  Nothing here touches a device: the control
plane is numpy.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import (A100_SXM4_40G as HW, DualLoopController,
                              PrefillOptimizer)
from repro_torch.sim import (PlantModel, profile_decode_table, profile_power,
                             profile_prefill_latency)


def main():
    # 1. A plant: qwen3-14b served on a 2xA100 prefill worker ---------------
    cfg = get_config("qwen3-14b")
    plant = PlantModel(cfg=cfg, hw=HW, n_chips=2, seed=0)

    # 2. Offline profiling -> compact fitted models (paper Figs. 7-8) --------
    lat = profile_prefill_latency(plant)             # t_ref(L) = aL^2 + bL + c
    pwr = profile_power(plant)                       # P(f) cubic
    print(f"latency fit:  a={lat.a:.3e}  b={lat.b:.3e}  c={lat.c:.3e}")
    print(f"power fit:    P(f_max)={pwr.predict(HW.f_max):.0f} W  "
          f"P(f_min)={pwr.predict(HW.f_min):.0f} W")

    # 3. Queueing-aware prefill clock selection (Eq. 12-14) -------------------
    opt = PrefillOptimizer(lat, pwr, HW, HW.p_idle)
    queue = [256, 512, 1024, 4096]                    # pending prompt lengths
    for D in (0.25, 0.5, 1.0, 2.0):
        f, info = opt.choose_frequency(queue, D)
        print(f"deadline D={D:4.2f}s -> f*={f:6.0f} MHz  "
              f"busy={info['busy']*1e3:6.1f} ms  feasible={info['feasible']}")

    # 4. Dual-loop decode controller under a load step (paper §3.3) -----------
    dplant = PlantModel(cfg=cfg, hw=HW, n_chips=1, seed=1)
    table = profile_decode_table(dplant)
    ctl = DualLoopController(HW, table)
    t, last = 0.0, 0.03
    for phase, tps in (("low", 400), ("high", 2400), ("low", 400)):
        for _ in range(300):
            f = ctl.maybe_tick(t)
            batch = max(int(np.ceil(tps * last)), 1)
            dur = dplant.decode_step_latency(batch, 640, f)
            ctl.record_tokens(t + dur, batch, dur)
            last, t = dur, t + dur
        print(f"load={phase:4s} ({tps:4d} TPS) -> clock {ctl.freq:6.0f} MHz, "
              f"TBT {last*1e3:.1f} ms (SLO 100 ms)")


if __name__ == "__main__":
    main()
