"""Training launcher of the port (port of ``src/repro/launch/train.py``).

Two modes:
  * ``--dry-run``: trace the full config's sharded train step against the
    production mesh on fake tensors (``launch.dryrun.run_one``, the same
    path as ``python -m repro_torch.launch.dryrun``): the record goes to
    ``results/dryrun/manual/<arch>__train_4k.json`` under the working
    directory; nothing is allocated on the device.
  * default: real steps of the arch's *smoke* variant on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --dry-run [--multi-pod] [--strategy fsdp]

``--multi-pod`` and ``--strategy`` (default ``tp``) only shape the
dry-run, so the default mode accepts and ignores them, as the reference's
does.  ``--device`` is the device of the steps, or of the dry-run's fake
tensors.
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.training import (AdamWConfig, init_train_state,
                                  make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strategy", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda: the port's kernels; cpu: "
                         "their plain versions)")
    args = ap.parse_args(argv)
    if args.dry_run:
        from repro_torch.launch.dryrun import run_one
        run_one(args.arch, "train_4k", args.multi_pod,
                outdir="results/dryrun/manual", strategy=args.strategy,
                device=args.device)
        return

    cfg = get_config(args.arch).smoke()
    gen = torch.Generator(device=args.device).manual_seed(0)
    state = init_train_state(gen, cfg)
    step = make_train_step(
        cfg, AdamWConfig(warmup_steps=5, total_steps=args.steps), 1)
    data = torch.Generator(device=args.device).manual_seed(1)
    for i in range(args.steps):
        batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (args.batch, args.seq), generator=data,
            device=args.device, dtype=torch.int32)}
        if cfg.num_prefix_embeds:
            batch["prefix_embeds"] = torch.randn(
                (args.batch, cfg.num_prefix_embeds, cfg.d_model),
                generator=data, device=args.device)
        state, m = step(state, batch)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.2f}")


if __name__ == "__main__":
    main()
