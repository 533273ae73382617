"""Train a ~100M-parameter dense model for a few hundred steps (port of
``examples/train_small.py``).

Uses the port's training substrate (AdamW + cosine schedule + microbatch
gradient accumulation + checkpointing) over the same synthetic token
pipeline; the checkpoint loads in the reference's ``load_checkpoint`` too.

    PYTHONPATH=src python -m repro_torch.examples.train_small [--steps 300] [--device cpu]
"""
import argparse
import os
import time

import numpy as np
import torch

from repro_torch.models import ModelConfig
from repro_torch.training import (AdamWConfig, init_train_state,
                                  make_train_step, save_checkpoint)

# ~100M params: 14L x d640 (GQA 10/5) x ff2560, 32k vocab
CFG = ModelConfig(
    name="repro-100m", arch_type="dense", num_layers=14, d_model=640,
    num_heads=10, num_kv_heads=5, head_dim=64, d_ff=2560, vocab_size=32_000,
    tie_embeddings=True, max_seq=1024,
)


def data_stream(batch, seq, vocab, seed=0):
    """Synthetic structured data: noisy arithmetic-progression sequences —
    learnable (loss falls well below uniform) without any external dataset.
    Yields int32 numpy token arrays (B, S), the reference's values."""
    rng = np.random.default_rng(seed)
    while True:
        start = rng.integers(0, vocab - 1, (batch, 1))
        step = rng.integers(1, 17, (batch, 1))
        seqs = (start + step * np.arange(seq)[None, :]) % vocab
        noise = rng.integers(0, vocab, (batch, seq))
        mask = rng.random((batch, seq)) < 0.02
        yield np.where(mask, noise, seqs).astype(np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default="results/train_small/ckpt.msgpack")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda: the port's kernels; cpu: "
                         "their plain versions)")
    args = ap.parse_args(argv)

    print(f"model: {CFG.param_count()/1e6:.1f}M params")
    state = init_train_state(
        torch.Generator(device=args.device).manual_seed(0), CFG)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(CFG, opt_cfg, num_microbatches=2)
    stream = data_stream(args.batch, args.seq, CFG.vocab_size)
    t0 = time.time()
    for i in range(args.steps):
        batch = {"tokens": torch.from_numpy(next(stream)).to(args.device)}
        state, m = step_fn(state, batch)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(m['loss']):7.4f}  "
                  f"lr {float(m['lr']):.2e}  gnorm {float(m['grad_norm']):8.2f}  "
                  f"({time.time()-t0:5.1f}s)")
    os.makedirs(os.path.dirname(args.ckpt) or ".", exist_ok=True)
    save_checkpoint(args.ckpt, state["params"])
    print(f"checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()
