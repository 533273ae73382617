"""The comparison that decides ``correct``.

After the window, a sample drawn from the seed of the requests finished in
it (the one with the most served tokens always among them, and a request
resumed after a preemption where there is one) goes through the family's
plain float32 reference once: each prompt followed by its served tokens.
At every position where a token was served, the gap is the reference's
best logit minus the served token's logit; ``max_logit_gap``, the widest
gap of the sample, is held to the cell's limit (``checks/<cell>.json``).
The served tokens are greedy, so a sound run serves the reference's best
token or one within the rounding of the program's precision.

The control (``control_gaps``) is the reference put in the program's
place in float8: at each of the same positions it reads the gap of the
token the float8 pass puts first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import numpy as np
import torch


def sample(finished: Dict[int, Tuple[np.ndarray, List[int]]],
           preempted: Set[int], seed: int, served: int) -> List[int]:
    """rids of finished requests: the one with the most served tokens,
    one resumed after a preemption (if any finished), then others in an
    order drawn from ``seed`` until ``served`` tokens are covered."""
    if not finished:
        return []
    rng = np.random.default_rng([int(seed) % 2 ** 64, 9])
    rids = sorted(finished)
    chosen = [max(rids, key=lambda r: (len(finished[r][1]),
                                       len(finished[r][0])))]
    resumed = [r for r in rids if r in preempted and r not in chosen]
    if resumed:
        chosen.append(resumed[int(rng.integers(len(resumed)))])
    rest = [r for r in rids if r not in chosen]
    rng.shuffle(rest)
    total = sum(len(finished[r][1]) for r in chosen)
    for r in rest:
        if total >= served:
            break
        chosen.append(r)
        total += len(finished[r][1])
    return chosen


def _inputs(prompts, tokens, device):
    seqs = [torch.as_tensor(np.concatenate([np.asarray(p, np.int64),
                                            np.asarray(t[:-1], np.int64)]),
                            device=device) for p, t in zip(prompts, tokens)]
    wanted = [range(len(p) - 1, len(p) - 1 + len(t))
              for p, t in zip(prompts, tokens)]
    return seqs, wanted


def served_gaps(ref, W, config, prompts: Sequence, tokens: Sequence
                ) -> List[torch.Tensor]:
    """Per request, the gap of each served token below the reference's
    best logit at its position (float32, >= 0)."""
    device = W["embed"].device
    seqs, wanted = _inputs(prompts, tokens, device)
    out = []
    for lg, t in zip(ref.logits(W, config, seqs, wanted), tokens):
        tok = torch.as_tensor(list(t), device=device)[:, None]
        out.append(lg.max(-1).values - lg.gather(1, tok)[:, 0])
    return out


def control_gaps(ref, W, config, prompts: Sequence, tokens: Sequence
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(the program's gaps, the float8 control's gaps) at the served
    positions: the control's token at a position is the one its float8
    pass puts first there, and its gap is read on the float32 logits."""
    device = W["embed"].device
    seqs, wanted = _inputs(prompts, tokens, device)
    exact = ref.logits(W, config, seqs, wanted)
    low = ref.logits(W, config, seqs, wanted, quantized=True)
    prog, ctrl = [], []
    for lg, lq, t in zip(exact, low, tokens):
        tok = torch.as_tensor(list(t), device=device)[:, None]
        best = lg.max(-1).values
        prog.append(best - lg.gather(1, tok)[:, 0])
        ctrl.append(best - lg.gather(1, lq.argmax(-1)[:, None])[:, 0])
    return prog, ctrl


def judge(ref, W, config, finished, preempted, limits: Dict, seed: int,
          out) -> Dict:
    """The compared numbers, each with its limit."""
    rids = sample(finished, preempted, seed, limits["served_tokens"])
    prompts = [finished[r][0] for r in rids]
    tokens = [finished[r][1] for r in rids]
    gaps = served_gaps(ref, W, config, prompts, tokens) if rids else []
    widest = max((float(g.max()) for g in gaps), default=0.0)
    print(f"check sample: {len(rids)} requests, prompts "
          f"{[len(p) for p in prompts]}, served {[len(t) for t in tokens]}, "
          f"{sum(r in preempted for r in rids)} resumed after preemption",
          file=out, flush=True)
    return {"max_logit_gap": {"value": widest,
                              "limit": limits["max_logit_gap"]},
            "served_tokens": {"value": sum(len(t) for t in tokens),
                              "limit": limits["served_tokens"]}}
