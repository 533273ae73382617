#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py                       # every phase, one GPU
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,kernels,serve_paged
    python3 chip_smoke.py --phases build,kernels,serve_q8
    python3 chip_smoke.py --phases build,sampling,observability
    python3 chip_smoke.py --phases build,kernels,arch
    python3 chip_smoke.py --phases build,equivalence,arch
    python3 chip_smoke.py --phases build,kernels,equivalence,arch \
        --archs mamba2-370m,recurrentgemma-9b
    python3 chip_smoke.py --phases build,cluster
    python3 chip_smoke.py --phases build,legacy
    python3 chip_smoke.py --phases build,prefill
    python3 chip_smoke.py --phases build,mixed_dtype
    python3 chip_smoke.py --phases build,kernels,equivalence,legacy,prefill,mixed_dtype
    python3 chip_smoke.py --phases build,controller,replay
    python3 chip_smoke.py --phases build,kernels,train
    python3 chip_smoke.py --phases build,mesh
    python3 chip_smoke.py --phases build,train_mesh,dryrun

Phases (each raises on failure; nothing is caught):

1. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   with nvcc (sm_90a), one process per source, into ``build/kernels`` and
   print the build time and ptxas's register / shared-memory report.
2. kernels: hold each kernel against its plain PyTorch version on the card,
   at the serve paths' shapes, in bfloat16 (atol/rtol 2e-2, and at most one
   bf16 rounding apart: atol 1e-3 + rtol 1e-2) and float32 (2e-5 for
   rmsnorm, 1e-4 for attention).  TF32 is off so that the float32
   plain versions compute in float32 (TF32 keeps ~3 significant digits).
   paged_decode_attention must also equal decode_attention bit for bit on
   the same context laid out densely.  rmsnorm and add_rmsnorm run at 8,
   256 and 1024 rows of 1536 and at 4 rows of 10008 (wider than one pass
   of the kernel's registers); add_rmsnorm must equal PyTorch's add
   followed by the unfused kernel bit for bit.  chunk_attention (a prompt
   chunk against its past, read through the page table, and its raw K/V)
   is held against its plain version on every route (bf16 pool, int8 pool
   under bf16 and float32 q, float32 pool under bf16 q (a bf16 model with
   float32 caches: rounded to bf16 as it is staged, and bit for bit the
   bf16 route on the cast past), float32 pool) and head dim, the float32
   routes also against the port's attention oracle, bit for bit across
   repeated launches and across two page chains holding the same context,
   and timed at the paged burst's shape (256 queries at position 512)
   beside SDPA with the same mask and at other key spans, and over a
   float32 chain and a float32 dense row under bf16 q.
   paged_decode_attention runs on float32 pools under bf16 q too (every
   PAGED_CASES row), bit for bit the dense bf16 kernel on the cast
   context, across page orders and across walk lengths, and is timed at
   qwen2's 128-page shape on float32 pools.  The decode body
   splits keys over
   CTAs in fixed spans, so its determinism is checked bit for bit: two
   launches on the same inputs, and the same context in a 1024-slot view
   and in the whole 2048-slot buffer (bf16, float32 and int8 kernels).
   Times (CUDA events, median of 21 samples of 20 launches each, or of 7
   samples of fewer launches for a call over 2 ms, after a warm-up,
   inputs rotated through > 100 MB so L2 is cold as in the model)
   for the kernel, its plain version and one PyTorch call computing the
   same function (``library_ms``, a yardstick the port never calls; none
   attends through a page table, so the paged kernel has none, and the
   dense kernel's time on the same context stands beside it), and the
   bound: max(bytes / 3.35 TB/s, FLOP / 989 TFLOP/s) for bf16 inputs.
   A "[summary]" line per main case gives ms, library_ms and bound_ms.
   ``--src DIR`` imports repro_torch from another source tree (e.g. an
   earlier commit unpacked under build/) to time its kernels with these
   cases in the same call.
   decode_attention_q8 (int8 K/V with float32 scales, q bf16 or f32) is
   held against its plain version on the reference's two cases, the
   serving shape (timed beside the bf16 kernel on the same context,
   dequantized) and every head dim and group size, and its paged int8
   route (``paged_decode_attention`` with scales) against its plain
   version and, bit for bit, against the dense int8 kernel on the same
   context; no PyTorch call attends over int8 K/V, so it has no library
   time.
   Then the dense attention family's shapes: rmsnorm at the QK norm's
   head rows (40960 x 128 for a 1024-token qwen3 prefill) and at d_model
   5120 / 4096 / 3584; flash at qwen3's prefill (40:8) and gemma2's (hd
   256, window 4096, softcap 50); the decode body (dense, int8, paged and
   paged int8) at gemma2's wrapped 4096-slot ring and full layer (16:8,
   hd 256, softcap 50), qwen3 (G 5), chatglm3 (G 16) and granite, the
   paged kernels bitwise equal to the dense ones; chunk_attention with
   window and softcap over page chains and over dense rows (a wrapped
   ring included), at gemma2, qwen3 and chatglm3 shapes and at the gemma2
   path's own chunks (4096 queries at 0, 3904 of 4096 at 4096, on the
   4096-slot ring and on a 16384-slot row), on every route, bitwise
   across repeated launches and between a dense row and a page chain
   holding the same context.  Then recurrentgemma's shapes (MQA 16:1 at
   hd 256, window 2048): rmsnorm at its 2048-token chunk and at mamba2's
   widths (d_model 1024, the SSD's gated norm over rows of 2048); flash
   at the 1024 bucket and past the window; decode on the wrapped
   2048-slot ring and on a 2048-slot dense row; paged decode over
   1024-position chains, bitwise the dense kernel; chunk_attention's
   2048-query chunks into the ring (at 0, and wrapped) and a chunk over a
   page chain.  Every case of every kernel sits in one
   table per kernel (NORM_SHAPES, DECODE_CASES, FLASH_CASES, PAGED_CASES,
   CHUNK_CASES, Q8_CASES); a named row is timed in bf16 and gets a
   "[summary]" line (chunk_attention's with its float32 scratch bytes);
   with a softcap no PyTorch call computes the function, so library_ms is
   none.  Then the training kernels: flash's LSE route (its output bit
   for bit the serve route's, its lse within 1e-4 of the plain one) and
   flash_attention_bwd at every FLASH_CASES row and at the train shape
   (FLASH_BWD_MAIN), and rmsnorm_bwd at every NORM_SHAPES row without and
   with the sum's gradient ds, bf16 and float32, against their plain
   versions (the FlashAttention-2 formula from the stored out and lse;
   the norm gradient in float32) at the forward's tolerances (dw within
   1e-4), bit for bit across two launches and between batch row 0 alone
   and in the batch (the flash backward's grids' CTAs and scratch bytes,
   and the norm backward's geometry, on "[kernels]" lines); timed beside
   SDPA's backward alone and beside F.rms_norm's autograd backward (the
   norm backward at qwen2's and gemma2's train rows), each timed case
   with the device ms of each launch.
3. equivalence: a 4-layer, full-width qwen2-1.5b in float32 runs one
   300-token prompt and 16 greedy decode steps on the card (kernels) and on
   the CPU (plain versions) from the same params: first-token logits
   allclose at 1e-3, the 16 tokens equal.  Then the same model serves 5
   requests through a paged engine with the prefix cache and a 15-page
   pool (prefix hits, a preemption, chunk_attention) on both: the same
   tokens.  Both checks run again with ``kv_quant`` (int8 caches).
   Then fault C2's routes: the same model in bf16 with float32 caches,
   teacher-forced through a prefill into a page chain, chunks over a
   float32 chain and over a float32 dense row, and 8 paged decode steps
   over float32 pools, every call's logits CUDA against CPU within 2e-2
   (the float32-past routes must launch).
   Then qwen3-14b, granite-8b, chatglm3-6b, gemma2-9b, qwen3-moe-30b-a3b,
   mixtral-8x7b, musicgen-large and llava-next-mistral-7b at full width
   and 2 layers (one local + full period for gemma2), float32, CUDA
   against CPU: logits after the prompt at 1e-3 and 8 greedy tokens
   equal; gemma2's prompt is window + 600 tokens, its last 600 one chunk
   through the dense-row route into the wrapped local ring, the others'
   300 tokens.  For the MoE models every routing call's chosen experts
   are compared first: a set that differs where the top-k boundary's two
   probabilities lie more than 1e-5 apart fails; a narrower tie is printed
   with its gap and that model's logits and tokens are reported, not
   asserted.  Then the recurrent models at full width in float32, CUDA
   against CPU: mamba2-370m at 2 layers and recurrentgemma-9b at 3 (one
   rglru, rglru, local period), a 300-token prompt and 8 greedy tokens,
   logits within 1e-4 and tokens equal.  Then one MoE layer at qwen3-moe's
   width (a 1024-token group,
   capacity 1.25): moe_einsum against moe_scatter within 1e-5 in float32,
   the keep mask against the CPU's, and both timed in bf16 (that group
   and an 8-row decode step) beside the layer's bound (every expert's
   weights read once).  Then the unpadded ``prefill`` at full width, 4
   layers, float32, CUDA against CPU (next_pos P + S, last logits at
   1e-3): gemma2-9b with a 5000-token prompt into its 4096-slot rings,
   llava-next-mistral-7b with 2880 seeded prefix embeddings and 256
   tokens, musicgen-large with 64 conditioning frames and 256 tokens,
   recurrentgemma-9b and qwen3-moe-30b-a3b with 2 rows of 512 tokens
   (recurrent rows from zeros; routing over both rows' tokens, compared
   call by call as above).
4. serve: full-width, full-depth qwen2-1.5b in bfloat16 with seeded random
   weights serves 8 greedy requests (prompts of 100-1000 tokens, 64-128 new
   tokens) through ``serving.api.Server`` and the slot-native engine
   (max_batch 8, max_len 2048, governor greenllm).
5. serve_paged: the same model on the paged engine with the prefix cache
   and a 219-page pool serves two waves of 8 greedy requests sharing a
   256-token system prompt; it must preempt, hit the cache and run
   chunk_attention, and no decode kernel but the paged one.  In this phase
   and in phases 4, 6, 8-14, 16 and 17, the kernels' launch counts are set to 0
   just before a path's burst and read just after; each kernel of the path
   must have launched.
6. serve_q8: phases 4 and 5 again with ``kv_quant`` (int8 K/V caches and
   pools with float32 scales): decode_attention_q8, the paged int8 route,
   chunk_attention's int8 route, flash_attention, rmsnorm and add_rmsnorm
   must each have launched.
   Prints tokens/s and the KV bytes per token against bf16's.
7. paged_vs_dense: phase 4's burst through a dense and a paged engine on
   the same weights gives identical tokens, with bf16 caches and with
   ``kv_quant``.
8. sampling: the threefry generator on the card (keys folded over 4096
   rows, raw bits and uniform draws over 8 x 151936) bitwise equal to the
   CPU's, and the sampler's tokens on one bf16 8 x 151936 logits tensor
   (greedy, temperature, top-k, top-p and both filters) equal to the
   CPU's; its wall time per decode step beside the argmax's.  Then phase
   4's burst with every odd request seeded nucleus sampling (temperature
   0.8, top-k 50, top-p 0.95) on a dense engine (greedy, mixed, mixed,
   greedy: tokens/s of the mixed burst beside the all-greedy one) and on
   the serve_paged pool, which preempts (mixed twice, greedy, and mixed on
   a roomy pool).  Each burst repeats its tokens run to run, greedy rows
   equal the all-greedy burst's on the same path, and sampled rows equal
   the dense engine's: in full on the roomy pool and for every request
   the small pool never preempted, up to the first preemption for the
   others (their recomputed bf16 context need not be the same bits).
   The first mixed burst of each path counts launches (paths
   ``sampling`` and ``sampling_paged``).
9. observability: phase 4's burst bare and with metrics, tracer and energy
   ledger installed, on the same weights: the same tokens, host drains,
   virtual time and energy, and the ledger conserves bitwise (path
   ``observability``, its launches counted).
10. arch: the attention-only architectures served on the card, one model
   at a time, each at full width (depths in ``ARCH_RUNS``): qwen3-14b (the
   paper's model) and qwen3-moe-30b-a3b (128 experts, top 8) at 8 of
   their 40 / 48 layers, the serve burst
   on the dense engine, greedy and with every odd request seeded nucleus
   sampling, and the serve_paged waves on the paged engine with the
   prefix cache (hits and a preemption); gemma2-9b at 8 of its 42
   layers, max_len 16384, max_batch 4, 4 prompts of 4500-8000 tokens (past
   the 4096 window: chunked through chunk_attention's dense-ring route;
   decode wraps the rings; softcaps everywhere) on the dense engine with
   bf16 and with int8 caches, and on the paged one (full layers pooled and
   preempting beside dense rings, the prefix cache never hitting a
   hybrid); mixtral-8x7b (every layer a 4096 ring, 8 experts, top 2) at
   full width and 4 layers, the same long burst dense with bf16 and int8
   caches; granite-8b and chatglm3-6b at full width and 4 layers,
   musicgen-large (layer norm, sincos, MHA at hd 64: no rmsnorm launch)
   at full depth, the serve burst; llava-next-mistral-7b (text only) at 8
   of its 32 layers, the serve burst and the paged waves; mamba2-370m (12
   of its 48 SSM blocks: the norms are its only kernels), the serve burst
   greedy and sampled; recurrentgemma-9b at 9 of its 38 layers (6 RG-LRU
   blocks, 3 local MQA layers) the
   serve burst, the long burst (chunks into its 2048-slot rings, decode
   wraps them; ``arch_rgemma_long``), the reuse burst in float32 (a stream
   chunked into a slot an earlier stream left gives the tokens it gives
   alone on a fresh engine, and no decode block moves the recurrent rows
   of a slot outside the batch; ``arch_rgemma_reuse``) and the paged
   waves (its local layers pooled at max_len 2048; they must preempt and
   never hit the prefix cache).  ``--archs`` keeps only the named models
   in this phase and in the equivalence phase's arch checks.
   Paths ``arch_<model>[_sampled|_q8|_paged|_long|_reuse]``, launches
   counted as in phase 5; tokens/s, the burst's peak memory (weights
   included) and a digest of the tokens printed.
11. cluster: the disaggregated prefill/decode cluster, every replica
   reading the same weight tensors.  ``cluster_qwen3``: qwen3-14b at full
   width and depth in bf16 on 2 prefill replicas (one per length class,
   SM <= 1024 prompt tokens and L above) and 1 decode replica (max_batch
   8, max_len 4096, dense-equivalent pools, governor greenllm) serves 12
   requests (prompts 100-2000 tokens, 32-96 new, virtual arrivals 50 ms
   apart, every odd one seeded nucleus sampling): every stream migrates
   once, each prefill replica serves only its class, the tokens equal one
   colocated paged engine's on the same weights, configuration and trace
   (sha256), and the peak memory stays below two copies of the weights;
   prints the bytes each handoff moved beside the stream's live K/V, the
   import retries and each replica's clock.  ``cluster_kill``: qwen2-1.5b
   at full width and depth in float32 (weights and caches) on 1 prefill
   and 2 decode replicas serves 8 requests healthy, then with decode0
   killed mid-decode and one import failed: the greedy rows' and the
   sampled rows' tokens equal the healthy run's, the dead replica's
   energy stays frozen at the kill, and at least one stream is recovered
   (recomputed through chunk_attention).  Launches counted as in phase 5.
12. legacy: the legacy data plane and the eager fallback
   (``phase_legacy``): qwen2-1.5b on ``slot_native=False`` serves 8
   lockstep requests (512-token prompts, 64 new) with the slot-native
   engine's tokens (paths ``legacy_qwen2``, ``legacy_qwen2_slot``,
   tokens/s of both); gemma2-9b with ``chunked_prefill=False`` admits the
   long burst's four prompts through the unpadded prefill
   (``legacy_gemma2_fallback``: 4 legacy prefills, flash 42 x 4, no
   chunk_attention), its agreement with ``arch_gemma2``'s chunked tokens
   printed.
13. prefill: the unpadded ``prefill`` at full width and depth
   (``phase_prefill``): llava-next-mistral-7b with 2 x 2880 prefix
   embeddings and 512 tokens then 32 greedy decode steps
   (``prefill_llava``: next_pos 3392, flash 32, decode 32 x 32);
   qwen3-14b with ``long_context=True`` (8192-slot rings), a 24576-token
   prompt and 32 decode steps, against its window-restricted twin on full
   buffers (``long_qwen3``: prefill logits bitwise; bf16 decode agreement
   printed, teacher-forced, beside the top-2 gaps), and at 8 layers in
   float32 (``long_qwen3_f32``: the same tokens, logits within 1e-3).
14. mixed_dtype: fault C2 end to end (``phase_mixed_dtype``): bf16
   qwen2-1.5b (the serve burst) and gemma2-9b (the long burst, chunked)
   with float32 caches on a dense and on a paged engine: paged tokens
   equal to dense, the float32-past routes launched.
15. controller: the batched dual-loop controller
   (``core/controller_torch.py``): 4096 controllers (16 SLOs x 4 up
   margins x 4 down margins x 16 telemetry traces drawn from ``--seed``
   over qwen3-14b's decode table) over 3000 ticks of 20 ms on the card,
   every tick's clock and the final states bit for bit the same sweep on
   the CPU; wall ms, controller-ticks per second, peak memory and the
   PyTorch operators a tick.
16. replay: the trace-replay example
   (``repro_torch.examples.serve_trace_replay``) at ``--duration 30
   --cluster --prefix-cache --kill-replica decode0 --handoff-failures 3``
   on the card (``replay_example``: the governor table printed, every
   burst completed, warm == cold tokens, decode0's streams recovered, the
   replicas' energy summing to the total); fault C3 (``replay_c3``: a
   float32 model over bf16 pages, cold and warm, tokens equal to the
   CPU's on the same weights); then the example's dense burst and
   ``run_cluster`` with qwen3-14b at full width in bf16, the burst at full
   depth and the cluster at 10 of its 40 layers (``replay_qwen3_dense``,
   ``replay_qwen3_cluster``).  Launches counted as in phase 5.
17. train: training through the backward kernels (``phase_train``):
   ``train_qwen2``, qwen2-1.5b at full width and depth in bf16, B 4 x S
   2048, remat on, the cross-entropy in chunks of 1024, 10 AdamW steps
   (lr 1e-3, warmup 2) on one fixed batch: every loss and grad norm
   finite, the loss below 0.9x its first value, one step's launches
   asserted (flash LSE route 56, flash backward 28, rmsnorm 2,
   add_rmsnorm 111, norm backward 2 + 55 with ds) and every step's the
   same; step ms, tokens/s, peak memory against params + grads + m + v;
   one more step under torch.profiler, its device ms by kernel family
   (GEMMs, flash forward and backward, norm forward and backward, CE,
   AdamW, other elementwise) and the device's idle share; then its
   params through save_checkpoint / load_checkpoint, bit for bit.
   ``train_gemma2``, gemma2-9b at full width and 4 layers, B 1 x S
   5120 (the local layers' 4096 window masks; hd 256, both softcaps,
   sandwich norms), 3 steps, the loss falling.  ``train_arch``: every
   arch's ``.smoke()`` in float32 at S 96, the loss, every gradient and
   one step on CUDA against the CPU from the same weights.  Launches
   counted as in phase 5.
18. mesh: serving on the (1,1) serving mesh (``phase_mesh``), a
   world-size-1 NCCL group (``launch.mesh.init_single_rank``), against
   ``mesh=None``: qwen2-1.5b at full width and depth in bf16, seed-0
   weights, a burst of 4 greedy requests (100-400-token prompts, 32-64 new
   tokens) on the dense engine (``mesh_dense``) and, with a shared
   128-token system prompt, on the paged engine with the prefix cache
   (``mesh_paged``), each served once to warm up with ``mesh=None``, then
   with ``mesh=None``, ``(1,1)``, ``(1,1)``, ``None``: tokens, ServingReport
   floats, energy, host drains, prefix-cache stats and every kernel's
   launch count equal in all five runs, bit for bit; tokens/s of each.  The group is destroyed at the end; a failing NCCL
   init fails the run.  Launches counted as in phase 5.
19. train_mesh: sharded training on the (1,1) mesh (``phase_train_mesh``),
   a world-size-1 NCCL group: qwen2-1.5b at full width and depth in bf16,
   B 4 x S 2048 (the microbatches ``launch.specs.microbatches_for`` gives:
   2), 3 AdamW steps (lr 1e-3, warmup 2) from one seed-0 state under
   ``mesh=None``, then through ``launch.specs.build_train`` under ``tp``
   and under ``fsdp``: every loss and grad norm, every leaf of p, m and v
   after the steps, and every kernel's launch count equal to
   ``mesh=None``'s, bit for bit (at (1,1) every spec sanitizes to
   replicated); step ms of each beside ``mesh=None``'s, and peak GiB.
   Launches counted as in phase 5 (path ``train_mesh``, the tp run).
20. dryrun: the train dry-run (``launch.dryrun.run_one``) on the fake
   16x16 mesh of 256 ranks: qwen2-1.5b ``train_4k`` under ``tp`` and
   ``fsdp`` and mixtral-8x7b ``train_4k`` under ``tp``, each traced on fake
   CUDA tensors and on fake CPU tensors, the six traces in processes of
   their own (``--dryrun-one``), in parallel on every host core, after
   the device phases (so no timed phase shares the host with them): the
   reference's ``[dryrun]`` line of each;
   each CUDA record equal to its CPU twin in every field but the times;
   and ``torch.cuda.max_memory_allocated()`` of each CUDA trace's process
   unmoved by it (after torch's fake-tensor machinery has made the one
   1-element tensor that initializes the CUDA context).
21. profile (opt-in, not in the default run): the serve, serve_paged and
   both serve_q8 bursts, then qwen3-moe-30b-a3b's and recurrentgemma-9b's
   serve bursts at full depth, again under ``torch.profiler`` after a
   warm-up run, printing
   the device's busy share of the wall time, the kernel time by name and
   the port's kernels' time by family with that run's launches, then
   the PyTorch operators the host dispatches per forward pass (in all,
   and the residual adds among them) and the norm launches per pass,
   fused and unfused.

The line before the last is one JSON object with a ``kernels`` list; the
last line is {"ok": true, "device": {...}}.  Details go to
``<--out>/chip_smoke.json`` (default ``build/chip_smoke``, git-ignored).
Exits non-zero without a CUDA device or outside a checkout of the
repository.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense tensor-core bf16
L2_FLUSH_BYTES = 100 * 2 ** 20   # > the 50 MB L2
BF16_ROUNDING = (1e-3, 1e-2)     # atol, rtol: one bf16 rounding apart
PHASES = ("build", "kernels", "equivalence", "serve", "serve_paged",
          "serve_q8", "paged_vs_dense", "sampling", "observability", "arch",
          "cluster", "legacy", "prefill", "mixed_dtype", "controller",
          "replay", "train", "mesh", "train_mesh", "dryrun")
# the paths whose launches count
SERVE_PATHS = ("serve", "serve_paged", "serve_q8", "serve_q8_paged",
               "sampling", "sampling_paged", "observability", "arch_qwen3",
               "arch_qwen3_sampled", "arch_qwen3_paged", "arch_gemma2",
               "arch_gemma2_q8", "arch_gemma2_paged", "arch_granite",
               "arch_chatglm3", "arch_qwen3moe", "arch_qwen3moe_sampled",
               "arch_qwen3moe_paged", "arch_mixtral", "arch_mixtral_q8",
               "arch_musicgen", "arch_llava", "arch_llava_paged",
               "arch_mamba2", "arch_mamba2_sampled", "arch_rgemma",
               "arch_rgemma_long", "arch_rgemma_reuse", "arch_rgemma_paged",
               "cluster_qwen3", "cluster_kill", "legacy_qwen2",
               "legacy_qwen2_slot", "legacy_gemma2_fallback", "prefill_llava",
               "long_qwen3", "long_qwen3_f32", "mixed_dtype_dense",
               "mixed_dtype_paged",
               "mixed_dtype_gemma2_dense", "mixed_dtype_gemma2_paged",
               "replay_example", "replay_c3", "replay_qwen3_dense",
               "replay_qwen3_cluster", "train_qwen2", "train_gemma2",
               "train_arch", "mesh_dense", "mesh_paged", "train_mesh")


def log(*a):
    print(*a, flush=True)


# -- timing ---------------------------------------------------------------------

def time_ms(fn, arg_sets, iters=20, reps=21):
    """Median over ``reps`` samples of the mean device time of ``iters``
    calls, rotating through ``arg_sets``.  A sleep kernel queued first lets
    the host enqueue every call before the device reaches them, so host
    launch cost does not show in the device interval.  A call longer than
    2 ms is sampled 7 times, over as many calls as fill about 20 ms, so
    that a large case stays cheap."""
    import torch
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    once_ms = (time.perf_counter() - t0) * 1e3
    if once_ms > 2:
        iters, reps = max(1, min(iters, round(20 / once_ms))), 7
    samples = []
    for r in range(reps):
        torch.cuda._sleep(4_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*arg_sets[(r * iters + i) % len(arg_sets)])
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def n_sets(bytes_per_call):
    return max(2, min(64, math.ceil(L2_FLUSH_BYTES / max(bytes_per_call, 1))))


def bound(bytes_, flops):
    """Least time for bf16 work: max(bytes / HBM rate, FLOP / bf16 peak)."""
    t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def max_err(out, want):
    return float((out.float() - want.float()).abs().max())


def check_close(name, out, want, tol, one_rounding=True):
    """Hold a kernel's output against its plain version at atol = rtol =
    ``tol``.  A bfloat16 output must also pass ``BF16_ROUNDING`` (unless
    ``one_rounding`` is false: ``want`` is not the same arithmetic): kernel
    and plain version both compute in float32 from the same bf16 inputs and
    round once, so they may differ by one bf16 ulp (<= 2**-7 relative) and
    no more.  2e-2 alone is ~60% of a typical decode output at Sk 2048
    (|out| ~0.03) and would pass a dropped or repeated key chunk.
    Returns (max |err|, the largest share of the bf16 bound used)."""
    import torch
    err = max_err(out, want)
    if not torch.allclose(out.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max |err| {err:.3g} > tol {tol}")
    if out.dtype != torch.bfloat16 or not one_rounding:
        return err, None
    atol, rtol = BF16_ROUNDING
    share = float(((out.float() - want.float()).abs()
                   / (atol + rtol * want.float().abs())).max())
    if share > 1:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"by more than one bf16 rounding (max |err| "
                             f"{err:.3g}, {share:.2f}x atol {atol} + rtol {rtol})")
    return err, share


# -- phase 1: build ----------------------------------------------------------------

def phase_build(res):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    dt = time.perf_counter() - t0
    log(f"[build] {sorted(libs)} in {dt:.1f}s -> {_build.BUILD_DIR}")
    res["ptxas"] = {}
    for name, text in _build.build_logs().items():
        fn = spill = None
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "spill" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line and fn:
                regs = line.split("Used")[-1].strip()
                res["ptxas"][f"{name}:{fn}"] = f"{regs}; {spill}"
                log(f"[build] {name}: {_demangle(fn)}: {regs}; {spill}")
    res["build_s"] = dt


def _demangle(sym):
    """A kernel's C++ name without its argument list (c++filt where the
    machine has it, else the mangled name)."""
    try:
        out = subprocess.run(["c++filt", sym], capture_output=True, text=True,
                             timeout=10).stdout.strip()
    except OSError:
        return sym
    return out.replace("(anonymous namespace)", "{anon}").split("(")[0] \
        if out else sym


# -- phase 2: kernels ----------------------------------------------------------------

def _timed(res, name, case, kern, plain, sets, nbytes, flops, library=None):
    """Times one bf16 case into ``case``: ms, plain_ms, bound_ms, bound_by
    and library_ms (``library`` = (fn, sets), one PyTorch call computing
    the same function; None where there is none), and lists it under
    ``name`` for a "[summary]" line."""
    case["ms"] = time_ms(kern, sets)
    case["plain_ms"] = time_ms(plain, sets)
    case["bound_ms"], case["bound_by"] = bound(nbytes, flops)
    case["library_ms"] = time_ms(*library) if library else None
    res["timed"].append((name, case))
    return case


# rmsnorm rows: the serve paths' (8 decode rows, a 256-token chunk, the
# 1024-token prefill bucket) of qwen2's 1536; 4 x 10008, wider than one pass
# of the kernel's registers (the last pass partial); the QK norm's head rows
# of a 1024-token qwen3 prefill (q: 40960 x 128, k: 8192 x 128) and of a
# decode step (8 x 40 = 320 x 128); d_model 5120 (qwen3), 4096 (granite,
# chatglm3) and 3584 (gemma2)
NORM_SHAPES = ((8, 1536), (256, 1536), (1024, 1536), (4, 10008),
               (40960, 128), (8192, 128), (320, 128), (8, 5120),
               (1024, 5120), (8, 4096), (8, 3584), (4096, 3584),
               # recurrentgemma's 2048-token chunk, mamba2's d_model and its
               # SSD gated norm (float32 rows of 2048 in the model)
               (2048, 4096), (8, 1024), (1024, 1024), (8, 2048),
               (1024, 2048),
               # the train phase's rows: qwen2's (B 4 x S 2048 of 1536)
               # and gemma2's (S 5120 of 3584)
               (8192, 1536), (5120, 3584))


def _rmsnorm_cases(res):
    """rmsnorm and add_rmsnorm against their plain versions at NORM_SHAPES,
    bf16 and float32; add_rmsnorm also bitwise against PyTorch's add
    followed by the unfused kernel.  Timed in bf16 beside the library
    (``F.rms_norm``; for the fused kernel ``x + delta`` then
    ``F.rms_norm``); the timed fused calls add into their inputs in place,
    as the model does.  Returns the 8 x 1536 cases (rmsnorm,
    add_rmsnorm)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as K
    g = torch.Generator(device="cuda").manual_seed(0)
    mains = {}
    for rows, d in NORM_SHAPES:
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
            def mk():
                return (torch.randn(rows, d, generator=g, device="cuda").to(dt),
                        torch.randn(rows, d, generator=g, device="cuda").to(dt))
            x, delta = mk()
            w = torch.randn(d, generator=g, device="cuda") + 1.0
            err, share = check_close(f"rmsnorm {rows}x{d} {dt}",
                                     K.rmsnorm(x, w), K.rmsnorm_plain(x, w), tol)
            # the sum goes into x in place: each call gets its own copy
            s_, h = K.add_rmsnorm(x.clone(), delta, w)
            _, h_plain = K.add_rmsnorm_plain(x.clone(), delta, w)
            a_err, a_share = check_close(f"add_rmsnorm {rows}x{d} {dt}", h,
                                         h_plain, tol)
            if not (torch.equal(s_, x + delta)
                    and torch.equal(h, K.rmsnorm(s_, w))):
                raise AssertionError(f"add_rmsnorm {rows}x{d} {dt}: not "
                                     "bitwise x + delta and rmsnorm of it")
            case = {"shape": [rows, d], "dtype": str(dt), "max_abs_err": err,
                    "bf16_share": share}
            acase = {"shape": [rows, d], "dtype": str(dt),
                     "max_abs_err": a_err, "bf16_share": a_share,
                     "bitwise_add_then_rmsnorm": True}
            if dt == torch.bfloat16:
                es = x.element_size()
                nbytes = 2 * rows * d * es + d * 4
                abytes = 4 * rows * d * es + d * 4
                sets = [mk() + (w,) for _ in range(n_sets(abytes))]
                wl = w.to(dt)
                _timed(res, f"rmsnorm {rows}x{d}", case,
                       lambda a, _d, w_: K.rmsnorm(a, w_),
                       lambda a, _d, w_: K.rmsnorm_plain(a, w_), sets, nbytes,
                       4 * rows * d,
                       (lambda a, _d, _w: F.rms_norm(a, (d,), wl, 1e-6), sets))
                acase["library"] = "x + delta, then F.rms_norm"
                _timed(res, f"add_rmsnorm {rows}x{d}", acase, K.add_rmsnorm,
                       K.add_rmsnorm_plain, sets, abytes, 5 * rows * d,
                       (lambda a, b, _w: F.rms_norm(a + b, (d,), wl, 1e-6),
                        sets))
                if (rows, d) == (8, 1536):
                    mains = {"rmsnorm": case, "add_rmsnorm": acase}
            res["cases"].append({"kernel": "rmsnorm", **case})
            res["cases"].append({"kernel": "add_rmsnorm", **acase})
            log(f"[kernels] rmsnorm {case}")
            log(f"[kernels] add_rmsnorm {acase}")
    return mains["rmsnorm"], mains["add_rmsnorm"]


def _decode_inputs(g, B, Sk, KH, Hq, hd, dt, buf, ring=False):
    """q, k/v as [:, :Sk] views of (B, buf, KH, hd) caches (the serve
    path's ctx slice), k_pos and q_pos: k_pos with -1 holes and q_pos in
    [Sk / 2, Sk), or, for a ``ring`` (Sk == buf), the slots' positions in a
    wrapped ring whose newest key is q_pos, in [buf + 500, 3 buf)."""
    import torch
    from repro_torch.models.kvcache import ring_slot_positions
    q = torch.randn(B, 1, Hq, hd, generator=g, device="cuda").to(dt)
    kc = torch.randn(B, buf, KH, hd, generator=g, device="cuda").to(dt)
    vc = torch.randn(B, buf, KH, hd, generator=g, device="cuda").to(dt)
    if ring:
        q_pos = torch.randint(buf + 500, 3 * buf, (B,), generator=g,
                              device="cuda", dtype=torch.int32)
        return q, kc, vc, ring_slot_positions(buf, q_pos + 1), q_pos
    q_pos = torch.randint(Sk // 2, Sk, (B,), generator=g, device="cuda",
                          dtype=torch.int32)
    k_pos = torch.arange(Sk, device="cuda", dtype=torch.int32)[None].repeat(B, 1)
    holes = torch.rand(B, Sk, generator=g, device="cuda") < 0.05
    k_pos = torch.where(holes, -1, k_pos).to(torch.int32)
    return q, kc[:, :Sk], vc[:, :Sk], k_pos, q_pos


def _decode_work(k_pos, q_pos, window, Hq, KH, hd, esize, B, key_bytes=None):
    """Bytes and FLOP of one decode call: each valid key's K and V rows
    (``key_bytes`` per key and kv head, 2*hd*esize by default) read once,
    k_pos, q_pos and q read, the output written."""
    valid = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window:
        valid &= k_pos > q_pos[:, None] - window
    nv = int(valid.sum())
    key_bytes = 2 * hd * esize if key_bytes is None else key_bytes
    nbytes = (nv * KH * key_bytes + k_pos.numel() * 4 + B * 4
              + 2 * B * Hq * hd * esize)
    return nbytes, 4 * nv * (Hq // KH) * hd * KH


def _decode_valid(kp, qp, window):
    """The decode mask as SDPA takes it: (B, 1, 1, Sk) bool."""
    valid = (kp >= 0) & (kp <= qp[:, None])
    if window:
        valid &= kp > qp[:, None] - window
    return valid[:, None, None, :]


# decode cases: (B, Hq, KH, Sk, hd, window, softcap, ring, the "[summary]"
# name of a timed case): qwen2's serve shape (12:2) short, long and with a
# window; gemma2's local layer (a wrapped 4096-slot ring, window 4096) and
# full layer (8192 keys), both 16:8 at hd 256 with softcap 50; qwen3 (40:8,
# G 5), chatglm3 (32:2, G 16), granite (32:8); recurrentgemma's local layer
# (MQA 16:1 at hd 256, window 2048) as the long burst's wrapped 2048-slot
# ring and as the serve burst's 2048-slot dense row
DECODE_CASES = [
    (8, 12, 2, 192, 128, 0, 0.0, False, "decode_attention B=8 Sk=192"),
    (8, 12, 2, 2048, 128, 0, 0.0, False, "decode_attention B=8 Sk=2048"),
    (8, 12, 2, 2048, 128, 700, 0.0, False, None),
    (4, 16, 8, 4096, 256, 4096, 50.0, True,
     "decode_attention gemma2 local ring"),
    (4, 16, 8, 8192, 256, 0, 50.0, False, None),
    (8, 40, 8, 2048, 128, 0, 0.0, False, "decode_attention qwen3"),
    (8, 32, 2, 2048, 128, 0, 0.0, False, None),
    (8, 32, 8, 2048, 128, 0, 0.0, False, None),
    (4, 16, 1, 2048, 256, 2048, 0.0, True,
     "decode_attention rgemma local ring"),
    (8, 16, 1, 2048, 256, 2048, 0.0, False, "decode_attention rgemma")]


def _decode_cases(res):
    """decode_attention against its plain version at DECODE_CASES, bf16 and
    float32; the named cases timed in bf16 beside SDPA with the same mask
    where there is no softcap (no PyTorch call caps logits).  Returns
    qwen2's Sk 2048 case."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as K
    g = torch.Generator(device="cuda").manual_seed(1)
    main = None
    for B, Hq, KH, Sk, hd, window, cap, ring, name in DECODE_CASES:
        kw = dict(window=window, softcap=cap)
        buf = Sk if ring else max(Sk, 2048)
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            q, k, v, kp, qp = _decode_inputs(g, B, Sk, KH, Hq, hd, dt, buf,
                                             ring)
            err, share = check_close(
                f"decode {(B, Hq, KH, Sk, hd, window, cap, ring)} {dt}",
                K.decode_attention(q, k, v, kp, qp, **kw),
                K.decode_attention_plain(q, k, v, kp, qp, **kw), tol)
            case = {"shape": [B, Sk, KH, Hq, hd], "window": window,
                    "softcap": cap, "ring": ring, "dtype": str(dt),
                    "max_abs_err": err, "bf16_share": share}
            if dt == torch.bfloat16 and name:
                nbytes, flops = _decode_work(kp, qp, window, Hq, KH, hd, 2, B)
                sets = [_decode_inputs(g, B, Sk, KH, Hq, hd, dt, buf, ring)
                        for _ in range(n_sets(nbytes))]
                sets = [(q_, k_, v_, kp, qp) for q_, k_, v_, _, _ in sets]
                library = None
                if not cap:
                    # the library yardstick in its own layout (B, H, S, hd)
                    valid = _decode_valid(kp, qp, window)
                    library = (
                        lambda q_, k_, v_: F.scaled_dot_product_attention(
                            q_, k_, v_, attn_mask=valid, enable_gqa=True),
                        [(q_.transpose(1, 2), k_.transpose(1, 2).contiguous(),
                          v_.transpose(1, 2).contiguous())
                         for q_, k_, v_, _, _ in sets])
                _timed(res, name, case,
                       lambda *a: K.decode_attention(*a, **kw),
                       lambda *a: K.decode_attention_plain(*a, **kw), sets,
                       nbytes, flops, library)
                if name == "decode_attention B=8 Sk=2048":
                    main = case
            res["cases"].append({"kernel": "decode_attention", **case})
            log(f"[kernels] decode_attention {case}")
    return main


# flash cases, batch 1: (S, Hq, KH, hd, window, softcap, the "[summary]"
# name of a timed case): qwen2's prefill (12:2) short, at the 1024 bucket,
# and with window and softcap; qwen3's (40:8); gemma2's (16:8, hd 256) on a
# local layer (window 4096, softcap 50) and a full one (softcap alone);
# recurrentgemma's local layer (MQA 16:1 at hd 256, window 2048) at the
# serve burst's 1024 bucket, and past its window
FLASH_CASES = [(96, 12, 2, 128, 0, 0.0, "flash_attention Sq=Sk=96"),
               (1024, 12, 2, 128, 0, 0.0, "flash_attention Sq=Sk=1024"),
               (1024, 12, 2, 128, 256, 30.0, None),
               (1024, 40, 8, 128, 0, 0.0, "flash_attention qwen3"),
               (4096, 16, 8, 256, 4096, 50.0, "flash_attention gemma2 local"),
               (2048, 16, 8, 256, 0, 50.0, "flash_attention gemma2 full"),
               (1024, 16, 1, 256, 2048, 0.0, "flash_attention rgemma"),
               (2304, 16, 1, 256, 2048, 0.0, None)]


def _sdpa_mask(S, window):
    """SDPA's keywords for causal attention over the last ``window`` keys
    (0: all): ``is_causal`` where the window masks nothing, else a boolean
    (S, S) mask on the card."""
    import torch
    if not window or window >= S:
        return {"is_causal": True}
    i = torch.arange(S, device="cuda")
    return {"attn_mask": (i[None, :] <= i[:, None])
            & (i[None, :] > i[:, None] - window)}


def _flash_cases(res):
    """flash_attention against its plain version at FLASH_CASES, bf16 and
    float32; the named cases timed in bf16 beside SDPA (causal, with the
    window's mask where it masks) where there is no softcap.  Returns
    qwen2's 1024-query case."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K
    g = torch.Generator(device="cuda").manual_seed(2)
    main = None
    for S, Hq, KH, hd, window, cap, name in FLASH_CASES:
        kw = dict(causal=True, window=window, softcap=cap)
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            def mk():
                return tuple(torch.randn(1, S, h, hd, generator=g,
                                         device="cuda").to(dt)
                             for h in (Hq, KH, KH))
            q, k, v = mk()
            err, share = check_close(
                f"flash S={S} {Hq}:{KH} hd={hd} window={window} "
                f"softcap={cap} {dt}", K.flash_attention(q, k, v, **kw),
                K.flash_attention_plain(q, k, v, **kw), tol)
            case = {"shape": [1, S, KH, Hq, hd], "window": window,
                    "softcap": cap, "dtype": str(dt), "max_abs_err": err,
                    "bf16_share": share}
            if dt == torch.bfloat16 and name:
                nbytes = 2 * S * Hq * hd * 2 + 2 * S * KH * hd * 2
                pairs = sum(min(i + 1, window or S) for i in range(S))
                sets = [mk() for _ in range(n_sets(nbytes))]
                sdpa_kw = _sdpa_mask(S, window)
                library = None if cap else (
                    lambda q_, k_, v_: F.scaled_dot_product_attention(
                        q_, k_, v_, enable_gqa=True, **sdpa_kw),
                    [tuple(t.transpose(1, 2).contiguous() for t in s)
                     for s in sets])
                _timed(res, name, case,
                       lambda *a: K.flash_attention(*a, **kw),
                       lambda *a: K.flash_attention_plain(*a, **kw), sets,
                       nbytes, 4 * Hq * hd * pairs, library)
                if name == "flash_attention Sq=Sk=1024":
                    main = case
            res["cases"].append({"kernel": "flash_attention", **case})
            log(f"[kernels] flash_attention {case}")
    return main


# the flash backward's timed train shape: qwen2's layer at the train phase's
# B 4 x S 2048 (12:2 heads, hd 128)
FLASH_BWD_MAIN = (4, 2048, 12, 2, 128)


# a kernel's launches in a profile, by a substring of their names: the
# flash backward's D pre-pass, dK / dV, the reduce and dQ; the norm
# backward's rows and dw's column sums (and a fill, where a wrapper zeroes
# dw before the rows launch)
FLASH_BWD_LAUNCHES = ("delta_kernel", "dkdv_kernel", "reduce_kernel",
                      "dq_kernel")
NORM_BWD_LAUNCHES = ("norm_bwd", "dw_sum_kernel", "FillFunctor")


def _launch_ms(call, parts, n=5):
    """Device ms a call spends in each of its launches (``parts``), over
    ``n`` calls under ``torch.profiler`` after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        for part in parts:
            if part in e.key and us > 0:
                out[part] = out.get(part, 0.0) + us / 1e3 / n
    return out


def _flash_bwd_cases(res, fwd_main):
    """The forward's LSE route and ``flash_attention_bwd`` against their
    plain versions at every FLASH_CASES geometry, bf16 and float32: the
    route's output bit for bit the serve route's, its lse within 1e-4 of
    the plain log-sum-exp; dq, dk, dv within the forward's tolerances of
    the plain backward (the same FlashAttention-2 formula from the same
    out and lse; bf16 also within one bf16 rounding: the kernel takes P and
    dS hi + lo in bf16) and of autograd through the plain forward (the true
    gradient; a bf16 out rounded before D = rowsum(dO o O) puts it past
    one rounding), bit for bit across two launches, and batch row 0 bit
    for bit alone and in the batch (a B 1 case gains a second row); each
    case logs its grids' CTAs and scratch bytes.  Timed in bf16 at the
    named cases (with the device ms of each launch) and at FLASH_BWD_MAIN
    beside SDPA's backward alone (causal, with the window's mask where it
    masks; none with a softcap), bound by operations at 2.5x the forward's
    FLOP; the LSE route timed
    beside the serve route at the forward's main case.  Returns the main
    case."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K
    g = torch.Generator(device="cuda").manual_seed(3)

    def mk(B, S, Hq, KH, hd, dt):
        q, k, v, dout = (torch.randn(B, S, h, hd, generator=g,
                                     device="cuda").to(dt)
                         for h in (Hq, KH, KH, Hq))
        return q, k, v, dout

    def bwd_args(q, k, v, dout, kw):
        out, lse = K.flash_attention(q, k, v, return_lse=True, **kw)
        return q, k, v, out, lse, dout

    main = None
    cases = [(1,) + c for c in FLASH_CASES] + [
        FLASH_BWD_MAIN + (0, 0.0, "flash_attention_bwd train")]
    for B, S, Hq, KH, hd, window, cap, name in cases:
        kw = dict(causal=True, window=window, softcap=cap)
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            what = f"S={S} B={B} {Hq}:{KH} hd={hd} window={window} " \
                   f"softcap={cap} {dt}"
            q, k, v, dout = mk(B, S, Hq, KH, hd, dt)
            args = bwd_args(q, k, v, dout, kw)
            if not torch.equal(args[3], K.flash_attention(q, k, v, **kw)):
                raise AssertionError(f"flash LSE route {what}: output not "
                                     "bitwise the serve route's")
            _, lse_plain = K.flash_attention_plain(q, k, v, return_lse=True,
                                                   **kw)
            lse_err, _ = check_close(f"flash lse {what}", args[4], lse_plain,
                                     1e-4)
            got = K.flash_attention_bwd(*args, **kw)
            again = K.flash_attention_bwd(*args, **kw)
            want = K.flash_attention_bwd_plain(*args, **kw)
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            true = torch.autograd.grad(
                K.flash_attention_plain(*leaves, **kw), leaves, dout)
            errs, shares, true_errs = [], [], []
            for gname, a, b, w, t in zip(("dq", "dk", "dv"), got, again, want,
                                         true):
                if not torch.equal(a, b):
                    raise AssertionError(f"flash_attention_bwd {what}: {gname}"
                                         " differs between two launches")
                e, sh = check_close(f"flash_attention_bwd {gname} {what}", a,
                                    w, tol)
                errs.append(e)
                shares.append(sh)
                true_errs.append(check_close(
                    f"flash_attention_bwd {gname} {what} against autograd "
                    "through the plain forward", a, t, tol,
                    one_rounding=False)[0])
            del leaves, true
            # batch row 0 alone == row 0 of a batched launch
            if B == 1:
                other = bwd_args(*mk(1, S, Hq, KH, hd, dt), kw)
                batched = K.flash_attention_bwd(
                    *(torch.cat([a, o]) for a, o in zip(args, other)), **kw)
                alone = got
                del other
            else:
                batched = got
                alone = K.flash_attention_bwd(
                    *(t[:1].contiguous() for t in args), **kw)
            for gname, a, bt in zip(("dq", "dk", "dv"), alone, batched):
                if not torch.equal(a[0], bt[0]):
                    raise AssertionError(
                        f"flash_attention_bwd {what}: {gname} of batch row 0"
                        " differs alone and in the batch")
            del alone, batched
            geo = K.bwd_geometry(B, S, S, Hq, KH, hd, dt)
            log(f"[kernels] flash_attention_bwd grids {what}: {geo}")
            case = {"shape": [B, S, KH, Hq, hd], "window": window,
                    "softcap": cap, "dtype": str(dt), "max_abs_err": max(errs),
                    "grad_errs": errs, "autograd_errs": true_errs,
                    "lse_err": lse_err,
                    "bf16_share": None if shares[0] is None else max(shares),
                    "bitwise_repeat": True, "bitwise_batch_row": True,
                    "grids": geo}
            if dt == torch.bfloat16 and name:
                es = 2
                nbytes = es * (4 * B * S * Hq * hd + 4 * B * S * KH * hd) \
                    + 4 * B * S * Hq
                pairs = sum(min(i + 1, window or S) for i in range(S))
                sets = [bwd_args(*mk(B, S, Hq, KH, hd, dt), kw)
                        for _ in range(n_sets(nbytes))]
                library = None
                if not cap:
                    sdpa_kw = _sdpa_mask(S, window)

                    def lib_set(q_, k_, v_, _o, _l, g_):
                        leaves = [t.transpose(1, 2).contiguous()
                                  .requires_grad_(True) for t in (q_, k_, v_)]
                        o = F.scaled_dot_product_attention(
                            *leaves, enable_gqa=True, **sdpa_kw)
                        return o, leaves, g_.transpose(1, 2).contiguous()
                    library = (lambda o, leaves, g_: torch.autograd.grad(
                        o, leaves, g_, retain_graph=True),
                        [lib_set(*a) for a in sets])
                    case["library"] = "SDPA backward (" + (
                        "is_causal" if "is_causal" in sdpa_kw
                        else "causal + window mask") + "), alone"
                _timed(res, name.replace("flash_attention ",
                                         "flash_attention_bwd "), case,
                       lambda *a: K.flash_attention_bwd(*a, **kw),
                       lambda *a: K.flash_attention_bwd_plain(*a, **kw),
                       sets, nbytes, 2.5 * 4 * B * Hq * hd * pairs, library)
                case["launch_ms"] = _launch_ms(
                    lambda: K.flash_attention_bwd(*sets[0], **kw),
                    FLASH_BWD_LAUNCHES)
                log(f"[kernels] flash_attention_bwd device ms by launch "
                    f"{what}: {case['launch_ms']}")
                del sets, library
                if name == "flash_attention_bwd train":
                    main = case
            res["cases"].append({"kernel": "flash_attention_bwd", **case})
            log(f"[kernels] flash_attention_bwd {case}")
            del q, k, v, dout, args, got, again, want
        torch.cuda.empty_cache()
    # the LSE route's time at the forward's main case, beside the serve
    # route's (the same launch plus one float32 store a row)
    S, Hq, KH, hd = 1024, 12, 2, 128
    nbytes = 2 * S * Hq * hd * 2 + 2 * S * KH * hd * 2 + 4 * S * Hq
    sets = [mk(1, S, Hq, KH, hd, torch.bfloat16)[:3]
            for _ in range(n_sets(nbytes))]
    fwd_main["lse_route"] = {
        "ms": time_ms(lambda *a: K.flash_attention(*a, return_lse=True), sets),
        "serve_route_ms": time_ms(lambda *a: K.flash_attention(*a), sets),
        "plain_ms": time_ms(lambda *a: K.flash_attention_plain(
            *a, return_lse=True), sets)}
    log(f"[kernels] flash_attention LSE route Sq=Sk=1024 {fwd_main['lse_route']}")
    return main


# rmsnorm_bwd's timed cases, bf16, by (rows, d, ds): qwen2's train rows
# (B 4 x S 2048 of 1536) without and with ds, gemma2's (S 5120 of 3584)
# with ds
NORM_BWD_TIMED = {(8192, 1536, False): "rmsnorm_bwd 8192x1536",
                  (8192, 1536, True): "rmsnorm_bwd 8192x1536 ds",
                  (5120, 3584, True): "rmsnorm_bwd gemma2 5120x3584 ds"}


def _norm_bwd_cases(res):
    """``rmsnorm_bwd`` against its plain version at NORM_SHAPES, without
    and with the sum's gradient ``ds`` (add_rmsnorm's backward), bf16 and
    float32: dx within the forward's tolerances (2e-2, 2e-5), dw (float32
    column sums over every row) within 1e-4, both bit for bit across two
    launches, and row 0's dx alone bit for bit row 0 of the batch; each
    case logs the wrapper's geometry (``bwd_geometry``: CTAs, threads,
    partial rows, scratch bytes).  Timed in bf16 at NORM_BWD_TIMED beside
    ``F.rms_norm``'s autograd backward, bound by bytes, with the device ms
    of each launch.  Returns {(rows, d, ds): timed case}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as K
    g = torch.Generator(device="cuda").manual_seed(4)
    mains = {}
    for rows, d in NORM_SHAPES:
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
            def mk():
                return tuple(torch.randn(rows, d, generator=g,
                                         device="cuda").to(dt)
                             for _ in range(3))
            x, dy, ds = mk()
            w = torch.randn(d, generator=g, device="cuda") + 1.0
            # the geometry (None for a source tree from before it: --src)
            geo = (K.bwd_geometry(rows, d, dt)._asdict()
                   if hasattr(K, "bwd_geometry") else None)
            for with_ds in (False, True):
                what = f"{rows}x{d} {dt} ds={with_ds}"
                extra = (ds,) if with_ds else ()
                dx, dw = K.rmsnorm_bwd(x, w, dy, 1e-6, *extra)
                dx2, dw2 = K.rmsnorm_bwd(x, w, dy, 1e-6, *extra)
                if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
                    raise AssertionError(f"rmsnorm_bwd {what}: differs "
                                         "between two launches")
                alone, _ = K.rmsnorm_bwd(x[:1], w, dy[:1], 1e-6,
                                         *(t[:1] for t in extra))
                if not torch.equal(alone[0], dx[0]):
                    raise AssertionError(f"rmsnorm_bwd {what}: dx of row 0 "
                                         "differs alone and in the batch")
                want = K.rmsnorm_bwd_plain(x, w, dy, 1e-6, *extra)
                err, share = check_close(f"rmsnorm_bwd dx {what}", dx,
                                         want[0], tol)
                werr, _ = check_close(f"rmsnorm_bwd dw {what}", dw, want[1],
                                      1e-4)
                case = {"shape": [rows, d], "dtype": str(dt), "ds": with_ds,
                        "max_abs_err": err, "dw_err": werr,
                        "bf16_share": share, "bitwise_repeat": True,
                        "bitwise_batch_row": True, "geometry": geo}
                name = NORM_BWD_TIMED.get((rows, d, with_ds))
                if dt == torch.bfloat16 and name:
                    es = x.element_size()
                    nbytes = (4 if with_ds else 3) * rows * d * es + 8 * d
                    sets = [mk() + (w,) for _ in range(n_sets(nbytes))]
                    wl = w.to(dt)

                    def call(x_, dy_, ds_, w_, plain=False):
                        fn = K.rmsnorm_bwd_plain if plain else K.rmsnorm_bwd
                        return fn(x_, w_, dy_, 1e-6,
                                  *((ds_,) if with_ds else ()))

                    def lib_set(x_, dy_, _ds, _w):
                        leaves = [x_.clone().requires_grad_(True),
                                  wl.clone().requires_grad_(True)]
                        return (F.rms_norm(leaves[0], (d,), leaves[1], 1e-6),
                                leaves, dy_)
                    case["library"] = "F.rms_norm autograd backward"
                    _timed(res, name, case, call,
                           lambda *a: call(*a, plain=True), sets, nbytes,
                           8 * rows * d,
                           (lambda y, leaves, dy_: torch.autograd.grad(
                               y, leaves, dy_, retain_graph=True),
                            [lib_set(*a) for a in sets]))
                    case["launch_ms"] = _launch_ms(lambda: call(*sets[0]),
                                                   NORM_BWD_LAUNCHES)
                    log(f"[kernels] rmsnorm_bwd {what}: geometry {geo}, "
                        f"device ms by launch {case['launch_ms']}")
                    del sets
                    mains[rows, d, with_ds] = case
                res["cases"].append({"kernel": "rmsnorm_bwd", **case})
                log(f"[kernels] rmsnorm_bwd {case}")
    return mains


def _paged_inputs(g, B, Hq, KH, hd, ps, n, dt, pos_lo=None, cover=None,
                  kv_dt=None):
    """q (B,1,Hq,hd), pools (P,ps,KH,hd) with P = B*n + 1 (page 0 scratch)
    in ``kv_dt`` (q's dtype by default), a (B,n) page table of distinct
    shuffled pages with scratch tails, and q_pos inside each chain
    (``cover`` pages of row b, all n by default)."""
    import torch
    P = B * n + 1
    kv_dt = kv_dt or dt
    q = torch.randn(B, 1, Hq, hd, generator=g, device="cuda").to(dt)
    kp = torch.randn(P, ps, KH, hd, generator=g, device="cuda").to(kv_dt)
    vp = torch.randn(P, ps, KH, hd, generator=g, device="cuda").to(kv_dt)
    perm = torch.randperm(P - 1, generator=g, device="cuda")[:B * n] + 1
    pt = perm.reshape(B, n).to(torch.int32)
    cov = cover if cover is not None else [n] * B
    for b in range(B):
        pt[b, cov[b]:] = 0
    lo = [0 if pos_lo is None else min(pos_lo, c * ps - 1) for c in cov]
    qp = torch.tensor([int(torch.randint(lo[b], cov[b] * ps, (1,),
                                         generator=g, device="cuda"))
                       for b in range(B)], dtype=torch.int32, device="cuda")
    return q, kp, vp, pt, qp


# paged decode cases: (B, Hq, KH, ps, n_pages, hd, window, softcap, pos_lo,
# partial chains, the "[summary]" name of a timed case): the reference's
# three, a short context, qwen2's serving shape; gemma2's full layer (8192
# keys, 16:8, hd 256, softcap 50), qwen3, chatglm3 and granite at 2048 keys;
# recurrentgemma's pooled local layers (16:1, hd 256, window 2048) at the
# paged waves' 1024-position chains
PAGED_CASES = [
    (2, 8, 2, 16, 8, 64, 0, 0.0, None, True, None),
    (3, 4, 4, 8, 6, 128, 0, 0.0, None, True, None),
    (1, 16, 4, 16, 4, 64, 24, 0.0, None, True, None),
    (8, 12, 2, 16, 12, 128, 0, 0.0, 100, False, None),
    (8, 12, 2, 16, 128, 128, 0, 0.0, 1024, False,
     "paged_decode_attention 128 pages"),
    (4, 16, 8, 16, 512, 256, 0, 50.0, 4096, False,
     "paged_decode_attention gemma2 full"),
    (8, 40, 8, 16, 128, 128, 0, 0.0, 1024, False, None),
    (8, 32, 2, 16, 128, 128, 0, 0.0, 1024, False, None),
    (8, 32, 8, 16, 128, 128, 0, 0.0, 1024, False, None),
    (8, 16, 1, 16, 128, 256, 2048, 0.0, 1024, False,
     "paged_decode_attention rgemma"),
    (3, 16, 1, 16, 40, 256, 2048, 0.0, None, True, None)]


# paged decode routes: (q dtype, pool dtype, tolerance); bf16 q over
# float32 pools is a bf16 model with float32 caches (the rounding route)
PAGED_ROUTES = (("bfloat16", "bfloat16", 2e-2), ("float32", "float32", 1e-4),
                ("bfloat16", "float32", 2e-2))


def _same_bits(name, a, b, what):
    import torch
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: {what} differs by {max_err(a, b):.3g} "
                             "(must be bitwise equal)")


def _paged_cases(res):
    """paged_decode_attention against its plain version at PAGED_CASES on
    every route (PAGED_ROUTES) and bitwise against decode_attention on the
    same context laid out densely (in q's dtype: a float32 pool's context
    cast to bf16); the float32 pools also bitwise across page orders (the
    chain moved to other page ids) and walk lengths (the table doubled
    with scratch entries); the named cases timed beside the dense kernel
    on the same context, qwen2's also on float32 pools.  Returns qwen2's
    128-page case, its float32-pool route under ``f32_past_route``."""
    import torch
    from repro_torch.kernels import decode_attention as D
    from repro_torch.kernels import paged_decode_attention as K
    g = torch.Generator(device="cuda").manual_seed(4)
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    main = f32_main = None
    for B, Hq, KH, ps, n, hd, window, cap, pos_lo, partial, label in \
            PAGED_CASES:
        kw = dict(window=window, softcap=cap)
        for qname, pname, tol in PAGED_ROUTES:
            dt, kv_dt = dts[qname], dts[pname]
            rounded = kv_dt != dt
            cover = None
            if partial:
                cover = [int(torch.randint(1, n + 1, (1,), generator=g,
                                           device="cuda")) for _ in range(B)]
            q, kp, vp, pt, qp = _paged_inputs(g, B, Hq, KH, hd, ps, n, dt,
                                              pos_lo, cover, kv_dt)
            out = K.paged_decode_attention(q, kp, vp, pt, qp, **kw)
            name = (f"paged B={B} {Hq}:{KH} hd={hd} ps={ps} n={n} w={window} "
                    f"cap={cap} {dt}" + (" float32 pools" if rounded else ""))
            err, share = check_close(
                name, out, K.paged_decode_attention_plain(
                    q, kp, vp, pt, qp, **kw), tol)
            # the same context laid out densely (in q's dtype): bitwise
            Sk = n * ps
            kd = kp[pt.long()].reshape(B, Sk, KH, hd).to(dt)
            vd = vp[pt.long()].reshape(B, Sk, KH, hd).to(dt)
            kpos = torch.arange(Sk, device="cuda", dtype=torch.int32)[None]
            dense = D.decode_attention(q, kd, vd, kpos.repeat(B, 1), qp, **kw)
            _same_bits(name, out, dense, "the dense kernel on the same "
                       "context")
            case = {"shape": [B, Sk, KH, Hq, hd], "page_size": ps,
                    "window": window, "softcap": cap, "dtype": str(dt),
                    "pool_dtype": str(kv_dt), "max_abs_err": err,
                    "bf16_share": share, "bitwise_equal_dense": True}
            if rounded:
                # other page ids for the same chains, and a walk twice as
                # long whose extra table entries point at scratch page 0
                perm = torch.cat([torch.zeros(1, dtype=torch.long,
                                              device="cuda"),
                                  torch.randperm(kp.shape[0] - 1, generator=g,
                                                 device="cuda") + 1])
                kp2, vp2 = torch.empty_like(kp), torch.empty_like(vp)
                kp2[perm], vp2[perm] = kp, vp
                pt2 = perm[pt.long()].to(torch.int32)
                _same_bits(name, out, K.paged_decode_attention(
                    q, kp2, vp2, pt2, qp, **kw), "another page order")
                _same_bits(name, out, K.paged_decode_attention(
                    q, kp, vp, torch.cat([pt, torch.zeros_like(pt)], 1), qp,
                    **kw), f"a walk of {2 * Sk}")
                case["bitwise_page_order_walk"] = True
            if dt == torch.bfloat16 and label and (
                    not rounded or label == "paged_decode_attention 128 pages"):
                nv = int((qp + 1).clamp(max=Sk).sum())
                nbytes = (nv * 2 * KH * hd * kv_dt.itemsize + B * n * 4
                          + B * 4 + 2 * B * Hq * hd * 2)
                sets = [_paged_inputs(g, B, Hq, KH, hd, ps, n, dt, pos_lo,
                                      kv_dt=kv_dt)
                        for _ in range(n_sets(nbytes))]
                sets = [(q_, kp_, vp_, pt_, qp) for q_, kp_, vp_, pt_, _ in sets]
                # no single PyTorch call attends through a page table
                _timed(res, label + (", float32 pools" if rounded else ""),
                       case, lambda *a: K.paged_decode_attention(*a, **kw),
                       lambda *a: K.paged_decode_attention_plain(*a, **kw),
                       sets, nbytes, 4 * nv * Hq * hd)
                dense_sets = [(q_, kp_[pt_.long()].reshape(B, Sk, KH, hd)
                               .to(dt),
                               vp_[pt_.long()].reshape(B, Sk, KH, hd).to(dt),
                               kpos.repeat(B, 1), qp_)
                              for q_, kp_, vp_, pt_, qp_ in sets]
                case["dense_kernel_ms"] = time_ms(
                    lambda *a: D.decode_attention(*a, **kw), dense_sets)
                if label == "paged_decode_attention 128 pages":
                    if rounded:
                        f32_main = case
                    else:
                        main = case
            res["cases"].append({"kernel": "paged_decode_attention", **case})
            log(f"[kernels] paged_decode_attention {case}")
    main["f32_past_route"] = f32_main
    return main


class ChunkCase(NamedTuple):
    """One chunk_attention case: a chunk of S queries at ``start``, the
    first ``length`` real, Hq:KH heads of hd.  The past is a chain of
    ``ps``-slot pages in a table of ``n_pages`` ids (0: just the chain up
    to start + S) or, with ``buf_len`` > 0, the stream's dense row of
    buf_len slots (a wrapped ring once start > buf_len).  ``bitwise``
    cases are also checked bit for bit across launches and against the
    same context in another page chain; ``summary`` names a timed case."""
    S: int
    start: int
    length: int
    Hq: int
    KH: int
    hd: int
    ps: int = 16
    n_pages: int = 0
    window: int = 0
    softcap: float = 0.0
    buf_len: int = 0
    bitwise: bool = False
    summary: str = ""


CHUNK_CASES = [
    # qwen2's paged burst (timed; its key spans too), a full page-aligned
    # chunk, start inside a page with a partial last page and pads, no
    # past, 16:1 over pages of 8 (rows over many tiles), MHA and 12:2 at
    # hd 256, hd 64
    ChunkCase(256, 512, 200, 12, 2, 128, 16, 64, bitwise=True,
              summary="chunk_attention S=256 at 512"),
    ChunkCase(256, 512, 200, 12, 2, 128, buf_len=2048, bitwise=True,
              summary="chunk_attention S=256 at 512, dense row"),
    ChunkCase(256, 512, 256, 12, 2, 128, 16, 48),
    ChunkCase(96, 37, 90, 12, 2, 128, 16, 10, bitwise=True),
    ChunkCase(64, 0, 64, 8, 8, 64, 16, 4),
    ChunkCase(130, 300, 130, 16, 1, 128, 8, 64),
    ChunkCase(48, 200, 40, 4, 4, 256, 16, 20),
    ChunkCase(40, 1000, 33, 12, 2, 256, 16, 70),
    ChunkCase(200, 77, 150, 8, 2, 64, 16, 24),
    # gemma2 (16:8, hd 256, softcap 50): a chunk into the local layers'
    # 4096-slot ring, wrapped and not, and over a full layer's chain
    ChunkCase(512, 4600, 500, 16, 8, 256, window=4096, softcap=50.0,
              buf_len=4096, bitwise=True,
              summary="chunk_attention gemma2 local, wrapped ring"),
    ChunkCase(512, 1000, 500, 16, 8, 256, window=4096, softcap=50.0,
              buf_len=4096, bitwise=True),
    ChunkCase(512, 4600, 512, 16, 8, 256, softcap=50.0,
              summary="chunk_attention gemma2 full, paged"),
    # the gemma2 path's own chunks (max_len 16384, 4096-query buckets): the
    # first at 0 and the second at 4096, on the ring and on a full layer's
    # dense row
    ChunkCase(4096, 0, 4096, 16, 8, 256, window=4096, softcap=50.0,
              buf_len=4096, summary="chunk_attention gemma2 ring, 4096 at 0"),
    ChunkCase(4096, 4096, 3904, 16, 8, 256, window=4096, softcap=50.0,
              buf_len=4096,
              summary="chunk_attention gemma2 ring, 4096 at 4096"),
    ChunkCase(4096, 0, 4096, 16, 8, 256, softcap=50.0, buf_len=16384,
              summary="chunk_attention gemma2 full row, 4096 at 0"),
    ChunkCase(4096, 4096, 3904, 16, 8, 256, softcap=50.0, buf_len=16384,
              summary="chunk_attention gemma2 full row, 4096 at 4096"),
    # qwen3 (40:8, G 5) over a chain and a dense row, chatglm3 (32:2),
    # a window of 300 over a wrapped 512-slot ring and over a chain
    ChunkCase(256, 512, 200, 40, 8, 128,
              summary="chunk_attention qwen3, paged"),
    ChunkCase(256, 512, 256, 40, 8, 128, buf_len=2048),
    ChunkCase(128, 300, 128, 32, 2, 128),
    ChunkCase(200, 900, 150, 8, 2, 64, window=300, buf_len=512),
    ChunkCase(200, 900, 150, 8, 2, 64, window=300, softcap=30.0),
    # recurrentgemma (MQA 16:1 at hd 256, window 2048): the long burst's
    # 2048-query chunks into the 2048-slot ring (at 0, and wrapped at 4096
    # with a short last chunk), and a recompute chunk of the paged waves
    ChunkCase(2048, 0, 2048, 16, 1, 256, window=2048, buf_len=2048,
              summary="chunk_attention rgemma ring, 2048 at 0"),
    ChunkCase(2048, 4096, 1500, 16, 1, 256, window=2048, buf_len=2048,
              bitwise=True,
              summary="chunk_attention rgemma ring, 2048 at 4096"),
    ChunkCase(256, 512, 200, 16, 1, 256, window=2048, bitwise=True,
              summary="chunk_attention rgemma, paged")]
# (q dtype, past dtype (None: q's), tolerance): the bf16 past, kv_quant's
# int8 past under bf16 and float32 models, a float32 past under bf16 (a bf16
# model with float32 caches: the rounding route), the float32 past
CHUNK_ROUTES = (("bfloat16", None, 2e-2), ("bfloat16", "int8", 2e-2),
                ("bfloat16", "float32", 2e-2), ("float32", None, 1e-4),
                ("float32", "int8", 1e-4))


def _chunk_inputs(g, c, dt, past_dt=None, past=None, perm_seed=None):
    """Case ``c``'s chunk (q, raw k/v in ``dt``) and past, in ``dt``, in
    float32 (``past_dt`` "float32") or int8 with float32 scales
    (``past_dt`` "int8"): a dense row (buf_len, KH, hd), or
    pools (P, ps, KH, hd) and a (1, n_pages) table of distinct shuffled
    page ids (from ``perm_seed`` when given) for the chain up to start + S,
    scratch page 0 past it.  ``past``, the (K, V, K scale, V scale) of
    positions 0 .. start - 1 as ``_past_by_position`` gives them, goes into
    the chain, whose other pages hold other values and whose positions >=
    start (the rest of the last past page and the chunk's pages, which the
    kernel must not read) hold NaN: in K and V, or in the scales of an int8
    pool.  Returns (args, kw) of chunk_attention."""
    import torch
    from repro_torch.models.kvcache import quantize_kv
    S, KH, hd, ps = c.S, c.KH, c.hd, c.ps
    q = torch.randn(1, S, c.Hq, hd, generator=g, device="cuda").to(dt)
    k = torch.randn(1, S, KH, hd, generator=g, device="cuda").to(dt)
    v = torch.randn(1, S, KH, hd, generator=g, device="cuda").to(dt)
    used = -(-(c.start + S) // ps)
    n = c.n_pages or used
    lead = (c.buf_len,) if c.buf_len else (n + used + 1, ps)
    kf = torch.randn(lead + (KH, hd), generator=g, device="cuda")
    vf = torch.randn(lead + (KH, hd), generator=g, device="cuda")
    if past_dt == "int8":
        (kp, ks), (vp, vs) = quantize_kv(kf), quantize_kv(vf)
    elif past_dt == "float32":
        kp, vp, ks, vs = kf, vf, None, None
    else:
        kp, vp, ks, vs = kf.to(dt), vf.to(dt), None, None
    kw = {"k_scale": ks, "v_scale": vs}
    if c.buf_len:
        return (q, k, v, kp, vp, None, c.start, c.length), kw
    pg = g if perm_seed is None else torch.Generator(
        device="cuda").manual_seed(perm_seed)
    pt = torch.zeros(1, n, dtype=torch.int32, device="cuda")
    pt[0, :used] = (torch.randperm(lead[0] - 1, generator=pg,
                                   device="cuda")[:used] + 1).to(torch.int32)
    if past is not None:          # the same context, other pages
        ids = pt[0, :used].long()
        for dst, src in zip((kp, vp, ks, vs), past):
            if dst is not None:
                chain = dst[ids].reshape((used * ps,) + dst.shape[2:])
                chain[:c.start] = src
                if chain.is_floating_point():
                    chain[c.start:] = float("nan")
                dst[ids] = chain.reshape(dst[ids].shape)
    return (q, k, v, kp, vp, pt, c.start, c.length), kw


def _past_by_position(c, args, kw):
    """The past K, V and their scales (None for a past in q's dtype) of
    positions 0 .. start - 1, read where case ``c`` keeps them: position p
    at slot p % buf_len of a dense row (those the ring no longer holds
    read as what their slot holds now), or in the page chain."""
    import torch
    _, _, _, kp, vp, pt, start, _ = args
    pos = torch.arange(start, device="cuda")
    if pt is None:
        at = (pos % c.buf_len,)
    else:
        at = (pt[0, pos // c.ps].long(), pos % c.ps)
    return [None if t is None else t[at]
            for t in (kp, vp, kw["k_scale"], kw["v_scale"])]


def _chunk_context(c, args, kw):
    """[past | chunk] K and V in position order (past cast to q's dtype)
    and their positions: -1 for a chunk pad and for a position the ring no
    longer holds."""
    import torch
    q, k, v = args[:3]
    pk, pv, _, _ = _past_by_position(c, args, kw)
    pk, pv = pk.to(q.dtype), pv.to(q.dtype)
    j = torch.arange(c.start + c.S, device="cuda", dtype=torch.int32)
    held = j >= c.start - c.buf_len if c.buf_len else j >= 0
    kpos = torch.where(held & (j < c.start + c.length), j, -1)
    return (torch.cat([pk, k[0]])[None], torch.cat([pv, v[0]])[None],
            kpos.to(torch.int32))


def _chunk_work(c, past_key_bytes):
    """Bytes and FLOP of one bf16 launch of case ``c`` at the keys its rows
    see (causal, pads masked, within the window, from the oldest position
    a ring still holds): q read and the output written, each past key some
    row sees and each real chunk key read once (``past_key_bytes`` per
    past key and kv head, 4 hd for a raw bf16 chunk key), the page ids of
    the chain; 4 hd FLOP per head and visible (query, key) pair."""
    S, start, length, window = c.S, c.start, c.length, c.window
    oldest = max(0, start - c.buf_len) if c.buf_len else 0
    pairs, first = 0, start
    for i in range(S):
        hi = start + min(i, length - 1)
        lo = max(oldest, start + i - window + 1) if window else oldest
        pairs += max(0, hi - lo + 1)
        first = min(first, lo)
    n_ids = 0 if c.buf_len else -(-start // c.ps)
    nbytes = (2 * S * c.Hq * c.hd * 2 + (start - first) * c.KH * past_key_bytes
              + length * c.KH * 4 * c.hd + n_ids * 4)
    return nbytes, 4 * c.hd * c.Hq * pairs


def _chunk_cases(res):
    """chunk_attention against its plain version at CHUNK_CASES on every
    route (CHUNK_ROUTES), the float32 routes also against the port's
    attention oracle on [past | chunk]; the ``bitwise`` cases bit for bit
    across repeated launches and against the same context in another page
    chain (a dense row's context laid out as a chain); the named cases
    timed (bf16 and int8 pasts) beside their plain version and SDPA with
    the same mask where there is no softcap, qwen2's burst shape also at
    other key spans.  The float32 past under bf16 q is also held bit for
    bit to the bf16 route on the past cast to bf16, and timed at qwen2's
    burst shape over a chain and over a dense row.  Returns qwen2's burst
    case, its int8 route under ``q8_route``, its float32-past routes under
    ``f32_past_route`` (chain) and ``f32_past_dense_route``."""
    import torch
    from repro_torch.kernels import chunk_attention as C
    from repro_torch.models.attention import attention
    g = torch.Generator(device="cuda").manual_seed(7)
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    main = q8_main = None
    f32_main = {}
    bitwise = []
    for ci, c in enumerate(CHUNK_CASES):
        ckw = dict(window=c.window, softcap=c.softcap)
        for dname, past_dt, tol in CHUNK_ROUTES:
            dt = dts[dname]
            i8, rounded = past_dt == "int8", past_dt == "float32"
            args, kw = _chunk_inputs(g, c, dt, past_dt)
            name = (f"chunk S={c.S} start={c.start} len={c.length} "
                    f"{c.Hq}:{c.KH} hd={c.hd} "
                    + (f"row {c.buf_len}" if c.buf_len else f"ps={c.ps}")
                    + f" window={c.window} softcap={c.softcap} {dname}"
                    + (f" {past_dt} past" if past_dt else ""))
            out = C.chunk_attention(*args, **ckw, **kw)
            plain = C.chunk_attention_plain(*args, **ckw, **kw)
            err, share = check_close(name, out, plain, tol)
            if rounded:
                # the bf16 route on the past cast to bf16: the same bits
                _same_bits(name, out, C.chunk_attention(
                    *args[:3], args[3].to(dt), args[4].to(dt), *args[5:],
                    **ckw), "the bf16 route on the cast past")
                bitwise.append(f"{name} == bf16 route on the cast past")
            if dt == torch.float32 and not i8:
                kc, vc, kpos = _chunk_context(c, args, kw)
                qpos = c.start + torch.arange(c.S, device="cuda",
                                              dtype=torch.int32)
                want = attention(args[0], kc, vc, qpos[None], kpos[None],
                                 **ckw)
                if max_err(out, want) > tol:
                    raise AssertionError(f"{name}: differs from the port's "
                                         "attention oracle by "
                                         f"{max_err(out, want):.3g}")
            if c.bitwise:
                # a second launch, and the same context in a page chain
                # (other page ids, other values on every other page)
                again = C.chunk_attention(*args, **ckw, **kw)
                args2, kw2 = _chunk_inputs(
                    g, c._replace(buf_len=0), dt, past_dt,
                    past=_past_by_position(c, args, kw), perm_seed=100 + ci)
                other = C.chunk_attention(*(args[:3] + args2[3:]), **ckw,
                                          **kw2)
                for what, b in (("repeated", again), ("another chain", other)):
                    if not torch.equal(out, b):
                        raise AssertionError(f"{name}: {what} differs by "
                                             f"{max_err(out, b):.3g} (must be "
                                             "bitwise equal)")
                    bitwise.append(f"{name} {what}")
            case = {"shape": [c.S, c.start, c.length, c.KH, c.Hq, c.hd],
                    "page_size": 0 if c.buf_len else c.ps,
                    "n_pages": 0 if c.buf_len else args[5].shape[1],
                    "buf_len": c.buf_len, "window": c.window,
                    "softcap": c.softcap, "dtype": dname,
                    "past_dtype": past_dt or dname, "max_abs_err": err,
                    "bf16_share": share}
            if dt == torch.bfloat16 and c.summary and (
                    not rounded or c in CHUNK_CASES[:2]):
                _time_chunk(res, g, c, past_dt, case)
                if rounded:
                    f32_main["dense" if c.buf_len else "paged"] = case
                elif ci == 0:
                    if i8:
                        q8_main = case
                    else:
                        main = case
            res["cases"].append({"kernel": "chunk_attention", **case})
            log(f"[kernels] chunk_attention {case}")
    res["chunk_bitwise"] = bitwise
    log(f"[kernels] chunk bitwise: {len(bitwise)} checks passed")
    main["q8_route"] = q8_main
    main["f32_past_route"] = f32_main["paged"]
    main["f32_past_dense_route"] = f32_main["dense"]
    return main


def _time_chunk(res, g, c, past_dt, case):
    """Case ``c`` timed into ``case`` with a bf16 q and a past of
    ``past_dt`` (None: bf16): the kernel, its plain version, SDPA with the
    same mask on [past | chunk] in position order (a bf16 past without
    softcap; no PyTorch call attends over an int8 past, or a float32 one
    under a bf16 q), the float32 scratch the launch allocates, and for the
    first case the kernel at other key spans (``C.SPAN`` set for the
    call)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import chunk_attention as C
    ckw = dict(window=c.window, softcap=c.softcap)
    past_key_bytes = {"int8": 2 * c.hd + 8, "float32": 8 * c.hd}
    nbytes, flops = _chunk_work(c, past_key_bytes.get(past_dt, 4 * c.hd))
    made = [_chunk_inputs(g, c, torch.bfloat16, past_dt)
            for _ in range(n_sets(nbytes))]
    sets = [a + (kw["k_scale"], kw["v_scale"]) for a, kw in made]

    def kern(*a):
        return C.chunk_attention(*a[:8], **ckw, k_scale=a[8], v_scale=a[9])

    def plain(*a):
        return C.chunk_attention_plain(*a[:8], **ckw, k_scale=a[8],
                                       v_scale=a[9])
    library = None
    if past_dt is None and not c.softcap:
        kpos = _chunk_context(c, *made[0])[2]
        qpos = c.start + torch.arange(c.S, device="cuda")
        valid = (kpos[None] >= 0) & (kpos[None] <= qpos[:, None])  # (S, Sk)
        if c.window:
            valid &= kpos[None] > qpos[:, None] - c.window
        library = (lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=valid, enable_gqa=True),
            [tuple(t.transpose(1, 2).contiguous()
                   for t in (a[0],) + _chunk_context(c, a, kw)[:2])
             for a, kw in made])
    name = c.summary + (f", {past_dt} past" if past_dt else "")
    _timed(res, name, case, kern, plain, sets, nbytes, flops, library)
    case["scratch_bytes"] = 4 * C.split_geometry(
        c.start, c.length, c.S, c.KH, c.Hq // c.KH, c.hd)[1]
    if c is CHUNK_CASES[0] and past_dt is None:
        case["span"], case["span_ms"] = C.SPAN, {}
        try:
            for sp in (128, 256, 512, 1024):   # 1024: one span at the burst
                C.SPAN = sp
                case["span_ms"][sp] = time_ms(kern, sets)
        finally:
            C.SPAN = case["span"]


def _geometry_cases(res):
    """Every head dim / group size the kernels instantiate (the CPU tests'
    case lists), kernel against plain version, untimed."""
    import torch
    from repro_torch.kernels import decode_attention as D
    from repro_torch.kernels import flash_attention as Fl
    g = torch.Generator(device="cuda").manual_seed(3)
    for B, Hq, KH, Sk, hd, window, pos in (
            (2, 8, 2, 512, 64, 0, 300), (1, 16, 8, 256, 128, 0, 255),
            (2, 4, 4, 512, 64, 128, 700), (3, 8, 1, 256, 128, 0, 60),
            (1, 16, 16, 256, 256, 0, 100), (2, 16, 1, 300, 256, 0, 299)):
        j = torch.arange(Sk, device="cuda", dtype=torch.int32)
        last = pos
        kp = last - torch.remainder(last - j, Sk)
        kp = torch.where(kp < 0, -1, kp).to(torch.int32)[None].repeat(B, 1)
        qp = torch.full((B,), pos, device="cuda", dtype=torch.int32)
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            q = torch.randn(B, 1, Hq, hd, generator=g, device="cuda").to(dt)
            k = torch.randn(B, Sk, KH, hd, generator=g, device="cuda").to(dt)
            v = torch.randn(B, Sk, KH, hd, generator=g, device="cuda").to(dt)
            err, share = check_close(
                f"decode geometry {(B, Hq, KH, Sk, hd, window, pos)} {dt}",
                D.decode_attention(q, k, v, kp, qp, window=window),
                D.decode_attention_plain(q, k, v, kp, qp, window=window), tol)
            res["cases"].append({"kernel": "decode_attention", "shape":
                                 [B, Sk, KH, Hq, hd], "window": window,
                                 "dtype": str(dt), "max_abs_err": err,
                                 "bf16_share": share})
    for B, Hq, KH, S, hd, window, softcap, causal in (
            (2, 4, 4, 256, 64, 0, 0.0, True), (1, 16, 1, 128, 128, 0, 0.0, True),
            (2, 4, 2, 384, 64, 128, 0.0, True), (1, 2, 2, 256, 256, 0, 50.0, True),
            (1, 4, 4, 300, 256, 0, 0.0, True), (2, 12, 2, 200, 128, 0, 0.0, False)):
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            q = torch.randn(B, S, Hq, hd, generator=g, device="cuda").to(dt)
            k = torch.randn(B, S, KH, hd, generator=g, device="cuda").to(dt)
            v = torch.randn(B, S, KH, hd, generator=g, device="cuda").to(dt)
            kw = dict(causal=causal, window=window, softcap=softcap)
            err, share = check_close(
                f"flash geometry {(B, Hq, KH, S, hd, window, softcap, causal)} "
                f"{dt}", Fl.flash_attention(q, k, v, **kw),
                Fl.flash_attention_plain(q, k, v, **kw), tol)
            res["cases"].append({"kernel": "flash_attention", "shape":
                                 [B, S, KH, Hq, hd], "window": window,
                                 "softcap": softcap, "causal": causal,
                                 "dtype": str(dt), "max_abs_err": err,
                                 "bf16_share": share})
    log("[kernels] geometry checks passed")


def _decode_bitwise(res):
    """The split decode body's determinism on the card: two launches on the
    same inputs give the same bits, and the same context (1024 slots, -1
    holes) gives the same bits in a 1024-slot view and in the whole
    2048-slot buffer with k_pos -1 past the context, for the bf16, float32
    and int8 kernels; the paged kernels repeat bit for bit too."""
    import torch
    from repro_torch.kernels import decode_attention as D
    from repro_torch.kernels import decode_attention_q8 as Q
    from repro_torch.kernels import paged_decode_attention as K
    from repro_torch.models.kvcache import quantize_kv
    g = torch.Generator(device="cuda").manual_seed(6)
    B, KH, Hq, hd, ctx, buf = 8, 2, 12, 128, 1024, 2048
    pad = torch.full((B, buf - ctx), -1, dtype=torch.int32, device="cuda")
    checks = []

    def same(name, a, b):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: outputs differ by "
                                 f"{max_err(a, b):.3g} (must be bitwise "
                                 "equal)")
        checks.append(name)
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, kp, qp = _decode_inputs(g, B, ctx, KH, Hq, hd, dt, ctx)
        kb = torch.randn(B, buf, KH, hd, generator=g, device="cuda").to(dt)
        vb = torch.randn(B, buf, KH, hd, generator=g, device="cuda").to(dt)
        kb[:, :ctx], vb[:, :ctx] = k, v
        kp_b = torch.cat([kp, pad], 1)
        out = D.decode_attention(q, kb[:, :ctx], vb[:, :ctx], kp, qp)
        same(f"decode {dt} repeated",
             out, D.decode_attention(q, kb[:, :ctx], vb[:, :ctx], kp, qp))
        same(f"decode {dt} Sk {ctx} == Sk {buf}",
             out, D.decode_attention(q, kb, vb, kp_b, qp))
        kq, ks = quantize_kv(kb.float())
        vq, vs = quantize_kv(vb.float())
        args = (kq[:, :ctx], ks[:, :ctx], vq[:, :ctx], vs[:, :ctx], kp, qp)
        out = Q.decode_attention_q8(q, *args)
        same(f"decode_q8 q {dt} repeated", out, Q.decode_attention_q8(q, *args))
        same(f"decode_q8 q {dt} Sk {ctx} == Sk {buf}",
             out, Q.decode_attention_q8(q, kq, ks, vq, vs, kp_b, qp))
        q, kp_, vp_, pt, qp = _paged_inputs(g, B, Hq, KH, hd, 16, 128, dt,
                                            1024)
        same(f"paged {dt} repeated",
             K.paged_decode_attention(q, kp_, vp_, pt, qp),
             K.paged_decode_attention(q, kp_, vp_, pt, qp))
    res["bitwise"] = checks
    log(f"[kernels] bitwise: {len(checks)} checks passed: {checks}")


def _q8_inputs(g, B, Sk, KH, Hq, hd, dt, buf, pos=None):
    """q and int8 K/V with their scales, quantized from normal values, as
    [:, :Sk] views of (B, buf, KH, hd) caches; k_pos with -1 holes and
    per-row q_pos (the serve path), or, given ``pos``, the ring positions
    of a buffer whose next write is pos + 1 and q_pos = pos for every row
    (the reference's cases)."""
    import torch
    from repro_torch.models.kvcache import quantize_kv
    q = torch.randn(B, 1, Hq, hd, generator=g, device="cuda").to(dt)
    kq, ks = quantize_kv(torch.randn(B, buf, KH, hd, generator=g, device="cuda"))
    vq, vs = quantize_kv(torch.randn(B, buf, KH, hd, generator=g, device="cuda"))
    j = torch.arange(Sk, device="cuda", dtype=torch.int32)
    if pos is None:
        q_pos = torch.randint(Sk // 2, Sk, (B,), generator=g, device="cuda",
                              dtype=torch.int32)
        holes = torch.rand(B, Sk, generator=g, device="cuda") < 0.05
        k_pos = torch.where(holes, -1, j[None].repeat(B, 1))
    else:
        q_pos = torch.full((B,), pos, device="cuda", dtype=torch.int32)
        kp = pos - torch.remainder(pos - j, Sk)
        k_pos = torch.where(kp < 0, -1, kp)[None].repeat(B, 1)
    return (q, kq[:, :Sk], ks[:, :Sk], vq[:, :Sk], vs[:, :Sk],
            k_pos.to(torch.int32), q_pos)


# int8 decode cases: (B, Hq, KH, Sk, hd, window, softcap, pos, the
# "[summary]" name of a timed case): the reference's two cases first, then
# the geometry sweep, qwen2's serving shape (pos None: holes), gemma2's
# wrapped 4096-slot local ring (window 4096) and full layer (softcap 50),
# qwen3, chatglm3 and granite
Q8_CASES = [
    (2, 8, 2, 512, 64, 0, 0.0, 300, None),
    (1, 16, 8, 256, 128, 128, 0.0, 700, None),
    (1, 16, 8, 256, 128, 0, 0.0, 255, None),
    (2, 4, 4, 512, 64, 128, 0.0, 700, None),
    (3, 8, 1, 256, 128, 0, 0.0, 60, None),
    (1, 16, 16, 256, 256, 0, 0.0, 100, None),
    (2, 16, 1, 300, 256, 0, 0.0, 299, None),
    (8, 12, 2, 192, 128, 0, 0.0, None, None),
    (8, 12, 2, 2048, 128, 700, 0.0, None, None),
    (8, 12, 2, 2048, 128, 0, 0.0, None, "decode_attention_q8 B=8 Sk=2048"),
    (4, 16, 8, 4096, 256, 4096, 50.0, 9000,
     "decode_attention_q8 gemma2 local ring"),
    (4, 16, 8, 8192, 256, 0, 50.0, None, None),
    (8, 40, 8, 2048, 128, 0, 0.0, None, None),
    (8, 32, 2, 2048, 128, 0, 0.0, None, None),
    (8, 32, 8, 2048, 128, 0, 0.0, None, None)]


def _q8_cases(res):
    """decode_attention_q8 against its plain version at Q8_CASES (the named
    cases timed beside the bf16 kernel on the same context, dequantized),
    and the paged int8 route at PAGED_CASES against its plain version and,
    bitwise, against the dense int8 kernel on the same context.  Returns
    the main cases (dense, paged)."""
    import torch
    from repro_torch.kernels import decode_attention as D
    from repro_torch.kernels import decode_attention_q8 as Q
    from repro_torch.kernels import paged_decode_attention as K
    from repro_torch.models.kvcache import dequantize_kv, quantize_kv
    g = torch.Generator(device="cuda").manual_seed(5)
    main = None
    for B, Hq, KH, Sk, hd, window, cap, pos, label in Q8_CASES:
        kw = dict(window=window, softcap=cap)
        buf = max(Sk, 2048) if pos is None else Sk
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            args = _q8_inputs(g, B, Sk, KH, Hq, hd, dt, buf, pos)
            err, share = check_close(
                f"decode_q8 {(B, Hq, KH, Sk, hd, window, cap, pos)} {dt}",
                Q.decode_attention_q8(*args, **kw),
                Q.decode_attention_q8_plain(*args, **kw), tol)
            case = {"shape": [B, Sk, KH, Hq, hd], "window": window,
                    "softcap": cap, "pos": pos, "dtype": str(dt),
                    "max_abs_err": err, "bf16_share": share}
            if dt == torch.bfloat16 and label:
                _, _, _, _, _, kp, qp = args
                # int8 K and V rows plus two float32 scales per key, kv head
                nbytes, flops = _decode_work(kp, qp, window, Hq, KH, hd, 2, B,
                                             key_bytes=2 * hd + 8)
                sets = [_q8_inputs(g, B, Sk, KH, Hq, hd, dt, buf, pos)[:5]
                        + (kp, qp) for _ in range(n_sets(nbytes))]
                # no PyTorch call attends over int8 K/V
                _timed(res, label, case,
                       lambda *a: Q.decode_attention_q8(*a, **kw),
                       lambda *a: Q.decode_attention_q8_plain(*a, **kw), sets,
                       nbytes, flops)
                # the bf16 kernel on the same context, dequantized
                bf_sets = [(q_, dequantize_kv(k_, ks_, dt),
                            dequantize_kv(v_, vs_, dt), kp_, qp_)
                           for q_, k_, ks_, v_, vs_, kp_, qp_ in sets]
                case["bf16_kernel_ms"] = time_ms(
                    lambda *a: D.decode_attention(*a, **kw), bf_sets)
                if label == "decode_attention_q8 B=8 Sk=2048":
                    main = case
            res["cases"].append({"kernel": "decode_attention_q8", **case})
            log(f"[kernels] decode_attention_q8 {case}")

    # the paged int8 route
    paged_main = None
    for B, Hq, KH, ps, n, hd, window, cap, pos_lo, partial, label in \
            PAGED_CASES:
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            cover = None
            if partial:
                cover = [int(torch.randint(1, n + 1, (1,), generator=g,
                                           device="cuda")) for _ in range(B)]

            def mk():
                q, kf, vf, pt, qp = _paged_inputs(g, B, Hq, KH, hd, ps, n,
                                                  torch.float32, pos_lo, cover)
                return (q.to(dt), *quantize_kv(kf), *quantize_kv(vf), pt, qp)
            q, kq, ks, vq, vs, pt, qp = mk()
            kw = dict(window=window, softcap=cap)
            out = K.paged_decode_attention(q, kq, vq, pt, qp, k_scale=ks,
                                           v_scale=vs, **kw)
            name = (f"paged q8 B={B} {Hq}:{KH} hd={hd} ps={ps} n={n} "
                    f"w={window} cap={cap} {dt}")
            err, share = check_close(name, out, K.paged_decode_attention_plain(
                q, kq, vq, pt, qp, k_scale=ks, v_scale=vs, **kw), tol)
            Sk = n * ps
            dense = [x[pt.long()].reshape(B, Sk, KH, x.shape[-1])
                     for x in (kq, ks, vq, vs)]
            kpos = torch.arange(Sk, device="cuda", dtype=torch.int32)[None]
            want = Q.decode_attention_q8(q, *dense, kpos.repeat(B, 1), qp,
                                         **kw)
            if not torch.equal(out, want):
                raise AssertionError(f"{name}: paged and dense int8 kernels "
                                     f"differ by {max_err(out, want):.3g} on "
                                     "the same context (must be bitwise "
                                     "equal)")
            case = {"route": "q8", "shape": [B, Sk, KH, Hq, hd],
                    "page_size": ps, "window": window, "softcap": cap,
                    "dtype": str(dt), "max_abs_err": err, "bf16_share": share,
                    "bitwise_equal_dense": True}
            if dt == torch.bfloat16 and label:
                nv = int((qp + 1).clamp(max=Sk).sum())
                nbytes = (nv * KH * (2 * hd + 8) + B * n * 4 + B * 4
                          + 2 * B * Hq * hd * 2)
                sets = [mk() for _ in range(n_sets(nbytes))]
                sets = [s_[:6] + (qp,) for s_ in sets]

                def paged(q_, kq_, ks_, vq_, vs_, pt_, qp_):
                    return K.paged_decode_attention(
                        q_, kq_, vq_, pt_, qp_, k_scale=ks_, v_scale=vs_, **kw)

                def plain(q_, kq_, ks_, vq_, vs_, pt_, qp_):
                    return K.paged_decode_attention_plain(
                        q_, kq_, vq_, pt_, qp_, k_scale=ks_, v_scale=vs_, **kw)
                _timed(res, f"{label}, int8 route", case, paged, plain, sets,
                       nbytes, 4 * nv * Hq * hd)
                dense_sets = [(q_, *[x[pt_.long()].reshape(B, Sk, KH, x.shape[-1])
                                     for x in (kq_, ks_, vq_, vs_)],
                               kpos.repeat(B, 1), qp_)
                              for q_, kq_, ks_, vq_, vs_, pt_, qp_ in sets]
                case["dense_kernel_ms"] = time_ms(
                    lambda *a: Q.decode_attention_q8(*a, **kw), dense_sets)
                if label == "paged_decode_attention 128 pages":
                    paged_main = case
            res["cases"].append({"kernel": "paged_decode_attention", **case})
            log(f"[kernels] paged_decode_attention q8 route {case}")
    return main, paged_main


KERNELS = {
    # name: (source, TPU kernel (or reference code) it replaces)
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:24"),
    "add_rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:24"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:68"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:91"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "src/repro/kernels/paged_decode_attention.py:86"),
    "decode_attention_q8": (
        "src/repro_torch/kernels/csrc/decode_attention_q8.cu",
        "src/repro/kernels/decode_attention_q8.py:63"),
    "chunk_attention": ("src/repro_torch/kernels/csrc/chunk_attention.cu",
                        "src/repro/models/transformer.py:311"),
    # the gradients the JAX package takes with jax.grad (no Pallas VJP)
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/models/attention.py:52"),
    "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/models/layers.py:22"),
}


def phase_kernels(res):
    res["cases"], res["timed"] = [], []
    norm, add_norm = _rmsnorm_cases(res)
    res["main_case"] = {"rmsnorm": norm, "add_rmsnorm": add_norm,
                        "decode_attention": _decode_cases(res),
                        "flash_attention": _flash_cases(res)}
    paged = _paged_cases(res)
    res["main_case"]["paged_decode_attention"] = paged
    chunk = _chunk_cases(res)
    res["main_case"]["chunk_attention"] = chunk
    q8, paged_q8 = _q8_cases(res)
    res["main_case"]["decode_attention_q8"] = q8
    res["main_case"]["paged_decode_attention"]["q8_route"] = paged_q8
    _geometry_cases(res)
    _decode_bitwise(res)
    res["main_case"]["flash_attention_bwd"] = _flash_bwd_cases(
        res, res["main_case"]["flash_attention"])
    nb = _norm_bwd_cases(res)
    main = nb[8192, 1536, False]
    main["ds_route"] = nb[8192, 1536, True]
    main["gemma2_ds_route"] = nb[5120, 3584, True]
    res["main_case"]["rmsnorm_bwd"] = main
    for name, c in res["timed"]:
        lib = c["library_ms"]
        ref = (f"library_ms {lib:.5f} ({c['ms'] / lib:.2f}x)" if lib else
               "library_ms none")
        for key, what in (("dense_kernel_ms", "dense kernel"),
                          ("bf16_kernel_ms", "bf16 kernel, dequantized")):
            if key in c:
                ref += f", {what} {c[key]:.5f}"
        scratch = (f", scratch_bytes {c['scratch_bytes']}"
                   if "scratch_bytes" in c else "")
        log(f"[summary] {name} bf16: ms {c['ms']:.5f}, {ref}, plain_ms "
            f"{c['plain_ms']:.5f}, bound_ms {c['bound_ms']:.5f} "
            f"({c['bound_by']}, {c['ms'] / c['bound_ms']:.1f}x), max_abs_err "
            f"{c['max_abs_err']:.3g}{scratch}")
    log(f"[summary] chunk_attention key spans (ms): {chunk['span_ms']}; "
        f"SPAN {chunk['span']}")


# -- phase 3: equivalence ---------------------------------------------------------------

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def _greedy_run(params, cfg, prompt, steps, device):
    import torch
    from repro_torch.models import decode_step, init_cache, prefill_into_slot
    caches = init_cache(cfg, 1, 512, dtype=torch.float32, device=device)
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=device)[None]
    logits, caches, pos = prefill_into_slot(params, cfg, toks, len(prompt),
                                            caches, 0)
    first = logits.float().cpu()
    out = [int(logits[0].argmax())]
    p = torch.tensor([pos], dtype=torch.int32, device=device)
    for _ in range(steps - 1):
        tok = torch.tensor([[out[-1]]], device=device)
        logits, caches = decode_step(params, cfg, tok, caches, p)
        out.append(int(logits[0].argmax()))
        p = p + 1
    return first, out


def phase_equivalence(res):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    base = get_config("qwen2-1.5b").replace(num_layers=4, dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), base)
    gparams = _to(params, "cuda")
    prompt = np.random.default_rng(0).integers(0, base.vocab_size, size=300)
    res["equivalence"] = {}
    for kv_quant in (False, True):
        cfg = base.replace(kv_quant=kv_quant)
        tag = "kv_quant" if kv_quant else "fp"
        dense_route, paged_route = (
            ("decode_attention_q8", "paged_decode_attention/q8") if kv_quant
            else ("decode_attention", "paged_decode_attention"))
        cpu_first, cpu_toks = _greedy_run(params, cfg, prompt, 16, "cpu")
        _reset_counts()
        gpu_first, gpu_toks = _greedy_run(gparams, cfg, prompt, 16, "cuda")
        greedy_counts = _launch_counts()
        err = max_err(gpu_first, cpu_first)
        log(f"[equivalence] 4-layer full-width qwen2 f32 {tag}: first-token "
            f"logits max |err| {err:.3g}; tokens cuda {gpu_toks} cpu "
            f"{cpu_toks}")
        if not torch.allclose(gpu_first, cpu_first, atol=1e-3, rtol=1e-3):
            raise AssertionError(f"{tag}: first-token logits differ by "
                                 f"{err:.3g} > 1e-3")
        if gpu_toks != cpu_toks:
            raise AssertionError(f"{tag}: greedy tokens differ between CUDA "
                                 "and CPU")
        if not greedy_counts[dense_route]:
            raise AssertionError(f"{tag}: decode did not run {dense_route}: "
                                 f"{greedy_counts}")
        res["equivalence"][tag] = {"logits_max_abs_err": err,
                                   "tokens": gpu_toks}
        cpu = _paged_engine_run(params, cfg, "cpu")
        _reset_counts()
        gpu = _paged_engine_run(gparams, cfg, "cuda")
        counts = _launch_counts()
        log(f"[equivalence] paged engine, 4-layer f32 {tag}: preempted "
            f"{gpu['preempted']}, prefix hits {gpu['hits']}, chunk "
            f"launches {counts['chunk_attention']}; "
            f"tokens equal: {gpu['tokens'] == cpu['tokens']}")
        if gpu["tokens"] != cpu["tokens"]:
            raise AssertionError(f"paged engine {tag}: greedy tokens differ "
                                 "between CUDA and CPU")
        if not (gpu["preempted"] and gpu["hits"]
                and counts["chunk_attention"] and counts[paged_route]):
            raise AssertionError(f"paged equivalence run {tag} missed a "
                                 f"route: {gpu} {counts}")
        res["equivalence"][tag]["paged"] = {**gpu, "launches": counts}
    _mixed_dtype_equivalence(res)
    _arch_equivalence(res)
    _prefill_equivalence(res)


# the archs of the equivalence phase beyond qwen2: the dense family (params
# drawn on the CPU), then the MoE models and the layer-norm / prefix family
# (drawn on the card, which is quicker for mixtral's 11 GB of float32
# experts, and copied to the CPU)
EQUIV_ARCHS = (("qwen3-14b", "cpu"), ("granite-8b", "cpu"),
               ("chatglm3-6b", "cpu"), ("gemma2-9b", "cpu"),
               ("qwen3-moe-30b-a3b", "cuda"), ("mixtral-8x7b", "cuda"),
               ("musicgen-large", "cuda"), ("llava-next-mistral-7b", "cuda"))
TIE_GAP = 1e-5      # a routing difference at a wider top-k boundary fails


def _arch_equivalence(res):
    """CUDA against CPU on each arch beyond qwen2 at full width, cut to 2
    layers (one local + full period for gemma2), in float32 from the same
    params: a 300-token prompt and 8 greedy decode steps, or for gemma2 a
    prompt of window + 600 tokens, its first 4096 tokens in one prefill and
    the rest as one chunk (the dense-row route: it wraps the local layer's
    4096-slot ring), then 8 decode steps; the logits after the prompt
    allclose at 1e-3, the tokens equal.  For the MoE models the experts
    each routing call chose are compared first, call by call: a token whose
    chosen set differs between CUDA and CPU where the k-th and (k+1)-th
    probabilities lie more than TIE_GAP apart fails the phase; a narrower
    tie (float32 rounding may swap them) is printed with its gap, and that
    model's logits and tokens are then reported, not asserted.  Then one
    MoE layer at qwen3-moe's width (``_moe_layer``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    for arch, init_on in EQUIV_ARCHS:
        cfg = get_config(arch).replace(num_layers=2, dtype="float32")
        t0 = time.perf_counter()
        gen = torch.Generator(device=init_on).manual_seed(0)
        params = init_params(gen, cfg)
        if init_on == "cuda":
            gparams, params = params, _to(params, "cpu")
        else:
            gparams = _to(params, "cuda")
        ring = arch == "gemma2-9b"
        n = cfg.window + 600 if ring else 300
        prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, size=n)
        first, toks, routes = {}, {}, {}
        _reset_counts()
        for dev, p in (("cuda", gparams), ("cpu", params)):
            with _RoutingLog() as routes[dev]:
                run = _ring_greedy_run if ring else _greedy_run
                first[dev], toks[dev] = run(p, cfg, prompt, 8, dev)
            if dev == "cuda":
                counts = _launch_counts()
        err = max_err(first["cuda"], first["cpu"])
        ties = _routing_ties(routes["cuda"], routes["cpu"], cfg,
                             arch) if cfg.is_moe else []
        log(f"[equivalence] {arch} 2 layers full width f32, {n}-token "
            f"prompt: logits max |err| {err:.3g}; tokens cuda {toks['cuda']} "
            f"cpu {toks['cpu']}; routing calls {len(routes['cuda'])}, "
            f"narrow ties {ties}; launches {counts} "
            f"({time.perf_counter() - t0:.1f}s)")
        if not ties:
            if not torch.allclose(first["cuda"], first["cpu"], atol=1e-3,
                                  rtol=1e-3):
                raise AssertionError(f"{arch}: logits differ by {err:.3g} "
                                     "> 1e-3")
            if toks["cuda"] != toks["cpu"]:
                raise AssertionError(f"{arch}: greedy tokens differ between "
                                     "CUDA and CPU")
        need = ["decode_attention", "flash_attention"]
        need += ["rmsnorm"] if cfg.norm == "rms" else []
        if ring:
            need.append("chunk_attention/dense")
        _check_launched(f"equivalence {arch}", counts, need)
        if cfg.norm != "rms" and (counts["rmsnorm"] or counts["add_rmsnorm"]):
            raise AssertionError(f"{arch}: a layer-norm model ran rmsnorm")
        res["equivalence"][arch] = {"logits_max_abs_err": err,
                                    "tokens": toks["cuda"],
                                    "tokens_cpu": toks["cpu"], "prompt": n,
                                    "narrow_ties": ties,
                                    "asserted": not ties,
                                    "launches": counts}
        del params, gparams
        torch.cuda.empty_cache()
    _recurrent_equivalence(res)
    if any(a == "qwen3-moe-30b-a3b" for a, _ in EQUIV_ARCHS):
        _moe_layer(res)


# the recurrent archs of the equivalence phase and their depth: mamba2's
# SSM blocks, one (rglru, rglru, local) period of recurrentgemma
RECURRENT_EQUIV = (("mamba2-370m", 2), ("recurrentgemma-9b", 3))


def _recurrent_equivalence(res):
    """CUDA against CPU on the recurrent archs at full width in float32 from
    the same params (drawn on the card): a 300-token prompt in one prefill
    (the SSD in chunks of 150, the RG-LRU scan over 300 steps) and 8 greedy
    decode steps; the logits after the prompt within 1e-4, the tokens
    equal.  mamba2 launches the norms only (its SSD gated norm is rmsnorm
    over float32 rows of 2048); recurrentgemma also flash and decode at
    MQA 16:1, hd 256."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    for arch, layers in RECURRENT_EQUIV:
        cfg = get_config(arch).replace(num_layers=layers, dtype="float32")
        t0 = time.perf_counter()
        gparams = init_params(torch.Generator(device="cuda").manual_seed(0),
                              cfg)
        params = _to(gparams, "cpu")
        prompt = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                                   size=300)
        _reset_counts()
        gfirst, gtoks = _greedy_run(gparams, cfg, prompt, 8, "cuda")
        counts = _launch_counts()
        cfirst, ctoks = _greedy_run(params, cfg, prompt, 8, "cpu")
        err = max_err(gfirst, cfirst)
        log(f"[equivalence] {arch} {layers} layers full width f32, 300-token "
            f"prompt: logits max |err| {err:.3g}; tokens cuda {gtoks} cpu "
            f"{ctoks}; launches {counts} ({time.perf_counter() - t0:.1f}s)")
        if not torch.allclose(gfirst, cfirst, atol=1e-4, rtol=1e-4):
            raise AssertionError(f"{arch}: logits differ by {err:.3g} > 1e-4")
        if gtoks != ctoks:
            raise AssertionError(f"{arch}: greedy tokens differ between CUDA "
                                 "and CPU")
        need = ["rmsnorm", "add_rmsnorm"]
        if cfg.num_heads:
            need += ["decode_attention", "flash_attention"]
        _check_launched(f"equivalence {arch}", counts, need)
        res["equivalence"][arch] = {"logits_max_abs_err": err,
                                    "tokens": gtoks, "tokens_cpu": ctoks,
                                    "prompt": 300, "layers": layers,
                                    "launches": counts}
        del params, gparams
        torch.cuda.empty_cache()


def _mixed_dtype_run(params, cfg, device, cache_dtype):
    """A bf16 model teacher-forced over caches of ``cache_dtype``: row 0 a
    300-token prompt prefilled into its page chain, row 1 a 700-token
    prompt in chunks of 256 over its chain (each chunk reads its past
    through the page table), then 8 decode steps of both rows over the
    pools; then the 700-token prompt again in chunks into row 1 of a dense
    cache (the dense-row past).  Returns every call's logits, on the
    CPU."""
    import numpy as np
    import torch
    from repro_torch.models import (decode_step, init_cache,
                                    prefill_chunk_into_slot,
                                    prefill_into_slot)
    rng = np.random.default_rng(9)
    a, b = (torch.as_tensor(rng.integers(0, cfg.vocab_size, size=n),
                            device=device)[None] for n in (300, 700))
    steps = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(8, 2, 1)),
                            device=device)
    table = torch.arange(1, 129, dtype=torch.int32,
                         device=device).reshape(2, 64)
    paged = init_cache(cfg, 2, 1024, dtype=cache_dtype, device=device,
                       paged_pool=(129, 16))
    dense = init_cache(cfg, 2, 1024, dtype=cache_dtype, device=device)
    pad = torch.zeros(1, 512, dtype=a.dtype, device=device)
    pad[:, :300] = a
    out = [prefill_into_slot(params, cfg, pad, 300, paged, 0,
                             page_table=table[:1])[0]]
    for caches, pt in ((paged, table[1:]), (dense, None)):
        for start in range(0, 700, 256):
            chunk = torch.zeros(1, 256, dtype=b.dtype, device=device)
            m = min(256, 700 - start)
            chunk[:, :m] = b[:, start:start + m]
            out.append(prefill_chunk_into_slot(params, cfg, chunk, start, m,
                                               caches, 1, page_table=pt)[0])
        if pt is not None:
            pos = torch.tensor([300, 700], dtype=torch.int32, device=device)
            for i in range(8):
                out.append(decode_step(params, cfg, steps[i], paged, pos + i,
                                       page_table=table)[0])
    return [o.float().cpu() for o in out]


def _mixed_dtype_equivalence(res):
    """Fault C2's routes in a 4-layer full-width qwen2-1.5b in bf16
    (``_mixed_dtype_run``).  A bf16 model writes bf16 values, which a
    float32 cache holds exactly and the float32-past routes round back
    exactly, so on each device every call's logits over float32 caches
    must equal those over bf16 caches bit for bit: on the card that holds
    the float32-past routes of paged decode, the paged chunk and the
    dense-row chunk (which must launch) to the bf16 routes, on the CPU the
    plain versions' cast.  CUDA against CPU is printed: a bf16 model's
    logits move by the two devices' bf16 GEMM rounding (the prefill call,
    which reads no past, as much as the others), which no kernel route
    decides."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("qwen2-1.5b").replace(num_layers=4)
    gparams = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    params = _to(gparams, "cpu")
    _reset_counts()
    gpu = _mixed_dtype_run(gparams, cfg, "cuda", torch.float32)
    counts = _launch_counts()
    runs = {"cuda bf16 caches": _mixed_dtype_run(gparams, cfg, "cuda",
                                                 torch.bfloat16),
            "cpu": _mixed_dtype_run(params, cfg, "cpu", torch.float32),
            "cpu bf16 caches": _mixed_dtype_run(params, cfg, "cpu",
                                                torch.bfloat16)}
    for what, ref, got in (("cuda", runs["cuda bf16 caches"], gpu),
                           ("cpu", runs["cpu bf16 caches"], runs["cpu"])):
        for i, (x, y) in enumerate(zip(got, ref)):
            _same_bits(f"float32 caches under bf16 on {what}, call {i}", x,
                       y, "the bf16 caches' logits")
    errs = [max_err(g_, c_) for g_, c_ in zip(gpu, runs["cpu"])]
    top = max(float(g_.abs().max()) for g_ in gpu)
    log(f"[equivalence] bf16 qwen2 4 layers: {len(gpu)} calls over float32 "
        f"caches bitwise equal to bf16 caches on the card and on the CPU; "
        f"CUDA against CPU logits max |err| per call "
        f"{[round(e, 4) for e in errs]} (largest |logit| {top:.3g}); "
        f"launches {counts}")
    _check_launched("equivalence float32 caches", counts,
                    ("paged_decode_attention/f32_past",
                     "chunk_attention/f32_past",
                     "chunk_attention/dense_f32_past", "flash_attention"))
    res["equivalence"]["f32_caches_bf16_model"] = {
        "bitwise_bf16_caches": True, "cuda_vs_cpu_max_abs_err": errs,
        "max_abs_logit": top, "launches": counts}


# the unpadded prefill's cases: (arch, layers, rows, prompt tokens, prefix
# embeddings): gemma2 past its 4096-slot rings, llava's 2880 image patches,
# musicgen's 64 conditioning frames, recurrentgemma's recurrent rows and
# qwen3-moe's routing over every row's tokens
PREFILL_EQUIV = (("gemma2-9b", 4, 1, 5000, 0),
                 ("llava-next-mistral-7b", 4, 1, 256, 2880),
                 ("musicgen-large", 4, 1, 256, 64),
                 ("recurrentgemma-9b", 4, 2, 512, 0),
                 ("qwen3-moe-30b-a3b", 4, 2, 512, 0))


def _prefill_equivalence(res):
    """The unpadded ``prefill`` CUDA against CPU at full width, cut to 4
    layers, in float32 from the same params (drawn on the card): B prompts
    after seeded prefix embeddings where the model takes them, into fresh
    caches; ``next_pos`` must be P + S and the last logits allclose at
    1e-3 (the arch checks' float32 bar).  For qwen3-moe every routing
    call's experts are compared first, as in ``_arch_equivalence``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params, prefill
    for arch, layers, B, n, P in PREFILL_EQUIV:
        if ONLY_ARCHS is not None and arch not in ONLY_ARCHS:
            continue
        cfg = get_config(arch).replace(num_layers=layers, dtype="float32")
        t0 = time.perf_counter()
        gparams = init_params(torch.Generator(device="cuda").manual_seed(0),
                              cfg)
        params = _to(gparams, "cpu")
        rng = np.random.default_rng(6)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, n)))
        pe = torch.as_tensor(rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32)) if P else None
        last, routes, counts = {}, {}, None
        for dev, p in (("cuda", gparams), ("cpu", params)):
            caches = init_cache(cfg, B, P + n + 64, dtype=torch.float32,
                                device=dev)
            _reset_counts()
            with _RoutingLog() as routes[dev]:
                lg, caches, pos = prefill(
                    p, cfg, tokens.to(dev), caches,
                    None if pe is None else pe.to(dev))
            last[dev] = lg.float().cpu()
            if dev == "cuda":
                counts = _launch_counts()
            if pos != P + n:
                raise AssertionError(f"{arch}: prefill returned next_pos "
                                     f"{pos}, not {P + n}")
            del caches
        err = max_err(last["cuda"], last["cpu"])
        ties = _routing_ties(routes["cuda"], routes["cpu"], cfg,
                             arch) if cfg.is_moe else []
        log(f"[equivalence] prefill {arch} {layers} layers full width f32, "
            f"B {B}, {P} prefix + {n} tokens: last logits max |err| "
            f"{err:.3g}; routing calls {len(routes['cuda'])}, narrow ties "
            f"{ties}; launches {counts} ({time.perf_counter() - t0:.1f}s)")
        if not ties and not torch.allclose(last["cuda"], last["cpu"],
                                           atol=1e-3, rtol=1e-3):
            raise AssertionError(f"prefill {arch}: logits differ by "
                                 f"{err:.3g} > 1e-3")
        need = ["flash_attention"] + ["rmsnorm"] * (cfg.norm == "rms")
        _check_launched(f"equivalence prefill {arch}", counts, need)
        if counts["chunk_attention"] or counts["chunk_attention/dense"]:
            raise AssertionError(f"prefill {arch} ran chunk_attention")
        res["equivalence"][f"prefill_{arch}"] = {
            "logits_max_abs_err": err, "rows": B, "prompt": n, "prefix": P,
            "layers": layers, "narrow_ties": ties, "asserted": not ties,
            "launches": counts}
        del params, gparams
        torch.cuda.empty_cache()


class _RoutingLog:
    """While open, every MoE routing call (``models.moe._routing``) appends
    its top (k + 1) probabilities and experts, copied to the host, to the
    list it yields."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.calls, self.orig = [], moe._routing

        def recorded(cfg, p, x):
            out = self.orig(cfg, p, x)
            probs = torch.softmax(x.float() @ p["router"], dim=-1)
            v, i = torch.topk(probs, cfg.experts_per_token + 1, dim=-1)
            self.calls.append((v.cpu(), i.cpu()))
            return out
        moe._routing = recorded
        return self.calls

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._routing = self.orig


def _routing_ties(cuda_calls, cpu_calls, cfg, arch):
    """Compare the chosen expert sets call by call (the same calls in the
    same order while the tokens agree).  Returns the narrow ties found
    (call, tokens, gap); raises on a differing set at a gap wider than
    TIE_GAP.  Comparison stops after the first call with a tie: past it
    the two devices may decode other tokens."""
    import torch
    k = cfg.experts_per_token
    if len(cuda_calls) != len(cpu_calls):
        raise AssertionError(f"{arch}: {len(cuda_calls)} routing calls on "
                             f"CUDA, {len(cpu_calls)} on the CPU")
    for c, ((gv, gi), (cv, ci)) in enumerate(zip(cuda_calls, cpu_calls)):
        diff = (gi[..., :k].sort(-1).values
                != ci[..., :k].sort(-1).values).any(-1)
        if not diff.any():
            continue
        gap = torch.minimum(gv[..., k - 1] - gv[..., k],
                            cv[..., k - 1] - cv[..., k])[diff]
        worst = float(gap.max())
        if worst > TIE_GAP:
            raise AssertionError(
                f"{arch}: routing call {c} chose other experts on CUDA than "
                f"on the CPU for {int(diff.sum())} tokens, top-k boundary "
                f"gap up to {worst:.3g} > {TIE_GAP}")
        return [{"call": c, "tokens": int(diff.sum()), "gap": worst}]
    return []


def _moe_layer(res):
    """One MoE layer at qwen3-moe's width (d 2048, 128 experts of ff 768,
    top 8, capacity 1.25) on the card: a 1024-token routing group through
    ``moe_einsum`` and ``moe_scatter`` in float32, within 1e-5 of each
    other, the keep mask equal to the CPU's (unless a top-k boundary tie
    within TIE_GAP is printed); then both timed in bf16 at that group and
    at a decode step of 8 rows (each its own group of one token, nothing
    dropped), beside the layer's bound: every expert's weights are read
    once (the reference's algorithm runs all E experts on C slots, empty
    ones too), the kept choices' FFN FLOP at the bf16 peak."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("qwen3-moe-30b-a3b").replace(dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(5)
    p = moe.init_moe(g, cfg, torch.float32)
    x = torch.randn(1, 1024, cfg.d_model, generator=g, device="cuda")
    ye, _ = moe.moe_einsum(cfg, p, x)
    ys, _ = moe.moe_scatter(cfg, p, x)
    err = max_err(ye, ys)
    if not torch.allclose(ye, ys, atol=1e-5, rtol=1e-5):
        raise AssertionError(f"moe layer: einsum and scatter differ by "
                             f"{err:.3g} > 1e-5")
    keep = moe._dispatch(cfg, p, x, None)[3].cpu()
    cp, cx = _to(p, "cpu"), x.cpu()
    with _RoutingLog() as gl:
        moe._routing(cfg, p, x)
    with _RoutingLog() as cl:
        moe._routing(cfg, cp, cx)
    ties = _routing_ties(gl, cl, cfg, "moe layer")
    keep_equal = bool(torch.equal(keep, moe._dispatch(cfg, cp, cx, None)[3]))
    if not keep_equal and not ties:
        raise AssertionError("moe layer: keep masks differ between CUDA and "
                             "the CPU with no routing tie")
    out = {"einsum_vs_scatter_max_abs_err": err, "keep_equal_cpu": keep_equal,
           "kept": int(keep.sum()), "choices": keep.numel(),
           "capacity": moe.capacity(cfg, 1024), "narrow_ties": ties}
    bcfg = cfg.replace(dtype="bfloat16")
    bp = {n: t.to(torch.bfloat16) if n != "router" else t
          for n, t in p.items()}
    del p, cp
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    w_bytes = sum(t.numel() * t.element_size() for t in bp.values())
    for name, B, S in (("group1024", 1, 1024), ("decode8", 8, 1)):
        xb = torch.randn(B, S, d, generator=g, device="cuda",
                         dtype=torch.bfloat16)
        kept = int(moe._dispatch(bcfg, bp, xb, None)[3].sum())
        flops = kept * 6 * d * ff + B * S * 2 * d * E
        bound_ms, by = bound(w_bytes + 2 * xb.numel() * 2, flops)
        case = {"shape": [B, S, d], "kept": kept, "bound_ms": bound_ms,
                "bound_by": by}
        for impl in ("einsum", "scatter"):
            fn = getattr(moe, f"moe_{impl}")
            case[f"{impl}_ms"] = time_ms(lambda a: fn(bcfg, bp, a), [(xb,)])
        out[name] = case
        log(f"[moe] qwen3-moe layer {name} ({B} x {S} tokens, {kept} kept "
            f"choices): einsum {case['einsum_ms']:.4f} ms, scatter "
            f"{case['scatter_ms']:.4f} ms, bound {bound_ms:.4f} ms ({by}: "
            f"{w_bytes / 1e9:.2f} GB of expert and router weights)")
    out["decode_step_bound_ms"] = cfg.num_layers * out["decode8"]["bound_ms"]
    log(f"[moe] float32 1024-token group: einsum vs scatter max |err| "
        f"{err:.3g}, {out['kept']}/{out['choices']} choices kept at capacity "
        f"{out['capacity']}, keep mask equal to the CPU's: {keep_equal}, "
        f"narrow ties {ties}; a {cfg.num_layers}-layer decode step's MoE "
        f"bound {out['decode_step_bound_ms']:.2f} ms")
    res["moe_layer"] = out


def _ring_greedy_run(params, cfg, prompt, steps, device):
    """The prompt's first ``cfg.window`` tokens in one prefill, the rest as
    one chunk, into a cache whose local layers are ``cfg.window``-slot
    rings; then greedy decode steps."""
    import torch
    from repro_torch.models import (decode_step, init_cache,
                                    prefill_chunk_into_slot,
                                    prefill_into_slot)
    w = cfg.window
    caches = init_cache(cfg, 1, 2 * len(prompt), dtype=torch.float32,
                        device=device)
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=device)[None]
    _, caches, _ = prefill_into_slot(params, cfg, toks[:, :w], w, caches, 0)
    logits, caches = prefill_chunk_into_slot(params, cfg, toks[:, w:], w,
                                             len(prompt) - w, caches, 0)
    first = logits.float().cpu()
    out = [int(logits[0].argmax())]
    p = torch.tensor([len(prompt)], dtype=torch.int32, device=device)
    for _ in range(steps - 1):
        tok = torch.tensor([[out[-1]]], device=device)
        logits, caches = decode_step(params, cfg, tok, caches, p)
        out.append(int(logits[0].argmax()))
        p = p + 1
    return first, out


def _paged_engine_run(params, cfg, device):
    """5 greedy requests sharing a 48-token head through a paged engine with
    the prefix cache and a 15-page pool: prefix hits and recompute after
    preemption run chunk_attention."""
    import numpy as np
    from repro_torch.core import SamplingParams
    from repro_torch.serving import EngineConfig, Server, ServingEngine
    eng = ServingEngine(cfg, params=params, ecfg=EngineConfig(
        max_batch=4, max_len=256, paged=True, page_size=16, num_pages=16,
        prefix_cache=True, cache_dtype="float32", governor="defaultnv"),
        device=device)
    server = Server(eng)
    rng = np.random.default_rng(1)
    head = rng.integers(0, cfg.vocab_size, size=48)
    hs = [server.submit(np.concatenate(
        [head, rng.integers(0, cfg.vocab_size, size=n)]),
        SamplingParams(max_tokens=m))
        for n, m in ((20, 24), (35, 30), (10, 20), (50, 26), (28, 22))]
    rep = server.run()
    if rep.completed != len(hs):
        raise AssertionError(f"paged run on {device}: {rep.completed}/"
                             f"{len(hs)} completed")
    return {"tokens": [list(h.request.tokens) for h in hs],
            "preempted": eng._preempted,
            "hits": eng.prefix_cache.stats()["hits"]}


# -- phase 4: serve ------------------------------------------------------------------------

def _serve_engine(kv_quant=False, arch="qwen2-1.5b"):
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = get_config(arch).replace(kv_quant=kv_quant)
    return cfg, ServingEngine(cfg, ecfg=EngineConfig(max_batch=8, max_len=2048,
                                                     governor="greenllm"),
                              seed=0, device="cuda")


def _serve_requests(vocab):
    """The serve burst's 8 requests: (prompt of 100-1000 tokens, 64-128
    new tokens), seeded."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = np.linspace(100, 1000, 8).astype(int)
    rng.shuffle(lens)
    return [(rng.integers(0, vocab, size=int(n)), int(rng.integers(64, 129)))
            for n in lens]


def _burst(server, vocab, sampling=None):
    """Submit the serve burst's 8 requests and serve them to completion;
    greedy, or request i with ``sampling(i, max_tokens)``."""
    from repro_torch.core import SamplingParams
    reqs = _serve_requests(vocab)
    handles = [server.submit(prompt, SamplingParams(max_tokens=m)
                             if sampling is None else sampling(i, m))
               for i, (prompt, m) in enumerate(reqs)]
    return [len(p) for p, _ in reqs], handles, server.run()


def _op_count(fn):
    """Run ``fn()`` counting the PyTorch operators it dispatches (each call
    that reaches the dispatcher below autograd, on any device; the port's
    ctypes kernel launches are not operators).  Returns the count and the
    counts by operator name."""
    from collections import Counter
    from torch.utils._python_dispatch import TorchDispatchMode
    by_op = Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            by_op[str(func)] += 1
            return func(*args, **(kwargs or {}))
    with Count():
        fn()
    return sum(by_op.values()), by_op


# the port's kernels in a profile, by a substring of their (demangled) name;
# the decode body's main kernel by row policy, its combine kernel apart
KERNEL_FAMILIES = (("flash_attention", "flash_kernel"),
                   ("chunk_attention", "chunk_kernel"),
                   ("chunk_attention merge", "chunk_merge_kernel"),
                   ("decode body, dense rows", "DenseRows"),
                   ("decode body, paged rows", "PagedRows"),
                   ("decode combine", "combine_kernel"),
                   ("rmsnorm", "rmsnorm_kernel"),
                   ("add_rmsnorm", "add_norm_kernel"))


def _profiled(path, make_engine, burst):
    """``burst`` once to warm up, then once more under ``torch.profiler``
    (CUDA activity only): the device's busy share of the wall time, its
    kernel time by name and the port's kernels' time by family with the
    launches of that run; then once more counting the PyTorch operators the
    host dispatches per forward pass (``_op_count``; forward passes from
    the attention launches, one per attention layer and pass on every
    route)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.api import Server
    cfg, eng = make_engine()
    server = Server(eng)
    burst(server, cfg.vocab_size)
    torch.cuda.synchronize()
    _reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        burst(server, cfg.vocab_size)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us
    busy = sum(by_name.values()) / 1e6
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    launched = _launch_counts()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log(f"[profile] {path}: wall {wall:.3f}s, device busy {busy:.3f}s = "
        f"{100 * busy / wall:.1f}% (idle {100 * (1 - busy / wall):.1f}%)")
    for name, us in top:
        log(f"[profile]   {us / 1e3:9.1f} ms  {100 * us / 1e6 / wall:5.1f}%  "
            f"{name[:90]}")
    families = {f: sum(us for n, us in by_name.items() if key in n) / 1e3
                for f, key in KERNEL_FAMILIES}
    for f, ms in families.items():
        log(f"[profile]   {path} {f}: {ms:.1f} ms = "
            f"{100 * ms / 1e3 / busy:.1f}% of busy")
    log(f"[profile]   {path} launches {launched}")
    _reset_counts()
    ops, by_op = _op_count(lambda: burst(server, cfg.vocab_size))
    counted = _launch_counts()
    norms = counted["rmsnorm"] + counted["add_rmsnorm"]
    attn_layers = sum(k in ("full", "local") for k in cfg.layer_kinds)
    passes = sum(n for r, n in counted.items()
                 if "norm" not in r) // attn_layers
    adds = sum(n for op, n in by_op.items() if op.startswith("aten.add"))
    log(f"[profile] {path}: {ops} PyTorch operators dispatched for {passes} "
        f"forward passes = {ops / passes:.1f} per pass; aten.add "
        f"{adds / passes:.1f} per pass; norms per pass {norms / passes:.1f} "
        f"(rmsnorm {counted['rmsnorm'] / passes:.2f}, add_rmsnorm "
        f"{counted['add_rmsnorm'] / passes:.2f})")
    return {"wall_s": wall, "device_busy_s": busy,
            "top_ms": {n: us / 1e3 for n, us in top},
            "family_ms": families, "launches": launched,
            "ops_per_pass": ops / passes, "passes": passes,
            "adds_per_pass": adds / passes,
            "ops_by_name": dict(by_op.most_common(30))}


def phase_profile(res):
    """Opt-in (``--phases ...,profile``): the serve, serve_paged and
    serve_q8 bursts under ``torch.profiler``, each after a warm-up run of
    itself (a paged one then starts with a warm prefix cache); then the
    serve burst on qwen3-moe-30b-a3b at full width and depth (the path of
    the arch phase's, there at 8 layers, ``arch_qwen3moe``), whose decode
    reads every expert, and on recurrentgemma-9b at full width and depth
    (``arch_rgemma``: 26 RG-LRU
    blocks of PyTorch operators beside 12 local attention layers).  With
    ``--archs``, only the named models' bursts."""
    import gc
    import torch
    res["profile"] = {}
    if ONLY_ARCHS is None:
        res["profile"] = {
            "serve": _profiled("serve", _serve_engine, _burst),
            "serve_paged": _profiled("serve_paged", _paged_serve_engine,
                                     _paged_waves),
            "serve_q8": _profiled("serve_q8", lambda: _serve_engine(True),
                                  _burst),
            "serve_q8_paged": _profiled("serve_q8_paged",
                                        lambda: _paged_serve_engine(True),
                                        _paged_waves)}
    for arch, path in (("qwen3-moe-30b-a3b", "arch_qwen3moe"),
                       ("recurrentgemma-9b", "arch_rgemma")):
        if ONLY_ARCHS is None or arch in ONLY_ARCHS:
            gc.collect()
            torch.cuda.empty_cache()
            res["profile"][path] = _profiled(
                path, lambda a=arch: _serve_engine(arch=a), _burst)


def _counters():
    """(module, attribute) of every kernel launch count, by route name."""
    from repro_torch.kernels import (chunk_attention, decode_attention,
                                     decode_attention_q8, flash_attention,
                                     paged_decode_attention, rmsnorm)
    return {"rmsnorm": (rmsnorm, "launches"),
            "add_rmsnorm": (rmsnorm, "add_launches"),
            "decode_attention": (decode_attention, "launches"),
            "chunk_attention": (chunk_attention, "launches"),
            "chunk_attention/dense": (chunk_attention, "dense_launches"),
            "flash_attention": (flash_attention, "launches"),
            "paged_decode_attention": (paged_decode_attention, "launches"),
            "paged_decode_attention/q8": (paged_decode_attention,
                                          "q8_launches"),
            "paged_decode_attention/f32_past": (paged_decode_attention,
                                                "f32_past_launches"),
            "chunk_attention/f32_past": (chunk_attention,
                                         "f32_past_launches"),
            "chunk_attention/dense_f32_past": (chunk_attention,
                                               "dense_f32_past_launches"),
            "decode_attention_q8": (decode_attention_q8, "launches"),
            "flash_attention/lse": (flash_attention, "lse_launches"),
            "flash_attention_bwd": (flash_attention, "bwd_launches"),
            "rmsnorm_bwd": (rmsnorm, "bwd_launches"),
            "rmsnorm_bwd/ds": (rmsnorm, "bwd_ds_launches")}


def _reset_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _launch_counts():
    return {n: getattr(mod, attr) for n, (mod, attr) in _counters().items()}


def _check_launched(path, counts, names):
    for n in names:
        if counts[n] <= 0:
            raise AssertionError(f"kernel {n} was not launched by the "
                                 f"{path} path")


def _check_outputs(handles, vocab):
    import numpy as np
    for h in handles:
        toks = np.asarray(h.request.tokens)
        if h.request.state.name != "FINISHED" \
                or len(toks) != h.request.output_len or toks.min() < 0 \
                or toks.max() >= vocab:
            raise AssertionError(f"request {h.rid}: {h.request.state.name}, "
                                 f"bad output {toks}")


def _tokens_digest(handles):
    """The first 16 hex digits of the sha256 of every request's tokens: a
    burst's tokens compared across runs, calls and source trees."""
    return hashlib.sha256(json.dumps(
        [list(map(int, h.request.tokens)) for h in handles]).encode()
    ).hexdigest()[:16]


def _kv_bytes_per_token(eng):
    """Bytes of K/V state (values and scales, every layer) per token the
    engine's caches or pools hold."""
    n = sum(t.numel() * t.element_size() for stage in eng.caches
            for d in stage for t in d.values())
    tokens = (eng.pager.num_pages * eng.ecfg.page_size if eng.pager
              else eng.ecfg.max_batch * eng.ecfg.max_len)
    return n / tokens


def phase_serve(res, kv_quant=False, path="serve"):
    import torch
    from repro_torch.serving.api import Server
    t0 = time.perf_counter()
    cfg, eng = _serve_engine(kv_quant)
    torch.cuda.synchronize()
    log(f"[{path}] engine with random bf16 weights built in "
        f"{time.perf_counter() - t0:.1f}s")
    server = Server(eng)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lens, handles, rep = _burst(server, cfg.vocab_size)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    out_toks = sum(len(h.request.tokens) for h in handles)
    log(rep.summary())
    log(f"[{path}] {len(handles)} requests, prompts {sorted(lens)}, "
        f"{out_toks} tokens out in {wall:.2f}s wall = {out_toks / wall:.1f} "
        f"tokens/s; host drains {eng._host_drains}; tokens sha256 "
        f"{_tokens_digest(handles)}; launches {counts}")
    if rep.completed != len(handles):
        raise AssertionError(f"only {rep.completed}/{len(handles)} completed")
    _check_outputs(handles, cfg.vocab_size)
    decode = "decode_attention_q8" if kv_quant else "decode_attention"
    _check_launched(path, counts, ("rmsnorm", "add_rmsnorm", decode,
                                   "flash_attention"))
    if kv_quant and counts["decode_attention"]:
        raise AssertionError("the int8 path ran the bf16 decode kernel")
    res[path] = {"wall_s": wall, "tokens_out": out_toks,
                 "tokens_per_s": out_toks / wall, "launches": counts,
                 "completed": rep.completed, "energy_j": rep.total_energy_j,
                 "host_drains": eng._host_drains,
                 "tokens_sha256": _tokens_digest(handles),
                 "kv_bytes_per_token": _kv_bytes_per_token(eng)}


def _paged_serve_engine(kv_quant=False):
    """Full-width, full-depth qwen2-1.5b in bf16 on the paged engine with
    the prefix cache and a 219-page pool (3504 tokens, against 16384 for
    the dense cache)."""
    from repro_torch.configs import get_config
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg = get_config("qwen2-1.5b").replace(kv_quant=kv_quant)
    return cfg, ServingEngine(cfg, ecfg=EngineConfig(
        max_batch=8, max_len=2048, paged=True, page_size=16, num_pages=220,
        prefix_cache=True, governor="greenllm"), seed=0, device="cuda")


def _paged_waves(server, vocab):
    """Two waves of 8 greedy requests served to completion, each prompt a
    shared 256-token system prompt (16 pages) and a 100-700-token tail,
    64-128 new tokens.  Prefix hits and recompute after preemption run
    chunk_attention."""
    import numpy as np
    from repro_torch.core import SamplingParams
    rng = np.random.default_rng(2)
    sys_prompt = rng.integers(0, vocab, size=256)
    handles = []
    for _ in range(2):
        tails = np.linspace(100, 700, 8).astype(int)
        rng.shuffle(tails)
        handles += [server.submit(
            np.concatenate([sys_prompt, rng.integers(0, vocab, size=int(n))]),
            SamplingParams(max_tokens=int(rng.integers(64, 129))))
            for n in tails]
        rep = server.run()
    return handles, rep


def phase_serve_paged(res, kv_quant=False, path="serve_paged"):
    import torch
    from repro_torch.serving import Server
    cfg, eng = _paged_serve_engine(kv_quant)
    server = Server(eng)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles, rep = _paged_waves(server, cfg.vocab_size)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    pc = eng.prefix_cache.stats()
    out_toks = sum(len(h.request.tokens) for h in handles)
    log(rep.summary())
    log(f"[{path}] {len(handles)} requests in two waves, {out_toks} "
        f"tokens out in {wall:.2f}s wall = {out_toks / wall:.1f} tokens/s; "
        f"host drains {eng._host_drains}; preempted {eng._preempted}; "
        f"prefix cache {pc}; peak pages {eng.pager.peak_used}/"
        f"{eng.pager.num_pages - 1}; tokens sha256 "
        f"{_tokens_digest(handles)}; launches {counts}")
    if rep.completed != len(handles):
        raise AssertionError(f"only {rep.completed}/{len(handles)} completed")
    _check_outputs(handles, cfg.vocab_size)
    if not (pc["hits"] >= 1 and eng._preempted >= 1):
        raise AssertionError(f"no prefix hit or no preemption: {pc}, "
                             f"preempted {eng._preempted}")
    paged, other = ("paged_decode_attention/q8", "paged_decode_attention")
    if not kv_quant:
        paged, other = other, paged
    _check_launched(path, counts, ("rmsnorm", "add_rmsnorm", paged,
                                   "flash_attention", "chunk_attention"))
    if counts["decode_attention"] or counts["decode_attention_q8"] \
            or counts[other]:
        raise AssertionError(f"the {path} path ran another decode kernel: "
                             f"{counts}")
    res[path] = {
        "wall_s": wall, "tokens_out": out_toks,
        "tokens_per_s": out_toks / wall, "launches": counts,
        "completed": rep.completed, "energy_j": rep.total_energy_j,
        "host_drains": eng._host_drains, "preempted": eng._preempted,
        "prefix_cache": pc, "peak_pages": eng.pager.peak_used,
        "tokens_sha256": _tokens_digest(handles),
        "kv_bytes_per_token": _kv_bytes_per_token(eng)}


def phase_serve_q8(res):
    """The serve and serve_paged bursts with kv_quant: int8 K/V caches and
    pools with float32 scales, full width and depth, bf16 weights."""
    from repro_torch.configs import get_config
    phase_serve(res, kv_quant=True, path="serve_q8")
    phase_serve_paged(res, kv_quant=True, path="serve_q8_paged")
    cfg = get_config("qwen2-1.5b")
    bf16 = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2
    for path in ("serve_q8", "serve_q8_paged"):
        b = res[path]["kv_bytes_per_token"]
        log(f"[serve_q8] {path}: {res[path]['tokens_per_s']:.1f} tokens/s; "
            f"KV bytes per token {b:.0f} against bf16's {bf16} "
            f"({b / bf16:.3f}x)")


def phase_paged_vs_dense(res):
    """The serve phase's burst through a dense and a paged engine (no
    prefix cache, a pool that never preempts) on the same weights, with
    bf16 caches and with kv_quant: the tokens must be identical."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, Server, ServingEngine
    base = get_config("qwen2-1.5b")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), base)
    res["paged_vs_dense"] = {}
    for kv_quant in (False, True):
        cfg = base.replace(kv_quant=kv_quant)
        tag = "kv_quant" if kv_quant else "bf16"
        toks = {}
        for paged in (False, True):
            eng = ServingEngine(cfg, params=params, ecfg=EngineConfig(
                max_batch=8, max_len=2048, paged=paged), device="cuda")
            _, handles, rep = _burst(Server(eng), cfg.vocab_size)
            _check_outputs(handles, cfg.vocab_size)
            toks[paged] = [list(h.request.tokens) for h in handles]
            del eng
        same = toks[True] == toks[False]
        log(f"[paged_vs_dense] {tag}: {sum(map(len, toks[True]))} tokens; "
            f"identical: {same}")
        if not same:
            diff = [i for i, (a, b) in enumerate(zip(toks[True], toks[False]))
                    if a != b]
            raise AssertionError(f"{tag}: paged and dense engines differ on "
                                 f"requests {diff}")
        res["paged_vs_dense"][tag] = {"identical": True,
                                      "tokens": sum(map(len, toks[True]))}


# -- phase 8: sampling ------------------------------------------------------------------

def _seeded(i, m):
    """The mixed burst: even requests greedy, odd ones seeded nucleus
    sampling (temperature 0.8, top-k 50, top-p 0.95)."""
    from repro_torch.core import SamplingParams
    if i % 2 == 0:
        return SamplingParams(max_tokens=m)
    return SamplingParams(max_tokens=m, temperature=0.8, top_k=50,
                          top_p=0.95, seed=100 + i)


def _wall_ms(fn, n=50):
    """Mean wall time of one call, host dispatch included (what an eager
    decode step pays), over ``n`` calls after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _sampler_checks(res):
    """CUDA against CPU on the same inputs: threefry keys, fold_in and raw
    bits bitwise, uniform bitwise, Gumbel noise close; the sampler's tokens
    on one bf16 (8 x 151936) logits tensor equal; its time per call beside
    the argmax it replaces in all-greedy blocks."""
    import torch
    from repro_torch.core import prng
    from repro_torch.models import sample_tokens_batched
    from repro_torch.serving.engine import _sample_rows
    V = 151936
    keys = torch.stack([prng.prng_key(s) for s in (0, 1, 2 ** 31 - 1, -5)])
    rows = prng.fold_in(keys.repeat(1024, 1), torch.arange(4096))
    bits = prng.random_bits32(rows[:8], V)
    cuda = {"fold_in": prng.fold_in(keys.cuda().repeat(1024, 1),
                                    torch.arange(4096, device="cuda")),
            "bits": prng.random_bits32(rows[:8].cuda(), V),
            "uniform": prng.uniform(rows[:8].cuda(), V)}
    for name, want in (("fold_in", rows), ("bits", bits),
                       ("uniform", prng.uniform(rows[:8], V))):
        if not torch.equal(cuda[name].cpu(), want):
            raise AssertionError(f"threefry {name}: CUDA differs from CPU")
    g_err = max_err(prng.gumbel(rows[:8].cuda(), V).cpu(),
                    prng.gumbel(rows[:8], V))
    g = torch.Generator().manual_seed(0)
    logits = (torch.randn(8, V, generator=g) * 3).bfloat16()
    temps = torch.tensor([0.0, 0.8, 0.7, 1.1, 0.9, 1.3, 0.0, 0.8])
    topk = torch.tensor([0, 50, 40, 0, 50, V, 5, 0], dtype=torch.int32)
    topp = torch.tensor([1.0, 0.95, 1.0, 0.9, 0.95, 1.0, 0.5, 1.0])
    sub = prng.fold_in(rows[:8], torch.arange(8) + 300)
    cpu_tok = sample_tokens_batched(logits, temps, topk, topp, sub)
    dev = [t.cuda() for t in (logits, temps, topk, topp, sub)]
    cuda_tok = sample_tokens_batched(*dev).cpu()
    log(f"[sampling] threefry on CUDA: fold_in (4096 rows), raw bits and "
        f"uniform (8 x {V}) bitwise equal to the CPU's; Gumbel max |err| "
        f"{g_err:.3g}; sampler tokens cuda {cuda_tok.tolist()} cpu "
        f"{cpu_tok.tolist()}")
    if not torch.equal(cuda_tok, cpu_tok):
        raise AssertionError("sampler: CUDA tokens differ from CPU tokens")
    pos = torch.arange(8, dtype=torch.int32, device="cuda") + 300
    keys8, (lg, t8, k8, p8) = dev[4], dev[:4]
    ms = _wall_ms(lambda: _sample_rows(True, lg, pos + 1, keys8, t8, k8, p8))
    argmax_ms = _wall_ms(lambda: _sample_rows(False, lg, pos + 1, keys8, t8,
                                              k8, p8))
    log(f"[sampling] sampler per decode step (8 x {V} bf16 logits, subkeys "
        f"included): {ms:.3f} ms wall against the argmax's {argmax_ms:.3f} "
        f"ms ({res['card']})")
    return {"gumbel_max_abs_err": g_err, "tokens": cuda_tok.tolist(),
            "sampler_ms": ms, "argmax_ms": argmax_ms}


def _timed_burst(make, params, sampling, path=None):
    """One burst on a fresh engine from ``make(params)``: (tokens per
    request, requests preempted with their token count at the first
    preemption, wall s, output tokens, engine).  With ``path`` the launch
    counts are set to 0 before it and kept under that name after."""
    import torch
    from repro_torch.core import RequestState, StateEvent, TokenEvent
    from repro_torch.serving import Server
    cfg, eng = make(params)
    seen, cut = {}, {}

    def on_event(ev):
        if isinstance(ev, TokenEvent):
            seen[ev.rid] = seen.get(ev.rid, 0) + ev.n
        elif isinstance(ev, StateEvent) and ev.state is RequestState.QUEUED:
            cut.setdefault(ev.rid, seen.get(ev.rid, 0))
    server = Server(eng, on_event=on_event)
    if path:
        _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, handles, rep = _burst(server, cfg.vocab_size, sampling)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rep.completed != len(handles):
        raise AssertionError(f"only {rep.completed}/{len(handles)} completed")
    _check_outputs(handles, cfg.vocab_size)
    toks = [list(h.request.tokens) for h in handles]
    cut = {i: cut[h.rid] for i, h in enumerate(handles) if h.rid in cut}
    return toks, cut, wall, sum(map(len, toks)), eng


def phase_sampling(res):
    """Per-request sampling at full width: CUDA threefry and sampler against
    the CPU's, then the mixed burst (even requests greedy, odd ones seeded
    nucleus sampling) through a dense engine and through the serve_paged
    pool (it preempts), each twice: reproducible run to run, greedy rows
    equal to the all-greedy burst's on the same path, and sampled rows
    equal between paged and dense -- in full for every request the pool
    never preempted and on a roomy pool, and up to the first preemption
    for the others (a recomputed context is chunked prefill, not the dense
    engine's one-shot prefill and decode writes, so its bf16 K/V need not
    be the same bits).  Tokens/s of the mixed burst against the all-greedy
    one in the same call."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingEngine
    out = {"checks": _sampler_checks(res)}
    cfg = get_config("qwen2-1.5b")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)

    def dense(p):
        return cfg, ServingEngine(cfg, params=p, ecfg=EngineConfig(
            max_batch=8, max_len=2048, governor="greenllm"), device="cuda")

    def paged(p, num_pages=220):
        return cfg, ServingEngine(cfg, params=p, ecfg=EngineConfig(
            max_batch=8, max_len=2048, paged=True, page_size=16,
            num_pages=num_pages, prefix_cache=True, governor="greenllm"),
            device="cuda")

    greedy1 = _timed_burst(dense, params, None)
    mixed1 = _timed_burst(dense, params, _seeded, "sampling")
    res["sampling"] = {"launches": _launch_counts()}
    mixed2 = _timed_burst(dense, params, _seeded)
    greedy2 = _timed_burst(dense, params, None)
    _check_launched("sampling", res["sampling"]["launches"],
                    ("rmsnorm", "add_rmsnorm", "decode_attention",
                     "flash_attention"))
    tps = {"greedy": [b[3] / b[2] for b in (greedy1, greedy2)],
           "mixed": [b[3] / b[2] for b in (mixed1, mixed2)]}
    log(f"[sampling] dense: greedy {greedy1[3]} tokens at "
        f"{tps['greedy'][0]:.1f} / {tps['greedy'][1]:.1f} tokens/s, mixed "
        f"{mixed1[3]} tokens at {tps['mixed'][0]:.1f} / "
        f"{tps['mixed'][1]:.1f} tokens/s (order greedy, mixed, mixed, "
        f"greedy; {res['card']})")
    if mixed1[0] != mixed2[0] or greedy1[0] != greedy2[0]:
        raise AssertionError("dense bursts differ run to run")
    sampled = [i for i in range(8) if i % 2]
    for i in range(8):
        same = mixed1[0][i] == greedy1[0][i]
        if same != (i not in sampled):
            raise AssertionError(f"dense request {i}: a greedy row moved "
                                 "with its sampled neighbours, or a sampled "
                                 "row did not sample")
    pmixed1 = _timed_burst(paged, params, _seeded, "sampling_paged")
    res["sampling_paged"] = {"launches": _launch_counts()}
    pmixed2 = _timed_burst(paged, params, _seeded)
    pgreedy = _timed_burst(paged, params, None)
    roomy = _timed_burst(lambda p: paged(p, num_pages=0), params, _seeded)
    _check_launched("sampling_paged", res["sampling_paged"]["launches"],
                    ("rmsnorm", "add_rmsnorm", "paged_decode_attention",
                     "flash_attention", "chunk_attention"))
    eng = pmixed1[4]
    log(f"[sampling] paged (220-page pool, prefix cache): preempted "
        f"{eng._preempted} (requests {sorted(pmixed1[1])} at tokens "
        f"{[pmixed1[1][i] for i in sorted(pmixed1[1])]}), "
        f"{pmixed1[3]} tokens at {pmixed1[3] / pmixed1[2]:.1f} tokens/s; "
        f"roomy pool preempted {roomy[4]._preempted}")
    if not pmixed1[1] or roomy[1]:
        raise AssertionError("the paged burst must preempt and the roomy "
                             "one must not")
    if pmixed1[0] != pmixed2[0]:
        raise AssertionError("paged bursts differ run to run")
    for i in range(0, 8, 2):
        if pmixed1[0][i] != pgreedy[0][i]:
            raise AssertionError(f"paged greedy request {i} differs from "
                                 "the all-greedy paged burst")
    full_equal = []
    for i in sampled:
        p, d = pmixed1[0][i], mixed1[0][i]
        if roomy[0][i] != d:
            raise AssertionError(f"sampled request {i}: roomy paged pool "
                                 "differs from the dense engine")
        n = pmixed1[1].get(i)
        if (p != d) if n is None else (p[:n] != d[:n]):
            raise AssertionError(f"sampled request {i}: paged differs from "
                                 f"dense (first preempted at {n} tokens)")
        full_equal.append(p == d)
    log(f"[sampling] sampled rows: paged == dense on the roomy pool for all "
        f"{len(sampled)}; on the preempting pool in full for "
        f"{sum(full_equal)} of {len(sampled)} (the rest equal up to their "
        f"preemption); runs reproducible; greedy rows unmoved")
    out.update(tokens_per_s=tps, preempted=eng._preempted,
               preempted_at=pmixed1[1],
               paged_tokens_per_s=pmixed1[3] / pmixed1[2],
               sampled_full_equal=sum(full_equal))
    res["sampling"].update(out)


# -- phase 9: observability -----------------------------------------------------------

def phase_observability(res):
    """The serve burst bare and with metrics, tracer and energy ledger
    installed on the same weights: the same tokens, host drains, virtual
    time and energy, and the ledger conserves bitwise."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import (EnergyLedger, MetricsRegistry, Tracer,
                                  verify_conservation)
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg = get_config("qwen2-1.5b")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    sinks = {}

    def engine(p, **kw):
        return cfg, ServingEngine(cfg, params=p, ecfg=EngineConfig(
            max_batch=8, max_len=2048, governor="greenllm"), device="cuda",
            name="e0", **kw)
    bare = _timed_burst(engine, params, None)
    reg, tr, led = MetricsRegistry(), Tracer(), EnergyLedger()
    inst = _timed_burst(lambda p: engine(p, metrics=reg, tracer=tr,
                                         ledger=led),
                        params, None, "observability")
    res["observability"] = {"launches": _launch_counts()}
    _check_launched("observability", res["observability"]["launches"],
                    ("rmsnorm", "add_rmsnorm", "decode_attention",
                     "flash_attention"))
    e0, e1 = bare[4], inst[4]
    rep = e1.report()
    (summ,) = verify_conservation(led, [dict(
        replica="e0", prefill_j=rep.prefill_energy_j,
        decode_j=rep.decode_energy_j, idle_j=rep.idle_energy_j)])
    flat = reg.flat()
    log(f"[observability] bare vs instrumented: tokens equal "
        f"{bare[0] == inst[0]}, host drains {e0._host_drains} / "
        f"{e1._host_drains}, vtime {e0.vtime!r} / {e1.vtime!r}; ledger "
        f"conserved, {summ['attributed_j']:.1f} J attributed, "
        f"{summ['energy_saved_j']:.1f} J saved vs f_max (plant model); "
        f"{len(list(tr.spans()))} spans, {len(list(tr.decisions()))} DVFS "
        f"decisions, {len(reg.timeline)} timeline snapshots; wall "
        f"{bare[2]:.2f} s bare, {inst[2]:.2f} s instrumented ({res['card']})")
    if bare[0] != inst[0] or e0._host_drains != e1._host_drains \
            or e0.vtime != e1.vtime or e0.energy_j != e1.energy_j:
        raise AssertionError("the instrumented run is not step-identical "
                             "to the bare one")
    if flat['greenllm_requests_total{replica="e0",event="completed"}'] != 8:
        raise AssertionError(f"metrics miss completions: {flat}")
    res["observability"].update(
        host_drains=e1._host_drains, spans=len(list(tr.spans())),
        attributed_j=summ["attributed_j"], wall_bare_s=bare[2],
        wall_instrumented_s=inst[2], stats=e1.stats())


# -- phase 10: arch ----------------------------------------------------------------------

# the arch phase's models, one at a time: (arch, layers (None: full depth),
# path tag, bursts).  Bursts: "serve" (the serve burst, greedy),
# "sampled" (the same with every odd request seeded nucleus sampling),
# "waves" (the serve_paged waves on a paged engine with the prefix cache,
# which must hit and preempt), "long" / "long_q8" / "long_paged" (4
# prompts of 4500-8000 tokens past a 4096 window at max_len 16384: dense
# with bf16 and int8 caches, and paged, which must preempt).  Every model
# at full width; at full depth musicgen-large (48 layers); at 8 layers
# qwen3-14b, gemma2-9b (4 local + full pairs), qwen3-moe-30b-a3b and
# llava-next-mistral-7b (at full depth the phase took 224-318 s of a
# default run that reached 1285 s of its 1200 on a slow host);
# granite-8b, chatglm3-6b and mixtral-8x7b (93 GB of bf16 weights at its
# 32 layers) at 4 layers.  The recurrent models: mamba2-370m (12 of its 48
# SSM blocks, no attention) the serve burst greedy and sampled;
# recurrentgemma-9b (9 of its 38 layers: 6 RG-LRU, 3 local MQA 16:1 at hd
# 256, window 2048) the serve burst, the
# long burst on the dense engine ("long": its 2048-slot rings; the path is
# ``arch_rgemma_long`` beside the serve burst's ``arch_rgemma``), "reuse"
# (a stream chunked into a slot an earlier stream left, float32) and the
# paged waves (its local layers pooled at max_len 2048; never a prefix hit)
ARCH_RUNS = (
    ("qwen3-14b", 8, "qwen3", ("serve", "sampled", "waves")),
    ("gemma2-9b", 8, "gemma2", ("long", "long_q8", "long_paged")),
    ("granite-8b", 4, "granite", ("serve",)),
    ("chatglm3-6b", 4, "chatglm3", ("serve",)),
    ("qwen3-moe-30b-a3b", 8, "qwen3moe", ("serve", "sampled", "waves")),
    ("mixtral-8x7b", 4, "mixtral", ("long", "long_q8")),
    ("musicgen-large", None, "musicgen", ("serve",)),
    ("llava-next-mistral-7b", 8, "llava", ("serve", "waves")),
    ("mamba2-370m", 12, "mamba2", ("serve", "sampled")),
    ("recurrentgemma-9b", 9, "rgemma", ("serve", "long", "reuse",
                                        "waves")))
# the archs ``--archs`` keeps (None: every one)
ONLY_ARCHS = None
# every attention kernel route (a model without attention launches none)
ATTN_ROUTES = ("decode_attention", "flash_attention", "chunk_attention",
               "chunk_attention/dense", "chunk_attention/f32_past",
               "chunk_attention/dense_f32_past", "paged_decode_attention",
               "paged_decode_attention/q8", "paged_decode_attention/f32_past",
               "decode_attention_q8")


def _long_burst(server, vocab):
    """4 greedy requests with prompts of 4500-8000 tokens (past the
    4096-token window of gemma2 and mixtral, so every prompt is chunked
    into the local rings) and 32-64 new tokens (decode wraps the rings)."""
    import numpy as np
    from repro_torch.core import SamplingParams
    rng = np.random.default_rng(3)
    lens = np.linspace(4500, 8000, 4).astype(int)
    rng.shuffle(lens)
    handles = [server.submit(rng.integers(0, vocab, size=int(n)),
                             SamplingParams(max_tokens=int(rng.integers(32,
                                                                        65))))
               for n in lens]
    return lens, handles, server.run()


def _arch_burst(res, path, cfg, eng, burst, need, forbid=()):
    """One burst on ``eng`` with the launch counts set to 0 before it and
    read after it; every kernel route in ``need`` must have launched and
    none in ``forbid``.  Tokens/s, launches, preemption and prefix-cache
    counters go to res[path]."""
    import torch
    from repro_torch.serving import Server
    server = Server(eng)
    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = burst(server, cfg.vocab_size)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    handles, rep = out[-2], out[-1]
    if rep.completed != len(handles):
        raise AssertionError(f"{path}: only {rep.completed}/{len(handles)} "
                             "completed")
    _check_outputs(handles, cfg.vocab_size)
    _check_launched(path, counts, need)
    if any(counts[n] for n in forbid):
        raise AssertionError(f"{path} ran {forbid}: {counts}")
    toks = sum(len(h.request.tokens) for h in handles)
    digest = _tokens_digest(handles)
    pc = eng.prefix_cache.stats() if eng.prefix_cache is not None else None
    res[path] = {"wall_s": wall, "tokens_out": toks,
                 "tokens_per_s": toks / wall, "launches": counts,
                 "completed": rep.completed, "energy_j": rep.total_energy_j,
                 "host_drains": eng._host_drains,
                 "preempted": eng._preempted, "prefix_cache": pc,
                 "prompt_tokens": sum(h.request.prompt_len for h in handles),
                 "tokens_sha256": digest,
                 "tokens": [list(map(int, h.request.tokens))
                            for h in handles],
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"[{path.split('_')[0]}] {path}: {cfg.name} {cfg.num_layers} layers, "
        f"{len(handles)} requests, {res[path]['prompt_tokens']} prompt "
        f"tokens, {toks} tokens out in {wall:.2f}s wall = "
        f"{toks / wall:.1f} tokens/s; host drains {eng._host_drains}; "
        f"preempted {eng._preempted}; prefix cache {pc}; tokens sha256 "
        f"{digest}; peak memory "
        f"{res[path]['peak_mem_gb']:.1f} GiB; launches {counts}")
    return res[path]


def phase_arch(res):
    """Every architecture beyond qwen2 on the card, one model at a time
    (its weights freed before the next), each burst of ``ARCH_RUNS`` on a
    fresh engine, at full width and the depths of ``ARCH_RUNS``: qwen3-14b
    (the paper's model) and qwen3-moe-30b-a3b (128 experts, top 8,
    capacity 1.25) serve the serve burst on the dense engine (greedy, then mixed with
    seeded sampling) and the serve_paged waves on the paged engine with
    the prefix cache (it must hit and preempt); gemma2-9b and
    mixtral-8x7b, max_len 16384
    (prompts truncated to 8192, local rings of 4096), max_batch 4, serve 4
    prompts of 4500-8000 tokens on the dense engine (bf16, then int8
    caches), gemma2 also on the paged one (full layers pooled and
    preempting, local rings dense): every prompt chunks through the
    dense-ring route of chunk_attention and decode wraps the rings;
    granite-8b, chatglm3-6b and musicgen-large (layer norm: no rmsnorm
    launch) serve the serve burst; llava-next-mistral-7b (text only) the
    serve burst and the paged waves; mamba2-370m (no
    attention: the norms are its kernels) the serve burst greedy and
    sampled; recurrentgemma-9b the serve burst, the long burst into its
    2048-slot rings, the reuse burst (``_reuse_burst``) and the paged waves
    (its local layers pooled; preempting, never a prefix hit).  Seeded
    random bf16 weights.  At capacity 1.25 an MoE model's routing depends
    on which tokens share a prefill call, so its paged waves (chunks,
    prefix hits) are not held to its dense burst."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingEngine
    gc.collect()
    torch.cuda.empty_cache()
    for arch, layers, tag, bursts in ARCH_RUNS:
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(num_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in _leaves(params))
        log(f"[arch] {arch}: {cfg.num_layers} layers, {n / 1e9:.2f} B "
            f"parameters in bf16 built in {time.perf_counter() - t0:.1f}s")
        rms = ("rmsnorm", "add_rmsnorm")
        norms, no_norms = (rms, ()) if cfg.norm == "rms" else ((), rms)
        attends = bool(cfg.num_heads)
        recurrent = not set(cfg.block_pattern) <= {"full", "local"}
        for burst in bursts:
            eng = None
            if burst in ("serve", "sampled"):
                eng = ServingEngine(cfg, params=params, ecfg=EngineConfig(
                    max_batch=8, max_len=2048, governor="greenllm"),
                    device="cuda")
                _arch_burst(res, f"arch_{tag}" + ("_sampled" * (
                    burst == "sampled")), cfg, eng,
                    lambda s, v, b=burst: _burst(
                        s, v, _seeded if b == "sampled" else None),
                    norms + ("decode_attention", "flash_attention") * attends,
                    no_norms + ATTN_ROUTES * (not attends))
            elif burst == "reuse":
                _reuse_burst(res, f"arch_{tag}_reuse", cfg, params, norms)
            elif burst == "waves":
                eng = ServingEngine(cfg, params=params, ecfg=EngineConfig(
                    max_batch=8, max_len=2048, paged=True, page_size=16,
                    num_pages=220, prefix_cache=True, governor="greenllm"),
                    device="cuda")
                r = _arch_burst(res, f"arch_{tag}_paged", cfg, eng,
                                _paged_waves,
                                norms + ("paged_decode_attention",
                                         "flash_attention",
                                         "chunk_attention"),
                                no_norms + ("decode_attention",))
                # a model with recurrent rows never shares a prefix
                if not (bool(r["prefix_cache"]["hits"]) != recurrent
                        and r["preempted"]):
                    raise AssertionError(f"{arch} paged: prefix hits or "
                                         f"preemption not as required: {r}")
            else:
                # long prompts: chunked through the dense-row route into
                # the 4096-slot rings; "long_q8" quantizes rings and rows,
                # "long_paged" pools the full layers (1000 pages: the burst
                # needs ~1600, so it preempts; the prefix cache never hits
                # a hybrid)
                q8 = burst == "long_q8"
                bcfg = cfg.replace(kv_quant=q8)
                extra = dict(paged=True, page_size=16, num_pages=1000,
                             prefix_cache=True) if burst == "long_paged" \
                    else {}
                eng = ServingEngine(bcfg, params=params, ecfg=EngineConfig(
                    max_batch=4, max_len=16384, governor="greenllm",
                    **extra), device="cuda")
                if burst == "long" and eng.chunk_len != cfg.window:
                    raise AssertionError(f"{arch} chunks of "
                                         f"{eng.chunk_len}")
                if burst == "long_paged":
                    r = _arch_burst(res, f"arch_{tag}_paged", cfg, eng,
                                    _long_burst,
                                    norms + ("decode_attention",
                                             "paged_decode_attention",
                                             "chunk_attention",
                                             "chunk_attention/dense"))
                    if not r["preempted"] or r["prefix_cache"]["hits"]:
                        raise AssertionError(
                            f"{arch} paged: preempted {r['preempted']}, "
                            f"prefix cache {r['prefix_cache']}")
                else:
                    decode = "decode_attention_q8" if q8 \
                        else "decode_attention"
                    long_tag = "_long" if "serve" in bursts else ""
                    _arch_burst(res, f"arch_{tag}" + ("_q8" if q8
                                                      else long_tag),
                                bcfg, eng, _long_burst,
                                norms + (decode, "chunk_attention/dense"),
                                ("chunk_attention",)
                                + ("decode_attention",) * q8)
            # an engine and the reuse burst's wrappers refer to each other:
            # collect them before the next burst
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        del params
        gc.collect()
        torch.cuda.empty_cache()


def _reuse_burst(res, path, cfg, params, norms):
    """A stream chunked into a slot an earlier stream left, at full width
    and depth in float32 (the bf16 weights cast; float32 caches, as the
    bitwise invariants require), max_batch 2, max_len 8192: A (300 tokens,
    48 new) is prefilled in one bucket, B (3000, 16 new) chunks 2048 + 952
    beside A's decode, C (2500, 16 new) waits for the slot of the first of
    them to finish and chunks into it from position 0 beside the other's
    decode.  C's tokens must equal C served alone on a fresh engine (sha256
    digests), and across every decode block the recurrent rows of each
    slot outside the decode batch (free, or a stream between its chunks)
    must keep their bits."""
    import numpy as np
    import torch
    from repro_torch.core import SamplingParams
    from repro_torch.serving import EngineConfig, Server, ServingEngine
    cfg32 = cfg.replace(dtype="float32")
    p32 = _to(params, torch.float32)
    ecfg = EngineConfig(max_batch=2, max_len=8192, governor="greenllm",
                        cache_dtype="float32")
    rng = np.random.default_rng(5)
    trace = ((300, 48), (3000, 16), (2500, 16))
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n, _ in trace]
    eng = ServingEngine(cfg32, params=p32, ecfg=ecfg, device="cuda")
    slots, frozen = _watch_rows(eng)
    kept = []

    def burst(server, vocab):
        kept.extend(server.submit(p, SamplingParams(max_tokens=m))
                    for p, (_, m) in zip(prompts, trace))
        return kept, server.run()
    r = _arch_burst(res, path, cfg32, eng, burst,
                    norms + ("decode_attention", "flash_attention",
                             "chunk_attention/dense"), ("chunk_attention",))
    alone = ServingEngine(cfg32, params=p32, ecfg=ecfg, device="cuda")
    server = Server(alone)
    h = server.submit(prompts[2], SamplingParams(max_tokens=16))
    server.run()
    got, want = _tokens_digest(kept[2:]), _tokens_digest([h])
    r.update(slots=slots, frozen_blocks=frozen, reused_sha256=got,
             alone_sha256=want)
    log(f"[arch] {path}: slots by stream {slots}; decode blocks holding "
        f"rows outside the batch {frozen}; stream 2 chunked into a reused "
        f"slot {got}, served alone {want}")
    if slots[2] not in (slots[0], slots[1]) or slots[0] == slots[1]:
        raise AssertionError(f"{path}: stream 2 did not reuse a slot: "
                             f"{slots}")
    if got != want:
        raise AssertionError(f"{path}: a stream chunked into a reused slot "
                             "differs from the same stream served alone")
    if not (frozen["mid_prefill"] and frozen["free"]):
        raise AssertionError(f"{path}: no decode block held a row outside "
                             f"the batch: {frozen}")


def _watch_rows(eng):
    """Record the slot each stream is admitted to, and check every decode
    block of ``eng``: the recurrent rows (SSM / RG-LRU state and conv
    window, every layer) of each slot outside the decode batch hold the
    same bits after the block as before it.  Returns (slots by rid, counts
    of the blocks that held a mid-prefill row and a free row)."""
    import torch
    slots, frozen = {}, {"mid_prefill": 0, "free": 0}
    leaves = [t for stage in eng.caches for d in stage if "conv" in d
              for t in d.values()]
    admit, chunked, decode = (eng._admit_slot, eng._start_chunked,
                              eng._decode_block)

    def admit_slot(req, slot):
        slots[req.rid] = slot
        return admit(req, slot)

    def start_chunked(req, slot, *a):
        slots[req.rid] = slot
        return chunked(req, slot, *a)

    def decode_block(k):
        held = [s for s in range(eng.ecfg.max_batch) if s not in eng.active]
        if not held:
            return decode(k)
        frozen["mid_prefill"] += any(s in eng.prefilling for s in held)
        frozen["free"] += any(s not in eng.prefilling for s in held)
        before = [t[:, held].clone() for t in leaves]
        n = decode(k)
        for t, b in zip(leaves, before):
            if not torch.equal(t[:, held], b):
                raise AssertionError(f"a decode block moved the recurrent "
                                     f"rows of slots {held} outside the "
                                     "batch")
        return n

    eng._admit_slot, eng._start_chunked = admit_slot, start_chunked
    eng._decode_block = decode_block
    return slots, frozen


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# -- phase 11: cluster --------------------------------------------------------------------

def _cluster_trace(vocab, n, lens, new, gap, seed):
    """(arrival, prompt, sampling) of ``n`` requests: prompt lengths spread
    over ``lens`` and shuffled, 32-96 new tokens (``new``), virtual
    arrivals ``gap`` seconds apart, every odd request seeded nucleus
    sampling (``_seeded``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sizes = np.linspace(*lens, n).astype(int)
    rng.shuffle(sizes)
    return [(gap * i, rng.integers(0, vocab, size=int(L)),
             _seeded(i, int(rng.integers(*new))))
            for i, L in enumerate(sizes)]


def _serve_trace(backend, trace):
    """Serve ``trace`` through ``Server`` on ``backend`` (an engine or a
    cluster); returns the handles, the report and the wall seconds."""
    import torch
    from repro_torch.serving import Server
    server = Server(backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [server.submit(p, sp, arrival=t) for t, p, sp in trace]
    rep = server.run()
    torch.cuda.synchronize()
    return handles, rep, time.perf_counter() - t0


def _count_handoffs(cl):
    """Wrap every replica's ``export_stream`` to record, per handoff, the
    payload's bytes (every extracted page and row) and the bytes of the
    stream's live K/V (its positions times the pools' bytes per token).
    The payload must stay on the card."""
    moved = []
    for r in cl.replicas:
        eng, export = r.engine, r.engine.export_stream
        per_tok = _kv_bytes_per_token(eng)

        def wrapped(slot, export=export, per_tok=per_tok):
            ho = export(slot)
            leaves = [t for stage in ho.blocks for _, pl in stage
                      if pl is not None for t in pl.values()]
            if not all(t.device.type == "cuda" for t in leaves):
                raise AssertionError("a handoff payload left the card")
            moved.append((sum(t.numel() * t.element_size() for t in leaves),
                          ho.pos * per_tok))
            return ho
        eng.export_stream = wrapped
    return moved


def _digest(handles, pick=lambda h: True):
    return _tokens_digest([h for h in handles if pick(h)])


def _cluster_qwen3(res):
    """qwen3-14b at full width and depth in bf16 on 2 prefill replicas (one
    per length class: SM <= 1024 prompt tokens, L above) and 1 decode
    replica, every replica reading the same weight tensors: 12 requests,
    prompts of 100-2000 tokens, 32-96 new tokens, arrivals 50 ms apart,
    every odd one seeded nucleus sampling.  Every stream must migrate once,
    each prefill replica serve only its class, the tokens equal those of
    one colocated paged engine on the same weights, configuration and
    trace, and the peak memory stay below two copies of the weights."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingCluster, \
        ServingEngine
    path = "cluster_qwen3"
    cfg = get_config("qwen3-14b")
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[cluster] {cfg.name}: {cfg.num_layers} layers, "
        f"{w_bytes / 2 ** 30:.1f} GiB of bf16 weights built in "
        f"{time.perf_counter() - t0:.1f}s")
    trace = _cluster_trace(cfg.vocab_size, 12, (100, 2000), (32, 97), 0.05,
                           seed=6)
    torch.cuda.reset_peak_memory_stats()
    cl = ServingCluster(cfg, n_prefill=2, n_decode=1, params=params,
                        ecfg=EngineConfig(max_batch=8, max_len=4096,
                                          governor="greenllm"),
                        device="cuda")
    moved = _count_handoffs(cl)
    _reset_counts()
    handles, rep, wall = _serve_trace(cl, trace)
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    toks = sum(len(h.request.tokens) for h in handles)
    rows = {r.name: r for r in rep.replicas}
    served = {r.name: sorted({q.cls for q in r.engine.requests})
              for r in cl.replicas if r.role == "prefill"}
    classes = {r.name: r.classes for r in cl.replicas}
    digest = _digest(handles)
    per = [b for b, _ in moved]
    bound = [b for _, b in moved]
    res[path] = {
        "wall_s": wall, "tokens_out": toks, "tokens_per_s": toks / wall,
        "launches": counts, "completed": rep.completed,
        "migrated": rep.migrated, "import_retries": cl.import_retries,
        "handoff_bytes": per, "handoff_bound_bytes": bound,
        "freq_mhz": {n: w.freq_mhz for n, w in rows.items()},
        "vtime_s": {n: w.vtime_s for n, w in rows.items()},
        "served_classes": served, "energy_j": rep.total_energy_j,
        "peak_mem_gb": peak / 2 ** 30, "weights_gb": w_bytes / 2 ** 30,
        "prompt_tokens": sum(h.request.prompt_len for h in handles),
        "tokens_sha256": digest}
    log(rep.summary())
    log(f"[cluster] {path}: {len(handles)} requests, "
        f"{res[path]['prompt_tokens']} prompt tokens, {toks} tokens out in "
        f"{wall:.2f}s wall = {toks / wall:.1f} tokens/s; handoffs "
        f"{rep.migrated}, bytes per handoff mean "
        f"{sum(per) / max(len(per), 1) / 2 ** 20:.2f} MiB against the live "
        f"K/V's {sum(bound) / max(len(bound), 1) / 2 ** 20:.2f} MiB "
        f"(total {sum(per) / 2 ** 20:.1f} / {sum(bound) / 2 ** 20:.1f} "
        f"MiB); import retries {cl.import_retries}; clocks (MHz) "
        f"{res[path]['freq_mhz']}; virtual s {res[path]['vtime_s']}; "
        f"classes served {served} of {classes}; peak memory "
        f"{peak / 2 ** 30:.1f} GiB, weights {w_bytes / 2 ** 30:.1f} GiB; "
        f"tokens sha256 {digest}; launches {counts}")
    if rep.completed != len(handles) or rep.migrated != len(handles):
        raise AssertionError(f"{path}: completed {rep.completed}, migrated "
                             f"{rep.migrated} of {len(handles)}")
    _check_outputs(handles, cfg.vocab_size)
    for r in cl.replicas:
        if r.role == "prefill" and served[r.name] != list(r.classes):
            raise AssertionError(f"{path}: {r.name} of class {r.classes} "
                                 f"served {served[r.name]}")
    _check_launched(path, counts, ("rmsnorm", "add_rmsnorm",
                                   "paged_decode_attention",
                                   "flash_attention"))
    if counts["decode_attention"]:
        raise AssertionError(f"{path} ran the dense decode kernel: {counts}")
    if peak >= 2 * w_bytes:
        raise AssertionError(f"{path}: peak memory {peak} >= two copies of "
                             f"the weights ({w_bytes} each)")
    ecfg = cl.ecfg
    del cl
    gc.collect()
    torch.cuda.empty_cache()
    eng = ServingEngine(cfg, params=params, ecfg=ecfg, device="cuda")
    colo, crep, cwall = _serve_trace(eng, trace)
    res[path].update(colocated_sha256=_digest(colo),
                     colocated_wall_s=cwall,
                     colocated_tokens_per_s=toks / cwall)
    log(f"[cluster] {path}: one colocated paged engine, the same trace: "
        f"{cwall:.2f}s wall = {toks / cwall:.1f} tokens/s; tokens sha256 "
        f"{_digest(colo)}")
    if _digest(colo) != digest:
        raise AssertionError(f"{path}: the cluster's tokens differ from "
                             "the colocated engine's")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()


def _cluster_kill(res):
    """qwen2-1.5b at full width and depth in float32 (weights and caches)
    on 1 prefill and 2 decode replicas: 8 requests, prompts of 100-1000
    tokens, every odd one seeded nucleus sampling, served healthy, then
    with a ``FaultPlan`` that kills decode0 mid-decode (at 40% of the
    healthy run's virtual duration) and fails one import.  The killed
    replica's streams are recomputed through chunked prefill on the
    survivors: the greedy rows' and the sampled rows' tokens must equal
    the healthy run's, the dead replica's energy stay frozen at the kill,
    and at least one stream be recovered."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import (EngineConfig, FaultPlan, HandoffFailure,
                                     ReplicaKill, ServingCluster)
    path = "cluster_kill"
    cfg = get_config("qwen2-1.5b").replace(dtype="float32")
    params = _to(init_params(torch.Generator(device="cuda").manual_seed(0),
                             get_config("qwen2-1.5b")), torch.float32)
    ecfg = EngineConfig(max_batch=8, max_len=2048, governor="greenllm",
                        cache_dtype="float32")
    trace = _cluster_trace(cfg.vocab_size, 8, (100, 1000), (32, 97), 0.0,
                           seed=7)

    def run(faults=None):
        cl = ServingCluster(cfg, n_prefill=1, n_decode=2, params=params,
                            ecfg=ecfg, faults=faults, device="cuda")
        recovered = []
        requeue = cl._requeue

        def counted(req, t):
            recovered.append(req.rid)
            return requeue(req, t)
        cl._requeue = counted
        return cl, recovered, *_serve_trace(cl, trace)

    _, _, healthy, hrep, hwall = run()
    kill_at = 0.4 * hrep.duration_s
    plan = FaultPlan([ReplicaKill(at=kill_at, replica="decode0"),
                      HandoffFailure(at=0.0, count=1)])
    _reset_counts()
    cl, recovered, handles, rep, wall = run(plan)
    counts = _launch_counts()
    greedy = lambda h: not h.request.sampling.temperature
    sampled = lambda h: bool(h.request.sampling.temperature)
    digests = {k: (_digest(healthy, f), _digest(handles, f))
               for k, f in (("greedy", greedy), ("sampled", sampled))}
    dead = next(w for w in rep.replicas if w.name == "decode0")
    toks = sum(len(h.request.tokens) for h in handles)
    res[path] = {
        "wall_s": wall, "healthy_wall_s": hwall, "tokens_out": toks,
        "tokens_per_s": toks / wall, "launches": counts,
        "completed": rep.completed, "migrated": rep.migrated,
        "import_retries": cl.import_retries, "kill_at_s": kill_at,
        "kills": cl.kills, "recovered": recovered,
        "dead_energy_j": dead.energy_j, "digests": digests,
        "freq_mhz": {w.name: w.freq_mhz for w in rep.replicas},
        "fault_log": [list(map(str, e)) for e in plan.log]}
    log(rep.summary())
    log(f"[cluster] {path}: {cfg.name} float32, {len(handles)} requests, "
        f"{toks} tokens out in {wall:.2f}s wall (healthy {hwall:.2f}s); "
        f"decode0 killed at {cl.kills[0][1]:.4f}s (planned {kill_at:.4f}s), "
        f"energy {dead.energy_j:.3f} J (at the kill {cl.kills[0][2]:.3f} J); "
        f"recovered streams {recovered}; migrated {rep.migrated}; import "
        f"retries {cl.import_retries}; clocks (MHz) {res[path]['freq_mhz']}; "
        f"tokens sha256 healthy / killed {digests}; launches {counts}")
    if rep.completed != len(handles):
        raise AssertionError(f"{path}: only {rep.completed}/{len(handles)} "
                             "completed")
    _check_outputs(handles, cfg.vocab_size)
    if not cl.kills or not recovered or cl.import_retries < 1:
        raise AssertionError(f"{path}: kills {cl.kills}, recovered "
                             f"{recovered}, retries {cl.import_retries}")
    if dead.alive or dead.energy_j != cl.kills[0][2]:
        raise AssertionError(f"{path}: decode0's energy moved after the "
                             f"kill: {dead.energy_j} != {cl.kills[0][2]}")
    for kind, (want, got) in digests.items():
        if got != want:
            raise AssertionError(f"{path}: the {kind} rows' tokens differ "
                                 "from the healthy run's")
    _check_launched(path, counts, ("rmsnorm", "add_rmsnorm",
                                   "paged_decode_attention",
                                   "flash_attention", "chunk_attention"))
    del cl, params
    gc.collect()
    torch.cuda.empty_cache()


def phase_cluster(res):
    """The disaggregated cluster on the card: ``_cluster_qwen3`` (the
    paper's model at full width and depth, class-routed prefill replicas,
    every stream handed off; its tokens == one colocated engine's) and
    ``_cluster_kill`` (a decode replica killed mid-decode and an import
    failed; recovery gives the healthy run's tokens)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    _cluster_qwen3(res)
    _cluster_kill(res)


# -- main ---------------------------------------------------------------------------------

# -- phase 12: legacy -------------------------------------------------------------------

def _count_calls(obj, name):
    """Wrap method ``name`` of ``obj`` (on the instance) to count its
    calls; returns the one-element count list."""
    n, orig = [0], getattr(obj, name)

    def counted(*a, **k):
        n[0] += 1
        return orig(*a, **k)
    setattr(obj, name, counted)
    return n


def _lockstep_burst(server, vocab):
    """8 greedy requests at t=0, each a 512-token prompt (a bucket: no
    pads) and 64 new tokens, so every decode step has all 8 rows at one
    position."""
    import numpy as np
    from repro_torch.core import SamplingParams
    rng = np.random.default_rng(5)
    handles = [server.submit(rng.integers(0, vocab, size=512),
                             SamplingParams(max_tokens=64)) for _ in range(8)]
    return handles, server.run()


def phase_legacy(res):
    """The legacy data plane and the eager fallback at full width and
    depth.  ``legacy_qwen2``: qwen2-1.5b on ``slot_native=False`` (max_batch
    8, max_len 2048) serves the lockstep burst: one unpadded prefill per
    request (flash 28 x 8), then one decode step of the whole batch per
    round at max(pos) (decode_attention 28 a step), no chunk and no paged
    launch; its tokens must equal the slot-native engine's on the same
    trace (``legacy_qwen2_slot``: the same kernels on the same shapes, and
    decode's fixed spans make a row's bits independent of the buffer
    length), tokens/s of both.  ``legacy_gemma2_fallback``: gemma2-9b at
    full depth, max_batch 4, max_len 16384, ``chunked_prefill=False``: the
    long burst's four 4500-8000-token prompts each exceed the 4096 bucket,
    so each goes through ``_admit_legacy`` (flash over the whole prompt at
    window 4096, the rings keeping the last 4096 positions): 4 legacy
    prefills, flash 42 x 4, no chunk_attention; the agreement of its greedy
    tokens with ``arch_gemma2``'s chunked burst (same prompts) is printed,
    not asserted: bf16 one-shot and chunked prefill are not the same
    bits."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingEngine
    paged_routes = ("chunk_attention", "chunk_attention/dense",
                    "paged_decode_attention", "paged_decode_attention/q8",
                    "paged_decode_attention/f32_past", "decode_attention_q8")
    cfg = get_config("qwen2-1.5b")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    for path, native in (("legacy_qwen2", False), ("legacy_qwen2_slot", True)):
        eng = ServingEngine(cfg, params=params, ecfg=EngineConfig(
            max_batch=8, max_len=2048, governor="greenllm",
            slot_native=native), device="cuda")
        admits = _count_calls(eng, "_admit_legacy")
        steps = _count_calls(eng, "_step_legacy")
        r = _arch_burst(res, path, cfg, eng, _lockstep_burst,
                        ("rmsnorm", "add_rmsnorm", "flash_attention",
                         "decode_attention"), paged_routes)
        r["legacy_prefills"], r["legacy_steps"] = admits[0], steps[0]
        c = r["launches"]
        if not native and (admits[0] != 8 or steps[0] != 63
                           or c["flash_attention"] != cfg.num_layers * 8
                           or c["decode_attention"]
                           != cfg.num_layers * steps[0]):
            raise AssertionError(f"{path}: {admits[0]} legacy prefills, "
                                 f"{steps[0]} steps, launches {c}")
        if native and admits[0]:
            raise AssertionError(f"{path}: the slot-native engine took the "
                                 "legacy admission")
        del eng
    a, b = res["legacy_qwen2"], res["legacy_qwen2_slot"]
    log(f"[legacy] legacy_qwen2 {a['tokens_per_s']:.1f} tokens/s, "
        f"slot-native {b['tokens_per_s']:.1f} tokens/s on the same trace; "
        f"digests {a['tokens_sha256']} {b['tokens_sha256']}")
    if a["tokens_sha256"] != b["tokens_sha256"]:
        raise AssertionError("legacy_qwen2: the legacy plane's tokens differ "
                             "from the slot-native engine's")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config("gemma2-9b")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = ServingEngine(cfg, params=params, ecfg=EngineConfig(
        max_batch=4, max_len=16384, governor="greenllm",
        chunked_prefill=False), device="cuda")
    admits = _count_calls(eng, "_admit_legacy")
    r = _arch_burst(res, "legacy_gemma2_fallback", cfg, eng, _long_burst,
                    ("rmsnorm", "add_rmsnorm", "flash_attention",
                     "decode_attention"), paged_routes)
    r["legacy_prefills"] = admits[0]
    if admits[0] != 4 \
            or r["launches"]["flash_attention"] != cfg.num_layers * 4:
        raise AssertionError(f"legacy_gemma2_fallback: {admits[0]} legacy "
                             f"prefills, launches {r['launches']}")
    chunked = res.get("arch_gemma2", {}).get("tokens")
    if chunked:
        agree = []
        for x, y in zip(r["tokens"], chunked):
            same = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v),
                        min(len(x), len(y)))
            agree.append(f"{same}/{len(x)}")
        r["agreement_with_arch_gemma2"] = agree
        log(f"[legacy] legacy_gemma2_fallback against arch_gemma2's chunked "
            f"tokens: leading tokens equal per request {agree}; digests "
            f"{r['tokens_sha256']} {res['arch_gemma2']['tokens_sha256']}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 13: prefill ------------------------------------------------------------------

def _decode_greedy(params, cfg, logits, caches, pos, steps, feed=None):
    """``steps`` greedy decode steps after a prefill's last logits, at a
    scalar position (every row at ``pos`` + i), each fed the previous
    step's argmax, or with ``feed`` ((B, steps + 1) tokens) teacher-forced
    with ``feed[:, i]``; returns the (B, steps + 1) argmax tokens on the
    host and every step's logits (the prefill's first), float32."""
    import torch
    from repro_torch.models import decode_step
    toks, out = [logits.argmax(-1)], [logits.float()]
    for i in range(steps):
        tok = toks[-1] if feed is None else feed[:, i].to(logits.device)
        logits, caches = decode_step(params, cfg, tok[:, None], caches,
                                     pos + i)
        toks.append(logits.argmax(-1))
        out.append(logits.float())
    return torch.stack(toks, 1).cpu(), out


def _finite_tokens(path, toks, logits, vocab):
    import torch
    if not bool(torch.isfinite(logits).all()) or int(toks.min()) < 0 \
            or int(toks.max()) >= vocab:
        raise AssertionError(f"{path}: non-finite logits or tokens out of "
                             "the vocabulary")


def phase_prefill(res):
    """The unpadded ``prefill`` at full width and depth.  ``prefill_llava``:
    llava-next-mistral-7b (32 layers), B 2, 2880 seeded image-patch
    embeddings through ``prefix_proj`` and a 512-token prompt into
    ``init_cache(cfg, 2, 4096)``, then 32 greedy decode steps at a scalar
    position (``tests/test_arch_smoke.py``'s loop): next_pos 3392, flash
    32, decode_attention 32 x 32.  ``long_qwen3``: qwen3-14b (40 layers)
    with ``long_context=True``: every layer a ring of 8192 slots, fed a
    24576-token prompt (three rings) by one prefill, then 32 greedy decode
    steps that read and wrap the rings; against its window-restricted twin
    on the same weights (LOCAL layers, window 8192, in full-length
    buffers): the prefill logits bit for bit; the twin's free-running
    tokens and, teacher-forced on the ring's tokens, its logits and argmax
    per step are printed beside the ring's top-2 logit gap, not asserted:
    the two decode the same keys in another order, which moves bf16
    logits by up to ~0.1, and bf16 logits tie exactly at some steps.  Then
    ``long_qwen3_f32``: the same at 8 layers in float32, where the tokens
    must be equal and every step's logits within 1e-3.  Prefill and decode
    times, tokens/s and peak memory printed."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params, prefill
    gc.collect()
    torch.cuda.empty_cache()

    def timed_prefill(path, params, cfg, tokens, caches, pe=None,
                      feed=None):
        _reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, caches, pos = prefill(params, cfg, tokens, caches, pe)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, steps = _decode_greedy(params, cfg, logits, caches, pos, 32,
                                     feed)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = _launch_counts()
        _finite_tokens(path, toks, steps[-1], cfg.vocab_size)
        r = {"next_pos": pos, "prefill_s": t1 - t0, "decode_s": t2 - t1,
             "decode_tokens_per_s": toks.shape[0] * 32 / (t2 - t1),
             "launches": counts, "tokens": toks.tolist(),
             "tokens_sha256": hashlib.sha256(json.dumps(
                 toks.tolist()).encode()).hexdigest()[:16],
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        res[path] = r
        log(f"[prefill] {path}: {cfg.num_layers} layers, B "
            f"{tokens.shape[0]}, next_pos {pos}, prefill "
            f"{r['prefill_s']:.3f}s, 32 decode steps {r['decode_s']:.3f}s "
            f"= {r['decode_tokens_per_s']:.1f} tokens/s, peak "
            f"{r['peak_mem_gb']:.1f} GiB, tokens sha256 "
            f"{r['tokens_sha256']}; launches {counts}")
        return steps, r

    cfg = get_config("llava-next-mistral-7b")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    P = cfg.num_prefix_embeds
    pe = torch.randn(2, P, cfg.d_model, generator=g, device="cuda").to(
        torch.bfloat16)
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 512)), device="cuda")
    caches = init_cache(cfg, 2, 4096, device="cuda")
    _, r = timed_prefill("prefill_llava", params, cfg, tokens, caches, pe)
    c = r["launches"]
    if r["next_pos"] != P + 512 or c["flash_attention"] != cfg.num_layers \
            or c["decode_attention"] != 32 * cfg.num_layers \
            or c["chunk_attention"] or c["chunk_attention/dense"]:
        raise AssertionError(f"prefill_llava: next_pos {r['next_pos']}, "
                             f"launches {c}")
    del params, caches, pe
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config("qwen3-14b")
    lcw = cfg.long_context_window
    n = 3 * lcw
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, n)), device="cuda")
    ring = init_cache(cfg, 1, n + 64, long_context=True, device="cuda")
    if ring[0][0]["k"].shape[2] != lcw:
        raise AssertionError(f"long_qwen3: a ring of "
                             f"{ring[0][0]['k'].shape[2]} slots")
    steps, r = timed_prefill("long_qwen3", params, cfg, tokens, ring)
    del ring
    gc.collect()
    torch.cuda.empty_cache()
    twin = cfg.replace(block_pattern=("local",), window=lcw)
    free, tr = timed_prefill("long_qwen3_twin", params, twin, tokens,
                             init_cache(cfg, 1, n + 64, device="cuda"))
    gc.collect()
    torch.cuda.empty_cache()
    feed = torch.tensor(r["tokens"])
    forced, _ = timed_prefill("long_qwen3_twin_forced", params, twin, tokens,
                              init_cache(cfg, 1, n + 64, device="cuda"),
                              feed=feed)
    errs = [max_err(a, b) for a, b in zip(steps, forced)]
    gaps = [float(x.topk(2, dim=-1).values.diff(dim=-1).abs().min())
            for x in steps]
    flips = [i for i, (a, b) in enumerate(zip(steps, forced))
             if not torch.equal(a.argmax(-1), b.argmax(-1))]
    same = next((i for i, (a, b) in enumerate(zip(r["tokens"][0],
                                                  tr["tokens"][0]))
                 if a != b), len(r["tokens"][0]))
    r["twin_logits_max_abs_err"], r["top2_gaps"] = errs, gaps
    r["teacher_forced_flips"], r["free_running_equal_prefix"] = flips, same
    log(f"[prefill] long_qwen3 against its window-{lcw} twin on full "
        f"buffers: free-running tokens equal for {same} of "
        f"{len(r['tokens'][0])}; teacher-forced with the ring's tokens, "
        f"per-step logits max |err| {[round(e, 4) for e in errs]}, argmax "
        f"differs at steps {flips}; the ring's top-2 logit gap per step "
        f"{[round(g, 4) for g in gaps]}")
    _same_bits("long_qwen3", steps[0], forced[0], "the twin's prefill logits")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the same comparison in float32 at 8 layers: the rings wrap as at full
    # depth, and a float32 model's logits move by ~1e-5 with the key order
    # of a reduction, far below any top-2 gap, so the tokens must be equal
    cfg = cfg.replace(num_layers=8, dtype="float32")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    f32 = torch.float32
    steps, r = timed_prefill("long_qwen3_f32", params, cfg, tokens,
                             init_cache(cfg, 1, n + 64, long_context=True,
                                        dtype=f32, device="cuda"))
    gc.collect()
    tsteps, tr = timed_prefill("long_qwen3_f32_twin", params,
                               cfg.replace(block_pattern=("local",),
                                           window=lcw), tokens,
                               init_cache(cfg, 1, n + 64, dtype=f32,
                                          device="cuda"))
    errs = [max_err(a, b) for a, b in zip(steps, tsteps)]
    r["twin_logits_max_abs_err"] = errs
    log(f"[prefill] long_qwen3_f32 (8 layers, float32) against its twin: "
        f"tokens equal {r['tokens'] == tr['tokens']}, per-step logits max "
        f"|err| {max(errs):.3g}")
    if r["tokens"] != tr["tokens"]:
        raise AssertionError("long_qwen3_f32: the ring's tokens differ from "
                             "the window-restricted twin's")
    for i, (a, b) in enumerate(zip(steps, tsteps)):
        if not torch.allclose(a, b, atol=1e-3, rtol=1e-3):
            raise AssertionError(f"long_qwen3_f32: step {i}'s logits differ "
                                 f"from the twin's by {errs[i]:.3g} > 1e-3")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 14: mixed_dtype ----------------------------------------------------------------

def phase_mixed_dtype(res):
    """Fault C2 end to end: bf16 models with ``cache_dtype="float32"``,
    greedy, each burst on the dense engine and on the paged engine with a
    dense-equivalent pool and no prefix cache (it never preempts); the
    paged tokens must equal the dense ones (decode and chunk keep fixed key
    spans, and the float32 past rounds to the same bf16 in both).
    ``mixed_dtype_dense`` / ``_paged``: qwen2-1.5b at full width and depth
    (max_batch 8, max_len 2048) serves the serve burst: dense decode casts
    the float32 rows, paged decode reads the float32 pool through its
    float32-past route.  qwen2's prompts never chunk there (a prompt is cut
    to max_len / 2, the largest bucket), so ``mixed_dtype_gemma2_dense`` /
    ``_paged``: gemma2-9b at full width and depth (max_batch 4, max_len
    16384) serves the long burst, whose prompts chunk into the 4096-slot
    rings through chunk_attention's float32 dense-row route and, on the
    paged engine, into the pooled full layers through its float32 chain
    route.  Tokens/s of each."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingEngine
    bf16_routes = ("paged_decode_attention", "chunk_attention",
                   "chunk_attention/dense")
    for arch, tag, ekw, burst in (
            ("qwen2-1.5b", "mixed_dtype", dict(max_batch=8, max_len=2048),
             _burst),
            ("gemma2-9b", "mixed_dtype_gemma2",
             dict(max_batch=4, max_len=16384), _long_burst)):
        cfg = get_config(arch)
        params = init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
        chunks = arch == "gemma2-9b"
        for paged in (False, True):
            path = f"{tag}_paged" if paged else f"{tag}_dense"
            eng = ServingEngine(cfg, params=params, ecfg=EngineConfig(
                governor="greenllm", cache_dtype="float32", paged=paged,
                **ekw), device="cuda")
            need = ["rmsnorm", "add_rmsnorm"]
            if paged:
                need += ["paged_decode_attention/f32_past"]
                need += ["chunk_attention/f32_past", "decode_attention",
                         "chunk_attention/dense_f32_past"] * chunks
                need += ["flash_attention"] * (not chunks)
            else:
                need += ["decode_attention"]
                need += (["chunk_attention/dense_f32_past"] if chunks
                         else ["flash_attention"])
            r = _arch_burst(res, path, cfg, eng, burst, need,
                            bf16_routes + ("decode_attention",)
                            * (paged and not chunks))
            if r["preempted"]:
                raise AssertionError(f"{path}: preempted {r['preempted']}")
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        a, b = res[f"{tag}_dense"], res[f"{tag}_paged"]
        log(f"[mixed_dtype] {arch} float32 caches under bf16: dense "
            f"{a['tokens_sha256']} ({a['tokens_per_s']:.1f} tokens/s), paged "
            f"{b['tokens_sha256']} ({b['tokens_per_s']:.1f} tokens/s)")
        if a["tokens_sha256"] != b["tokens_sha256"]:
            diff = [i for i, (x, y) in enumerate(zip(a["tokens"],
                                                     b["tokens"])) if x != y]
            raise AssertionError(f"{tag}: paged and dense engines differ on "
                                 f"requests {diff}")
        del params
        gc.collect()
        torch.cuda.empty_cache()


# -- phase 15: controller ---------------------------------------------------------------

# the fleet: tbt_slo x up_margin x down_margin x telemetry traces, 20 ms ticks
CTL_FLEET = (16, 4, 4, 16)
CTL_TICKS = 3000
# the seed of the controller phase's telemetry (``--seed``)
SEED = 0


def _ctl_inputs(seed):
    """The controller phase's fleet as numpy: qwen3-14b's decode table
    (profiled on the port's plant), each controller's (tbt_slo, up_margin,
    down_margin) and its telemetry (tokens and p95 TBT per tick).  A trace
    holds a TPS level for 0.5-3 s, the levels drawn over 0-125% of the
    table's top bucket, so the fleet crosses every bucket; the p95 grows
    with the load around 30-150 ms with 5% empty windows (0: no sample)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import A100_SXM4_40G as HW
    from repro_torch.sim import PlantModel, profile_decode_table
    table = profile_decode_table(PlantModel(
        cfg=get_config("qwen3-14b"), hw=HW, n_chips=1, seed=seed))
    n_slo, n_up, n_down, n_tr = CTL_FLEET
    grid = np.stack(np.meshgrid(np.linspace(0.04, 0.2, n_slo),
                                np.linspace(0.9, 1.2, n_up),
                                np.linspace(0.5, 0.8, n_down),
                                np.arange(n_tr), indexing="ij"),
                    -1).reshape(-1, 4)
    rng = np.random.default_rng(seed)
    top = 1.25 * float(table.tps_grid[-1])
    tps = np.empty((n_tr, CTL_TICKS))
    for i in range(n_tr):
        t = 0
        while t < CTL_TICKS:
            n = int(rng.integers(25, 151))
            tps[i, t:t + n] = rng.uniform(0.0, top)
            t += n
    tokens = rng.poisson(tps * 0.020).astype(np.float64)
    p95 = 0.1 * (0.3 + 1.2 * tps / top) * rng.lognormal(0.0, 0.15, tps.shape)
    p95[rng.random(tps.shape) < 0.05] = 0.0
    idx = grid[:, 3].astype(int)
    return (HW, table, grid[:, 0], grid[:, 1], grid[:, 2], tokens[idx],
            p95[idx])


def phase_controller(res):
    """The batched dual-loop controller (``core/controller_torch.py``) on
    the card: 4096 controllers (16 SLOs x 4 up margins x 4 down margins x
    16 seeded telemetry traces) over 3000 ticks of 20 ms, held bit for bit
    (every tick's frequency and every field of the final state) to the
    same sweep on the CPU.  Prints the wall time, controller-ticks per
    second, the peak memory and the PyTorch operators per tick (each a
    launch on the card whatever the fleet size)."""
    import numpy as np
    import torch
    from repro_torch.core import controller_torch as C
    hw, table, slo, up, down, tokens, p95 = _ctl_inputs(SEED)
    n, T = tokens.shape

    def params(device):
        return C.make_params(hw, table, tbt_slo=slo, device=device)._replace(
            up_margin=torch.as_tensor(up, dtype=torch.float32, device=device),
            down_margin=torch.as_tensor(down, dtype=torch.float32,
                                        device=device))

    t0 = time.perf_counter()
    cpu_state, cpu_freqs = C.simulate(params("cpu"), tokens, p95)
    cpu_wall = time.perf_counter() - t0
    p = params("cuda")
    tok, q = (torch.as_tensor(x, dtype=torch.float32, device="cuda")
              for x in (tokens, p95))
    C.simulate(p, tok[:, :20], q[:, :20])                     # warm-up
    fleet = C.broadcast_params(p, (n,))
    s0 = C.init_state(fleet)
    n_ops, by_op = _op_count(lambda: C.controller_step(fleet, s0, tok[:, 0],
                                                       q[:, 0]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state, freqs = C.simulate(p, tok, q)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_mem
    same = torch.equal(freqs.cpu(), cpu_freqs) and all(
        torch.equal(a.cpu(), b) for a, b in zip(state, cpu_state))
    f = cpu_freqs.numpy()
    buckets = np.unique(cpu_state.bucket.numpy())
    res["controller"] = {
        "controllers": n, "ticks": T, "wall_ms": wall * 1e3,
        "cpu_wall_ms": cpu_wall * 1e3,
        "controller_ticks_per_s": n * T / wall,
        "peak_mem_mb": peak / 2 ** 20, "ops_per_tick": n_ops,
        "ops_by_name": dict(by_op), "bitwise_cuda_eq_cpu": same,
        "final_buckets": buckets.tolist(),
        "distinct_freqs": int(np.unique(f).size)}
    log(f"[controller] {n} controllers x {T} ticks on the card in "
        f"{wall * 1e3:.1f} ms = {n * T / wall:.4g} controller-ticks/s "
        f"({T / wall:.0f} ticks/s, {n_ops} PyTorch operators a tick); "
        f"peak memory above the inputs {peak / 2 ** 20:.1f} MiB; the CPU's "
        f"run {cpu_wall * 1e3:.1f} ms; CUDA == CPU bitwise: {same}; final "
        f"buckets {buckets.tolist()}, {np.unique(f).size} distinct clocks")
    if not same:
        raise AssertionError("controller: the card's sweep differs from the "
                             "CPU's")
    if f.min() < hw.f_min or f.max() > hw.f_max or len(buckets) < 2:
        raise AssertionError(f"controller: clocks {f.min()}-{f.max()} MHz, "
                             f"final buckets {buckets.tolist()}")


# -- phase 16: replay -------------------------------------------------------------------

# the example's flags in the replay phase (its defaults otherwise)
REPLAY_ARGS = ("--duration", "30", "--cluster", "--prefix-cache",
               "--kill-replica", "decode0", "--handoff-failures", "3")
# qwen3-14b's depth in the replay phase's full-width cluster run (the dense
# burst runs all 40): at 40 layers its two runs took 49-69 s and the phase
# 69-97 s, which left the default run 790 s of its 800 on a slow host; at
# 20, 38.8-48.7 s, in a default run that reached 1285 s of its 1200
REPLAY_CLUSTER_LAYERS = 10


def _check_cluster_run(path, cl, rep, base, failures):
    """``run_cluster``'s result: every request of both runs completed, the
    kill fired on decode0 with streams on it that were recovered, the
    failed imports retried, and the replicas' energy sums to the total."""
    kills = cl.tracer.spans("replica_kill")
    victims = sum(k.attrs["victims"] for k in kills)
    e_sum = sum(r.energy_j for r in rep.replicas)
    log(f"[replay] {path}: completed {rep.completed}/{rep.n_requests} "
        f"(baseline {base.completed}), migrated {rep.migrated}, kills "
        f"{[(n, round(t, 4)) for n, t, _ in cl.kills]} with {victims} "
        f"streams recovered, import retries {cl.import_retries}, replica "
        f"energy {e_sum:.6f} J of {rep.total_energy_j:.6f} J")
    if not rep.completed == base.completed == rep.n_requests:
        raise AssertionError(f"{path}: {rep.completed}/{rep.n_requests} "
                             f"completed, baseline {base.completed}")
    if [k for k, _, _ in cl.kills] != ["decode0"] or victims < 1:
        raise AssertionError(f"{path}: kills {cl.kills}, victims {victims}")
    if cl.import_retries < failures:
        raise AssertionError(f"{path}: {cl.import_retries} import retries "
                             f"for {failures} failures")
    if abs(e_sum - rep.total_energy_j) > 1e-6 * max(rep.total_energy_j, 1):
        raise AssertionError(f"{path}: replica energy {e_sum} != "
                             f"{rep.total_energy_j}")
    return {"completed": rep.completed, "migrated": rep.migrated,
            "victims": victims, "import_retries": cl.import_retries,
            "kills": cl.kills, "energy_j": rep.total_energy_j,
            "baseline_energy_j": base.total_energy_j}


def phase_replay(res):
    """The trace-replay example (``repro_torch.examples.serve_trace_replay``)
    on the card.  ``replay_example``: its main at ``REPLAY_ARGS`` (qwen3-14b's
    plant; the governor table from the simulator, then the real-execution
    bursts on qwen3-14b's ``.smoke()`` model: dense, paged at half the K/V
    memory, prefix cache cold against warm, the cluster with decode0
    killed and 3 imports failed).  The example asserts warm == cold tokens,
    the kill and the retries; here every burst must complete, killed
    streams be recovered and the replicas' energy sum to the total.  Then
    the dense burst (``replay_qwen3_dense``, 40 layers) and ``run_cluster``
    (``replay_qwen3_cluster``, the same faults, ``REPLAY_CLUSTER_LAYERS``
    layers on the 40-layer plant) with qwen3-14b itself at full width in
    bf16.  Launch counts per path."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import get_trace
    from repro_torch.core import SamplingParams
    from repro_torch.examples import serve_trace_replay as S
    from repro_torch.models import init_cache, init_params, prefill
    from repro_torch.serving import EngineConfig, Server, ServingEngine
    failures = int(REPLAY_ARGS[REPLAY_ARGS.index("--handoff-failures") + 1])

    path = "replay_example"
    _reset_counts()
    t0 = time.perf_counter()
    out = S.main(["--device", "cuda", *REPLAY_ARGS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    table = {g: dataclasses.asdict(m) for g, m in out["governors"].items()}
    base_j = out["governors"]["defaultNV"].total_energy_j
    log("[replay] governor table (simulator, qwen3-14b plant, chat_5qps "
        f"{REPLAY_ARGS[1]} s): " + "; ".join(
            f"{g} TTFT {m.ttft_pass * 100:.1f}% TBT {m.tbt_pass * 100:.1f}% "
            f"E {m.total_energy_j / 1e3:.3f} kJ "
            f"(dE {100 * (1 - m.total_energy_j / base_j):.2f}%)"
            for g, m in out["governors"].items()))
    cold, warm = out["prefix"]
    for name, rep in (("burst", out["burst"]), ("paged", out["paged"]),
                      ("cold", cold), ("warm", warm)):
        if rep.completed != rep.n_requests:
            raise AssertionError(f"{path}: {name} burst "
                                 f"{rep.completed}/{rep.n_requests}")
    if warm.prefill_tokens >= cold.prefill_tokens:
        raise AssertionError(f"{path}: warm prefill {warm.prefill_tokens} "
                             f">= cold {cold.prefill_tokens}")
    res[path] = {"wall_s": wall, "launches": counts, "governors": table,
                 "cluster": _check_cluster_run(path, *out["cluster"],
                                               failures),
                 "prefix_tokens": (cold.prefill_tokens, warm.prefill_tokens)}
    log(f"[replay] {path}: {wall:.1f}s wall; launches {counts}")
    _check_launched(path, counts, ("rmsnorm", "add_rmsnorm",
                                   "decode_attention", "flash_attention",
                                   "paged_decode_attention",
                                   "chunk_attention"))
    del out
    gc.collect()

    # fault C3: a float32 model over bf16 pages (the engine's default cache
    # dtype) widens its past before paged decode and chunk_attention, which
    # take no bf16 past under a float32 q.  The example's prefix burst over
    # bf16 pages, on the example's own weights (drawn on the card), cold
    # and warm on each device: the tokens equal the CPU's.  Warm against
    # cold is printed with each first flip's top-2 logit gap (float32,
    # one-shot prefill on the CPU): a hit reads bf16-rounded K/V where the
    # cold run attends to float32 ones, so a near tie may flip
    path = "replay_c3"
    cfg = get_config("qwen3-14b")
    pc_cfg = cfg.smoke().replace(dtype="float32")
    cpu_params = _to(init_params(torch.Generator(device="cuda").manual_seed(0),
                                 pc_cfg), "cpu")
    toks = {}
    for dev, on in (("cpu", False), ("cpu", True), ("cuda", False),
                    ("cuda", True)):
        if dev == "cuda" and on:
            _reset_counts()
        eng = ServingEngine(pc_cfg, _to(cpu_params, dev), plant_cfg=cfg,
                            ecfg=EngineConfig(max_batch=8, max_len=192,
                                              paged=True, prefix_cache=on),
                            device=dev)
        srv = Server(eng)
        prng = np.random.default_rng(7)           # the example's prompts
        head = prng.integers(0, pc_cfg.vocab_size, size=80)
        for _ in range(12):
            tail = prng.integers(0, pc_cfg.vocab_size,
                                 size=int(prng.integers(4, 16)))
            srv.submit(np.concatenate([head, tail]),
                       SamplingParams(max_tokens=16))
        rep = srv.run()
        toks[dev, on] = [list(map(int, q.tokens)) for q in eng.requests]
        if rep.completed != rep.n_requests:
            raise AssertionError(f"{path}: {dev} {rep.completed}/"
                                 f"{rep.n_requests}")
    torch.cuda.synchronize()
    counts = _launch_counts()
    hits = eng.prefix_cache.stats()["hits"]
    same = {on: toks["cuda", on] == toks["cpu", on] for on in (False, True)}
    flips = []
    for i, (c, w) in enumerate(zip(toks["cpu", False], toks["cpu", True])):
        j = next((j for j, (a, b) in enumerate(zip(c, w)) if a != b), None)
        if j is None:
            continue
        ids = torch.as_tensor(np.concatenate([eng.requests[i].prompt,
                                              c[:j]]))[None]
        logits = prefill(cpu_params, pc_cfg, ids, init_cache(
            pc_cfg, 1, ids.shape[1], dtype=torch.float32, device="cpu"))[0]
        top = torch.topk(logits[0], 2).values
        flips.append({"request": i, "token": j, "cold": c[j], "warm": w[j],
                      "top2_gap": float(top[0] - top[1])})
    res[path] = {"launches": counts, "cuda_eq_cpu": same, "hits": hits,
                 "flips": flips}
    log(f"[replay] {path}: float32 model over bf16 pages, cold and warm "
        f"(hits {hits}): CUDA == CPU {same}; warm != cold at {flips}; "
        f"launches {counts}")
    if not all(same.values()) or not hits:
        raise AssertionError(f"{path}: CUDA == CPU {same}, hits {hits}")
    _check_launched(path, counts, ("rmsnorm", "add_rmsnorm",
                                   "paged_decode_attention",
                                   "chunk_attention"))

    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    path = "replay_qwen3_dense"
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles, rep = S.dense_burst(cfg, cfg, device="cuda", params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    if rep.completed != len(handles):
        raise AssertionError(f"{path}: {rep.completed}/{len(handles)}")
    _check_outputs(handles, cfg.vocab_size)
    toks = sum(len(h.request.tokens) for h in handles)
    res[path] = {"wall_s": wall, "launches": counts, "tokens_out": toks,
                 "tokens_per_s": toks / wall, "layers": cfg.num_layers,
                 "tokens_sha256": _tokens_digest(handles)}
    log(f"[replay] {path}: {cfg.name} {cfg.num_layers} layers bf16, "
        f"{len(handles)} requests, {toks} tokens in {wall:.2f}s wall = "
        f"{toks / wall:.1f} tokens/s; tokens sha256 "
        f"{res[path]['tokens_sha256']}; launches {counts}")
    _check_launched(path, counts, ("rmsnorm", "add_rmsnorm",
                                   "decode_attention", "flash_attention"))

    path = "replay_qwen3_cluster"
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ccfg = cfg.replace(num_layers=REPLAY_CLUSTER_LAYERS)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), ccfg)
    trace = get_trace("azure_code8", duration=float(REPLAY_ARGS[1]))[:16]
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cl, rep, base = S.run_cluster(cfg, ccfg, trace, kill_replica="decode0",
                                  handoff_failures=failures, device="cuda",
                                  params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    res[path] = {"wall_s": wall, "launches": counts,
                 "layers": ccfg.num_layers,
                 **_check_cluster_run(path, cl, rep, base, failures)}
    log(f"[replay] {path}: {cfg.name} {ccfg.num_layers} of "
        f"{cfg.num_layers} layers bf16 ({cfg.num_layers}-layer plant), "
        f"{wall:.2f}s wall (baseline and faulted runs); launches {counts}")
    _check_launched(path, counts, ("rmsnorm", "add_rmsnorm",
                                   "paged_decode_attention",
                                   "flash_attention", "chunk_attention"))
    del cl, params
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 17: train ---------------------------------------------------------------

TRAIN_QWEN2 = (4, 2048, 10)          # batch, sequence, AdamW steps
TRAIN_MESH = (4, 2048, 3)            # batch, sequence, steps per run
# the dry-run's records: (arch, strategy), each traced on fake CUDA and
# fake CPU tensors
DRYRUN_RUNS = (("qwen2-1.5b", "tp"), ("qwen2-1.5b", "fsdp"),
               ("mixtral-8x7b", "tp"))
DRYRUN_TIMEOUT_S = 900
TRAIN_GEMMA2 = (4, 1, 5120, 3)       # layers, batch, sequence, steps
TRAIN_ARCH_S = 96                    # past the smoke window of 64
TRAIN_ARCH_OPT = dict(lr=1e-2, warmup_steps=0)   # first update ~1e-2
TRAIN_ARCH_TOL = 1e-5                # atol of the step's update (see there)


def _tree_bytes(tree, per_elem=None):
    from repro_torch.training.pytree import leaves
    return sum(t.numel() * (per_elem or t.element_size())
               for t in leaves(tree))


def _train_steps(res, path, cfg, batch, steps, opt_cfg, seed):
    """``steps`` AdamW steps of ``make_train_step`` on one fixed batch from
    fresh random weights, every count set to 0 just before the first step
    and read after it (one step's launches) and after the last (the
    path's).  Earlier phases' garbage is collected first, so the peak is
    this path's; ``base_gib`` is what was still allocated then.  Returns
    (state, result)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.training import init_train_state, make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(seed),
                             cfg)
    step_fn = make_train_step(cfg, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, ms = [], [], []
    _reset_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if i == 0:
            per_step = _launch_counts()
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    params = state["params"]
    p_bytes = _tree_bytes(params)
    # params, their gradients (the params' dtype), AdamW's m and v (float32)
    state_bytes = 2 * p_bytes + 2 * _tree_bytes(params, 4)
    tokens = batch["tokens"].numel()
    step_ms = statistics.median(ms[1:]) if steps > 1 else ms[0]
    out = {"losses": losses, "grad_norms": gnorms, "step_ms": ms,
           "median_step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
           "peak_gib": peak / 2 ** 30, "base_gib": base / 2 ** 30,
           "params_grads_opt_gib": state_bytes / 2 ** 30,
           "launches_per_step": per_step, "launches": counts}
    log(f"[{path}] {cfg.name} {cfg.num_layers} layers {cfg.dtype}, batch "
        f"{tuple(batch['tokens'].shape)}: losses {losses}, grad norms "
        f"{gnorms}; step ms {[round(x, 1) for x in ms]} (median after the "
        f"first {step_ms:.1f}), {out['tokens_per_s']:.0f} tokens/s; peak "
        f"{out['peak_gib']:.2f} GiB (of which {out['base_gib']:.2f} resident "
        f"before) against params + grads + m + v "
        f"{out['params_grads_opt_gib']:.2f} GiB; launches a step "
        f"{ {k: v for k, v in per_step.items() if v} }")
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(gnorms))):
        raise AssertionError(f"{path}: a loss or grad norm is not finite")
    if any(counts[k] != steps * per_step[k] for k in counts):
        raise AssertionError(f"{path}: launches {counts} are not {steps} x "
                             f"one step's {per_step}")
    res[path] = out
    return state, out


# a train step's kernels by family: a substring of the kernel's name
# (cuBLAS's GEMMs and the port's kernels), then, for the rest, the
# enclosing range: the norms' autograd nodes (a fill or cast of their
# backward), AdamW (``adamw_update``), the cross-entropy (``_ce_block``,
# forward and the checkpoint's recompute, and the autograd nodes of its
# logsumexp and gather), everything else elementwise
TRAIN_FAMILIES = (
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("flash forward", ("flash_kernel",)),
    ("flash backward", ("delta_kernel", "dkdv_kernel", "dq_kernel",
                        "tc::reduce_kernel")),
    ("norm forward", ("rmsnorm_kernel", "add_norm_kernel")),
    ("norm backward", ("norm_bwd", "dw_sum_kernel")))
TRAIN_RANGES = (("norm backward", ("RMSNormFnBackward",)),
                ("AdamW", ("adamw_update",)),
                ("CE", ("ce_block", "LogsumexpBackward0", "GatherBackward0")))


def _profiled_step(path, cfg, opt_cfg, state, batch):
    """One more step of ``make_train_step`` under ``torch.profiler`` (CPU
    and CUDA activity), ``adamw_update`` and ``_ce_block`` wrapped in
    ranges for it: the step's wall ms, the device's busy time (the union
    of its events' intervals) and idle share, its device ms by family
    (TRAIN_FAMILIES, TRAIN_RANGES; a kernel no CPU op lists is
    "unattributed") and its largest kernels.  Returns (state, the
    profile)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import transformer
    from repro_torch.training import make_train_step, train_loop

    def ranged(fn, name):
        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapped
    ranges = ("adamw_update", "ce_block")
    saved = train_loop.adamw_update, transformer._ce_block
    train_loop.adamw_update = ranged(saved[0], ranges[0])
    transformer._ce_block = ranged(saved[1], ranges[1])
    try:
        step_fn = make_train_step(cfg, opt_cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        train_loop.adamw_update, transformer._ce_block = saved
    # every device event once (not the ranges' own spans on the device's
    # timeline): the CPU ops list the kernels they launched, by name and
    # duration; where the profiler lists one kernel under two ops, the
    # first op in time takes it and the time listed twice is logged as
    # "ambiguous"
    events = prof.events()
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and e.name not in ranges
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    busy, end = 0.0, -math.inf
    for e in dev:
        busy += max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
    busy /= 1e3
    if busy <= 0:
        raise AssertionError(f"{path}: the profiler recorded no device time")
    avail = {}
    for e in dev:
        key = (e.name, e.time_range.end - e.time_range.start)
        avail[key] = avail.get(key, 0) + 1
    fams = {f: 0.0 for f, _ in TRAIN_FAMILIES + TRAIN_RANGES}
    fams["other elementwise"] = fams["unattributed"] = 0.0
    by_kernel, twice = {}, [0.0]

    def add(fam, name, us):
        fams[fam] += us / 1e3
        by_kernel[fam, name[:80]] = by_kernel.get((fam, name[:80]), 0.0) \
            + us / 1e3

    def named(name):
        return next((f for f, keys in TRAIN_FAMILIES
                     if any(key in name for key in keys)), None)

    def walk(e, ctx):
        ctx = ctx + (e.name,)
        # the op's kernels (not its own device time, named as the op)
        for k in e.kernels:
            key = (k.name, k.duration)
            if k.name == e.name:
                continue
            if not avail.get(key):
                twice[0] += k.duration / 1e3
                continue
            avail[key] -= 1
            add(named(k.name) or next(
                (f for f, keys in TRAIN_RANGES
                 if any(r in c for c in ctx for r in keys)),
                "other elementwise"), k.name, k.duration)
        for c in e.cpu_children:
            walk(c, ctx)
    for e in events:
        if e.device_type == DeviceType.CPU and e.cpu_parent is None:
            walk(e, ())
    for (name, us), n in avail.items():
        for _ in range(n):
            add(named(name) or "unattributed", name, us)
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy,
           "idle_share": 1 - busy / (wall * 1e3), "family_ms": fams,
           "ambiguous_ms": twice[0]}
    log(f"[{path}] profiled step: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy:.1f} ms (idle {100 * out['idle_share']:.1f}%); kernel time "
        f"listed under two ops {twice[0]:.2f} ms (ambiguous)")
    for f, ms in fams.items():
        log(f"[{path}]   {f}: {ms:.2f} ms = {100 * ms / busy:.1f}% of busy")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    out["top_ms"] = {f"{f}: {n}": ms for (f, n), ms in top}
    for (f, n), ms in top:
        log(f"[{path}]   top {ms:8.2f} ms  {f}: {n}")
    return state, out


def _train_qwen2(res):
    """qwen2-1.5b at full width and depth in bf16, B 4 x S 2048, remat on,
    the cross-entropy in chunks of 1024: 10 AdamW steps (lr 1e-3, warmup
    2) on one fixed batch; the loss must fall below 0.9x its first value.
    With remat each layer's flash forward runs twice (forward and
    recompute) and its backward once; every norm forward runs twice but
    the final norm's (outside the checkpoints), every norm backward once,
    with the sum's gradient ds but for layer 0's pre-norm and the final
    norm.  Then one more step under the profiler (``_profiled_step``) and
    its params through ``save_checkpoint`` / ``load_checkpoint``, bit for
    bit."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.training import (AdamWConfig, load_checkpoint,
                                      save_checkpoint)
    from repro_torch.training.pytree import leaves
    B, S, steps = TRAIN_QWEN2
    cfg = get_config("qwen2-1.5b")
    g = torch.Generator(device="cuda").manual_seed(11)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device="cuda", dtype=torch.int32)}
    import gc
    import os
    state, out = _train_steps(
        res, "train_qwen2", cfg, batch, steps,
        AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps), seed=0)
    L = cfg.num_layers
    want = {"flash_attention/lse": 2 * L, "flash_attention_bwd": L,
            "rmsnorm": 2, "add_rmsnorm": 4 * L - 1, "rmsnorm_bwd": 2,
            "rmsnorm_bwd/ds": 2 * L - 1}
    per_step = out["launches_per_step"]
    got = {k: v for k, v in per_step.items() if v}
    if got != want:
        raise AssertionError(f"train_qwen2: launches a step {got}, want "
                             f"{want}")
    if not out["losses"][-1] < 0.9 * out["losses"][0]:
        raise AssertionError(f"train_qwen2: loss {out['losses']} did not "
                             "fall below 0.9x its first value")
    state, out["profile"] = _profiled_step(
        "train_qwen2", cfg,
        AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps), state, batch)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        path = os.path.join(d, "qwen2.msgpack")
        save_checkpoint(path, state["params"])
        size = os.path.getsize(path)
        back = load_checkpoint(path, state["params"])
    for a, b in zip(leaves(state["params"]), leaves(back)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError("train_qwen2: checkpoint round trip is not "
                                 "bitwise")
    out["checkpoint"] = {"bytes": size, "s": time.perf_counter() - t0}
    log(f"[train_qwen2] checkpoint round trip bitwise: {size} bytes in "
        f"{out['checkpoint']['s']:.1f}s")
    del state, back
    gc.collect()
    torch.cuda.empty_cache()


def _train_gemma2(res):
    """gemma2-9b at full width, 4 layers (local, full, local, full), bf16,
    B 1 x S 5120: the local layers' 4096 window masks; hd 256, the
    attention and final softcaps, sandwich norms.  3 steps, the loss
    finite and falling."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.training import AdamWConfig
    import gc
    layers, B, S, steps = TRAIN_GEMMA2
    cfg = get_config("gemma2-9b").replace(num_layers=layers)
    g = torch.Generator(device="cuda").manual_seed(12)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device="cuda", dtype=torch.int32)}
    state, out = _train_steps(
        res, "train_gemma2", cfg, batch, steps,
        AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps), seed=0)
    _check_launched("train_gemma2", out["launches"],
                    ("flash_attention/lse", "flash_attention_bwd", "rmsnorm",
                     "add_rmsnorm", "rmsnorm_bwd", "rmsnorm_bwd/ds"))
    if not out["losses"][-1] < out["losses"][0]:
        raise AssertionError(f"train_gemma2: loss {out['losses']} did not "
                             "fall")
    del state
    gc.collect()
    torch.cuda.empty_cache()


def _train_arch(res):
    """Every architecture's ``.smoke()`` in float32 at S 96 (B 2, prefix
    embeddings where the model takes them): the loss, every gradient leaf
    and one ``make_train_step`` step (TRAIN_ARCH_OPT: lr 1e-2, no warmup)
    on CUDA against the CPU from the same weights and batch.  Loss and
    grad norm within rtol 1e-4; each gradient within lim = 1e-5 + 1e-3 x
    its leaf's largest |value| (summation order).  The step's m and v
    within what that gradient tolerance allows (m = 0.1 s g and v = 0.05
    (s g)^2 after one step, s the clip scale); its update (new - old
    params, about lr x sign(g) = 1e-2 per element) within TRAIN_ARCH_TOL on
    every element whose CPU gradient is over 2 lim with s |g| >= 1e-5 (no
    sign can turn, and Adam's eps 1e-8 moves the update by < 5e-6), or
    zero on both devices; at least 80% of the elements are so held."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import loss_fn
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)
    from repro_torch.training.pytree import leaves, unflatten
    rows = {}
    _reset_counts()
    for arch in ARCH_IDS:
        cfg = get_config(arch).smoke().replace(dtype="float32")
        cpu = init_train_state(torch.Generator().manual_seed(5), cfg)
        old = [p.clone() for p in leaves(cpu["params"])]
        rng = np.random.default_rng(6)
        nb = {"tokens": rng.integers(0, cfg.vocab_size, (2, TRAIN_ARCH_S))
              .astype(np.int32)}
        if cfg.num_prefix_embeds:
            nb["prefix_embeds"] = rng.standard_normal(
                (2, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
        got = {}
        for dev in ("cuda", "cpu"):
            state = _to(cpu, dev)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
            flat = [p.detach().requires_grad_(True)
                    for p in leaves(state["params"])]
            loss, _ = loss_fn(unflatten(state["params"], flat), cfg, batch,
                              ce_chunk=40)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            new, m = make_train_step(cfg, AdamWConfig(**TRAIN_ARCH_OPT))(
                state, batch)
            got[dev] = (float(loss.detach()), [None if x is None else x.cpu()
                                               for x in grads],
                        float(m["grad_norm"]),
                        [[x.cpu() for x in leaves(t)] for t in
                         (new["params"], new["opt"]["m"], new["opt"]["v"])])
        (lc, gc_, nc, sc), (lh, gh, nh, sh) = got["cuda"], got["cpu"]
        s = min(1.0, 1.0 / (nh + 1e-9))
        gerr = merr = verr = uerr = 0.0
        held = total = 0
        for i, (a, b) in enumerate(zip(gc_, gh)):
            if (a is None) != (b is None):
                raise AssertionError(f"train_arch {arch}: a gradient is "
                                     "missing on one device")
            p0, (pc, mc, vc), (ph, mh, vh) = old[i], \
                [x[i] for x in sc], [x[i] for x in sh]
            if a is None or not a.numel():
                continue
            gmax = float(b.abs().max())
            lim = 1e-5 + 1e-3 * gmax
            gerr = max(gerr, float((a - b).abs().max()) / lim)
            mlim = 0.1 * s * 1.1 * lim
            vlim = 0.05 * s * s * (2 * gmax + 1.1 * lim) * 1.1 * lim
            merr = max(merr, float((mc - mh).abs().max()) / mlim)
            verr = max(verr, float((vc - vh).abs().max()) / vlim)
            keep = ((b.abs() > 2 * lim) & (s * b.abs() >= 1e-5)) \
                | ((a == 0) & (b == 0))
            if keep.any():
                uerr = max(uerr, float(((pc - p0) - (ph - p0))[keep]
                                       .abs().max()))
            held += int(keep.sum())
            total += keep.numel()
        row = {"loss_cuda": lc, "loss_cpu": lh, "grad_norm_cuda": nc,
               "grad_norm_cpu": nh, "grad_err_share": gerr,
               "m_err_share": merr, "v_err_share": verr,
               "update_max_err": uerr, "update_held_share": held / total}
        log(f"[train_arch] {arch}: {row}")
        if abs(lc - lh) > 1e-4 * abs(lh) or abs(nc - nh) > 1e-4 * abs(nh) \
                or max(gerr, merr, verr) > 1 or uerr > TRAIN_ARCH_TOL \
                or held < 0.8 * total:
            raise AssertionError(f"train_arch {arch}: CUDA and CPU differ: "
                                 f"{row}")
        rows[arch] = row
    counts = _launch_counts()
    _check_launched("train_arch", counts,
                    ("flash_attention/lse", "flash_attention_bwd", "rmsnorm",
                     "add_rmsnorm", "rmsnorm_bwd", "rmsnorm_bwd/ds"))
    res["train_arch"] = {"archs": rows, "launches": counts}


def phase_train(res):
    """Training on the card (``src/repro_torch/training``): ``_train_qwen2``
    (full width and depth, launch counts asserted, checkpoint round trip),
    ``_train_gemma2`` (full width, 4 layers, window and softcaps) and
    ``_train_arch`` (every arch's smoke step, CUDA against CPU)."""
    _train_qwen2(res)
    _train_gemma2(res)
    _train_arch(res)


def _mesh_burst(server, vocab, shared):
    """4 greedy requests, 100-400-token prompts (after a ``shared`` system
    prompt, when given), 32-64 new tokens, served to completion."""
    import numpy as np
    from repro_torch.core import SamplingParams
    rng = np.random.default_rng(5)
    lens = np.linspace(100, 400, 4).astype(int)
    rng.shuffle(lens)
    handles = [server.submit(
        np.concatenate([shared, rng.integers(0, vocab, size=int(n))]),
        SamplingParams(max_tokens=int(rng.integers(32, 65)))) for n in lens]
    return handles, server.run()


def _mesh_run(cfg, params, ecfg):
    """One burst through a fresh engine: its digest (tokens, report
    floats, energy, host drains, prefix-cache stats, launch counts) and
    tokens/s."""
    import numpy as np
    import torch
    from repro_torch.serving import Server, ServingEngine
    eng = ServingEngine(cfg, params=params, ecfg=ecfg, seed=0,
                        device="cuda")
    shared = np.random.default_rng(6).integers(0, cfg.vocab_size, size=128) \
        if ecfg.prefix_cache else np.zeros(0, np.int64)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles, rep = _mesh_burst(Server(eng), cfg.vocab_size, shared)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    _check_outputs(handles, cfg.vocab_size)
    out_toks = sum(len(h.request.tokens) for h in handles)
    digest = {
        "tokens": [list(map(int, h.request.tokens)) for h in handles],
        "report": {f.name: repr(getattr(rep, f.name))   # NaN == NaN
                   for f in dataclasses.fields(rep)
                   if isinstance(getattr(rep, f.name), (int, float))},
        "energy_j": repr(eng.energy_j), "host_drains": eng._host_drains,
        "prefix_cache": eng.prefix_cache.stats()
        if eng.prefix_cache is not None else None,
        "launches": counts}
    del eng
    torch.cuda.empty_cache()
    return digest, out_toks / wall, _tokens_digest(handles)


def phase_mesh(res):
    """The (1,1) serving mesh on a world-size-1 NCCL group against
    mesh=None, dense and paged with the prefix cache: every digest field
    bitwise equal (see phase 18 in the module docstring)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_single_rank, shutdown
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig
    cfg = get_config("qwen2-1.5b")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    init_single_rank("cuda")
    try:
        for path, kw, need in (
                ("mesh_dense", {}, ("rmsnorm", "add_rmsnorm",
                                    "decode_attention", "flash_attention")),
                ("mesh_paged", dict(paged=True, page_size=16,
                                    num_pages=160, prefix_cache=True),
                 ("rmsnorm", "add_rmsnorm", "paged_decode_attention",
                  "flash_attention", "chunk_attention"))):
            runs = []
            # a warm-up run, then None, (1,1), (1,1), None: tokens/s of a
            # pair taken in turns, after the first run's one-time costs
            for mesh in (None, None, (1, 1), (1, 1), None):
                ecfg = EngineConfig(max_batch=8, max_len=2048,
                                    governor="greenllm", mesh=mesh, **kw)
                runs.append((mesh, *_mesh_run(cfg, params, ecfg)))
            _, base, _, sha = runs[0]
            for mesh, got, _, got_sha in runs[1:]:
                for key in base:
                    if got[key] != base[key]:
                        raise AssertionError(
                            f"{path}: mesh={mesh} differs from the first "
                            f"mesh=None run in {key}: {got[key]} != "
                            f"{base[key]}")
            tps = [t for m, _, t, _ in runs[1:] if m is not None]
            base_tps = [t for m, _, t, _ in runs[1:] if m is None]
            got = runs[-2][1]
            log(f"[{path}] tokens sha256 {sha}, the same in all 5 runs; "
                f"tokens/s mesh=None {base_tps[0]:.1f}, {base_tps[1]:.1f}; "
                f"mesh=(1,1) {tps[0]:.1f}, {tps[1]:.1f} (warm-up "
                f"{runs[0][2]:.1f}) on {res['card']}; host drains "
                f"{got['host_drains']}; prefix cache {got['prefix_cache']}; "
                f"launches {got['launches']}")
            _check_launched(path, got["launches"], need)
            if kw.get("prefix_cache") and not got["prefix_cache"]["hits"]:
                raise AssertionError(f"{path}: no prefix hit")
            res[path] = {"launches": got["launches"],
                         "tokens_per_s": tps, "tokens_per_s_none": base_tps,
                         "tokens_per_s_warmup": runs[0][2],
                         "tokens_sha256": sha,
                         "host_drains": got["host_drains"],
                         "energy_j": got["energy_j"],
                         "prefix_cache": got["prefix_cache"]}
    finally:
        shutdown()


def _state_leaves(state):
    """p, m and v of a train state as plain local tensors."""
    from repro_torch.training.pytree import leaves
    return [x.to_local() if hasattr(x, "to_local") else x
            for t in (state["params"], state["opt"]["m"], state["opt"]["v"])
            for x in leaves(t)]


def phase_train_mesh(res):
    """Sharded training at (1,1) against mesh=None, bit for bit (see phase
    19 in the module docstring)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import (init_single_rank, make_debug_mesh,
                                         shutdown)
    from repro_torch.launch.specs import (InputShape, build_train,
                                          microbatches_for)
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)
    B, S, steps = TRAIN_MESH
    cfg = get_config("qwen2-1.5b")
    g = torch.Generator(device="cuda").manual_seed(13)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device="cuda", dtype=torch.int32)}
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    shape = InputShape("train_mesh", "train", S, B)
    gc.collect()
    torch.cuda.empty_cache()
    state0 = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                              cfg)
    init_single_rank("cuda")
    base = None
    out = {}
    try:
        mesh = make_debug_mesh(1, 1, device="cuda")
        mb = microbatches_for(cfg, shape, mesh)
        for run in ("none", "tp", "fsdp"):
            if run == "none":
                step, st, b = make_train_step(cfg, opt, mb), state0, batch
            else:
                built = build_train(cfg, shape, mesh, strategy=run,
                                    state=state0, batch=batch, opt_cfg=opt)
                if built["meta"]["microbatches"] != mb:
                    raise AssertionError(f"train_mesh {run}: "
                                         f"{built['meta']} microbatches")
                step, (st, b) = built["fn"], built["args"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            ms, losses, gnorms = [], [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                st, m = step(st, b)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(m["loss"].item())
                gnorms.append(m["grad_norm"].item())
            counts = _launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            final = [x.cpu() for x in _state_leaves(st)]
            del st, b, step
            gc.collect()
            torch.cuda.empty_cache()
            got = {"losses": losses, "grad_norms": gnorms, "step_ms": ms,
                   "peak_gib": peak, "launches": counts}
            log(f"[train_mesh] {run}: {cfg.name} {B}x{S}, {mb} "
                f"microbatches: losses {losses}, grad norms {gnorms}; step ms "
                f"{[round(x, 1) for x in ms]}; peak {peak:.2f} GiB on "
                f"{res['card']}; launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            if base is None:
                base = (losses, gnorms, counts, final)
                _check_launched("train_mesh", counts,
                                ("flash_attention/lse", "flash_attention_bwd",
                                 "rmsnorm", "add_rmsnorm", "rmsnorm_bwd",
                                 "rmsnorm_bwd/ds"))
            else:
                for what, a, b_ in (("losses", losses, base[0]),
                                    ("grad norms", gnorms, base[1]),
                                    ("launches", counts, base[2])):
                    if a != b_:
                        raise AssertionError(
                            f"train_mesh {run}: {what} {a} != mesh=None's "
                            f"{b_}")
                for i, (a, b_) in enumerate(zip(final, base[3])):
                    if a.dtype != b_.dtype or not torch.equal(a, b_):
                        raise AssertionError(
                            f"train_mesh {run}: state leaf {i} (p, m, v in "
                            "order) differs from mesh=None's")
            del final
            out[run] = got
    finally:
        shutdown()
    del state0, base
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train_mesh] (1,1) tp and fsdp == mesh=None bit for bit: losses, "
        f"grad norms, every p / m / v leaf and every launch count; median "
        f"step ms none {statistics.median(out['none']['step_ms']):.1f}, tp "
        f"{statistics.median(out['tp']['step_ms']):.1f}, fsdp "
        f"{statistics.median(out['fsdp']['step_ms']):.1f}")
    res["train_mesh"] = {**out, "launches": out["tp"]["launches"],
                         "microbatches": mb}


def _dryrun_one(spec):
    """One dry-run record, in its own process (``--dryrun-one
    arch:strategy:device:outdir``): ``launch.dryrun.run_one`` on the fake
    16x16 mesh, then one JSON line with the record's path and, for a CUDA
    trace, ``torch.cuda.max_memory_allocated()`` before and after it."""
    import torch
    from repro_torch.launch.dryrun import run_one
    arch, strategy, device, outdir = spec.split(":", 3)
    torch.set_num_threads(1)
    mem = where = None
    if device == "cuda":
        # a fake CUDA tensor's first creation in a process initializes the
        # CUDA context with one real 1-element tensor (torch's
        # fake_tensor.init_gpu_context, once per device), before the
        # baseline: the trace itself must allocate nothing
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            torch.empty(1, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        mem = [torch.cuda.max_memory_allocated()]
        # where any allocation comes from, should one happen
        torch.cuda.memory._record_memory_history(max_entries=1000)
    t0 = time.perf_counter()
    run_one(arch, "train_4k", False, outdir, strategy=strategy,
            device=device, tag=strategy)
    wall = time.perf_counter() - t0
    if device == "cuda":
        mem.append(torch.cuda.max_memory_allocated())
        where = [[f"{f['filename']}:{f['line']} {f['name']}"
                  for f in e.get("frames", [])[:25]]
                 for t in torch.cuda.memory._snapshot()["device_traces"]
                 for e in t if e["action"] == "alloc"][:4]
    print(json.dumps({"dryrun_one": spec, "wall_s": wall, "cuda_mem": mem,
                      "cuda_allocs": where,
                      "path": str(Path(outdir) / f"{arch}__train_4k__"
                                  f"{strategy}.json")}), flush=True)
    return 0


def start_dryrun(res):
    """Start the dry-run's six traces (DRYRUN_RUNS on fake CUDA and fake
    CPU tensors), one single-threaded process each, in parallel.  Returns
    [(spec, log path, log file, process)]."""
    import os
    out_dir = ROOT / "build" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(Path(res["src"])),
               OMP_NUM_THREADS="1")
    procs = []
    for arch, strategy in DRYRUN_RUNS:
        for device in ("cuda", "cpu"):
            spec = f"{arch}:{strategy}:{device}:{out_dir / device}"
            log_path = out_dir / f"{arch}__{strategy}__{device}.log"
            log_path.parent.mkdir(parents=True, exist_ok=True)
            f = open(log_path, "w")
            procs.append((spec, log_path, f, subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--dryrun-one", spec, "--src", res["src"]],
                stdout=f, stderr=subprocess.STDOUT, env=env,
                cwd=str(ROOT))))
    res["dryrun_started"] = time.perf_counter()
    return procs


def stop_dryrun(procs):
    for _, _, f, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        f.close()


def phase_dryrun(res):
    """The train dry-run on fake CUDA tensors against fake CPU tensors
    (see phase 20 in the module docstring)."""
    procs = start_dryrun(res)
    out_dir = ROOT / "build" / "dryrun"
    recs = {}
    try:
        for spec, log_path, f, p in procs:
            rc = p.wait(timeout=DRYRUN_TIMEOUT_S)
            f.close()
            text = log_path.read_text()
            if rc != 0:
                raise AssertionError(f"dryrun {spec}: rc {rc}\n{text[-3000:]}")
            line = [x for x in text.splitlines()
                    if x.startswith('{"dryrun_one"')][-1]
            info = json.loads(line)
            for x in text.splitlines():
                if x.startswith("[dryrun]"):
                    log(f"{x} ({spec.split(':')[2]}, {spec.split(':')[1]}, "
                        f"traced in {info['wall_s']:.1f}s)")
            recs[spec] = (json.loads(Path(info["path"]).read_text()), info)
    finally:
        stop_dryrun(procs)
    waited = time.perf_counter() - res["dryrun_started"]
    out = {}
    for arch, strategy in DRYRUN_RUNS:
        cu, cu_info = recs[f"{arch}:{strategy}:cuda:{out_dir / 'cuda'}"]
        cp, cp_info = recs[f"{arch}:{strategy}:cpu:{out_dir / 'cpu'}"]
        before, after = cu_info["cuda_mem"]
        if after != before:
            raise AssertionError(f"dryrun {arch} {strategy}: the CUDA trace "
                                 f"allocated device memory ({before} -> "
                                 f"{after} bytes at peak) at "
                                 f"{cu_info['cuda_allocs']}")
        for key in cu:
            if key in ("lower_s", "compile_s"):
                continue
            if cu[key] != cp[key]:
                raise AssertionError(
                    f"dryrun {arch} {strategy}: {key} on fake CUDA tensors "
                    f"{cu[key]} != on fake CPU tensors {cp[key]}")
        out[f"{arch}__{strategy}"] = {
            "record": cu, "trace_s": {"cuda": cu_info["wall_s"],
                                      "cpu": cp_info["wall_s"]},
            "cuda_max_memory_allocated": [before, after]}
        log(f"[dryrun] {arch} {strategy}: the fake CUDA record == the fake "
            f"CPU record in every field but the times; max_memory_allocated "
            f"{before} -> {after}; traced in {cu_info['wall_s']:.1f}s (cuda) "
            f"and {cp_info['wall_s']:.1f}s (cpu) in parallel")
    log(f"[dryrun] the six traces, in parallel, collected {waited:.1f}s "
        "after they started (each trace's own time above)")
    res["dryrun"] = {**out, "traces_wall_s": waited}


def gpu_name_and_limit():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


# the keys of a kernel's entry in the printed line; the per-path launches
# and the other routes' cases stay in chip_smoke.json, keeping the line short
LINE_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")


def _line_entry(k):
    """A kernel's entry of the printed line: LINE_KEYS, its launches summed
    by route, and the ms of each other route's timed case."""
    by_route = {}
    for counts in k["launches_by_path"].values():
        for r, n in counts.items():
            by_route[r] = by_route.get(r, 0) + n
    routes = {r: k[r]["ms"] for r in ("q8_route", "f32_past_route",
                                      "f32_past_dense_route", "lse_route",
                                      "ds_route") if k.get(r)}
    return {**{key: k[key] for key in LINE_KEYS},
            "launches_by_route": by_route, "routes_ms": routes}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/chip_smoke",
                    help="directory for the detailed JSON results "
                         "(relative to the checkout)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}, or "
                         "'profile' (a traced serve burst)")
    ap.add_argument("--archs", default="",
                    help="comma-separated arch ids: the arch phase and the "
                         "equivalence phase's arch checks keep only these "
                         "(default: every one)")
    ap.add_argument("--src", default=str(SRC),
                    help="the source tree to import repro_torch from (default "
                         "the checkout's src/; another tree's, e.g. an earlier "
                         "commit unpacked under build/, runs this script's "
                         "cases against that version's kernels)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the controller phase's telemetry")
    ap.add_argument("--dryrun-one", default="",
                    help="arch:strategy:device:outdir: trace one dry-run "
                         "record in this process (the dryrun phase's "
                         "workers) and exit")
    args = ap.parse_args(argv)
    global SEED
    SEED = args.seed
    phases = [p for p in args.phases.split(",") if p]
    if args.archs:
        keep = set(args.archs.split(","))
        global ARCH_RUNS, EQUIV_ARCHS, RECURRENT_EQUIV, ONLY_ARCHS
        ONLY_ARCHS = keep
        ARCH_RUNS = tuple(r for r in ARCH_RUNS if r[0] in keep)
        EQUIV_ARCHS = tuple(r for r in EQUIV_ARCHS if r[0] in keep)
        RECURRENT_EQUIV = tuple(r for r in RECURRENT_EQUIV if r[0] in keep)
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no {src / 'repro_torch'}; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if args.dryrun_one:
        return _dryrun_one(args.dryrun_one)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_limit()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"({card}); repro_torch from {src}")
    res = {"card": card, "src": str(src)}
    fns = {"build": phase_build, "kernels": phase_kernels,
           "equivalence": phase_equivalence, "serve": phase_serve,
           "serve_paged": phase_serve_paged, "serve_q8": phase_serve_q8,
           "paged_vs_dense": phase_paged_vs_dense,
           "sampling": phase_sampling, "observability": phase_observability,
           "arch": phase_arch, "cluster": phase_cluster,
           "legacy": phase_legacy, "prefill": phase_prefill,
           "mixed_dtype": phase_mixed_dtype, "controller": phase_controller,
           "replay": phase_replay, "train": phase_train,
           "mesh": phase_mesh, "train_mesh": phase_train_mesh,
           "dryrun": phase_dryrun, "profile": phase_profile}
    for p in phases:
        t0 = time.perf_counter()
        fns[p](res)
        log(f"[{p}] done in {time.perf_counter() - t0:.1f}s")

    kernels = []
    main_case = res.get("main_case", {})
    by_path = {p: res[p]["launches"] for p in SERVE_PATHS if p in res}
    for name, (source, replaces) in KERNELS.items():
        routes = [r for r in _counters() if r.split("/")[0] == name]
        counts = {p: {r: c[r] for r in routes} for p, c in by_path.items()}
        c = main_case.get(name) or {}
        cases = [x for x in res.get("cases", []) if x["kernel"] == name]
        errs = [x["max_abs_err"] for x in cases]
        shares = [x["bf16_share"] for x in cases if x["bf16_share"] is not None]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(sum(c.values()) for c in counts.values())
            if counts else None, "launches_by_path": counts,
            "max_abs_err": max(errs) if errs else None,
            "bf16_share": max(shares) if shares else None,
            "ms": c.get("ms"), "plain_ms": c.get("plain_ms"),
            "bound_ms": c.get("bound_ms"), "bound_by": c.get("bound_by"),
            "library_ms": c.get("library_ms"), "shape": c.get("shape"),
            "dense_kernel_ms": c.get("dense_kernel_ms"),
            "bf16_kernel_ms": c.get("bf16_kernel_ms"),
            "q8_route": c.get("q8_route"),
            "f32_past_route": c.get("f32_past_route"),
            "f32_past_dense_route": c.get("f32_past_dense_route"),
            "lse_route": c.get("lse_route"), "ds_route": c.get("ds_route"),
            "span_ms": c.get("span_ms"),
            "library": c.get("library")})
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {**res, "kernels": kernels}, indent=1, default=str))
    print(card, flush=True)
    print(json.dumps({"kernels": [_line_entry(k) for k in kernels],
                      "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
