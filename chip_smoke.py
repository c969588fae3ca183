"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. card and build: the card's name and power limit; every kernel of the
     port compiled from ``src/repro_torch/kernels/csrc`` with nvcc (one
     process per source, started together), with the build time;
  2. each kernel against its plain PyTorch version on the card, on inputs
     drawn from seeded generators (the decode pools and the gossip stores
     from a torch.Generator on the card, the flash operands from a numpy
     RNG) — the decode attention in float32 at
     the serve shape and at GQA shapes with softcap and window (1e-5), and
     from bf16 pools at gemma2-27b's decode shape (H 32, KV 16, hd 128, 8
     slots up to 8,192 tokens: the global and local layers, a length-0
     and a length-1 slot, windows that start inside a split) and at phase
     3b's shape (40 pages, slots up to 576 tokens and either side of its
     split boundaries, q scaled so the softcap binds) and at granite-20b's
     (MQA: H 48 on KV 1, hd 128, 8 slots up to 8,192 tokens, a length-0
     and a length-1 slot) and at granite-moe-3b-a800m's (H 24 on KV 8, hd
     64) and jamba-v0.1-52b's (H 32 on KV 8, hd 128, window 4,096: phases
     11a and 12a), 8 slots up to 8,192 tokens with a length-0 and a
     length-1 slot and lengths either side of their split boundaries,
     each element within 2^-7 |plain| + 1e-3
     rms(plain), timed at the serve shape, at gemma2's global and local
     decode layers, at granite's and at granite-moe's and jamba's (bound:
     the bytes, or q.k and P.V once each at the pool dtype's rate; the
     arithmetic of the kernel that runs is kept beside it); the gossip
     update at the training shape (n=4, T=1,056,920, K=1, momentum), on a
     ring with weight decay and an inactive NaN row, in AD-PSGD publish
     mode, as a mixing-only round (K=3), and at the launch path's n = 1
     (a received (2, T, 128) remote stack; publish mode with a received
     row); the reorthogonalization
     kernels (Lanczos CGS2) at the transformer-100m probe shape (M = 9,
     T = 1,056,920), on a ragged T, M = 1, a partial mask and an
     orthonormal (QR) basis, on vectors drawn on the card from a seeded
     torch.Generator: dots within 1e-5 of ||v_k|| ||w||, the axpy bitwise
     given the same dots, the CGS2 residual below 1e-4 ||w|| — then each
     kernel's time beside the plain version's, one PyTorch library call's
     where one computes the same function, and the least time the card
     could take (``bound_ms``);
  3. full-width serving: transformer-100m (12 layers, d=768, vocab 32768,
     random weights from a seeded torch.Generator) behind ``ServeEngine``
     (8 slots, page 16, max_len 256) runs 16 requests to completion; every
     request must finish with its budget, every logit must be finite, the
     attention kernel must have launched 12 times per engine step, and the
     first 2 steps' logits must match the port on the CPU (plain versions,
     same weights); then an open-loop drive of 4 requests arriving at
     fixed engine steps, ``idle_tick`` between them, where no idle tick
     may launch a kernel and every request's tokens must equal the same
     requests served closed-loop;
  3b. gemma2-27b served the same way at full width, depth cut to one
     local/global period (2 layers, 2.31 B bf16 parameters, bf16 K/V
     pools): 8 slots, page 16, max_len 640, 16 requests of 32-512 prompt
     and 16-64 new tokens; 2 decode launches per step, the first 3 steps'
     logits within 1e-2 (relative, Frobenius) of the port on the CPU while
     the control (the CPU steps one mantissa bit below bf16) falls outside
     it, and the decode kernel, on the inputs both layers gave it at steps 256,
     512 and 768, within the bf16 tier of its plain version;
  3c. granite-20b served as in 3b at full width, depth cut from 52 to 2
     layers (1.67 B bf16 parameters; 48 query heads on one kv head), with
     the same requests and checks (1e-2, against its control);
  4. full-width training: transformer-100m trained with DPSGD by
     ``MultiLearnerTrainer`` (4 learners, random_pair, the
     ``examples/train_100m.py`` recipe: sgd(0.5, momentum 0.9) under a
     warm-up schedule, synthetic tokens, seq 512, local batch 2): 2 warm-up
     and 6 timed steps, then 2 profiled ones; every loss must be finite,
     the gossip kernel must have launched once per gossip round, and the
     first 2 steps with ``kernel_backend="ref"`` must give the same
     parameters; then the consensus bridge: ``ConsensusBridge.snapshot``
     of the 4 learners (equal to ``learner_mean`` within 1e-6) served to
     phase 3's 16 requests by a ``ServeEngine``, 2 more training steps,
     ``staleness`` (2 steps behind, every field finite) and
     ``served_divergence`` on a 2 x 64 probe (top-1 agreement in [0, 1],
     every field finite);
  4b. the full-width landscape probe: after the training steps, a
     ``make_trainer_probe`` hook (Lanczos 8, Hutchinson 4) runs once
     through ``trainer.run_probes`` on a 4 x 2 x 512-token superbatch, then
     ``trainer.diagnostics``; every field finite, the sharpness equal to a
     ``reorth="ref"`` run of the same probe within 1e-4, the reorth
     kernels launched 16 / 16 times (0 / 0 in the ``ref`` run);
  5. the paper's experiment and the other modes on the FC net: the
     quickstart twin (SSGD vs DPSGD at lr 0.5, 5 x 400, 120 steps; DPSGD
     must end below SSGD), ``full`` gossip on 4 learners (two rounds, so
     the mixing-only pass runs) with momentum and weight decay, and
     AD-PSGD with a straggler, both against ``kernel_backend="ref"``;
  6. Table 1 at nB = 2000, lr = 0.5 (``repro_torch.bench``): SSGD must
     fail, DPSGD converge and SSGD+AutoLR converge below 1e-2 with the
     controller clamping below 1, through the reorth kernels; a
     ``reorth="ref"`` AutoLR run must agree on the first probe's
     sharpness within 1e-4 and end below 1e-2 too;
  2d. the flash-attention kernels against their plain version at
     gemma2-27b's shape (bf16, window 4,096, softcap 50, S = 4,608),
     transformer-100m's training shape (float32, S = 512), granite-20b's
     MQA (bf16, S = 1,024), non-causal float32 (S = 256, hd 32), rows with
     no live key (Sq 256 > Sk 128 + window 64), gemma2's heads and masks in
     float32 with q scaled so the softcap binds, ragged bf16 lengths (Sq =
     Sk = 100; Sq 100, Sk 37) and bf16 at hd 64, ragged float32 lengths
     at hd 32, 64 and 128 (the same two masks) and ragged bf16 at hd 32,
     and head dims the kernels take zero-padded or at their widest
     instance (float32 hd 96 with GQA, float32 hd 256 with window and a
     binding softcap, bf16 hd 256, bf16 hd 80 on the tensor cores) —
     float32 within the reference's tiers, bf16 within one bf16 ulp of
     each value — then, at gemma2's prefill shapes (S = 8,192, global and
     local), the training shape and a float32 hd-256 shape (H 16, S
     2,048), the same comparison, its time, the
     plain version's, SDPA's where one call computes the same function
     (also at granite-moe's 4,096-token and jamba's 8,192-token prefill
     layers, jamba's SDPA with a causal-window mask)
     and the bound (the tensor-core kernel: q.k once and P.V twice at the
     bf16 rate; the float32 kernel: the slower of q.k in float32 FMAs and
     P.V three times at the TF32 rate, beside both at the float32 rate);
     also at the benchmark's flash4k shape (transformer-100m, B 2, S
     4,096, float32);
  2f. the flash backward kernel at every shape 2d times (the hd-256 shape
     keeps the plain version's recompute, statically): dq, dk, dv against
     its plain version (``ref.flash_attention_bwd_ref``) and against
     autograd through the dense recompute on the first kv heads, float32
     within 1e-5 of each gradient's largest element, bf16 within one bf16
     ulp of the plain version; then its time, the recompute's (where its
     score tensors fit), SDPA's backward where one call computes the same
     function, and the bound (q.k and dO.v in float32 FMAs, dV, dK, dQ in
     three TF32 terms; bf16: all five products at the bf16 rate);
  2e. the single-learner gossip kernel through ``ops.dpsgd_fused_update``
     on transformer-100m's full parameter tree with 2 neighbour trees,
     bitwise equal to ``backend="ref"``, then its time;
  7. gemma2-27b at full width, depth cut to one local/global period (2
     layers; 2.31 B bf16 parameters from a seeded torch.Generator), with
     ``use_pallas``: ``api.apply`` prefill of 8,192 tokens (2 flash
     launches, finite logits, the last 64 positions equal to the chunked
     route's within a bf16 tier), then ``loss_fn`` + backward at 4,608
     tokens (2 forward and 2 backward launches, finite gradients, both
     layers' ``wq`` gradients equal to the chunked route's within the
     tier);
  8. transformer-100m trained as in phase 4 with ``use_pallas``: 48 flash
     forward and 48 backward launches per step, the first 2 losses equal
     to phase 4's within 1e-5
     relative, step time, idle share and kernels per step beside phase
     4's;
  9. the pytree engine at full width, transformer-100m with phase 4's
     recipe: (a) SSGD* (noise 0.01) on the pytree engine, 2 warm-up, 4
     timed and 1 profiled steps, finite losses, no kernel launched, step
     time, idle share and peak memory; (b) DPSGD on ``engine="pytree"``
     against ``engine="flat"`` from the same seed: after 2 steps the
     parameters agree within the reference's flat-against-pytree tier
     (2e-5 absolute + 2e-5 relative), the flat run launching the gossip
     kernel once a step and the pytree run none; (c) bf16 leaves on the
     flat engine (cast into persistent bf16 leaves, gradients written
     back into the float32 store): the gossip kernel once a round, the
     first 2 steps equal to ``kernel_backend="ref"`` within 1e-5, its step
     time beside phase 4's and the cast and write passes' share of the
     step's device time;
 10. the paper's experiments on the FC net through the bench twins
     (``repro_torch.bench``): Fig. 2 (SSGD, DPSGD and SSGD* with
     diagnostics and probes every 20 of 140 steps, then the SSGD* noise
     sweep) — DPSGD must end below SSGD and every probe run through the
     reorth kernels (16 + 16 launches a probe); the topology ablation (9
     topologies, n = 8, 130 steps each) — every scheduled topology fused,
     the gossip kernel launched rounds x steps times, ``measured_gap >=
     gap_bound``; Table 4, Fig. 4 and Table 5 (the ASR proxy: 100 zipf
     classes, SSGD against DPSGD at lr 0.25, 0.5 and 1.0, 120 steps; both
     converge at 0.25, as the reference's own run does), each printing its
     ``derived`` line and its gossip launches; the twin of
     ``examples/paper_mnist_repro.py`` at its full settings (5 x 400, lr
     0.5, 150 steps of SSGD, SSGD* and DPSGD, a CSV row every 10 steps):
     150 gossip launches for DPSGD and none for SSGD or SSGD*, every field
     finite, test accuracy in [0, 1], and the reference's CPU verdict:
     SSGD above 1 with accuracy below 0.5 at step 140, SSGD* and DPSGD
     below 1e-2 with accuracy at least 0.99;
 11. granite-moe-3b-a800m at full width, 12 of its 32 layers (40
     experts top-8, 1.3 B bf16 parameters from a seeded torch.Generator)
     served as phase 3b serves gemma2 (12 decode launches a step; logits
     within 2e-2 and the control outside it; the CPU
     steps replay the card's expert choices, and at most a quarter of the
     tokens may have picked another set of experts on the CPU; the error
     layer by layer beside the logits' error; the MoE layers' device
     time a step beside the bytes of every expert weight), then
     ``api.apply`` of
     4,096 tokens through the flash route against the chunked route
     (routing shared; the last 64 positions within 2e-2, Frobenius);
 12. jamba-v0.1-52b at full width, depth cut to one period (8 layers: 7
     mamba, 1 attention without RoPE and with a 4,096 window, 4 MoE
     layers of 16 experts top-2; 13.3 B bf16 parameters), served the same
     way (1 decode launch a step; 2e-2 against its control), plus on the served cache: a step with
     half the slots not advancing keeps their mamba leaves bitwise and
     ``reset_slot`` zeroes one slot's leaves and no other's; then the
     prefill of 8,192 tokens, where the window binds;
 13. xlstm-350m at full width in bf16 served at 12 of its 24 layers (6
     mLSTM and 6 sLSTM blocks) as phase 3b serves gemma2 (no attention:
     no decode launch; card logits within 5e-2 of the CPU's; the advance
     mask keeps a frozen slot's mLSTM/sLSTM leaves bitwise and
     ``reset_slot`` zeroes one slot); at full depth (24 layers), paged
     decode of a 64-token prompt against ``api.apply`` (bf16 within 0.12,
     float32 within 1e-4), then
     trained with DPSGD (4 learners, random_pair, seq 64, local batch 2,
     1 step: 1 gossip launch, the store equal to
     ``kernel_backend="ref"`` within 1e-5);
 14. qwen2-vl-7b (28 layers) and seamless-m4t-large-v2 (24 + 24 layers)
     at full width and depth in bf16, one after the other: qwen2-vl's
     ``api.apply`` on 1,024 patch embeddings + 1,024 text tokens (M-RoPE,
     the chunked route), seamless's ``init_cache`` over (8, 512) frames;
     then 40 greedy ``decode_step``s of 8 sequences, each step's logits
     within 3e-2 of ``apply``'s on the same tokens (teacher forcing); then
     both with depth cut to 2 (2 + 2) layers on the card against the CPU
     on 64 + 64 positions (logits within 1.2e-2; every layer's output).
     Each bf16 tier of phases 3b-3c and 11-14 must also reject its
     control, the same run one mantissa bit below bf16 (``held``).
 15. the elastic fleet (``core/membership.py``, ``core/faults.py``,
     ``checkpoint/``), through the gossip kernel's active column:
     (a) transformer-100m at full width and depth with phase 4's recipe
     (4 learners, DPSGD on random_pair, the flat engine): 2 steps of an
     all-active ``Membership(4)`` bitwise the fixed fleet's, then
     ``crash(1)`` and 2 steps (learner 1's parameter and momentum rows
     bitwise frozen; a twin fleet whose row 1 is NaN keeps rows 0, 2 and 3
     bitwise equal and finite; ``n_active`` 3), ``admit`` (slot 1 the
     live rows' mean within 1e-6 relative, its momentum zero),
     ``rejoin`` and 2 steps (finite, ``n_active`` 4); the whole script
     with ``kernel_backend="ref"`` within 1e-5; one crash on ``ring``
     (``reschedule``'s K = 2 tables) against ``ref``; ms a step in each
     window, one profiled step; (b) that fleet's state after the dead
     window (parameters, momentum, membership: ~4.3 GB) saved with
     ``save_checkpoint``, verified, and restored through
     ``state_from_view`` bitwise past a torn newer copy, each timed;
     (c) the FC net through ``train_fc(fault_plan=...)`` against
     ``kernel_backend="ref"`` (1e-5, equal supervisor reports):
     ``benchmarks/faults.py``'s crash-rejoin + straggler plan for DPSGD
     and AD-PSGD, ``FaultPlan.random(0, 120, 8)``, a sticky hang evicted
     after its retries, and one crash on every deterministic topology;
     (d) the Fig. 3 twin at its full settings, held to what the
     reference's run shows.
 16. the launch path (``repro_torch.launch``, one learner per rank on
     ``torch.distributed``): (a) 4 gloo ranks spawned together, sharing
     the one card (the transport is gloo over TCP loopback, staged
     through pinned host memory, not NCCL), transformer-100m at full
     width and depth with phase 4's recipe, rank r from its own weights
     (seed SEED + r, carried in as stacked numpy through
     ``rank_state_from_numpy``): DPSGD on random_pair (matchings drawn on
     the host) for 2 steps and on ring (K = 2) for 2, AD-PSGD (staleness
     4, learner 0 three times slower) for 3 ticks; every step's gossip
     through the fused kernel at n = 1 (launches summed over the ranks =
     ranks x steps x rounds), one send and one receive per live slot, K
     stores received a round (beside ``analytic``'s ring bytes); rank 0
     gathers every rank's rows (and AD-PSGD's buffers) and holds them
     within 1e-5 of a single-process ``MultiLearnerTrainer`` fed the same
     batches and tables, with ``kernel_backend="ref"`` (the kernel's
     plain version); ms a step (host clock ending in a sync) split
     into compute, exchange and kernel, and each rank's peak memory;
     (b) world size 1 over NCCL: an SSGD step (its gradient all_reduce)
     and a solo DPSGD step against the trainer at n = 1, each under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host sync); with no
     neighbour, no point-to-point op and no gossip kernel runs there.
 17. the model axis (a learner spanning the ranks of a ``DeviceMesh``,
     ``launch/train.py`` with ``mesh=``): 4 gloo ranks sharing the card
     again.  (a) a (data 2, model 2) mesh, transformer-100m at full width
     and depth with phase 4's recipe (one row a model rank): DPSGD on
     ring for 3 steps, SSGD for 3 and AD-PSGD for 2 ticks, each rank
     storing its shard of every leaf as the reference's ``leaf_spec``
     cuts it; a step gathers the shards over the model group, runs its
     rows, reduce-scatters the gradient (3 model-group collectives a
     step) and gossips its shard with the rank at the same model
     coordinate of the partner learner through kernel #2; the learners'
     gathered stores within 1e-5 of the single-process trainer at n = 2
     (plain kernel); ms a step split into compute, model (the gather,
     reduce-scatter and all-reduce), exchange and kernel, the bytes of
     each, peak memory; (b) the sharded probe on (a)'s DPSGD learners and
     on SSGD's replica (``stacked=False``), its Lanczos basis a shard per
     rank through kernels #4 / #5, against the single-process
     ``probe_landscape`` with the same draws (sharpness within 1e-4);
     (c) a (1, 4) mesh: one granite-moe-3b-a800m MoE block at full width
     in bf16 through the expert-parallel all-to-all
     (``models/moe_shardmap.py``), 4,096 tokens, forward and backward
     against the einsum path on the same tokens, its bf16 tier held
     against its control; (d) the per-period gather (``gather="period"``)
     on (a)'s mesh: DPSGD on ring and SSGD from (a)'s initial state, each
     period gathered as the forward reaches it and again in its
     checkpointed recompute, held to (a)'s ``"whole"`` shards (1e-6;
     bitwise is what the card gives if the gap reads 0), each rank's
     peak memory beside the dry run's prediction, kernel #2's launches;
     (e) the sequence-sharded decode on a (1, 4) mesh: transformer-100m
     at full width, 8 sequences, a 64-row buffer cut 4 ways, 72 steps
     (a wrap), logits within 1e-4 relative of the single-process
     ``decode_step`` on the card with the same weights; then gemma2-27b
     at 2 layers in bf16 (softcap, GQA, a local layer), 72 steps of a
     64-row buffer, its tier held against its control; collectives,
     bytes and ms a step; (f) the sharded prefill on (a)'s mesh:
     transformer-100m with ``use_pallas``, each rank's row of 512 tokens
     through kernel #6 on the gathered weights, within 1e-5 relative of
     the single-process flash prefill of the same row; (g) the audio
     family under the model axis: seamless-m4t-large-v2 at full width (d
     1,024, 16 heads, vocab 256,206, bf16), 2 encoder and 2 decoder
     layers, on the (1, 4) mesh: 8 sequences of 512 frames encoded each
     model rank its rows, one all-to-all leaving each rank its quarter of
     the encoder length of every row's cross K/V, then 32 steps of a
     64-row self-attention buffer (two collectives a decoder layer a
     step), logits within 1e-2 of the single-process ``decode_step`` on
     the card against its control; the sharded prefill of the frames and
     64 tokens on (a)'s mesh within 1e-5 of the single-process ``apply``
     of the same rows; (h) the probe on the per-period gather
     (``gather="period"``: forward over reverse a period at a time) on
     (b)'s states and draws, stacked and single, every field within 1e-4
     of (b)'s whole probe, kernels #4 / #5 launched on the basis shard,
     its full weights (the non-period leaves and one period) and peak
     memory beside the whole probe's.
 18. the static auditor (``repro_torch.analysis``) on the card, every
     finding a failure: (a) ``audit_trainer`` (the FC net, DPSGD ring,
     n 4, hidden 32), then its rules on transformer-100m at full width
     with phase 4's recipe under ``scale_by_controller``: a warm step,
     one traced (no concatenate of n_params / 100 elements, no host read,
     the stores written in place, kernel #2 once a gossip round),
     ``run_steps`` over 2, and a sentinel window of 3 steps around a
     controller scale write and a crash (the trace signature unchanged,
     no library loaded), every traced call under
     ``torch.cuda.set_sync_debug_mode("error")``; (b) the serve engine's
     ``paged_decode_step`` at full width (phase 3's engine; kernel #1 12
     times a step, the pools written in place; the sentinel over a
     submit, a mid-flight join and evictions); (c) in phase 16's 4 gloo
     ranks: DPSGD on ring with the point-to-point backend, one traced
     step a rank (two sends, one a live slot, float32 on the wire, no
     parameter-sized concatenate, no host read, the stores in place);
     (d) the twins ``repro_torch.serve_batched`` at its defaults and
     ``repro_torch.train_100m --preset full --seq 512`` (2 learners): 2
     steps and a checkpoint, a run resumed from it, a held-out loss.
 Phase 2 also holds the gossip kernel at the launch path's shapes: n = 1
 with a received (2, T, 128) stack as its remote (the ring), and n = 1 in
 publish mode (AD-PSGD).

``python3 chip_smoke.py --only N`` runs phase N alone (2: every kernel
check, 3-7, 10, 13-18; 18 spawns its own 4 ranks for c) and prints its
record and the last line.
Each path runs with every kernel's launch count set to 0 just before it
and read just after.  The last lines are the serve (100m, gemma2,
granite), train (with the bridge), probe, FC, Table-1, gemma2,
flash-training, pytree-engine, paper-experiment, granite-moe, jamba,
xlstm, qwen2-vl, seamless, elastic, launch, mesh and audit numbers, each
phase's wall seconds, the card, the kernels record and ``{"ok": true,
"device": {...}}``.
Without CUDA the script exits 1 before printing any result.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
N_SLOTS, PAGE, MAX_LEN = 8, 16, 256
N_REQUESTS = 16
# phase 3's open-loop drive: the first requests' engine arrival steps (two
# overlapping, a gap the engine idles through, two more), each request cut
# to a short prompt and budget
OPEN_LOOP_ARRIVALS = (0, 2, 60, 64)
OPEN_LOOP_PROMPT, OPEN_LOOP_NEW = 12, 8
CPU_STEPS = 2
KERNEL_ATOL = 1e-5
# logits over 12 float32 layers on the card against the CPU: the sums run
# in other orders, so the two agree to ~1e-5 relative, not bitwise
LOGIT_TOL = 1e-3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                  # float32 outside the tensor cores
TF32_FLOPS = 495e12                # TF32 in the tensor cores, dense
BF16_FLOPS = 989e12                # bf16 in the tensor cores, dense
L2_BYTES = 50 * 2 ** 20
# training (examples/train_100m.py's recipe at full width)
TRAIN_LEARNERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 2, 512, 0.5
TRAIN_ROWS = 1_056_920      # T of transformer-100m's flat store (checked)
CASE_ROWS = 131_072         # T of the other gossip cases: 64 MB per learner
WARM_STEPS, TIMED_STEPS, PROF_STEPS, REF_STEPS = 2, 6, 2, 2
# phase 9: the pytree engine (SSGD*), pytree against flat, bf16 leaves
PYTREE_WARM, PYTREE_TIMED, PYTREE_PROF = 2, 4, 1
ENGINE_STEPS = 2
# the flat engine against the pytree engine: the reference's own tier for
# that comparison (tests/test_flat_engine.py), |a - b| <= 2e-5 + 2e-5 |b|
ENGINE_ATOL = ENGINE_RTOL = 2e-5
BF16_WARM, BF16_TIMED, BF16_PROF = 2, 4, 1
# the gossip kernel rounds every operation as its plain version does, so
# the two agree bitwise; a training step recomputes its gradients, and
# cuBLAS or the embedding backward may sum in another order run to run
GOSSIP_ATOL = 0.0
TRAIN_REF_ATOL = 1e-5
# reorthogonalization: the dots sum T * 128 float32 products in another
# order than torch.sum (1.35e8 terms at the probe shape), so they are held
# relative to ||v_k|| ||w||; the axpy rounds as its plain version does
REORTH_M = 9                # Lanczos 8 steps -> a 9-vector basis
REORTH_DOTS_RTOL = 1e-5
REORTH_AXPY_ATOL = 0.0
REORTH_RESIDUAL = 1e-4      # of ||w||: tests/test_landscape.py's bound
# the full-width probe and Table 1
PROBE_ITERS, PROBE_SAMPLES = 8, 4
PROBE_RTOL = 1e-4
TABLE1_SCALE, TABLE1_STEPS = 4, 120     # nB = 2000, lr = 0.5
# phase 10's topology ablation: steps a topology.  What the phase holds
# (every schedule fused, rounds x steps gossip launches, measured_gap >=
# gap_bound from a 16-step window of the schedule) does not depend on the
# length, so it runs the twin's --smoke length (130 to PR 22; cut for the
# run's time when phase 17 grew in PR 23)
ABLATION_STEPS = 40
# phase 10's paper_mnist_repro twin at its full settings: the verdict of
# the reference example's own run on the CPU, at its last row (step 140:
# SSGD loss 1.7562, accuracy 0.275; SSGD* 0.0009 and DPSGD 0.0005, both
# 1.000): SSGD above the first pair, SSGD* and DPSGD inside the second
MNIST_FAIL_LOSS, MNIST_FAIL_ACC = 1.0, 0.5
MNIST_OK_LOSS, MNIST_OK_ACC = 1e-2, 0.99
# flash attention. float32: the reference's own sweep tiers
# (tests/test_kernels.py) — the sums run in another order than the plain
# version's einsum, so 2e-6 holds to S = 256 and 1e-5 above. bf16: both
# sides round one float32 result once, so they may land one bf16 ulp apart
# (at most 2^-7 of the value) and no further; each element is held to
# 2^-7 |plain| + 1e-3 rms(plain), the second term for sums near 0
FLASH_ATOL_F32_SHORT, FLASH_ATOL_F32 = 2e-6, 1e-5
FLASH_BF16_ULP, FLASH_BF16_RMS = 2.0 ** -7, 1e-3
_BF16, _F32 = torch.bfloat16, torch.float32
FLASH_CASES = [   # (name, B, H, KV, hd, Sq, dtype, mask, Sk or None, q scale)
    ("a_gemma2", 1, 32, 16, 128, 4608, _BF16,
     dict(causal=True, window=4096, attn_softcap=50.0), None, 1.0),
    ("b_train_100m", 2, 12, 12, 64, 512, _F32, dict(causal=True), None, 1.0),
    ("c_granite_mqa", 1, 48, 1, 128, 1024, _BF16, dict(causal=True), None,
     1.0),
    ("d_full_f32", 1, 4, 2, 32, 256, _F32, dict(causal=False), None, 1.0),
    ("e_no_live_key_rows", 1, 4, 2, 32, 256, _F32,
     dict(causal=False, window=64), 128, 1.0),
    # gemma2's heads and masks in float32, q scaled by 8 so scores reach
    # tens and the cap at 50 changes them by whole units: a kernel that
    # dropped or misplaced the softcap fails here (checked below)
    ("f_softcap_binds_f32", 1, 32, 16, 128, 4608, _F32,
     dict(causal=True, window=4096, attn_softcap=50.0), None, 8.0),
    # the tensor-core kernel's ragged tiles (a length the reference takes
    # below its 128 block) and its hd-64 instance
    ("g_ragged_bf16", 1, 4, 2, 128, 100, _BF16,
     dict(causal=True, window=32, attn_softcap=50.0), None, 1.0),
    ("h_ragged_sk_bf16", 1, 4, 2, 128, 100, _BF16, dict(causal=False), 37,
     1.0),
    ("i_hd64_bf16", 1, 8, 4, 64, 512, _BF16,
     dict(causal=True, attn_softcap=50.0), None, 1.0),
    # the float32 kernel's ragged tiles at each head width (Sq = Sk = 100
    # with window and softcap; Sq 100 against Sk 37), and bf16 at hd 32
    ("j_ragged_f32_hd32", 1, 4, 2, 32, 100, _F32,
     dict(causal=True, window=32, attn_softcap=50.0), None, 1.0),
    ("k_ragged_f32_hd64", 1, 4, 2, 64, 100, _F32,
     dict(causal=True, window=32, attn_softcap=50.0), None, 1.0),
    ("l_ragged_f32_hd128", 1, 4, 2, 128, 100, _F32,
     dict(causal=True, window=32, attn_softcap=50.0), None, 1.0),
    ("m_ragged_sk_f32_hd32", 1, 4, 2, 32, 100, _F32, dict(causal=False),
     37, 1.0),
    ("n_ragged_sk_f32_hd64", 1, 4, 2, 64, 100, _F32, dict(causal=False),
     37, 1.0),
    ("o_ragged_sk_f32_hd128", 1, 4, 2, 128, 100, _F32, dict(causal=False),
     37, 1.0),
    ("p_ragged_bf16_hd32", 1, 4, 2, 32, 100, _BF16,
     dict(causal=True, window=32, attn_softcap=50.0), None, 1.0),
    # every head dim up to 256: float32 hd 96 (zero-padded to the hd-128
    # instance, GQA); float32 hd 256 (the widest instance) with window and
    # softcap, q scaled by 8 so the cap binds (checked as case f's);
    # bf16 hd 256 (the float32 kernel's bf16 instance); bf16 hd 80
    # (padded to 128, the tensor-core kernel)
    ("q_f32_hd96_gqa", 1, 8, 2, 96, 256, _F32, dict(causal=True), None,
     1.0),
    ("r_f32_hd256_softcap_binds", 1, 8, 4, 256, 512, _F32,
     dict(causal=True, window=128, attn_softcap=50.0), None, 8.0),
    ("s_bf16_hd256", 1, 8, 4, 256, 512, _BF16,
     dict(causal=True, attn_softcap=50.0), None, 1.0),
    ("t_bf16_hd80_tc", 1, 8, 2, 80, 512, _BF16,
     dict(causal=True, window=128), None, 1.0),
]
# the cap's effect on case f's plain output, in units of its tolerance
FLASH_CAP_EFFECT_MIN = 100.0
# single-learner gossip: every operation rounded as the plain version
GOSSIP_SINGLE_K, GOSSIP_SINGLE_LR, GOSSIP_SINGLE_BETA = 2, 0.1, 0.9
# gemma2-27b at full width, 2 layers (one local/global period)
GEMMA_LAYERS, GEMMA_PREFILL_SEQ, GEMMA_TRAIN_SEQ = 2, 8192, 4608
GEMMA_LAST = 64             # prefill positions compared with the chunked route
GEMMA_CHUNK = 512           # the chunked route's block at S = 4,608 (9 x 512)
# the flash and chunked routes round the attention output to bf16 from
# float32 sums taken in other orders, and two bf16 layers and the tied head
# carry the difference on: held as ||a - b|| / ||b||
GEMMA_BF16_RTOL = 2e-2
# a served bf16 model's card logits against the CPU's (Frobenius, the
# worst of CPU_STEPS steps), each tier held against its control, the CPU
# steps one mantissa bit below bf16 (``held``: the control's best step must
# fall outside it).  The difference grows with depth as sqrt(layers)
# (granite-moe: 1.3e-3 after one layer, 8.6e-3 after 8, 1.67e-2 after all
# 32; phase 11 serves 16 since PR 22).  On an H100 (run 18c, over 3 CPU
# steps; 2 since PR 22): gemma2 (2 layers) 4.5-5.3e-3, control
# 2.09e-2; granite-20b (2) 3.9-4.7e-3, control 1.50e-2; granite-moe (32)
# 1.64-1.76e-2, control 6.62e-2; jamba (8) 1.04-1.21e-2, control 2.92e-2.
# 2e-2 let a 2-layer model's control pass, so those hold 1e-2
SERVE_CUT_RTOL = {"gemma2-27b": 1e-2, "granite-20b": 1e-2,
                  "granite-moe-3b-a800m": 2e-2, "jamba-v0.1-52b": 2e-2}
GEMMA_LOSS_RTOL = 1e-3
# gemma2-27b's decode shape in phase 2: 8 slots, lengths up to 8,192
GEMMA_DECODE_LEN = 8192
# phase 3b: gemma2-27b served (8 slots, page 16) from bf16 pools
GEMMA_SERVE_MAX_LEN, GEMMA_SERVE_REQUESTS = 640, 16
GEMMA_SERVE_PROMPT, GEMMA_SERVE_NEW = (32, 512), (16, 64)
GEMMA_SERVE_KEEP_STEPS = (256, 512, 768)    # of 1,040 engine steps
# granite-20b (arXiv:2405.04324: MQA, 48 query heads on one kv head, hd
# 128): its decode shape in phase 2 (8 slots up to 8,192 tokens, bf16
# pools) and phase 3c, served at full width with 2 of its 52 layers, as
# phase 3b serves gemma2
GRANITE_LAYERS = 2
FLASH_TIMED = {   # (B, H, KV, hd, S, dtype, mask, library call or None)
    "gemma2_prefill_global": (1, 32, 16, 128, GEMMA_PREFILL_SEQ, _BF16,
                              dict(causal=True, attn_softcap=50.0), None),
    "gemma2_prefill_local": (1, 32, 16, 128, GEMMA_PREFILL_SEQ, _BF16,
                             dict(causal=True, window=4096,
                                  attn_softcap=50.0), None),
    "train_100m": (TRAIN_BATCH, 12, 12, 64, TRAIN_SEQ, _F32,
                   dict(causal=True), "sdpa"),
    # phases 11c and 12c: granite-moe's and jamba's prefill layers
    "granite_moe_prefill": (1, 24, 8, 64, 4096, _BF16, dict(causal=True),
                            "sdpa"),
    "jamba_prefill": (1, 32, 8, 128, 8192, _BF16,
                      dict(causal=True, window=4096), "sdpa_window"),
    # the float32 kernel's hd-256 instance: 16 heads of 256,
    # as gemma-7b's, causal, float32
    "hd256_f32": (1, 16, 16, 256, 2048, _F32, dict(causal=True), "sdpa"),
    # the benchmark's train.t100m.flash4k cell: one learner's call
    "train_100m_flash4k": (2, 12, 12, 64, 4096, _F32, dict(causal=True),
                           "sdpa"),
}
# the backward kernel against its plain version (the same formulas,
# dense) and autograd through the dense recompute (the route's backward
# before it), on the first FLASH_BWD_KV kv heads of each timed shape so
# the plain versions' (S, S) tensors stay a few GB: float32 per gradient
# within FLASH_GRAD_RTOL_F32 of its largest element, and at least 1e-5
# (the tests' GRAD_RTOL_F32 and GRAD_ATOL); bf16 within one bf16 ulp of
# the plain version (2d's rule) and FLASH_GRAD_RTOL_BF16 (norm) of the
# recompute, which sums D as sum P dP in float32 where the kernel takes
# the bf16-rounded output
FLASH_GRAD_RTOL_F32, FLASH_GRAD_RTOL_BF16 = 1e-5, 1e-2
FLASH_BWD_KV = 2
# the recompute is timed whole where a score tensor holds at most this
# many elements (2.1 GB in float32; its autograd keeps several)
FLASH_BWD_PLAIN_MAX = 2 ** 29
# transformer-100m with use_pallas against phase 4's chunked route
FLASH_TRAIN_WARM, FLASH_TRAIN_TIMED, FLASH_TRAIN_PROF = 2, 4, 2
FLASH_TRAIN_LOSS_RTOL = 1e-5
# phase 4's bridge: the consensus mean against learner_mean, the steps
# trained past the snapshot, the probe prompts of served_divergence
BRIDGE_MEAN_ATOL = 1e-6
BRIDGE_STEPS = 2
BRIDGE_PROBE = (2, 64)
# phases 11-12: granite-moe-3b-a800m at full width, 12 of 32 layers (40
# experts top-8, 24 query heads on 8 kv heads, hd 64; cut from the full
# depth to 16 layers for the run's time limit when phase 17 came, and to
# 12 when 17g-h came; its control at 16 layers read 3.85e-2, at 32
# 6.6e-2, so ~3e-2 at 12, outside the 2e-2 tier) and
# jamba-v0.1-52b at full width, depth cut to one period (8 layers: 7
# mamba, 1 attention with a 4,096 window and no RoPE; 4 MoE layers of 16
# experts top-2), both bf16, served as phase 3b serves gemma2 and
# prefilled through the flash route against the chunked route (the last
# GEMMA_LAST positions within GEMMA_BF16_RTOL)
ZOO = (   # (record key, config, layers, why, prefill length)
    ("serve_granite_moe", "granite-moe-3b-a800m", 12,
     "12 of 32 layers, for the run's time limit", 4096),
    ("serve_jamba", "jamba-v0.1-52b", 8,
     "one period: 7 mamba + 1 attention layers, 4 of them MoE", 8192),
)
# a comparison of two runs of a MoE model shares one run's routing; of the
# tokens, at most this share may have picked another set of experts on
# their own (a router fault changes the set of nearly every token: two
# random top-8 sets of granite-moe's 40 experts agree once in 7.7e7)
ROUTING_SET_CHANGES = 0.25
# phases 13-14: the ssm, vlm and audio families at full width in bf16.
# Each bf16 tier below is held against its control, the same run one
# mantissa bit below bf16 (CoarseBF16): the sound reading within the tier,
# the control's beyond it (``held``).
# 13: xlstm-350m at full width, served with phase 3b's requests at
# XLSTM_LAYERS of its 24 layers (6 mLSTM + 6 sLSTM blocks; cut from the
# full depth for the run's time when phase 17g-h came; card logits
# against the CPU's), decoded token by token against its prefill
# and trained at full depth (4 learners, DPSGD on random_pair,
# examples/train_100m.py's recipe at seq 64: the sLSTM's per-position host
# loop takes ~85 ms a token a step, so seq 256 took ~22 s a step, cut for
# the run's time when phase 18 came)
XLSTM_LAYERS = 12
# bf16 rounding grows with xlstm's depth (card against CPU: 2.0e-3 after
# layer 1, 3.3e-2 after 24; control 0.135: about linear in depth, so ~0.07
# at 12 layers, outside the tier), and the mLSTM's normalizer
# |q . n| amplifies it; decode against prefill compares the chunkwise form
# with the recurrent one (0.080, control 0.192; in float32 8.7e-6 at
# depth 24 on the CPU), so the float32 run is held too
XLSTM_SERVE_RTOL = 5e-2
XLSTM_PREFILL = 64          # prompt of the decode-against-prefill check
XLSTM_DECODE_RTOL = 0.12
XLSTM_DECODE_F32_RTOL = 1e-4
XLSTM_TRAIN_SEQ, XLSTM_TRAIN_STEPS = 64, 1
# 14: qwen2-vl-7b (28 layers) and seamless-m4t-large-v2 (24 + 24) at full
# depth: prefill / encode, then greedy decode_step held against apply on
# the same tokens; then both at full width with depth cut to 2 (2 + 2)
# layers, the card against the port on the CPU (logits and every layer's
# output) on a short input
VLM_TEXT = 1024             # + 1,024 patch embeddings: 2,048 positions
# (64 new tokens before 17g-h came, cut for the run's time)
ZOO_DECODE_SEQS, ZOO_PROMPT, ZOO_NEW = 8, 8, 40
AUDIO_FRAMES = 512
# decode against apply, every step (qwen2-vl 2.1e-2, control 6.3e-2;
# seamless 1.5e-2, control 8.6e-2); 2 layers on the card against the CPU
# (6.6e-3 / 8.1e-3, controls 2.5e-2 / 2.9e-2)
ZOO_DECODE_RTOL = 3e-2
ZOO_PROFILED_STEPS = 8
CUT_LAYERS = 2
CUT_INPUT = 64              # patches + text tokens, or frames + tokens
CUT_RTOL = 1.2e-2
# phase 15: the elastic fleet.  a: transformer-100m at full width with
# phase 4's recipe, ELASTIC_WINDOW steps healthy, as many with learner
# ELASTIC_DEAD dead and as many rejoined; the admitted row against the live
# mean (the same float32 sum over other rows: an f32-ulp tier); b: a
# checkpoint of that fleet, beside a torn newer copy (its first
# CKPT_TORN_BYTES); c: the FC net under supervised fault plans at
# benchmarks/faults.py's settings; d: the Fig. 3 twin
ELASTIC_WINDOW, ELASTIC_DEAD = 1, 1
ADMIT_RTOL = 1e-6
CKPT_TORN_BYTES = 1 << 20
FAULT_N, FAULT_LR, FAULT_BATCH, FAULT_STEPS = 5, 0.5, 200, 60
# a sticky hang under the supervisor's defaults (staleness bound 4, grace
# 2, 2 retries): retried past 8 and 16 silent ticks, evicted past 32
HANG_EVICTED_AT = 4 * 2 * 2 ** 2
# phase 16: the launch path (launch/train.py) on torch.distributed.  a: 4
# gloo ranks sharing the one card (NCCL puts no two ranks of one
# communicator on one device), transformer-100m at full width and depth
# with phase 4's recipe, rank r from its own weights (seed SEED + r):
# (case, steps) DPSGD on random_pair (matchings drawn on the host) and on
# ring (K = 2), AD-PSGD with a 3x straggler; each held against the
# single-process trainer (plain kernels) fed the same batches and tables
# within TRAIN_REF_ATOL.  b: world size 1 over NCCL, an SSGD and a solo
# DPSGD step against the trainer at n = 1, with no host sync
LAUNCH_RANKS = 4
LAUNCH_CASES = (("dpsgd_random_pair", 2), ("dpsgd_ring", 2), ("adpsgd", 3))
LAUNCH_STALENESS, LAUNCH_SLOW, LAUNCH_SLOW_FACTOR = 4, 0, 3
LAUNCH_TIMEOUT_S = 600      # the gloo group's timeout and the phase's wait
# phase 18c: the auditor's launch rules in phase 16's ranks: DPSGD on ring
# with the point-to-point backend, a warm step and one traced
LAUNCH_AUDIT_STEPS = 2
# phase 17: the model axis (launch/train.py with mesh=, launch/shardstore.py,
# models/moe_shardmap.py), 4 gloo ranks sharing the card as in phase 16.
# a: transformer-100m at full width and depth on a (data 2, model 2) mesh
# with phase 4's recipe (local batch 2: one row a model rank), learner i
# from seed SEED + i: (case, steps) DPSGD on ring, SSGD and AD-PSGD (a 3x
# straggler), each learner's gathered store held against the
# single-process trainer at n = 2 (plain kernels) within TRAIN_REF_ATOL.
# b: the sharded probe (MESH_PROBE: Lanczos iterations, Hutchinson
# samples) on a's DPSGD state (stacked) and SSGD state (stacked=False),
# against the single-process probe_landscape with the same draws (its
# reorthogonalization the plain version, as the reference's sharded probe
# runs it): sharpness within MESH_PROBE_RTOL.  c: one granite-moe-3b-a800m
# MoE block at full width (d 1,536, 40 experts top-8, ff 512, bf16) on a
# (1, 4) mesh, MOE_EP_TOKENS tokens (each rank a quarter), forward and
# backward through the expert-parallel all-to-all at a capacity that drops
# nothing (MOE_EP_CF), against the einsum moe_forward on the same rank's
# tokens (MOE_EINSUM_CF drops nothing either): output, dx and the summed
# dw1 within MOE_EP_RTOL, y and dx held against their control.
MESH_SHAPE = (2, 2)
MESH_CASES = (("dpsgd_ring", 2), ("ssgd", 2), ("adpsgd", 2))
MESH_PROBE = (2, 1)
MESH_PROBE_RTOL = 1e-4
MOE_EP_TOKENS, MOE_EP_CF, MOE_EINSUM_CF = 4096, 4.0, 5.0
MOE_EP_RTOL = 8e-3
# d: (case, steps) with gather="period" from a's initial state, each rank's
# shard within MESH_PERIOD_ATOL of a's gather="whole" shard (the same
# float32 operations on the same values; a reduce of two ranks is one
# addition either way)
MESH_PERIOD_CASES = (("dpsgd_ring", 2), ("ssgd", 2))
MESH_PERIOD_ATOL = 1e-6
# e: the sequence-sharded decode on (1, 4): SEQ_DECODE_B sequences, a
# buffer of SEQ_DECODE_BUF rows (a quarter a rank), SEQ_DECODE_STEPS steps
# (past a wrap); transformer-100m in float32 against the single-process
# decode_step on the card (the merge of 4 float32 partials rounds
# otherwise than one softmax), then gemma2-27b at GEMMA_LAYERS in bf16
# over a GEMMA_SEQ_BUF-row buffer (both layers' own: the window is 4,096)
SEQ_DECODE_MESH = (1, 4)
# (256 rows and 264 steps before phase 18 came: cut for the run's time
# to gemma2's buffer; a step's work is a quarter of it a rank)
SEQ_DECODE_B, SEQ_DECODE_BUF, SEQ_DECODE_STEPS = 8, 64, 72
SEQ_DECODE_RTOL = 1e-4
GEMMA_SEQ_BUF, GEMMA_SEQ_STEPS = 64, 72
GEMMA_SEQ_RTOL = 1e-2
# f: the sharded prefill against the single-process flash prefill of the
# same rows (the same kernel on the same gathered weights)
MESH_PREFILL_RTOL = 1e-5
# g: seamless-m4t-large-v2 at full width, AUDIO_MESH_LAYERS encoder and
# decoder layers in bf16, on SEQ_DECODE_MESH: SEQ_DECODE_B sequences of
# AUDIO_FRAMES frames encoded (each model rank its rows, then one
# all-to-all of the cross K/V), a SEQ_DECODE_BUF-row self-attention buffer,
# AUDIO_MESH_STEPS steps, against the single-process decode_step at
# GEMMA_SEQ_RTOL (its control one mantissa bit below bf16); the sharded
# prefill of the frames and AUDIO_MESH_TOKENS tokens on (a)'s mesh against
# the single-process apply of the same rows at MESH_PREFILL_RTOL.  h: the
# probe with gather="period" beside b's "whole" probe, on the same state
# and draws, every field within MESH_PROBE_RTOL of it
AUDIO_MESH_LAYERS, AUDIO_MESH_STEPS, AUDIO_MESH_TOKENS = 2, 32, 64
# jamba's decode shape in phase 2 (H 32 on KV 8, hd 128, window 4,096)
# and granite-moe's (H 24 on KV 8, hd 64), 8 slots up to 8,192 tokens
ZOO_DECODE = {"granite_moe": (24, 8, 64, {}),
              "jamba": (32, 8, 128, {"window": 4096})}
# phase 18: the static auditor (repro_torch.analysis) on the card.  a: the
# trainer's audit at the reference's size (the FC net), then its rules on
# transformer-100m at full width with phase 4's recipe under a controller
# scale (AUDIT_TRAIN_STEPS steps: 1 warm, 1 traced, 2 through run_steps, 3
# in the sentinel window around a scale write and a crash); b: the serve
# engine's paged decode step at full width (phase 3's engine); c: in phase
# 16's ranks; d: the twins of examples/serve_batched.py (its defaults) and
# examples/train_100m.py (full preset, seq 512, TWIN_LEARNERS learners:
# TWIN_STEPS steps and a checkpoint, then a run resumed from it to one
# more step; 2 learners halve the checkpoint phase 15 already times at 4)
AUDIT_TRAIN_STEPS = 7
TWIN_LEARNERS, TWIN_STEPS = 2, 2


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, iters=200) -> float:
    """Mean ms per call over ``iters`` calls cycling through ``arg_sets``
    (copies large enough together to miss the L2, as the serve path's 12
    layers of pools do), timed with CUDA events after a warm-up."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_times(run):
    """Run ``run()`` under torch.profiler; returns ({event name: [device
    us, count]} over the device's events, the same over the host's launch
    and copy API calls, wall seconds, {host op name: [self us, count]}).
    The profiler's own host cost inflates the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out, api, host = {}, {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = out.setdefault(e.name, [0.0, 0])
        elif e.name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy")):
            acc = api.setdefault(e.name, [0.0, 0])
        else:
            acc = host.setdefault(e.name, [0.0, 0])
            acc[0] += e.self_cpu_time_total
            acc[1] += 1
            continue
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    return out, api, wall, host


def per_event_ms(times, kernel_name):
    """(device ms per call, fewest events kept) of the kernels whose name
    holds ``kernel_name`` in a ``device_times`` result: the profiler may
    drop events from a short window, and not evenly across kernels, so
    each kernel's time is divided by its own events, and a call of two
    stages adds the two per-event times."""
    kept = [(v[0] / v[1], v[1]) for k, v in times.items()
            if kernel_name in k and v[1]]
    if not kept:
        return None, 0
    return sum(t for t, _ in kept) / 1e3, min(n for _, n in kept)


# ---------------------------------------------------------------------------
# phase 2: paged decode attention against its plain version
# ---------------------------------------------------------------------------

def paged_operands(S, H, KV, hd, page, max_pages, lengths, seed,
                   dtype=torch.float32, q_scale=1.0):
    """q, the K and V pools, a shuffled page table and the lengths, drawn
    on the card from a torch.Generator seeded with ``seed`` (a host draw
    of gemma2's pools took seconds a shape)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    P = 1 + S * max_pages                   # page 0 = scratch, never mapped
    q = q_scale * torch.randn((S, H, hd), generator=gen, device="cuda")
    kp = torch.randn((P, page, KV, hd), generator=gen, device="cuda")
    vp = torch.randn((P, page, KV, hd), generator=gen, device="cuda")
    table = 1 + torch.randperm(P - 1, generator=gen, device="cuda")
    return [q.to(dtype), kp.to(dtype), vp.to(dtype),
            table.to(torch.int32).reshape(S, max_pages),
            torch.tensor(lengths, dtype=torch.int32, device="cuda")]


def decode_error(got, want, live):
    """(max |got - want| over live slots, max of that over its tier): 1e-5
    for float32; for bf16 the flash phase's rule, 2^-7 |plain| + 1e-3
    rms(plain) per element."""
    g, w = got[live].float(), want[live].float()
    err = (g - w).abs()
    if want.dtype == _BF16:
        tol = (FLASH_BF16_ULP * w.abs()
               + FLASH_BF16_RMS * float(w.pow(2).mean().sqrt()))
    else:
        tol = torch.full_like(w, KERNEL_ATOL)
    return float(err.max()), float((err / tol).max())


def decode_timed(kernel, label, shape, lengths, dtype, kw, seed):
    """Kernel (events and device), plain and SDPA ms at one shape, on pool
    copies that together exceed the L2, with the bound: the larger of the
    live rows' bytes in the pool's dtype and q.k and P.V once each at the
    pool dtype's rate (float32 FMAs, or the bf16 tensor cores); the
    tensor-core kernel's own arithmetic (P.V twice, P = hi + lo in bf16)
    is kept beside it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import kernel_for, launch_plan

    q, kp, vp, table, ln = paged_operands(lengths=lengths, dtype=dtype,
                                          seed=seed, **shape)
    n_copies = 1 + L2_BYTES // (2 * kp.numel() * kp.element_size())
    sets = [(q, kp, vp, table, ln)] + [
        (q, kp.clone(), vp.clone(), table, ln) for _ in range(n_copies - 1)]
    err, ratio = decode_error(kernel(*sets[0], **kw),
                              ref.paged_decode_attention_ref(*sets[0], **kw),
                              ln > 0)
    check(ratio <= 1.0, f"decode {label}: |kernel - plain| reaches {ratio} "
          f"x its tier (max abs {err})")
    kernel_ms = time_ms(lambda *a: kernel(*a, **kw), sets)
    plain_ms = time_ms(lambda *a: ref.paged_decode_attention_ref(*a, **kw),
                       sets[:1], iters=20)

    S, H, hd = q.shape
    KV, page = kp.shape[2], kp.shape[1]
    W = table.shape[1] * page
    pos = torch.arange(W, device="cuda")[None, :]
    valid = pos < ln.long()[:, None]
    if kw.get("window"):
        valid &= pos >= ln.long()[:, None] - kw["window"]

    def gathered(k, v):
        def g(pool):
            return pool[table.long()].reshape(S, W, KV, hd).transpose(1, 2)
        return q[:, :, None, :], g(k), g(v), valid[:, None, None, :]

    lib_sets = [gathered(k, v) for _, k, v, _, _ in sets[:2]]

    def sdpa(qq, kk, vv, mask):
        return torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask, enable_gqa=H != KV)
    library_ms = time_ms(sdpa, lib_sets, iters=50)
    del lib_sets
    times, _, _, _ = device_times(lambda: [kernel(*sets[i % len(sets)], **kw)
                                           for i in range(40)])
    device_ms, n_ev = per_event_ms(times, "paged_decode")

    live = int(valid.sum())
    nbytes = (kp.element_size() * (2 * q.numel() + 2 * live * KV * hd)
              + 4 * (table.numel() + ln.numel()))
    flops = 4 * live * H * hd
    gtiles, splits, pages = launch_plan(
        S, H, KV, hd, kp.element_size(), page, table.shape[1],
        torch.cuda.get_device_properties(0).multi_processor_count)
    route = kernel_for(dtype, H // KV, hd, gtiles)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    t_kernel = (1.5 * flops / BF16_FLOPS if route == "tc"
                else flops / F32_FLOPS)
    bound_ms = 1e3 * max(t_bytes, t_ops)
    del sets
    torch.cuda.empty_cache()
    return {
        "shape": {"S": S, "H": H, "KV": KV, "hd": hd, "page": page,
                  "max_pages": W // page, "dtype": str(dtype)[6:],
                  "lengths": lengths, **kw},
        "kernel": f"paged_decode_{route}",
        "splits": splits, "split_tokens": pages * page,
        "head_tiles": gtiles, "heads_per_block": -(-(H // KV) // gtiles),
        "max_abs_err": err, "max_err_over_tier": ratio,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "device_ms": device_ms,
        "device_events": n_ev, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes": nbytes, "bound_bytes_ms": 1e3 * t_bytes,
        "bound_flops": flops, "bound_ops_ms": 1e3 * t_ops,
        "kernel_ops_ms": 1e3 * t_kernel,
        "share_of_bound": bound_ms / device_ms if device_ms else None,
        "library_ms": library_ms,
    }


def decode_attention_phase():
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import \
        paged_decode_attention_fwd as kernel
    from repro_torch.kernels.decode_attention import launch_plan, split_plan

    lengths = np.linspace(1, MAX_LEN, N_SLOTS).astype(int).tolist()
    g_shape = dict(S=N_SLOTS, H=32, KV=16, hd=128, page=PAGE,
                   max_pages=GEMMA_DECODE_LEN // PAGE)
    g_lengths = np.linspace(1, GEMMA_DECODE_LEN, N_SLOTS).astype(int).tolist()
    # a length-0 and a length-1 slot, and windows whose live range starts
    # inside a split (start = len - 4,096, split boundaries at multiples of
    # the split's tokens)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    _, pages = split_plan(g_shape["max_pages"], PAGE, N_SLOTS, 16, n_sm)
    tok = pages * PAGE
    edge = [0, 1, GEMMA_DECODE_LEN, 4096 + tok // 2, 4096 + tok + 3,
            2 * tok - 1, 2 * tok + 1, GEMMA_DECODE_LEN - 5]
    # phase 3b's own shape (max_len 640: 40 pages, fewer and shorter
    # splits), up to the longest slot it serves (512 prompt + 64 new
    # tokens) and either side of its split boundaries; q scaled so that the
    # cap at 50 binds (checked below)
    s_shape = dict(g_shape, max_pages=GEMMA_SERVE_MAX_LEN // PAGE)
    _, pages = split_plan(s_shape["max_pages"], PAGE, N_SLOTS, 16, n_sm)
    s_tok, s_max = pages * PAGE, sum(x[1] for x in (GEMMA_SERVE_PROMPT,
                                                     GEMMA_SERVE_NEW))
    s_lengths = np.linspace(1, s_max, N_SLOTS).astype(int).tolist()
    s_edge = [0, 1, s_tok - 1, s_tok, s_tok + 1, 2 * s_tok + 1, s_max,
              GEMMA_SERVE_MAX_LEN]
    # granite-20b's decode shape: one kv head for 48 query heads, all in
    # one block (the tensor-core kernel: bf16, 16 <= G <= 128); a
    # length-0 and a length-1 slot and one token either side of its split
    # boundaries
    gr_shape = dict(g_shape, H=48, KV=1)
    _, _, pages = launch_plan(N_SLOTS, 48, 1, 128, 2, PAGE,
                              gr_shape["max_pages"], n_sm)
    gr_tok = pages * PAGE
    gr_edge = [0, 1, gr_tok - 1, gr_tok + 1, 5 * gr_tok, 2 * tok + 1,
               GEMMA_DECODE_LEN - 3, GEMMA_DECODE_LEN]
    # granite-moe's and jamba's decode shapes (phases 11a and 12a): a
    # length-0 and a length-1 slot, one token either side of their split
    # boundaries, and (jamba) windows that start inside a split
    zoo = {}
    for key, (H, KV, hd, kw) in ZOO_DECODE.items():
        shape = dict(g_shape, H=H, KV=KV, hd=hd)
        _, _, pages = launch_plan(N_SLOTS, H, KV, hd, 2, PAGE,
                                  shape["max_pages"], n_sm)
        t = pages * PAGE
        zoo[key] = (shape, kw, [0, 1, t - 1, t + 1, 4096 + t // 2,
                                4096 + t + 3, GEMMA_DECODE_LEN - 3,
                                GEMMA_DECODE_LEN])
    cases = [   # (name, shape, lengths, dtype, mask, q scale)
        ("serve", dict(S=N_SLOTS, H=12, KV=12, hd=64, page=PAGE,
                       max_pages=MAX_LEN // PAGE), lengths, _F32, {}, 1.0),
        ("gqa_softcap", dict(S=N_SLOTS, H=8, KV=2, hd=128, page=PAGE,
                             max_pages=MAX_LEN // PAGE), lengths, _F32,
         dict(attn_softcap=50.0), 1.0),
        ("gqa_window", dict(S=N_SLOTS, H=8, KV=2, hd=128, page=PAGE,
                            max_pages=MAX_LEN // PAGE), lengths, _F32,
         dict(window=64), 1.0),
        ("gemma2_global_bf16", g_shape, g_lengths, _BF16,
         dict(attn_softcap=50.0), 1.0),
        ("gemma2_local_bf16", g_shape, g_lengths, _BF16,
         dict(window=4096, attn_softcap=50.0), 1.0),
        ("gemma2_edges_local_bf16", g_shape, edge, _BF16,
         dict(window=4096, attn_softcap=50.0), 1.0),
        ("gemma2_edges_global_bf16", g_shape, edge, _BF16,
         dict(attn_softcap=50.0), 1.0),
        ("gemma2_serve_global_bf16", s_shape, s_lengths, _BF16,
         dict(attn_softcap=50.0), 8.0),
        ("gemma2_serve_local_bf16", s_shape, s_lengths, _BF16,
         dict(window=4096, attn_softcap=50.0), 8.0),
        ("gemma2_serve_edges_global_bf16", s_shape, s_edge, _BF16,
         dict(attn_softcap=50.0), 8.0),
        ("gemma2_serve_edges_local_bf16", s_shape, s_edge, _BF16,
         dict(window=4096, attn_softcap=50.0), 8.0),
        ("granite_mqa_bf16", gr_shape, g_lengths, _BF16, {}, 1.0),
        ("granite_mqa_edges_bf16", gr_shape, gr_edge, _BF16, {}, 1.0),
    ] + [(f"{key}_{part}bf16", shape, lens, _BF16, kw, 1.0)
         for key, (shape, kw, edges) in zoo.items()
         for part, lens in (("", g_lengths), ("edges_", edges))]
    errs = {}
    for i, (name, shape, lens, dt, kw, q_scale) in enumerate(cases):
        ops = paged_operands(lengths=lens, dtype=dt, seed=SEED + i,
                             q_scale=q_scale, **shape)
        got = kernel(*ops, **kw)
        want = ref.paged_decode_attention_ref(*ops, **kw)
        torch.cuda.synchronize()
        live = ops[4] > 0
        err, ratio = decode_error(got, want, live)
        errs[name] = {"max_abs_err": err, "max_err_over_tier": ratio}
        check(got.dtype == dt, f"{name}: output {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(bool((got[~live] == 0).all()), f"{name}: a length-0 slot is "
              "not 0")
        check(ratio <= 1.0, f"{name}: |kernel - plain| reaches {ratio} x "
              f"its tier (max abs {err})")
        if q_scale != 1.0:
            # the cap's effect on the plain output in units of the tier:
            # a kernel that dropped the cap would miss it by this much
            uncapped = ref.paged_decode_attention_ref(
                *ops, **{**kw, "attn_softcap": 0.0})
            _, effect = decode_error(uncapped, want, live)
            errs[name]["softcap_effect_over_tier"] = effect
            check(effect >= FLASH_CAP_EFFECT_MIN,
                  f"{name}: the softcap moves the output by only {effect} "
                  "x the tier")
            del uncapped
        del ops, got, want
    print(f"decode_attention error per case {json.dumps(errs)}", flush=True)

    timed = {
        "serve_100m_f32": decode_timed(
            kernel, "serve", cases[0][1], lengths, _F32, {}, SEED),
        "gemma2_global_bf16": decode_timed(
            kernel, "gemma2 global", g_shape, g_lengths, _BF16,
            dict(attn_softcap=50.0), SEED + 20),
        "gemma2_local_bf16": decode_timed(
            kernel, "gemma2 local", g_shape, g_lengths, _BF16,
            dict(window=4096, attn_softcap=50.0), SEED + 21),
        "granite_mqa_bf16": decode_timed(
            kernel, "granite", gr_shape, g_lengths, _BF16, {}, SEED + 22),
        **{f"{key}_bf16": decode_timed(kernel, key, shape, g_lengths, _BF16,
                                       kw, SEED + 23 + i)
           for i, (key, (shape, kw, _)) in enumerate(zoo.items())},
    }
    main = timed["serve_100m_f32"]
    return {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:99",
        "tpu_kernel": ("src/repro/kernels/decode_attention.py::"
                       "paged_decode_attention_fwd"),
        "launches": None,
        "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
        "error_per_case": errs,
        "ms": main["ms"], "kernel_ms": main["kernel_ms"],
        "device_ms": main["device_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library": ("torch.nn.functional.scaled_dot_product_attention on "
                    "the already-gathered K/V with the length (and window) "
                    "mask, no softcap (gather excluded)"),
        "ms_is": ("CUDA events over back-to-back wrapper calls (host "
                  "wrapper included); device_ms: the kernel from "
                  "torch.profiler, per call"),
        "shape": main["shape"],
        "per_shape": timed,
    }


# ---------------------------------------------------------------------------
# phase 3: full-width serving
# ---------------------------------------------------------------------------

class Recorder:
    """Wraps ``paged_decode_step``: keeps the first ``keep`` steps' logits
    (once ``on``) and a device-side all-finite flag, read after the run."""

    def __init__(self, step_fn, keep):
        self.step_fn, self.keep = step_fn, keep
        self.on, self.logits, self.finite = False, [], None

    def __call__(self, *args, **kw):
        logits, cache = self.step_fn(*args, **kw)
        if self.on:
            if len(self.logits) < self.keep:
                self.logits.append(logits.clone())
            ok = torch.isfinite(logits).all()
            self.finite = ok if self.finite is None else self.finite & ok
        return logits, cache


class DecodeCapture:
    """Wraps the model's decode-attention entry point: counts its calls and
    keeps a copy of the inputs (the pools as they are at that call) of the
    calls numbered in ``at``."""

    def __init__(self, fn, at):
        self.fn, self.at, self.calls, self.kept = fn, set(at), 0, []

    def __call__(self, q, k_pages, v_pages, page_table, lengths, **kw):
        if self.calls in self.at:
            self.kept.append(([t.clone() for t in (q, k_pages, v_pages,
                                                   page_table, lengths)], kw))
        self.calls += 1
        return self.fn(q, k_pages, v_pages, page_table, lengths, **kw)


class SharedRouting:
    """Wraps ``models.moe.route``.  Mode "record" keeps the expert ids of
    the next ``limit`` calls; mode "replay" routes call i to the ids
    recorded at call i (the gates are this run's own probabilities at those
    experts, renormalized) and counts the tokens whose own top-k would have
    picked another set of experts (``set_changes``) or the same set in
    another order (``order_changes``; the order cannot change the keep
    mask or the output).  A router input one rounding apart can pick
    another expert, a discrete jump that no tolerance on the logits
    absorbs, so a comparison of two runs of a MoE model shares one run's
    routing; a router fault would change the set of almost every token,
    rounding only near-ties, so at most ROUTING_SET_CHANGES of the tokens
    may change their set."""

    def __init__(self, fn, limit=None):
        self.fn, self.limit = fn, limit
        self.mode, self.ids = None, []
        self.replay_from(0)

    def replay_from(self, i):
        self.replayed, self.tokens = i, 0
        self.set_changes = self.order_changes = 0

    def __call__(self, logits, top_k):
        probs, gates, ids = self.fn(logits, top_k)
        if self.mode == "record" and (self.limit is None
                                      or len(self.ids) < self.limit):
            self.ids.append(ids.clone())
        elif self.mode == "replay":
            want = self.ids[self.replayed].to(ids.device)
            self.replayed += 1
            other_set = (want.sort(-1).values
                         != ids.sort(-1).values).any(-1)
            self.set_changes += int(other_set.sum())
            self.order_changes += int(((want != ids).any(-1)
                                       & ~other_set).sum())
            self.tokens += ids.shape[0]
            gates = probs.gather(1, want)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
            ids = want
        return probs, gates, ids

    def record(self):
        return {"routings": self.replayed, "tokens": self.tokens,
                "set_changes": self.set_changes,
                "order_changes": self.order_changes,
                "set_changes_max": ROUTING_SET_CHANGES * self.tokens}

    def check(self, what):
        check(self.set_changes <= ROUTING_SET_CHANGES * self.tokens,
              f"{what}: {self.set_changes} of {self.tokens} tokens would "
              f"have picked another set of experts")


class LayerOutputs:
    """Wraps ``transformer._layer_decode_paged``: once ``on``, keeps each
    layer's output of the first ``keep`` calls (CPU_STEPS steps of every
    layer), so two runs' difference can be read layer by layer."""

    def __init__(self, fn, keep):
        self.fn, self.keep, self.on, self.kept = fn, keep, False, []

    def __call__(self, *args, **kw):
        x = self.fn(*args, **kw)
        if self.on and len(self.kept) < self.keep:
            self.kept.append(x.detach().float().cpu())
        return x


class CoarseBF16(torch.overrides.TorchFunctionMode):
    """Rounds every new bf16 result to one mantissa bit fewer (7
    significant bits, nearest): a run one bit less precise than bf16
    throughout, the control that a bf16 tier must reject.  Views and
    in-place results (storage shared with an argument) pass unchanged, so
    writes through them still reach their base.  A result that requires
    grad keeps its graph (the rounding added as a detached difference),
    so a differentiated run's backward runs on its coarse forward (the
    backward's own products, in autograd's engine, are not rounded)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (isinstance(out, torch.Tensor)
                and out.dtype == torch.bfloat16):
            return out
        ptr = out.untyped_storage().data_ptr()
        if any(isinstance(a, torch.Tensor)
               and a.untyped_storage().data_ptr() == ptr
               for a in (*args, *(kwargs or {}).values())):
            return out
        bits = out.detach().view(torch.int16).to(torch.int32)
        coarse = ((bits + 1) // 2 * 2).to(torch.int16).view(torch.bfloat16)
        if out.requires_grad:   # keep the graph: out + (coarse - out)
            return out + (coarse - out.detach())
        return coarse


def module_on(params, device):
    """A copy of the module ``params`` with every parameter on ``device``,
    copied leaf by leaf (a deepcopy first would hold a second copy on the
    card)."""
    memo = {id(p): torch.nn.Parameter(p.detach().to(device),
                                      requires_grad=p.requires_grad)
            for p in params.parameters()}
    return copy.deepcopy(params, memo)


def layer_counts(cfg):
    """(attention layers, MoE layers) of a model."""
    from repro_torch.models.transformer import n_periods, period_spec
    spec, n = period_spec(cfg), n_periods(cfg)
    return (n * sum(m.startswith("attn") for m, _ in spec),
            n * sum(f == "moe" for _, f in spec))


def requests(vocab, n_requests=N_REQUESTS, prompt=(8, 128), new=(16, 64)):
    """(prompt tokens, max_new_tokens) per request from numpy seed SEED:
    prompt lengths and budgets uniform over the closed ranges given."""
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(n_requests):
        n = int(rng.integers(prompt[0], prompt[1] + 1))
        out.append((rng.integers(1, vocab, n).tolist(),
                    int(rng.integers(new[0], new[1] + 1))))
    return out


def serve_model(cfg, jobs, n_slots, page, max_len, compare, n_prof,
                kernels, capture_at=(), open_loop=False):
    """Serve ``jobs`` through ``ServeEngine`` on the card, then the same
    weights and requests for CPU_STEPS steps on the CPU (plain versions);
    ``compare(card logits, cpu logits)`` returns the step's error and
    raises past its tier.  A bf16 model's CPU steps run once more under
    ``CoarseBF16``, the control; its error is recorded here and held
    against the tier by ``cut_serve_phase``.  A MoE
    model's CPU steps replay the card's routing (``SharedRouting``).  Each
    layer's output at the compared steps is kept on both sides, for the
    error's growth with depth.  The decode-attention calls numbered in
    ``capture_at`` keep their inputs, on which the kernel is then held
    against its plain version (decode_error's tier).  A MoE model adds its
    MoE layers' device time a step, a model with recurrent state the
    advance-mask and ``reset_slot`` checks on the served cache;
    ``open_loop`` adds ``open_loop_drive`` on the same weights.  The
    counts of ``kernels`` are set to 0 just before the served run and read
    just after it.  Returns (record, decode kernel launches)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import \
        paged_decode_attention_fwd as kernel
    from repro_torch.kernels.decode_attention import launch_plan
    from repro_torch.models import attention, build_model, moe, transformer
    from repro_torch.models.transformer import PAGED
    from repro_torch.serve import ServeEngine

    n_attn, n_moe = layer_counts(cfg)
    pin = SharedRouting(moe.route, limit=CPU_STEPS * n_moe)
    if n_moe:
        moe.route = pin
    layers = LayerOutputs(transformer._layer_decode_paged,
                          CPU_STEPS * cfg.n_layers)
    transformer._layer_decode_paged = layers
    try:
        api = build_model(cfg)
        t0 = time.perf_counter()
        params = api.init(SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in params.parameters())
        rec = Recorder(api.paged_decode_step, CPU_STEPS)
        eng = ServeEngine(api._replace(paged_decode_step=rec), params,
                          n_slots=n_slots, page_size=page, max_len=max_len)
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0

        for k in kernels:
            k.launches = 0
        rec.on = layers.on = True
        pin.mode = "record"
        cap = DecodeCapture(attention.paged_decode_attention, capture_at)
        attention.paged_decode_attention = cap
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            reqs = [eng.submit(p, m) for p, m in jobs]
            ends = []           # host clock after each step (ends in a sync)
            while eng.has_work:
                eng.step()
                ends.append(time.perf_counter() - t0)
                check(len(ends) < 10 * max_len * len(jobs),
                      "serve engine wedged")
            torch.cuda.synchronize()
        finally:
            attention.paged_decode_attention = cap.fn
            pin.mode = None
            layers.on = False
        run_s = time.perf_counter() - t0
        launched = {k.__name__: k.launches for k in kernels}
        launches = launched[kernel.__name__]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        step_ms = np.diff([0.0] + ends) * 1e3
        ttft_ms = sorted(1e3 * ends[r.first_token_step] for r in reqs)
        steps, generated = eng.real_steps, eng.generated_total

        check(all(r.done and len(r.generated) == m
                  for r, (_, m) in zip(reqs, jobs)),
              f"{cfg.name}: a request did not finish with its token budget")
        check(bool(rec.finite),
              f"{cfg.name}: non-finite logits in the serve run")
        check(launches == steps * n_attn,
              f"{cfg.name}: kernel launches {launches} != {steps} steps x "
              f"{n_attn} attention layers")
        check(all(v == 0 for k, v in launched.items()
                  if k != kernel.__name__),
              f"the {cfg.name} serving path launched another path's "
              f"kernel: {launched}")

        # the kernel on the kept inputs of the run: these launches compare
        check(len(cap.kept) == len(capture_at), f"{cfg.name}: kept "
              f"{len(cap.kept)} of {len(capture_at)} decode calls")
        decode_checks = []
        for inputs, kw in cap.kept:
            got = kernel(*inputs, **kw)
            want = ops.paged_decode_attention(*inputs, backend="ref", **kw)
            err, ratio = decode_error(got, want, inputs[4] > 0)
            max_len_kept = int(inputs[4].max())
            check(ratio <= 1.0, f"{cfg.name}: on the inputs of serve call "
                  f"with lengths up to {max_len_kept}, |kernel - plain| "
                  f"reaches {ratio} x its tier (max abs {err})")
            decode_checks.append({"max_length": max_len_kept,
                                  "max_abs_err": err,
                                  "max_err_over_tier": ratio, **kw})
        if decode_checks:
            q, k_pool, _, table, _ = cap.kept[0][0]
            _, _, pages = launch_plan(
                q.shape[0], q.shape[1], k_pool.shape[2], q.shape[2],
                q.element_size(), page, table.shape[1],
                torch.cuda.get_device_properties(0).multi_processor_count)
            check(max(c["max_length"] for c in decode_checks)
                  > 2 * pages * page,
                  f"{cfg.name}: no kept call fills three splits of "
                  f"{pages * page} tokens")
        del cap

        # the same weights and requests through the port on the CPU,
        # routed as the card routed (a MoE model); then, for a bf16 model,
        # once more one mantissa bit below bf16
        t0 = time.perf_counter()
        card_layers, layers.kept = layers.kept, []
        cpu_api = build_model(cfg, device="cpu")
        cpu_params = module_on(params, "cpu")

        def cpu_steps(collect):
            cpu_rec = Recorder(cpu_api.paged_decode_step, CPU_STEPS)
            cpu_eng = ServeEngine(cpu_api._replace(paged_decode_step=cpu_rec),
                                  cpu_params, n_slots=n_slots,
                                  page_size=page, max_len=max_len)
            cpu_rec.on, layers.on = True, collect
            pin.mode = "replay"
            pin.replay_from(0)
            for p, m in jobs:
                cpu_eng.submit(p, m)
            for _ in range(CPU_STEPS):
                cpu_eng.step()
            pin.mode, layers.on = None, False
            check(len(cpu_rec.logits) == CPU_STEPS == len(rec.logits),
                  "fewer recorded steps than compared")
            check(pin.replayed == len(pin.ids), f"{cfg.name}: replayed "
                  f"{pin.replayed} of {len(pin.ids)} recorded routings")
            return cpu_rec.logits

        logit_errs = [compare(i, g.cpu(), c) for i, (g, c) in
                      enumerate(zip(rec.logits, cpu_steps(True)))]
        routing = pin.record()
        if n_moe:
            pin.check(f"{cfg.name} serve, CPU against the card")
        depth_errs = [
            _rel(torch.cat(card_layers[i::cfg.n_layers]),
                 torch.cat(layers.kept[i::cfg.n_layers]))
            for i in range(cfg.n_layers)]
        control_rec = None
        if cfg.compute_dtype == "bfloat16":
            with CoarseBF16():
                coarse = cpu_steps(False)
            control_rec = {
                "logit_errs": [_rel(g.cpu(), c)
                               for g, c in zip(rec.logits, coarse)],
                "routing": pin.record() if n_moe else None}
        cpu_s = time.perf_counter() - t0
        del cpu_params, cpu_api

        # where a steady serve step's time goes: n_prof steps of fresh
        # requests
        rec.on = False
        for p, m in jobs[:n_slots]:
            eng.submit(p, m)
        for _ in range(5):
            eng.step()
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        try:
            times, api_calls, wall, _ = device_times(
                lambda: [eng.step() for _ in range(n_prof)])
        finally:
            smi.terminate()
            samples = smi.communicate()[0].split("\n")
        clocks = sorted(float(x.split(",")[0]) for x in samples if "," in x)
        busy_us = sum(v[0] for v in times.values())
        top = sorted(times.items(), key=lambda kv: -kv[1][0])[:8]
        profile = {
            "steps": n_prof,
            "wall_ms_per_step_profiled": 1e3 * wall / n_prof,
            "device_busy_ms_per_step": busy_us / 1e3 / n_prof,
            "device_idle_share": ((1 - busy_us / 1e6 / wall) if busy_us
                                  else None),
            "attention_kernel_ms_per_step": sum(
                v[0] for k, v in times.items()
                if "paged_decode" in k) / 1e3 / n_prof,
            "host_api_ms_per_step": {
                k: [v[0] / 1e3 / n_prof, v[1] / n_prof]
                for k, v in api_calls.items()},
            "sm_clock_mhz_median": (clocks[len(clocks) // 2] if clocks
                                    else None),
            "top_device_ms_per_step": [
                [k[:90], v[0] / 1e3 / n_prof, v[1] / n_prof]
                for k, v in top],
        }
        extra = {}
        if n_moe:
            extra["moe_step"] = moe_profile(api, params, n_slots)
        if any(name not in PAGED for c in eng.cache.values() for name in c):
            extra["recurrent_state"] = recurrent_checks(eng, api, params)
        if open_loop:
            extra["open_loop"] = open_loop_drive(
                api, params, jobs, n_slots, page, max_len, n_attn, kernels)
    finally:
        moe.route = pin.fn
        transformer._layer_decode_paged = layers.fn
    del eng, params
    torch.cuda.empty_cache()

    prompt_tokens = sum(len(p) for p, _ in jobs)
    return {
        "model": cfg.name, "n_layers": cfg.n_layers, "n_params": n_params,
        "dtype": cfg.param_dtype, "init_s": init_s, "n_slots": n_slots,
        "page_size": page, "max_len": max_len, "requests": len(jobs),
        "prompt_tokens": prompt_tokens, "generated_tokens": generated,
        "real_steps": steps, "warmup_s": warmup_s, "run_s": run_s,
        "ms_per_step": 1e3 * run_s / steps,
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_p95": float(np.percentile(step_ms, 95)),
        "step_samples": len(step_ms),
        "ttft_ms_median": float(np.median(ttft_ms)),
        "ttft_ms_max": ttft_ms[-1],
        "tokens_per_s": generated / run_s,
        "fed_tokens_per_s": (prompt_tokens + generated) / run_s,
        "max_memory_allocated_gb": peak_gb,
        "kernel_launches": launched,
        f"cpu_logit_err_first_{CPU_STEPS}_steps": max(logit_errs),
        "cpu_logit_err_per_step": logit_errs,
        "cpu_hidden_rel_err_by_layer": depth_errs,
        "cpu_control_one_bit_below_bf16": control_rec,
        "cpu_reference_s": cpu_s,
        "routing_shared_with_cpu": routing if n_moe else None,
        "decode_kernel_on_kept_serve_calls": decode_checks,
        "profile": profile, **extra,
    }, launches


def open_loop_drive(api, params, jobs, n_slots, page, max_len, n_attn,
                    kernels):
    """The open-loop serving loop of ``benchmarks/serving.py`` on the
    served weights: ``jobs``' first requests, cut to short prompts and
    budgets, each submitted when the engine clock reaches its arrival
    step; ``step`` while the engine has work, ``idle_tick`` otherwise.  The
    counts of ``kernels`` are set to 0 just before the drive and read just
    after it: no idle tick may launch a kernel, and the decode kernel
    launches once per attention layer and model step.  The same requests
    submitted together and run closed-loop must give every request the
    same tokens."""
    from repro_torch.kernels.decode_attention import \
        paged_decode_attention_fwd as kernel
    from repro_torch.serve import ServeEngine

    jobs = [(p[:OPEN_LOOP_PROMPT], min(m, OPEN_LOOP_NEW))
            for p, m in jobs[:len(OPEN_LOOP_ARRIVALS)]]

    def engine():
        e = ServeEngine(api, params, n_slots=n_slots, page_size=page,
                        max_len=max_len)
        e.warmup()
        return e

    eng = engine()
    for k in kernels:
        k.launches = 0
    pending = list(zip(OPEN_LOOP_ARRIVALS, jobs))
    reqs, idle, idle_launches, busy = [], 0, 0, []
    t0 = time.perf_counter()
    while pending or eng.has_work:
        while pending and pending[0][0] <= eng.step_count:
            _, (prompt, max_new) = pending.pop(0)
            reqs.append(eng.submit(prompt, max_new))
        if eng.has_work:
            eng.step()
            busy.append(eng.active_slots)
        else:
            before = sum(k.launches for k in kernels)
            eng.idle_tick()
            idle += 1
            idle_launches += sum(k.launches for k in kernels) - before
        check(eng.step_count < 10 * max_len, "open-loop drive wedged")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k.__name__: k.launches for k in kernels}
    launches = launched[kernel.__name__]
    check(idle > 0 and idle_launches == 0,
          f"open loop: {idle} idle ticks launched {idle_launches} kernels")
    check(launches == eng.real_steps * n_attn,
          f"open loop: decode launches {launches} != {eng.real_steps} "
          f"steps x {n_attn} layers")
    check(all(v == 0 for k, v in launched.items() if k != kernel.__name__),
          f"the open-loop drive launched another path's kernel: {launched}")
    check(eng.step_count == eng.real_steps + idle,
          f"open loop: clock {eng.step_count} != {eng.real_steps} steps + "
          f"{idle} idle ticks")
    check([r.arrival_step for r in reqs] == list(OPEN_LOOP_ARRIVALS)
          and all(r.done for r in reqs),
          f"open loop: arrivals {[r.arrival_step for r in reqs]}")

    closed = engine()
    creqs = [closed.submit(p, m) for p, m in jobs]
    closed.run()
    same = [list(r.generated) == list(c.generated)
            for r, c in zip(reqs, creqs)]
    check(all(same), f"open loop: tokens differ from the closed-loop run's "
          f"for requests {[i for i, x in enumerate(same) if not x]}")
    del eng, closed
    return {
        "arrival_steps": list(OPEN_LOOP_ARRIVALS),
        "first_token_steps": [r.first_token_step for r in reqs],
        "finish_steps": [r.finish_step for r in reqs],
        "prompt_tokens": [len(p) for p, _ in jobs],
        "generated_tokens": [len(r.generated) for r in reqs],
        "engine_steps": len(busy) + idle,
        "real_steps": len(busy), "idle_ticks": idle,
        "kernel_launches_on_idle_ticks": idle_launches,
        "decode_launches": launches, "max_active_slots": max(busy),
        "wall_s": wall,
        "tokens_equal_closed_loop": all(same),
    }


def serve_phase(kernels):
    from repro_torch.configs import get_config

    def compare(i, g, c):
        err = float((g - c).abs().max())
        check(torch.allclose(g, c, atol=LOGIT_TOL, rtol=LOGIT_TOL),
              f"step {i}: card logits differ from the CPU's by {err}")
        return err

    cfg = get_config("transformer-100m")
    return serve_model(cfg, requests(cfg.vocab), N_SLOTS, PAGE, MAX_LEN,
                       compare, n_prof=20, kernels=kernels, open_loop=True)


def cut_serve_phase(name, n_layers, why, kernels, tier=None):
    """Phases 3b, 3c, 11b, 12b and 13a: ``name`` at full width, depth cut
    to ``n_layers``, served from pools in its own dtype (bf16) with phase
    3b's requests; card logits held to the CPU's in the Frobenius norm
    within ``tier`` (default ``SERVE_CUT_RTOL[name]``) and the control one
    mantissa bit below bf16 beyond it (``held``), and the decode kernel on
    the inputs of every attention layer at three steps spread over the
    run."""
    from repro_torch.configs import get_config

    tier = SERVE_CUT_RTOL[name] if tier is None else tier

    def compare(i, g, c):
        rel = _rel(g, c)
        check(rel <= tier,
              f"{name} serve step {i}: card logits differ from the CPU's "
              f"by {rel} relative (Frobenius)")
        return rel

    full = get_config(name)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    jobs = requests(cfg.vocab, GEMMA_SERVE_REQUESTS, GEMMA_SERVE_PROMPT,
                    GEMMA_SERVE_NEW)
    n_attn, _ = layer_counts(cfg)
    at = [n_attn * step + layer for step in GEMMA_SERVE_KEEP_STEPS
          for layer in range(n_attn)]
    record, launches = serve_model(cfg, jobs, N_SLOTS, PAGE,
                                   GEMMA_SERVE_MAX_LEN, compare, n_prof=10,
                                   kernels=kernels, capture_at=at)
    record["reduced"] = {"n_layers": f"{full.n_layers} -> {n_layers} "
                                     f"({why}; every width kept)"}
    record["heads"] = {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                       "head_dim": cfg.head_dim_}
    record["window"] = cfg.window
    record["logit_tier"] = f"||card - cpu|| / ||cpu|| <= {tier}"
    record["serve_tier"] = held(
        f"{name} serve, card against CPU",
        max(record["cpu_logit_err_per_step"]),
        min(record["cpu_control_one_bit_below_bf16"]["logit_errs"]), tier)
    return record, launches


# ---------------------------------------------------------------------------
# phase 2b: the gossip update against its plain version
# ---------------------------------------------------------------------------

def _cuda_arrays(*arrays):
    return [None if a is None else
            torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


def _bits_equal(a, b) -> bool:
    """Bitwise equality, NaN payloads included."""
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _max_err(a, b) -> float:
    d = (a - b).abs()
    both_nan = torch.isnan(a) & torch.isnan(b)
    return float(torch.where(both_nan, 0.0, d).nan_to_num(nan=float("inf"))
                 .max())


def gossip_cases():
    """The six cases of the gossip kernel's check, as (name, kwargs of
    ops.flat_gossip_update, rows that must come back bitwise unchanged).
    The stores are drawn on the card from a seeded torch.Generator (a
    host draw of the ~4 G values took most of the phase); the tables are
    built on the host."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    T_train, T = TRAIN_ROWS, CASE_ROWS

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    out = []
    # (a) the training shape: sync DPSGD, remote = w, a random matching
    n = TRAIN_LEARNERS
    w, g, mu = normal(n, T_train, 128), normal(n, T_train, 128), \
        normal(n, T_train, 128)
    partner = np.array([2, 3, 0, 1])
    coefs = np.tile([0.5, 0.5, 1.0, 1.0], (n, 1)).astype(np.float32)
    p, c = _cuda_arrays(partner[None].astype(np.int32), coefs)
    out.append(("a_train_shape", dict(w=w, remote=w, grads=g, momentum=mu,
                                      partners=p, coefs=c, lr=TRAIN_LR,
                                      beta=0.9), []))
    # (b) ring K=2, no momentum, weight decay; learner 4 inactive, its
    # weights and gradient NaN (its ring neighbours 3 and 5 read it)
    n = 8
    w, g = normal(n, T, 128), normal(n, T, 128)
    w[4], g[4] = float("nan"), float("nan")
    idx = np.arange(n)
    partners = np.stack([(idx + 1) % n, (idx - 1) % n]).astype(np.int32)
    active = np.ones(n)
    active[4] = 0.0
    coefs = np.concatenate([np.full((n, 3), 1.0 / 3.0),
                            np.linspace(0.5, 1.5, n)[:, None],
                            active[:, None]], axis=1).astype(np.float32)
    p, c = _cuda_arrays(partners, coefs)
    out.append(("b_ring_wd_nan", dict(w=w, remote=w, grads=g, momentum=None,
                                      partners=p, coefs=c, lr=0.1,
                                      weight_decay=1e-4), [4]))
    # (c) AD-PSGD publish mode, K=1, active / nbr_fresh / publish mixed
    n = 8
    w, g, mu, buf = (normal(n, T, 128) for _ in range(4))
    partner = np.array([1, 0, 3, 2, 5, 4, 7, 6])
    active = np.array([0, 1, 1, 1, 0, 1, 1, 1], np.float32)
    fresh = np.array([0, 1, 1, 0, 0, 0, 1, 1], np.float32)
    coefs = np.concatenate(
        [np.tile([0.5, 0.5], (n, 1)), np.ones((n, 1)), active[:, None],
         fresh[partner][:, None], np.maximum(active, fresh)[:, None]],
        axis=1).astype(np.float32)
    p, c = _cuda_arrays(partner[None].astype(np.int32), coefs)
    out.append(("c_publish", dict(w=w, remote=w, grads=g, momentum=mu,
                                  partners=p, coefs=c, lr=0.1, beta=0.9,
                                  buffer=buf), [0, 4]))
    # (d) a mixing-only round: lr = 0, K = 3 (the exponential graph, n=8)
    from repro_torch.core.schedule import make_schedule
    sched = make_schedule("exp", n)
    (partners, mix), = sched.step_rounds(None, 0)
    w = normal(n, T, 128)
    coefs = np.concatenate([mix.numpy(), np.ones((n, 2))],
                           axis=1).astype(np.float32)
    p, c = _cuda_arrays(partners.numpy(), coefs)
    out.append(("d_mix_only_exp", dict(w=w, remote=w, grads=w, momentum=None,
                                       partners=p, coefs=c, lr=0.0), []))
    # (e) the launch path's DPSGD on the ring (phase 16): one rank's row,
    # n = 1, its two received neighbour rows as a (2, T, 128) remote
    w, g, mu, remote = normal(1, T_train, 128), normal(1, T_train, 128), \
        normal(1, T_train, 128), normal(2, T_train, 128)
    coefs = np.array([[1 / 3, 1 / 3, 1 / 3, 1.0, 1.0]], np.float32)
    p, c = _cuda_arrays(np.array([[0], [1]], np.int32), coefs)
    out.append(("e_launch_ring_n1", dict(w=w, remote=remote, grads=g,
                                         momentum=mu, partners=p, coefs=c,
                                         lr=TRAIN_LR, beta=0.9), []))
    # (f) the launch path's AD-PSGD tick (phase 16): publish mode at n = 1,
    # the partner's chosen row received as a (1, T, 128) remote, fresh
    w, g, mu, remote, buf = (normal(1, T_train, 128) for _ in range(5))
    coefs = np.array([[0.5, 0.5, 1.0, 1.0, 1.0, 1.0]], np.float32)
    p, c = _cuda_arrays(np.array([[0]], np.int32), coefs)
    out.append(("f_launch_publish_n1", dict(w=w, remote=remote, grads=g,
                                            momentum=mu, partners=p,
                                            coefs=c, lr=TRAIN_LR, beta=0.9,
                                            buffer=buf), []))
    return out


def gossip_phase():
    from repro_torch.kernels import ops
    from repro_torch.kernels.gossip_mix import gossip_mix_update_flat

    errs, cases = {}, gossip_cases()
    for name, kw, frozen in cases:
        mu = kw["momentum"]
        buf = kw.get("buffer")
        plain_kw = dict(kw, momentum=None if mu is None else mu.clone())
        want = ops.flat_gossip_update(**plain_kw, backend="ref")
        before = gossip_mix_update_flat.launches
        got = ops.flat_gossip_update(**dict(kw, momentum=None if mu is None
                                            else mu.clone()), backend="cuda")
        torch.cuda.synchronize()
        check(gossip_mix_update_flat.launches == before + 1,
              f"{name}: the kernel did not launch")
        err = 0.0
        for a, b in zip(got, want):
            if a is None:
                continue
            err = max(err, _max_err(a, b))
            check(_bits_equal(a, b) or err <= GOSSIP_ATOL,
                  f"{name}: max |kernel - plain| {err} > {GOSSIP_ATOL}")
        for r in frozen:             # inactive rows come back unchanged
            check(_bits_equal(got[0][r], kw["w"][r]),
                  f"{name}: inactive learner {r} changed")
            if buf is not None and not bool(kw["coefs"][r, -1] > 0.5):
                check(_bits_equal(got[2][r], buf[r]),
                      f"{name}: learner {r} published")
        if name == "b_ring_wd_nan":
            far = [i for i in range(8) if i not in (3, 4, 5)]
            check(bool(torch.isfinite(got[0][far]).all()),
                  f"{name}: NaN leaked past the ring neighbours")
        errs[name] = err
    print(f"gossip_mix max_abs_err per case {json.dumps(errs)}", flush=True)

    # the launch path's shapes (n = 1, a received remote stack): kernel and
    # plain version by CUDA events, bound by the rows read and written
    launch_shapes = {}
    for name, kw, _ in cases[4:]:
        row_bytes = kw["w"].numel() * 4
        # in: w, g, mu and the remote rows; out: w', mu' and, publishing
        # with a fresh partner (case f), buffer' (the old buffer unread)
        rows = 3 + kw["remote"].shape[0] + 2 + ("buffer" in kw)
        launch_shapes[name] = {
            "ms": time_ms(lambda: ops.flat_gossip_update(**kw,
                                                         backend="cuda"),
                          [()], iters=20),
            "plain_ms": time_ms(lambda: ops.flat_gossip_update(
                **kw, backend="ref"), [()], iters=3),
            "bound_ms": 1e3 * rows * row_bytes / HBM_BYTES_PER_S,
            "remote_rows": kw["remote"].shape[0],
            "publish": "buffer" in kw}
    print(f"gossip_mix at the launch path's shapes "
          f"{json.dumps(launch_shapes)}", flush=True)

    # timing at the training shape: each buffer alone is 43x the L2
    _, kw, _ = cases[0]
    del cases
    out = torch.empty_like(kw["w"])

    def kernel(**k):
        return gossip_mix_update_flat(
            k["w"], k["remote"], k["grads"], k["momentum"], k["partners"],
            k["coefs"], lr=k["lr"], beta=k["beta"], out=out)

    def plain(**k):
        from repro_torch.kernels import ref
        return ref.gossip_mix_update_flat_ref(
            k["w"], k["remote"], k["grads"], k["momentum"], k["partners"],
            k["coefs"], lr=k["lr"], beta=k["beta"])

    kernel_ms = time_ms(lambda: kernel(**kw), [()], iters=50)
    plain_ms = time_ms(lambda: plain(**kw), [()], iters=5)
    times, _, _, _ = device_times(lambda: [kernel(**kw)
                                           for _ in range(20)])
    dev = [v for k, v in times.items() if "gossip_mix_kernel" in k]
    device_ms = dev[0][0] / dev[0][1] / 1e3 if dev else None

    w = kw["w"]
    # distinct tensors the function must read once and write once: w (also
    # the remote), g and mu in; w' and mu out
    nbytes = 5 * w.numel() * 4 + kw["partners"].numel() * 4 + \
        kw["coefs"].numel() * 4
    flops = 6 * w.numel()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    n, T, _ = w.shape
    return {
        "name": "gossip_mix_update_flat",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gossip_mix.cu",
        "replaces": "src/repro/kernels/gossip_mix.py:252",
        "tpu_kernel": "src/repro/kernels/gossip_mix.py::"
                      "gossip_mix_update_flat",
        "launches": None,
        "max_abs_err": max(errs.values()),
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes": nbytes,
        "library_ms": None,
        "library": ("none: no single PyTorch call computes a neighbour "
                    "gather, a momentum update and a masked select in one "
                    "pass"),
        "shape": {"n": n, "T": T, "K": 1, "momentum": True,
                  "remote": "w"},
        "launch_shapes": launch_shapes,
    }


# ---------------------------------------------------------------------------
# phase 2c: the reorthogonalization kernels against their plain versions
# ---------------------------------------------------------------------------

def reorth_operands(M, T, live, seed, orthonormal=False):
    """(basis, w, mask) on the card: unit basis rows (a QR's orthonormal
    rows when asked; random rows are orthogonal to ~1/sqrt(T * 128)), and a
    candidate w with large components along the live rows, as a Lanczos
    candidate has."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if orthonormal:
        q, _ = torch.linalg.qr(torch.randn((T * 128, M), device="cuda",
                                           generator=gen))
        basis = q.t().contiguous().view(M, T, 128)
    else:
        basis = torch.randn((M, T, 128), device="cuda", generator=gen)
        basis /= torch.linalg.norm(basis.view(M, -1), dim=1)[:, None, None]
    w = torch.randn((T, 128), device="cuda", generator=gen)
    coef = torch.linalg.norm(w) * torch.linspace(1.0, 3.0, M, device="cuda")
    w += torch.einsum("m,mtl->tl", coef, basis)
    mask = (torch.arange(M, device="cuda") < live).float()
    return basis, w, mask


def reorth_phase():
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.reorth import reorth_axpy, reorth_dots

    cases = [("probe_100m", REORTH_M, TRAIN_ROWS, REORTH_M, False),
             ("ragged_T", 5, 100_003, 5, False),
             ("m1", 1, CASE_ROWS, 1, False),
             ("partial_mask", 6, CASE_ROWS, 3, False),
             ("orthonormal_qr", 8, 8_191, 8, True)]
    errs = {}
    for i, (name, M, T, live, ortho) in enumerate(cases):
        basis, w, mask = reorth_operands(M, T, live, SEED + i, ortho)
        before = (reorth_dots.launches, reorth_axpy.launches)
        d_k = reorth_dots(basis, w, mask)
        d_p = ref.reorth_dots_ref(basis, w, mask)
        w_k = reorth_axpy(w, basis, d_p)
        w_p = ref.reorth_axpy_ref(w, basis, d_p)
        w2 = ops.reorthogonalize(basis, w, mask)
        torch.cuda.synchronize()
        check((reorth_dots.launches, reorth_axpy.launches)
              == (before[0] + 3, before[1] + 3),
              f"{name}: the reorth kernels did not launch")
        scale = torch.linalg.norm(basis.view(M, -1), dim=1) * \
            torch.linalg.norm(w)
        dots_err = float(((d_k - d_p).abs() / scale).max())
        axpy_err = _max_err(w_k, w_p)
        resid = float((torch.einsum("mtl,tl->m", basis, w2) * mask)
                      .abs().max() / torch.linalg.norm(w2))
        errs[name] = {"M": M, "T": T, "live": live,
                      "dots_err_rel_to_norms": dots_err,
                      "axpy_max_abs_diff": axpy_err,
                      "cgs2_residual_rel": resid}
        check(bool(torch.isfinite(w2).all()), f"{name}: non-finite CGS2")
        check(dots_err <= REORTH_DOTS_RTOL,
              f"{name}: dots differ by {dots_err} of ||v|| ||w|| > "
              f"{REORTH_DOTS_RTOL}")
        check(_bits_equal(w_k, w_p) and axpy_err <= REORTH_AXPY_ATOL,
              f"{name}: axpy differs from its plain version by {axpy_err}")
        check(resid < REORTH_RESIDUAL,
              f"{name}: CGS2 residual {resid} of ||w|| >= {REORTH_RESIDUAL}")
        if name != "probe_100m":
            del basis, w, mask, d_k, d_p, w_k, w_p, w2
    print(f"reorth per case {json.dumps(errs)}", flush=True)

    # timing at the probe shape: each vector (541 MB) is 10x the L2
    basis, w, mask = reorth_operands(REORTH_M, TRAIN_ROWS, REORTH_M, SEED)
    M, T, _ = basis.shape
    dots = ref.reorth_dots_ref(basis, w, mask)
    out = torch.empty_like(w)
    flat_b, flat_w = basis.view(M, -1), w.view(-1)
    timed = {
        "reorth_dots": (lambda: reorth_dots(basis, w, mask),
                        lambda: ref.reorth_dots_ref(basis, w, mask),
                        lambda: torch.mv(flat_b, flat_w)),
        "reorth_axpy": (lambda: reorth_axpy(w, basis, dots, out=out),
                        lambda: ref.reorth_axpy_ref(w, basis, dots),
                        lambda: torch.addmv(flat_w, flat_b.t(), dots,
                                            alpha=-1)),
    }
    times, _, _, _ = device_times(lambda: [
        (reorth_dots(basis, w, mask), reorth_axpy(w, basis, dots, out=out))
        for _ in range(20)])
    # per call: both stages of the dots, each over its own events
    dev = {name: per_event_ms(times, name)
           for name in ("reorth_dots", "reorth_axpy")}
    vec = T * 128 * 4
    need = {   # bytes each function must move, flops it must do
        "reorth_dots": ((M + 1) * vec + 2 * M * 4, 2 * M * T * 128),
        "reorth_axpy": ((M + 2) * vec + M * 4, 2 * M * T * 128),
    }
    library = {
        "reorth_dots": "torch.mv(basis.view(M, -1), w.view(-1)) (cuBLAS; "
                       "no mask)",
        "reorth_axpy": "torch.addmv(w.view(-1), basis.view(M, -1).t(), "
                       "dots, alpha=-1) (cuBLAS)",
    }
    records = []
    for name, (kern, plain, lib) in timed.items():
        nbytes, flops = need[name]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        kernel_ms = time_ms(kern, [()], iters=20)
        records.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/reorth.cu",
            "replaces": ("src/repro/kernels/reorth.py:90" if name ==
                         "reorth_dots" else
                         "src/repro/kernels/reorth.py:118"),
            "tpu_kernel": f"src/repro/kernels/reorth.py::{name}",
            "launches": None,
            "max_abs_err": max(
                e["dots_err_rel_to_norms"] if name == "reorth_dots"
                else e["axpy_max_abs_diff"] for e in errs.values()),
            "max_abs_err_is": ("max |kernel - plain| / (||v_k|| ||w||)"
                               if name == "reorth_dots" else
                               "max |kernel - plain| given the same dots"),
            "ms": kernel_ms,
            "kernel_ms": kernel_ms,
            "device_ms": dev[name][0],
            "device_events": dev[name][1],
            "plain_ms": time_ms(plain, [()], iters=5),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes,
            "library_ms": time_ms(lib, [()], iters=20),
            "library": library[name],
            "shape": {"M": M, "T": T, "live": REORTH_M},
        })
    return records


# ---------------------------------------------------------------------------
# phase 4: full-width training
# ---------------------------------------------------------------------------

def _train_100m_trainer(api, backend, algo="dpsgd", engine="auto"):
    """Phase 4's trainer: the recipe of ``repro_torch.train_100m`` (the
    twin of ``examples/train_100m.py``) at TRAIN_LEARNERS learners."""
    from repro_torch import train_100m
    return train_100m.make_trainer(
        api, train_100m.recipe(TRAIN_LR), learners=TRAIN_LEARNERS,
        algo=algo, alpha_for_diag=TRAIN_LR, kernel_backend=backend,
        engine=engine)


def train_100m(kernels, warm, timed, prof, use_pallas=False,
               keep_after_warm=False, algo="dpsgd", dtype="float32"):
    """Train transformer-100m with phase 4's recipe (``algo`` on the engine
    ``auto`` routes it to, parameters and compute in ``dtype``) for
    ``warm`` warm-up, ``timed`` timed and ``prof`` profiled steps, every
    launch count set to 0 just before the first; checks that every loss is
    finite and that the gossip kernel launched once per round on the
    fused flat engine (and never elsewhere).  Returns the run's pieces,
    with a copy of the store after the warm-up when ``keep_after_warm``."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, SyntheticTokenStream
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("transformer-100m"),
                              use_pallas=use_pallas, param_dtype=dtype,
                              compute_dtype=dtype)
    api = build_model(cfg)
    tree = api.param_tree(api.init(SEED))
    steps = warm + timed + prof
    loader = ShardedLoader(SyntheticTokenStream(vocab=cfg.vocab),
                           n_learners=TRAIN_LEARNERS,
                           local_batch=TRAIN_BATCH, extra_args=(TRAIN_SEQ,),
                           seed=SEED)
    t0 = time.perf_counter()
    batches = [loader.batch(i) for i in range(steps)]     # set-up, not timed
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0

    trainer = _train_100m_trainer(api, "auto", algo=algo)
    state = trainer.init(SEED, tree)
    if trainer.is_flat:
        check(state.params.shape[1] == TRAIN_ROWS,
              f"the flat store has {state.params.shape[1]} rows, the "
              f"gossip check ran at {TRAIN_ROWS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    metrics = []

    def run(lo, hi):
        nonlocal state
        for i in range(lo, hi):
            state, m = trainer.train_step(state, batches[i])
            metrics.append(m)

    run(0, warm)
    after_warm = state.params.clone() if keep_after_warm else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(warm, warm + timed)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / timed
    times, api_calls, wall, host = device_times(
        lambda: run(warm + timed, steps))
    launches = {k.__name__: k.launches for k in kernels}

    losses = torch.stack([m.loss for m in metrics]).tolist()
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    want = steps * trainer.rounds_per_step if trainer.is_fused else 0
    check(launches["gossip_mix_update_flat"] == want,
          f"gossip kernel launches {launches['gossip_mix_update_flat']} != "
          f"{want} ({steps} steps x {trainer.rounds_per_step} rounds, "
          f"fused: {trainer.is_fused})")
    tokens = TRAIN_LEARNERS * TRAIN_BATCH * TRAIN_SEQ
    return SimpleNamespace(
        cfg=cfg, api=api, tree=tree, loader=loader, batches=batches,
        trainer=trainer, state=state, metrics=metrics, losses=losses,
        after_warm=after_warm, steps=steps, data_s=data_s,
        step_ms=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
        launches=launches,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile=train_profile(times, api_calls, wall, host, prof))


def train_profile(times, api_calls, wall, host, n):
    """Per-step figures of ``n`` profiled steps from ``device_times``."""
    busy_us = sum(v[0] for v in times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:8]
    top_host = sorted(host.items(), key=lambda kv: -kv[1][0])[:10]
    out = {
        "steps": n,
        "wall_ms_per_step_profiled": 1e3 * wall / n,
        "device_busy_ms_per_step": busy_us / 1e3 / n,
        "device_idle_share": (1 - busy_us / 1e6 / wall) if busy_us
        else None,
        "top_device_ms_per_step": [
            [k[:90], v[0] / 1e3 / n, v[1] / n] for k, v in top],
        "device_kernels_per_step": sum(v[1] for v in times.values()) / n,
        "host_api_ms_per_step": {
            k: [v[0] / 1e3 / n, v[1] / n] for k, v in api_calls.items()},
        "top_host_self_ms_per_step": [
            [k[:60], v[0] / 1e3 / n, v[1] / n] for k, v in top_host],
    }
    for label, name in (("gossip_kernel", "gossip_mix_kernel"),
                        ("flash_kernel", "flash_attention")):
        k_us = sum(v[0] for k, v in times.items() if name in k)
        out[f"{label}_ms_per_step"] = k_us / 1e3 / n
        out[f"{label}_share_of_device"] = k_us / busy_us if busy_us else None
    return out


def train_phase(kernels):
    run = train_100m(kernels, WARM_STEPS, TIMED_STEPS, PROF_STEPS,
                     keep_after_warm=True)
    launches = run.launches
    check(all(v == 0 for k, v in launches.items()
              if k != "gossip_mix_update_flat"),
          f"the training path launched another path's kernel: {launches}")
    n_params = sum(t.numel() for t in _leaves(run.tree))
    sigma = float(run.metrics[-1].sigma_w_sq)
    probe, probe_launches = probe_phase(run.trainer, run.state, run.api,
                                        run.loader, kernels)
    bridge, bridge_launches = bridge_phase(run, kernels)
    del run.trainer, run.state, run.metrics
    torch.cuda.empty_cache()

    # the same first steps through the plain version on the card
    ref_trainer = _train_100m_trainer(run.api, "ref")
    ref_state = ref_trainer.init(SEED, run.tree)
    for i in range(REF_STEPS):
        ref_state, _ = ref_trainer.train_step(ref_state, run.batches[i])
    ref_err = float((ref_state.params - run.after_warm).abs().max())
    check(ref_err <= TRAIN_REF_ATOL,
          f"kernel and plain training differ by {ref_err} after "
          f"{REF_STEPS} steps")
    del ref_trainer, ref_state, run.after_warm
    torch.cuda.empty_cache()

    return {
        "model": run.cfg.name, "n_params": n_params,
        "learners": TRAIN_LEARNERS, "local_batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "algo": "dpsgd", "topology": "random_pair",
        "lr": TRAIN_LR, "steps": run.steps, "data_setup_s": run.data_s,
        "ms_per_step": run.step_ms, "timed_steps": TIMED_STEPS,
        "tokens_per_s": run.tokens_per_s,
        "profile": run.profile,
        "max_memory_allocated_gb": run.peak_gb,
        "losses": run.losses, "sigma_w_sq": sigma,
        "kernel_launches": launches,
        "ref_backend_max_abs_diff_after_2_steps": ref_err,
        "bridge": bridge,
    }, launches["gossip_mix_update_flat"], probe, probe_launches, \
        bridge_launches


def bridge_phase(run, kernels):
    """Phase 4's consensus bridge: snapshot the trained learners' mean,
    serve phase 3's requests from it, train BRIDGE_STEPS more steps, then
    the staleness and the served divergence.  Returns (record, launches
    by kernel)."""
    from repro_torch.core.util import learner_mean
    from repro_torch.serve import (ConsensusBridge, ServeEngine,
                                   served_divergence)
    from repro_torch.tree import tree_leaves

    for k in kernels:
        k.launches = 0
    api, trainer, state = run.api, run.trainer, run.state
    bridge = ConsensusBridge(trainer)
    snap = bridge.snapshot(state)
    mean_err = max(float((a - b.float()).abs().max()) for a, b in zip(
        tree_leaves(snap.params),
        tree_leaves(learner_mean(trainer.params_tree(state)))))
    check(snap.step == run.steps and snap.n_active == TRAIN_LEARNERS,
          f"bridge snapshot at step {snap.step} of {snap.n_active}")
    check(mean_err <= BRIDGE_MEAN_ATOL,
          f"the snapshot differs from learner_mean by {mean_err}")
    eng = ServeEngine(api, api.params_from_tree(snap.params),
                      n_slots=N_SLOTS, page_size=PAGE, max_len=MAX_LEN)
    jobs = requests(api.cfg.vocab)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, m) for p, m in jobs]
    eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    check(all(r.done and len(r.generated) == m
              for r, (_, m) in zip(reqs, jobs)),
          "bridge: a request did not finish with its token budget")
    losses = []
    for i in range(BRIDGE_STEPS):
        state, m = trainer.train_step(state, run.loader.batch(run.steps + i))
        losses.append(float(m.loss))
    stale = bridge.staleness(state, snap)
    check(stale["steps_behind"] == BRIDGE_STEPS
          and all(np.isfinite(v) for v in stale.values())
          and all(np.isfinite(losses)),
          f"bridge staleness {stale}, losses {losses}")
    live = bridge.snapshot(state)
    probe = torch.from_numpy(np.random.default_rng(SEED).integers(
        1, api.cfg.vocab, BRIDGE_PROBE)).cuda()
    div = served_divergence(api, snap.params, live.params, probe)
    check(0.0 <= div["top1_agreement"] <= 1.0
          and all(np.isfinite(v) for v in div.values()),
          f"served divergence {div}")
    launches = {k.__name__: k.launches for k in kernels}
    check(launches["gossip_mix_update_flat"]
          == BRIDGE_STEPS * trainer.rounds_per_step
          and launches["paged_decode_attention_fwd"]
          == eng.real_steps * api.cfg.n_layers
          and sum(launches.values()) == launches["gossip_mix_update_flat"]
          + launches["paged_decode_attention_fwd"],
          f"bridge launches {launches}")
    del eng, snap, live
    torch.cuda.empty_cache()
    return {"snapshot_step": run.steps,
            "snapshot_mean_max_abs_diff_vs_learner_mean": mean_err,
            "consensus_dist_snapshot": stale["consensus_dist_snapshot"],
            "served_requests": len(jobs), "serve_s": serve_s,
            "generated_tokens": sum(len(r.generated) for r in reqs),
            "steps_after_snapshot": BRIDGE_STEPS, "losses_after": losses,
            "staleness": stale, "served_divergence": div,
            "probe_tokens": list(BRIDGE_PROBE),
            "kernel_launches": launches}, launches


def probe_phase(trainer, state, api, loader, kernels):
    """The full-width landscape probe on the trained state, through the
    trainer's probe seam, then its Lanczos with the plain reorth from the
    same start vector, and ``trainer.diagnostics``.  Returns (record,
    {kernel: launches})."""
    from repro_torch.core.util import learner_mean
    from repro_torch.kernels.reorth import reorth_axpy, reorth_dots
    from repro_torch.landscape import (ProbeSchedule, lanczos_pytree,
                                       make_trainer_probe, sharpness)
    from repro_torch.landscape.probe import probe_seed

    def probe_fn(reorth):
        return make_trainer_probe(
            api.loss_fn, alpha=TRAIN_LR, lanczos_iters=PROBE_ITERS,
            hutchinson_samples=PROBE_SAMPLES, seed=SEED, reorth=reorth,
            params_from_tree=api.params_from_tree)

    batch = loader.batch(10_000)        # the superbatch, 4 x 2 x 512 tokens
    trainer.add_probe("landscape", ProbeSchedule(every=1), probe_fn("auto"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu,clocks.sm",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        state, results = trainer.run_probes(state, batch, step=state.step)
        torch.cuda.synchronize()
        probe_s = time.perf_counter() - t0
    finally:
        smi.terminate()
        samples = smi.communicate()[0].split("\n")
    launches = {k.__name__: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainer.hooks.clear()
    res = results["landscape"]
    util = [float(x.split(",")[0]) for x in samples if "," in x]
    clocks = sorted(float(x.split(",")[1]) for x in samples if "," in x)

    # the sharpness again with the plain reorth: the probe's Lanczos alone,
    # from the start vector its generator drew first
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(
        probe_seed(SEED, state.step))
    ref_lam = float(sharpness(lanczos_pytree(
        api.loss_fn, learner_mean(trainer.state_view(state).params), batch,
        m=PROBE_ITERS, gen=gen, reorth="ref",
        params_from_tree=api.params_from_tree)))
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref_launches = {k.__name__: k.launches for k in kernels}

    t0 = time.perf_counter()
    diag = trainer.diagnostics(state, batch)
    torch.cuda.synchronize()
    diag_s = time.perf_counter() - t0

    fields = {f: float(v) for f, v in res._asdict().items()}
    diag_fields = {f: float(v) for f, v in diag._asdict().items()}
    check(all(np.isfinite(list(fields.values()))),
          f"non-finite probe result {fields}")
    check(all(np.isfinite(list(diag_fields.values()))),
          f"non-finite diagnostics {diag_fields}")
    rel = abs(fields["sharpness"] - ref_lam) / abs(ref_lam)
    check(rel <= PROBE_RTOL,
          f"probe sharpness {fields['sharpness']} differs from the plain "
          f"reorth run's {ref_lam} by {rel} relative")
    want = 2 * PROBE_ITERS          # two CGS sweeps per Lanczos step
    check(launches["reorth_dots"] == want == launches["reorth_axpy"],
          f"reorth launches in the probe {launches}, want {want} each")
    check(ref_launches["reorth_dots"] == 0 == ref_launches["reorth_axpy"],
          f"the reorth='ref' probe launched a kernel: {ref_launches}")
    check(all(v == 0 for k, v in launches.items()
              if k not in ("reorth_dots", "reorth_axpy")),
          f"the probe launched another path's kernel: {launches}")
    busy = float(np.mean(util)) / 100 if util else None
    return {
        "model": api.cfg.name, "superbatch": [TRAIN_LEARNERS, TRAIN_BATCH,
                                              TRAIN_SEQ],
        "lanczos_iters": PROBE_ITERS, "hutchinson_samples": PROBE_SAMPLES,
        "step": state.step,
        "wall_s_per_probe": probe_s,
        "device_busy_share": busy,
        "device_idle_share": None if busy is None else 1 - busy,
        "busy_from": "nvidia-smi utilization.gpu, 100 ms samples over the "
                     "probe",
        "busy_samples": len(util),
        "sm_clock_mhz_median": clocks[len(clocks) // 2] if clocks else None,
        "max_memory_allocated_gb": peak_gb,
        "result": fields,
        "ref_reorth_sharpness": ref_lam, "ref_reorth_lanczos_wall_s": ref_s,
        "sharpness_rel_diff_vs_ref_reorth": rel,
        "diagnostics": diag_fields, "diagnostics_wall_s": diag_s,
        "kernel_launches": launches,
        "ref_reorth_kernel_launches": ref_launches,
    }, launches


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# phase 5: the FC net — the paper's experiment and the other modes
# ---------------------------------------------------------------------------

def _fc_pair(algo, topology, opt_fn, steps, n, **kw):
    """The same FC-net run with the kernel and with the plain version;
    returns (max |param diff|, max |buffer diff| or None, final loss)."""
    from repro_torch.core import AlgoConfig, MultiLearnerTrainer
    from repro_torch.data import ShardedLoader, TemplateImages
    from repro_torch.models import fcnet

    loader = ShardedLoader(TemplateImages(), n_learners=n, local_batch=64,
                           seed=SEED)
    init = fcnet.init_params(torch.Generator(device="cuda").manual_seed(SEED))
    out = {}
    for backend in ("cuda", "ref"):
        tr = MultiLearnerTrainer(fcnet.loss_fn, opt_fn(),
                                 AlgoConfig(algo=algo, topology=topology,
                                            n_learners=n, **kw),
                                 kernel_backend=backend)
        st = tr.init(SEED, init)
        for i in range(steps):
            st, m = tr.train_step(st, loader.batch(i))
        out[backend] = (st.params.clone(),
                        None if st.buffer is None else st.buffer.clone(),
                        float(m.loss))
    (pk, bk, loss), (pr, br, _) = out["cuda"], out["ref"]
    perr = float((pk - pr).abs().max())
    berr = None if bk is None else float((bk - br).abs().max())
    return perr, berr, loss


def fc_phase(kernels):
    from repro_torch import quickstart
    from repro_torch.optim import sgd

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    ssgd = quickstart.train("ssgd", log_every=0)
    dpsgd = quickstart.train("dpsgd", log_every=0)
    torch.cuda.synchronize()
    quick_s = time.perf_counter() - t0
    check(np.isfinite(dpsgd).all(), "non-finite DPSGD loss in the "
          "quickstart twin")
    check(dpsgd[-1] < ssgd[-1],
          f"quickstart twin: DPSGD {dpsgd[-1]} did not end below SSGD "
          f"{ssgd[-1]} (paper Fig. 2a)")
    full_err, _, full_loss = _fc_pair(
        "dpsgd", "full",
        lambda: sgd(0.1, momentum=0.9, weight_decay=1e-3), 5, 4)
    ad_err, ad_buf_err, ad_loss = _fc_pair(
        "adpsgd", "random_pair", lambda: sgd(0.1, momentum=0.9), 6, 4,
        slow_learner=0, slow_factor=2, max_staleness=1)
    for name, err in (("full", full_err), ("adpsgd", ad_err),
                      ("adpsgd buffer", ad_buf_err)):
        check(err <= TRAIN_REF_ATOL,
              f"FC net {name}: kernel and plain differ by {err}")
    return {
        "quickstart": {"ssgd_final_loss": ssgd[-1],
                       "dpsgd_final_loss": dpsgd[-1],
                       "ssgd_loss_every_20": ssgd[::20],
                       "dpsgd_loss_every_20": dpsgd[::20],
                       "wall_s_both": quick_s},
        "full_n4_momentum_wd": {"max_abs_diff_vs_ref": full_err,
                                "final_loss": full_loss},
        "adpsgd_straggler": {"max_abs_diff_vs_ref": ad_err,
                             "buffer_max_abs_diff_vs_ref": ad_buf_err,
                             "final_loss": ad_loss},
        "kernel_launches": {k.__name__: k.launches for k in kernels},
    }


# ---------------------------------------------------------------------------
# phase 6: Table 1 at the largest batch — SSGD, DPSGD, SSGD+AutoLR
# ---------------------------------------------------------------------------

def table1_phase(kernels):
    from repro_torch.bench.table1_large_batch import run_cell
    from repro_torch.kernels.reorth import reorth_axpy, reorth_dots

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    cells = {a: run_cell(a, TABLE1_SCALE, steps=TABLE1_STEPS)
             for a in ("ssgd", "dpsgd", "ssgd_autolr")}
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    n_probes = len(cells["ssgd_autolr"]["probes"])
    for k in kernels:
        k.launches = 0
    ref = run_cell("ssgd_autolr", TABLE1_SCALE, steps=TABLE1_STEPS,
                   probe_kwargs={"reorth": "ref"})
    ref_launches = {k.__name__: k.launches for k in kernels}

    final = {a: c["final_loss"] for a, c in cells.items()}
    auto = cells["ssgd_autolr"]
    scales = [s for _, s in auto["scales"]]
    sharp = [float(r.sharpness) for _, r in auto["probes"]]
    ref_sharp = [float(r.sharpness) for _, r in ref["probes"]]
    first_rel = abs(sharp[0] - ref_sharp[0]) / abs(ref_sharp[0])
    check(np.isfinite(final["ssgd_autolr"]) and final["ssgd_autolr"] < 1e-2,
          f"SSGD+AutoLR final loss {final['ssgd_autolr']} is not below 1e-2")
    check(not np.isfinite(final["ssgd"]) or final["ssgd"] > 1.0,
          f"SSGD final loss {final['ssgd']} did not fail (> 1)")
    check(np.isfinite(final["dpsgd"]) and final["dpsgd"] < 1e-2,
          f"DPSGD final loss {final['dpsgd']} did not converge")
    check(min(scales) < 1.0, f"the controller never clamped: {scales}")
    check(launches["reorth_dots"] == 2 * 8 * n_probes
          == launches["reorth_axpy"] > 0,
          f"reorth launches {launches} for {n_probes} probes")
    check(ref_launches["reorth_dots"] == 0 == ref_launches["reorth_axpy"],
          f"the reorth='ref' run launched a kernel: {ref_launches}")
    check(first_rel <= PROBE_RTOL,
          f"first probe sharpness {sharp[0]} (kernels) vs {ref_sharp[0]} "
          f"(plain): {first_rel} relative")
    check(np.isfinite(ref["final_loss"]) and ref["final_loss"] < 1e-2,
          f"SSGD+AutoLR with reorth='ref' ended at {ref['final_loss']}")
    return {
        "nB": auto["nB"], "lr": auto["lr"], "steps": TABLE1_STEPS,
        "landscape_every": 10,
        "final_loss": final,
        "ssgd_autolr_scales": auto["scales"],
        "ssgd_autolr_sharpness": sharp,
        "ref_reorth": {"final_loss": ref["final_loss"],
                       "scales": ref["scales"], "sharpness": ref_sharp,
                       "kernel_launches": ref_launches},
        "first_probe_sharpness_rel_diff": first_rel,
        "us_per_step": {a: c["us_per_step"] for a, c in cells.items()},
        "wall_s_three_cells": wall_s,
        "kernel_launches": launches,
    }


# ---------------------------------------------------------------------------
# phase 2d: flash attention against its plain version
# ---------------------------------------------------------------------------

def flash_operands(B, H, KV, hd, Sq, dtype, seed, Sk=None, q_scale=1.0):
    """q (B, H, Sq, hd), k, v (B, KV, Sk, hd) on the card, as the model
    passes them: ``transpose(1, 2)`` views of (B, S, heads, hd) tensors
    drawn from a seeded numpy RNG, q times ``q_scale``."""
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    out = []
    for S, n, c in ((Sq, H, q_scale), (Sk, KV, 1.0), (Sk, KV, 1.0)):
        a = c * rng.standard_normal((B, S, n, hd), dtype=np.float32)
        out.append(torch.from_numpy(a).cuda().to(dtype).transpose(1, 2))
    return out


def flash_error(got, want, Sq):
    """(max |got - want|, max of |got - want| over its tolerance): the
    float32 tiers by length, or one bf16 ulp of the plain value plus
    1e-3 rms of the plain output; the kernel is within tier when the
    second is <= 1."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == _BF16:
        tol = (FLASH_BF16_ULP * w.abs()
               + FLASH_BF16_RMS * float(w.pow(2).mean().sqrt()))
    else:
        tol = FLASH_ATOL_F32_SHORT if Sq <= 256 else FLASH_ATOL_F32
    return float(err.max()), float((err / tol).max())


def live_pairs(Sq, Sk, causal, window) -> int:
    """(q, k) pairs the masks leave live, positions contiguous from 0."""
    qpos = np.arange(Sq)[:, None]
    lo = np.zeros((Sq, 1), np.int64)
    hi = np.full((Sq, 1), Sk - 1)
    if causal:
        hi = np.minimum(hi, qpos)
    if window:
        lo = np.maximum(lo, qpos - window + 1)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_phase():
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import \
        flash_attention_fwd as kernel
    from repro_torch.kernels.flash_attention import kernel_for

    errs = {}
    for i, (name, B, H, KV, hd, Sq, dt, kw, Sk, q_scale) in enumerate(
            FLASH_CASES):
        q, k, v = flash_operands(B, H, KV, hd, Sq, dt, SEED + i, Sk, q_scale)
        before = kernel.launches
        got = kernel(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        check(kernel.launches == before + 1, f"{name}: no launch")
        check(got.dtype == dt and got.shape == q.shape,
              f"{name}: output {got.dtype} {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        err, ratio = flash_error(got, want, Sq)
        errs[name] = {"max_abs_err": err, "max_err_over_tol": ratio}
        check(ratio <= 1.0, f"{name}: |kernel - plain| reaches {ratio} x "
              f"its tolerance (max abs {err})")
        if kw.get("attn_softcap") and dt == _F32 and q_scale != 1.0:
            uncapped = ref.flash_attention_ref(
                q, k, v, **{**kw, "attn_softcap": 0.0})
            effect = float((uncapped - want).abs().max()) / (
                FLASH_ATOL_F32_SHORT if Sq <= 256 else FLASH_ATOL_F32)
            errs[name]["softcap_effect_over_tol"] = effect
            check(effect >= FLASH_CAP_EFFECT_MIN,
                  f"{name}: the softcap moves the output by only {effect} "
                  f"x the tolerance")
            del uncapped
        del q, k, v, got, want
    torch.cuda.empty_cache()
    print(f"flash_attention error per case {json.dumps(errs)}", flush=True)

    timed = {}
    for j, (label, (B, H, KV, hd, S, dt, kw, lib)) in enumerate(
            FLASH_TIMED.items()):
        q, k, v = flash_operands(B, H, KV, hd, S, dt, SEED + 10 + j)
        per_set = 4 * q.element_size() * q.numel()      # q, k, v, out
        sets = [(q, k, v)] + [tuple(t.clone() for t in (q, k, v))
                              for _ in range(L2_BYTES // per_set)]
        big = S > 1024
        kernel_ms = time_ms(lambda a, b, c: kernel(a, b, c, **kw), sets,
                            iters=10 if big else 100)
        plain_ms = time_ms(lambda a, b, c: ref.flash_attention_ref(
            a, b, c, **kw), sets[:1], iters=2 if big else 20)
        err, ratio = flash_error(kernel(q, k, v, **kw),
                                 ref.flash_attention_ref(q, k, v, **kw), S)
        check(ratio <= 1.0, f"{label}: |kernel - plain| reaches {ratio} x "
              f"its tolerance (max abs {err})")
        errs[label] = {"max_abs_err": err, "max_err_over_tol": ratio}
        library_ms = None
        if lib:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            mask = None
            if lib == "sdpa_window":
                pos = torch.arange(S, device="cuda")
                d = pos[:, None] - pos[None, :]
                mask = (d >= 0) & (d < kw["window"])
            library_ms = time_ms(
                lambda a, b, c: sdpa(a, b, c, attn_mask=mask,
                                     is_causal=mask is None,
                                     enable_gqa=H != KV),
                sets, iters=10 if big else 100)
            del mask
        times, _, _, _ = device_times(
            lambda: [kernel(*sets[i % len(sets)], **kw) for i in range(10)])
        device_ms, n_ev = per_event_ms(times, "flash_attention")
        pairs = live_pairs(S, S, kw.get("causal", True), kw.get("window", 0))
        # the function's operations: q.k and P.V once each.  bf16 inputs:
        # one tensor-core pass each at the bf16 rate.  float32: q.k in
        # float32 FMAs (three TF32 terms miss the float32 tier) and
        # P.V in three TF32 passes beside them, so the slower of the two;
        # beside it, both halves at the float32 rate.  What the kernel
        # that runs does is kept apart in bound_parts_ms: the tensor-core
        # kernel takes P.V twice (P = hi + lo in bf16), the float32 kernel
        # two TF32 passes for bf16 V
        half = 2 * hd * pairs * B * H
        flops = 2 * half
        nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
        t_bytes = nbytes / HBM_BYTES_PER_S
        route = kernel_for(dt, hd)
        if dt == _BF16:
            t_ops = flops / BF16_FLOPS
            parts = {"qk_pv_bf16_tensor_cores": t_ops,
                     "kernel_" + route: (
                         3 * half / BF16_FLOPS if route == "tc"
                         else max(half / F32_FLOPS, 2 * half / TF32_FLOPS))}
        else:
            parts = {"qk_f32_fma": half / F32_FLOPS,
                     "pv_tf32_tensor_cores": 3 * half / TF32_FLOPS}
            t_ops = max(parts.values())
        timed[label] = {
            "shape": {"B": B, "H": H, "KV": KV, "hd": hd, "S": S,
                      "dtype": str(dt).replace("torch.", ""), **kw},
            "ms": kernel_ms, "kernel_ms": kernel_ms, "device_ms": device_ms,
            "device_events": n_ev, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "live_pairs_per_head": pairs,
            "bound_parts_ms": {"bytes": 1e3 * t_bytes,
                               **{k: 1e3 * t for k, t in parts.items()}},
            "bound_f32_rate_ms": 1e3 * max(t_bytes, 2 * half / F32_FLOPS),
            "kernel": f"flash_attention_{route}_kernel",
            "share_of_bound": 1e3 * max(t_bytes, t_ops) / kernel_ms,
            "library_ms": library_ms,
            "library": {
                "sdpa": "torch.nn.functional.scaled_dot_product_attention("
                        "is_causal=True)",
                "sdpa_window": "torch.nn.functional."
                               "scaled_dot_product_attention with a boolean "
                               "causal-window mask",
                None: "none: scaled_dot_product_attention has no logit "
                      "softcap"}[lib],
        }
        del q, k, v, sets
        torch.cuda.empty_cache()
    main = timed["gemma2_prefill_global"]
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:100",
        "tpu_kernel": "src/repro/kernels/flash_attention.py::"
                      "flash_attention_fwd",
        "launches": None,
        "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
        "error_per_case_and_timed_shape": errs,
        "ms": main["ms"], "kernel_ms": main["kernel_ms"],
        "device_ms": main["device_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "library": main["library"],
        "shape": main["shape"],
        "per_shape": timed,
    }


# ---------------------------------------------------------------------------
# phase 2f: the flash backward against its plain version and the recompute
# ---------------------------------------------------------------------------

def flash_recompute_grads(q, k, v, do, kw):
    """Autograd through the dense plain version: the route's backward
    before the kernel."""
    from repro_torch.kernels import ref
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(ref.flash_attention_ref(*qkv, **kw), qkv, do)


def flash_grad_error(got, want, dtype, norm=False):
    """(max |got - want|, that over its tolerance) for one gradient:
    float32 FLASH_GRAD_RTOL_F32 of want's largest element; bf16 one bf16
    ulp plus 1e-3 rms (``flash_error``'s rule), or with ``norm``,
    ||got - want|| / ||want|| over FLASH_GRAD_RTOL_BF16."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if dtype == _F32:
        tol = max(1e-5, FLASH_GRAD_RTOL_F32 * float(w.abs().max()))
        return err, err / tol
    if norm:
        return err, float((g - w).norm() / w.norm()) / FLASH_GRAD_RTOL_BF16
    return flash_error(got, want, 0)


def flash_bwd_phase():
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        backward_kernel_takes, flash_attention_bwd, flash_attention_fwd)
    kernel = flash_attention_bwd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # the first backward on the card gives autograd's worker thread a
    # cuBLAS workspace that lives as long as the process: make it here, on
    # an empty cache, so it takes a segment of its own and does not pin
    # one of the large ones below (one did: 8.3 GB held to phase 13, which
    # then ran out of memory)
    torch.cuda.empty_cache()
    tiny = torch.ones((1, 1, 8, 32), device="cuda")
    flash_recompute_grads(tiny, tiny, tiny, tiny, dict(causal=True))
    del tiny
    timed, errs = {}, {}
    for j, (label, (B, H, KV, hd, S, dt, kw, lib)) in enumerate(
            FLASH_TIMED.items()):
        if not backward_kernel_takes(hd):
            timed[label] = {"route": "recompute", "why": (
                f"hd {hd}: no backward instance holds dK and dV in "
                "registers; FlashAttention keeps the plain version's "
                "recompute, statically by shape")}
            continue
        q, k, v = flash_operands(B, H, KV, hd, S, dt, SEED + 20 + j)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 40 + j)
        do = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(
            dt).transpose(1, 2)
        o, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
        before = kernel.launches
        got = kernel(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        check(kernel.launches == before + 1, f"{label}: no backward launch")
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{label}: non-finite gradients")
        # the first kv heads and their query heads
        nk = min(KV, FLASH_BWD_KV)
        nq = nk * (H // KV)
        cut = (q[:, :nq], k[:, :nk], v[:, :nk])
        plain = ref.flash_attention_bwd_ref(
            *cut, o[:, :nq], lse[:, :nq].contiguous(), do[:, :nq], **kw)
        recompute = flash_recompute_grads(*cut, do[:, :nq], kw)
        errs[label] = {}
        for name, g, p, r in zip(("dq", "dk", "dv"),
                                 (got[0][:, :nq], got[1][:, :nk],
                                  got[2][:, :nk]), plain, recompute):
            e_p, ratio_p = flash_grad_error(g, p, dt)
            e_r, ratio_r = flash_grad_error(g, r, dt, norm=True)
            errs[label][name] = {
                "max_abs_err_vs_plain": e_p, "max_err_over_tol_vs_plain":
                ratio_p, "max_abs_err_vs_recompute": e_r,
                "err_over_tol_vs_recompute": ratio_r}
            check(max(ratio_p, ratio_r) <= 1.0,
                  f"{label} {name}: {ratio_p} x its tolerance against the "
                  f"plain backward, {ratio_r} x against the recompute")
        del got, plain, recompute, cut
        per_set = sum(t.element_size() * t.numel() for t in (q, k, v, o, do))
        sets = [(q, k, v, o, lse, do)] + [
            tuple(t.clone() for t in (q, k, v, o, lse, do))
            for _ in range(L2_BYTES // per_set)]
        big = S > 1024
        kernel_ms = time_ms(lambda *a: kernel(*a, **kw), sets,
                            iters=10 if big else 50)
        plain_ms = None
        if B * H * S * S <= FLASH_BWD_PLAIN_MAX:
            plain_ms = time_ms(lambda a, b, c, _o, _l, g: (
                flash_recompute_grads(a, b, c, g, kw)), sets[:1],
                iters=2 if big else 10)
        library_ms = None
        if lib:
            mask = None
            if lib == "sdpa_window":
                pos = torch.arange(S, device="cuda")
                d = pos[:, None] - pos[None, :]
                mask = (d >= 0) & (d < kw["window"])

            def sdpa_call(a, b, c, g=None):
                if g is None:
                    return sdpa(a, b, c, attn_mask=mask,
                                is_causal=mask is None, enable_gqa=H != KV)
                qkv = [t.detach().requires_grad_() for t in (a, b, c)]
                return torch.autograd.grad(sdpa_call(*qkv), qkv, g)
            iters = 10 if big else 50
            library_ms = (
                time_ms(lambda a, b, c, _o, _l, g: sdpa_call(a, b, c, g),
                        sets, iters=iters)
                - time_ms(lambda a, b, c, *_: sdpa_call(a, b, c), sets,
                          iters=iters))
            del mask
        times, _, _, _ = device_times(
            lambda: [kernel(*sets[i % len(sets)], **kw) for i in range(10)])
        device_ms, n_ev = per_event_ms(times, "flash_bwd")
        check(not any("flash_attention" in name for name in times
                      if "flash_bwd" in name),
              f"{label}: a backward kernel's name holds flash_attention")
        pairs = live_pairs(S, S, kw.get("causal", True), kw.get("window", 0))
        # five products of 2 hd flops a live pair and head: q.k and dO.v
        # in float32 FMAs; dV, dK, dQ on the tensor cores in three TF32
        # terms (bf16 B operands in two).  bf16 inputs: the function at the
        # bf16 tensor-core rate; what the kernel does is kept apart
        prod = 2 * hd * pairs * B * H
        flops = 5 * prod
        nbytes = q.element_size() * (4 * q.numel() + 4 * k.numel())
        t_bytes = nbytes / HBM_BYTES_PER_S
        fma, tc = 2 * prod / F32_FLOPS, 3 * 3 * prod / TF32_FLOPS
        if dt == _BF16:
            t_ops = flops / BF16_FLOPS
            parts = {"all_bf16_tensor_cores": t_ops, "kernel_fma": fma,
                     "kernel_tf32_tensor_cores": 3 * 2 * prod / TF32_FLOPS}
        else:
            parts = {"qk_dov_f32_fma": fma, "dv_dk_dq_tf32x3": tc}
            t_ops = max(parts.values())
        timed[label] = {
            "shape": {"B": B, "H": H, "KV": KV, "hd": hd, "S": S,
                      "dtype": str(dt).replace("torch.", ""), **kw},
            "route": "kernel", "ms": kernel_ms, "kernel_ms": kernel_ms,
            "device_ms": device_ms, "device_events": n_ev,
            "plain_ms": plain_ms,
            "plain": "autograd through the dense plain version (the "
                     "recompute)" if plain_ms is not None else
                     "not timed: its score tensors would not fit beside "
                     "the rest",
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "live_pairs_per_head": pairs,
            "bound_parts_ms": {"bytes": 1e3 * t_bytes,
                               **{n: 1e3 * t for n, t in parts.items()}},
            "kernel": "flash_bwd_kernel + flash_bwd_prep_kernel",
            "share_of_bound": 1e3 * max(t_bytes, t_ops) / kernel_ms,
            "library_ms": library_ms,
            "library": None if lib is None else
            "the backward of torch.nn.functional.scaled_dot_product_"
            "attention: its forward and backward, less its forward",
        }
        del q, k, v, o, lse, do, sets
        torch.cuda.empty_cache()
    print(f"flash_attention_bwd error per timed shape {json.dumps(errs)}",
          flush=True)
    main = timed["train_100m_flash4k"]
    return {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
        "replaces": None,
        "why": "the TPU flash kernel has no backward (the reference "
               "differentiates its oracle, repro/kernels/ops.py::"
               "_flash_bwd); the route's training recomputed the dense "
               "scores and differentiated them",
        "launches": None,
        "max_abs_err": max(e["max_abs_err_vs_plain"] for g in errs.values()
                           for e in g.values()),
        "error_per_timed_shape": errs,
        **{key: main[key] for key in (
            "ms", "kernel_ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library", "shape")},
        "per_shape": timed,
    }


# ---------------------------------------------------------------------------
# phase 2e: the single-learner gossip kernel through dpsgd_fused_update
# ---------------------------------------------------------------------------

def gossip_single_phase(kernels):
    from repro_torch.configs import get_config
    from repro_torch.core.flatstate import flatten_for_kernel
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gossip_mix import gossip_mix_update
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    api = build_model(get_config("transformer-100m"))
    tree = api.param_tree(api.init(SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def draw(t):
        return torch.randn(t.shape, generator=gen, device="cuda")

    nbrs = [tree_map(draw, tree) for _ in range(GOSSIP_SINGLE_K)]
    grads, mom = tree_map(draw, tree), tree_map(draw, tree)
    coefs = [1.0 / (GOSSIP_SINGLE_K + 1)] * (GOSSIP_SINGLE_K + 1)
    kw = dict(lr=GOSSIP_SINGLE_LR, beta=GOSSIP_SINGLE_BETA)
    torch.cuda.synchronize()

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    got = ops.dpsgd_fused_update(tree, nbrs, grads, mom, coefs, **kw)
    torch.cuda.synchronize()
    tree_ms = 1e3 * (time.perf_counter() - t0)
    launches = {k.__name__: k.launches for k in kernels}
    check(launches["gossip_mix_update"] == 1 and sum(launches.values()) == 1,
          f"dpsgd_fused_update launches {launches}")
    want = ops.dpsgd_fused_update(tree, nbrs, grads, mom, coefs,
                                  backend="ref", **kw)
    err = 0.0
    for g_tree, w_tree in zip(got, want):
        for a, b in zip(_leaves(g_tree), _leaves(w_tree)):
            err = max(err, _max_err(a, b))
            check(_bits_equal(a, b),
                  f"dpsgd_fused_update: kernel and plain differ by {err}")
    print(f"gossip_mix_update (dpsgd_fused_update, 100m tree, K="
          f"{GOSSIP_SINGLE_K}) max_abs_err {err}", flush=True)

    w, _ = flatten_for_kernel(tree)
    T = w.shape[0]
    check(T == TRAIN_ROWS, f"the 100m tree flattens to {T} rows, not "
          f"{TRAIN_ROWS}")
    nb = torch.stack([flatten_for_kernel(t)[0] for t in nbrs])
    g, mu = flatten_for_kernel(grads)[0], flatten_for_kernel(mom)[0]
    c = torch.tensor(coefs, dtype=torch.float32, device="cuda")
    del nbrs, grads, mom, got, want
    kernel_ms = time_ms(lambda: gossip_mix_update(w, nb, g, mu, c, **kw),
                        [()], iters=50)
    plain_ms = time_ms(lambda: ref.gossip_mix_update_ref(w, nb, g, mu, c,
                                                         **kw),
                       [()], iters=5)
    times, _, _, _ = device_times(
        lambda: [gossip_mix_update(w, nb, g, mu, c, **kw)
                 for _ in range(20)])
    device_ms, n_ev = per_event_ms(times, "gossip_mix_single_kernel")
    vec = w.numel() * 4
    # w, the K neighbours, g and mu in; w' and mu' out
    nbytes = (3 + GOSSIP_SINGLE_K) * vec + 2 * vec + c.numel() * 4
    flops = (2 * GOSSIP_SINGLE_K + 5) * w.numel()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {
        "name": "gossip_mix_update",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gossip_mix.cu",
        "replaces": "src/repro/kernels/gossip_mix.py:74",
        "tpu_kernel": "src/repro/kernels/gossip_mix.py::gossip_mix_update",
        "launches": launches["gossip_mix_update"],
        "max_abs_err": err,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "device_ms": device_ms,
        "device_events": n_ev, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes": nbytes,
        "library_ms": None,
        "library": ("none: no single PyTorch call computes the K-term mix, "
                    "the momentum update and the step in one pass"),
        "tree_level_ms_first_call": tree_ms,
        "shape": {"T": T, "K": GOSSIP_SINGLE_K, "coefs": coefs, **kw},
    }


# ---------------------------------------------------------------------------
# phase 7: gemma2-27b at full width through the flash route
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def gemma2_phase(kernels):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    full = get_config("gemma2-27b")
    cfg = dataclasses.replace(full, n_layers=GEMMA_LAYERS, use_pallas=True)
    chunked = dataclasses.replace(cfg, use_pallas=False)
    api, api_c = build_model(cfg), build_model(chunked)
    t0 = time.perf_counter()
    params = api.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, GEMMA_PREFILL_SEQ))).cuda()

    def counted(fn):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, 1e3 * (time.perf_counter() - t0),
                {k.__name__: k.launches for k in kernels},
                torch.cuda.max_memory_allocated() / 1e9)

    # (i) prefill: every logit finite, the last positions against chunked
    with torch.no_grad():
        logits, prefill_ms, launches, prefill_gb = counted(
            lambda: api.apply(params, {"tokens": tokens}))
        check(launches["flash_attention_fwd"] == GEMMA_LAYERS
              and sum(launches.values()) == GEMMA_LAYERS,
              f"gemma2 prefill launches {launches}")
        check(logits.shape == (1, GEMMA_PREFILL_SEQ, cfg.padded_vocab)
              and logits.dtype == getattr(torch, cfg.compute_dtype),
              f"gemma2 logits {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()),
              "non-finite gemma2 prefill logits")
        last = logits[:, -GEMMA_LAST:].clone()
        del logits
        logits_c, chunked_ms, launches_c, chunked_gb = counted(
            lambda: api_c.apply(params, {"tokens": tokens}))
        check(sum(launches_c.values()) == 0,
              f"the chunked route launched {launches_c}")
        last_c = logits_c[:, -GEMMA_LAST:].clone()
        del logits_c
    prefill_rel = _rel(last, last_c)
    prefill_max = float((last.float() - last_c.float()).abs().max())
    check(prefill_rel <= GEMMA_BF16_RTOL,
          f"gemma2 prefill: last {GEMMA_LAST} positions differ from the "
          f"chunked route by {prefill_rel} relative")
    torch.cuda.empty_cache()

    # (ii) loss + backward; the chunked route at a 512 block (4,608 = 9 x
    # 512; its default 1,024 does not divide the length)
    labels = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, GEMMA_TRAIN_SEQ))).cuda()
    batch = {"tokens": tokens[:, :GEMMA_TRAIN_SEQ].contiguous(),
             "labels": labels}
    api_c2 = build_model(dataclasses.replace(chunked,
                                             attn_chunk=GEMMA_CHUNK))

    def loss_and_grad(a):
        params.zero_grad(set_to_none=True)
        loss = a.loss_fn(params, batch)
        loss.backward()
        return loss.detach()

    loss, train_ms, launches_t, train_gb = counted(
        lambda: loss_and_grad(api))
    check(launches_t["flash_attention_fwd"] == GEMMA_LAYERS
          and launches_t["flash_attention_bwd"] == GEMMA_LAYERS
          and sum(launches_t.values()) == 2 * GEMMA_LAYERS,
          f"gemma2 loss/backward launches {launches_t}")
    check(all(bool(torch.isfinite(p.grad).all())
               for p in params.parameters()),
          "non-finite gemma2 gradients")
    wq = [params.periods[0][f"l{i}"].mixer.wq.grad.clone()
          for i in range(2)]
    loss_c, train_c_ms, launches_tc, train_c_gb = counted(
        lambda: loss_and_grad(api_c2))
    check(sum(launches_tc.values()) == 0,
          f"the chunked route launched {launches_tc}")
    wq_c = [params.periods[0][f"l{i}"].mixer.wq.grad for i in range(2)]
    wq_rel = [_rel(a, b) for a, b in zip(wq, wq_c)]
    loss_rel = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    check(max(wq_rel) <= GEMMA_BF16_RTOL,
          f"gemma2 wq gradients differ from the chunked route by {wq_rel}")
    check(loss_rel <= GEMMA_LOSS_RTOL,
          f"gemma2 loss {float(loss)} vs chunked {float(loss_c)}")
    params.zero_grad(set_to_none=True)
    del params, wq, wq_c
    torch.cuda.empty_cache()
    return {
        "model": full.name, "n_layers": GEMMA_LAYERS,
        "reduced": {"n_layers": f"{full.n_layers} -> {GEMMA_LAYERS} (one "
                                "local/global period; every width kept)"},
        "d_model": cfg.d_model, "n_heads": cfg.n_heads,
        "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim_,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab, "window": cfg.window,
        "softcaps": [cfg.attn_softcap, cfg.final_softcap],
        "dtype": cfg.param_dtype, "n_params": n_params, "init_s": init_s,
        "prefill": {"tokens": GEMMA_PREFILL_SEQ,
                    "flash_wall_ms": prefill_ms,
                    "chunked_wall_ms": chunked_ms,
                    "flash_peak_gb": prefill_gb,
                    "chunked_peak_gb": chunked_gb,
                    "flash_launches": launches["flash_attention_fwd"],
                    "last_positions": GEMMA_LAST,
                    "last_logits_rel_diff_vs_chunked": prefill_rel,
                    "last_logits_max_abs_diff_vs_chunked": prefill_max,
                    "tier_rel": GEMMA_BF16_RTOL},
        "loss_backward": {"tokens": GEMMA_TRAIN_SEQ,
                          "loss": float(loss), "chunked_loss": float(loss_c),
                          "loss_rel_diff": loss_rel,
                          "flash_wall_ms": train_ms,
                          "chunked_wall_ms": train_c_ms,
                          "flash_peak_gb": train_gb,
                          "chunked_peak_gb": train_c_gb,
                          "chunked_block": GEMMA_CHUNK,
                          "flash_launches": launches_t["flash_attention_fwd"],
                          "flash_bwd_launches":
                              launches_t["flash_attention_bwd"],
                          "wq_grad_rel_diff_vs_chunked": wq_rel,
                          "tier_rel": GEMMA_BF16_RTOL},
    }, (launches["flash_attention_fwd"] + launches_t["flash_attention_fwd"],
        launches_t["flash_attention_bwd"])


# ---------------------------------------------------------------------------
# phase 8: transformer-100m trained through the flash route
# ---------------------------------------------------------------------------

def flash_train_phase(kernels, chunked_train):
    run = train_100m(kernels, FLASH_TRAIN_WARM, FLASH_TRAIN_TIMED,
                     FLASH_TRAIN_PROF, use_pallas=True)
    launches, losses = run.launches, run.losses
    per_step = TRAIN_LEARNERS * run.cfg.n_layers
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        check(launches[name] == run.steps * per_step,
              f"{name} launches {launches[name]} != {run.steps} steps x "
              f"{per_step}")
    others = {k: v for k, v in launches.items() if k not in (
        "flash_attention_fwd", "flash_attention_bwd",
        "gossip_mix_update_flat")}
    check(sum(others.values()) == 0, f"other kernels launched: {others}")
    ref = chunked_train["losses"][:2]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[:2], ref)]
    check(max(rel) <= FLASH_TRAIN_LOSS_RTOL,
          f"flash-route losses {losses[:2]} vs chunked {ref}: {rel}")
    prof = chunked_train["profile"]
    del run.trainer, run.state, run.metrics
    torch.cuda.empty_cache()
    return {
        "model": run.cfg.name, "use_pallas": True, "steps": run.steps,
        "timed_steps": FLASH_TRAIN_TIMED,
        "ms_per_step": run.step_ms, "tokens_per_s": run.tokens_per_s,
        "profile": run.profile,
        "chunked_route": {
            "ms_per_step": chunked_train["ms_per_step"],
            "tokens_per_s": chunked_train["tokens_per_s"],
            "device_idle_share": prof["device_idle_share"],
            "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
            "device_kernels_per_step": prof["device_kernels_per_step"]},
        "max_memory_allocated_gb": run.peak_gb,
        "losses": losses, "chunked_losses_first_2": ref,
        "loss_rel_diff_first_2": rel,
        "kernel_launches": launches,
    }, (launches["flash_attention_fwd"], launches["flash_attention_bwd"])


# ---------------------------------------------------------------------------
# phase 9: the pytree engine at full width (SSGD*, pytree vs flat, bf16)
# ---------------------------------------------------------------------------

def _cast_leaves(meta):
    """Indices (in the flat store's order) of the leaves that are not
    float32: the ones the flat engine casts around each forward and
    backward."""
    return [j for j, dt in enumerate(meta.dtypes) if dt != torch.float32]


def _cast_passes_ms(meta, state, iters=5):
    """Event ms of one step's bf16 cast pass and of its gradient write
    pass, run alone: the trainer's copies, on tensors of this script's own.
    The cast pass copies every learner's row of each cast leaf from the
    float32 store into a bf16 leaf; the write pass copies a bf16 gradient
    into a float32 store of the same layout."""
    cast = _cast_leaves(meta)
    src = meta.views(state.params)
    dst = meta.views(torch.empty_like(state.params))
    one = [torch.zeros(meta.shapes[i], dtype=meta.dtypes[i],
                       device=state.params.device) for i in cast]
    n = state.params.shape[0]
    passes = {
        "cast": lambda: [c.copy_(src[i][j]) for j in range(n)
                         for c, i in zip(one, cast)],
        "write": lambda: [dst[i][j].copy_(c) for j in range(n)
                          for c, i in zip(one, cast)]}
    out = {}
    with torch.no_grad():
        for name, fn in passes.items():
            out[name] = time_ms(fn, [()], iters=iters)
    return out


def pytree_phase(kernels, chunked_train):
    """(a) SSGD* on the pytree engine; (b) DPSGD on the pytree engine
    against the flat engine (kernel #2) from the same seed; (c) bf16 leaves
    on the flat engine against ``kernel_backend="ref"``.  Returns (record,
    gossip launches by path)."""
    from repro_torch.core import flat_meta

    names = [k.__name__ for k in kernels]
    out, gossip = {}, {}

    # (a) SSGD*: the pytree engine at full width, no kernel on its path
    run = train_100m(kernels, PYTREE_WARM, PYTREE_TIMED, PYTREE_PROF,
                     algo="ssgd_star")
    check(not run.trainer.is_flat, "SSGD* did not take the pytree engine")
    check(sum(run.launches.values()) == 0,
          f"the SSGD* path launched a kernel: {run.launches}")
    out["a_ssgd_star"] = {
        "engine": "pytree", "noise_std": run.trainer.algo.noise_std,
        "steps": run.steps, "timed_steps": PYTREE_TIMED,
        "ms_per_step": run.step_ms, "tokens_per_s": run.tokens_per_s,
        "profile": run.profile,
        "max_memory_allocated_gb": run.peak_gb, "losses": run.losses,
        "sigma_w_sq_last": float(run.metrics[-1].sigma_w_sq),
        "kernel_launches": run.launches}
    api, tree, batches = run.api, run.tree, run.batches
    del run
    torch.cuda.empty_cache()

    # (b) DPSGD on random_pair, pytree against flat (the gossip kernel)
    params, losses = {}, {}
    for engine in ("pytree", "flat"):
        for k in kernels:
            k.launches = 0
        tr = _train_100m_trainer(api, "auto", engine=engine)
        st = tr.init(SEED, tree)
        ls = []
        for i in range(ENGINE_STEPS):
            st, m = tr.train_step(st, batches[i])
            ls.append(m.loss)
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in zip(names, kernels)}
        want = ENGINE_STEPS if engine == "flat" else 0
        check(launches["gossip_mix_update_flat"] == want
              and sum(launches.values()) == want,
              f"{engine} DPSGD launches {launches}, want {want} gossip")
        gossip[f"transformer_100m_dpsgd_{engine}_engine"] = launches[
            "gossip_mix_update_flat"]
        params[engine] = [x.clone() for x in _leaves(tr.params_tree(st))]
        losses[engine] = torch.stack(ls).tolist()
        del tr, st
        torch.cuda.empty_cache()
    excess = max(float(((a - b).abs() - ENGINE_RTOL * b.abs()).max())
                 for a, b in zip(params["flat"], params["pytree"]))
    diff = max(float((a - b).abs().max())
               for a, b in zip(params["flat"], params["pytree"]))
    check(excess <= ENGINE_ATOL,
          f"flat and pytree DPSGD differ by {diff} after {ENGINE_STEPS} "
          f"steps (|a-b| - {ENGINE_RTOL}|b| = {excess} > {ENGINE_ATOL})")
    out["b_dpsgd_pytree_vs_flat"] = {
        "steps": ENGINE_STEPS, "max_abs_diff": diff,
        "max_excess_over_rtol": excess, "atol": ENGINE_ATOL,
        "rtol": ENGINE_RTOL, "losses": losses}
    del params, api, tree, batches
    torch.cuda.empty_cache()

    # (c) bf16 leaves on the flat engine: cast in, write back, kernel #2
    run = train_100m(kernels, BF16_WARM, BF16_TIMED, BF16_PROF,
                     keep_after_warm=True, dtype="bfloat16")
    tr = run.trainer
    meta = flat_meta(run.tree)
    cast = _cast_leaves(meta)
    check(tr.is_flat and len(cast) > 0
          and run.state.params.dtype == torch.float32,
          "the bf16 run did not cast on the flat engine")
    check(sum(v for n, v in run.launches.items()
              if n != "gossip_mix_update_flat") == 0,
          f"the bf16 path launched another path's kernel: {run.launches}")
    gossip["transformer_100m_bf16_flat"] = run.launches[
        "gossip_mix_update_flat"]
    passes = _cast_passes_ms(meta, run.state)
    busy = run.profile["device_busy_ms_per_step"]
    n_cast = sum(meta.sizes[i] for i in cast)
    record = {
        "dtype": "bfloat16", "engine": "flat", "steps": run.steps,
        "timed_steps": BF16_TIMED, "ms_per_step": run.step_ms,
        "tokens_per_s": run.tokens_per_s,
        "float32_phase4_ms_per_step": chunked_train["ms_per_step"],
        "profile": run.profile, "max_memory_allocated_gb": run.peak_gb,
        "losses": run.losses, "cast_leaves": len(cast),
        "cast_elements_per_learner": n_cast,
        "cast_pass_ms_per_step": passes["cast"],
        "write_pass_ms_per_step": passes["write"],
        "cast_and_write_share_of_device": (
            (passes["cast"] + passes["write"]) / busy if busy else None),
        "kernel_launches": run.launches}
    after_warm, batches, api, tree = (run.after_warm, run.batches, run.api,
                                      run.tree)
    del run, tr
    torch.cuda.empty_cache()
    ref = _train_100m_trainer(api, "ref")
    ref_state = ref.init(SEED, tree)
    for i in range(REF_STEPS):
        ref_state, _ = ref.train_step(ref_state, batches[i])
    ref_err = float((ref_state.params - after_warm).abs().max())
    check(ref_err <= TRAIN_REF_ATOL,
          f"bf16: kernel and plain training differ by {ref_err} after "
          f"{REF_STEPS} steps")
    record["ref_backend_max_abs_diff_after_2_steps"] = ref_err
    out["c_bf16_flat"] = record
    del ref, ref_state, after_warm
    torch.cuda.empty_cache()
    return out, gossip


# ---------------------------------------------------------------------------
# phase 10: the paper's experiments on the FC net (the bench twins)
# ---------------------------------------------------------------------------

def paper_phase(kernels):
    """The Fig. 2, topology-ablation, Table 4, Fig. 4, Table 5 and
    ``paper_mnist_repro`` twins, each with the launch counts zeroed just
    before it and read just after.  Returns
    (record, gossip launches by path, reorth launches)."""
    from repro_torch.bench import (ablation_topology, fig2_effective_lr,
                                   fig4_noise_decomp, table4_lr_tuning,
                                   table5_asr_proxy)
    from repro_torch.bench.common import final_loss

    names = [k.__name__ for k in kernels]

    def zero():
        for k in kernels:
            k.launches = 0

    def read():
        return {n: k.launches for n, k in zip(names, kernels)}

    def only(launches, allowed, what):
        others = {n: v for n, v in launches.items() if n not in allowed}
        check(sum(others.values()) == 0,
              f"{what} launched another path's kernel: {others}")

    out, gossip = {}, {}
    zero()
    t0 = time.perf_counter()
    fig2 = fig2_effective_lr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read()
    final = {a: final_loss(r["losses"]) for a, r in fig2["runs"].items()}
    check(np.isfinite(final["dpsgd"]) and final["dpsgd"] < final["ssgd"],
          f"Fig. 2: DPSGD {final['dpsgd']} did not end below SSGD "
          f"{final['ssgd']}")
    n_probes = sum(len(r["probes"]) for r in fig2["runs"].values())
    want = 2 * 8 * n_probes
    check(n_probes > 0 and launches["reorth_dots"] == want
          == launches["reorth_axpy"],
          f"Fig. 2 reorth launches {launches}, want {want} each for "
          f"{n_probes} probes")
    want_g = fig2_effective_lr.STEPS        # the DPSGD run, one round a step
    check(launches["gossip_mix_update_flat"] == want_g,
          f"Fig. 2 gossip launches {launches['gossip_mix_update_flat']} != "
          f"{want_g}")
    only(launches, ("reorth_dots", "reorth_axpy", "gossip_mix_update_flat"),
         "Fig. 2")
    gossip["fig2_dpsgd"] = launches["gossip_mix_update_flat"]
    reorth = {k: launches[k] for k in ("reorth_dots", "reorth_axpy")}
    derived = fig2_effective_lr.derived(fig2)
    print(f"fig2_effective_lr,{fig2['us_per_step']:.0f},{derived}",
          flush=True)
    out["fig2"] = {"final_loss": final, "ssgd_star_sweep": fig2["sweep"],
                   "eq4_mean_abs_err_over_alpha": fig2["eq4"],
                   "probes": n_probes, "us_per_step": fig2["us_per_step"],
                   "wall_s": wall, "kernel_launches": launches,
                   "derived": derived, "rows": fig2["rows"]}
    del fig2

    rows, t0 = [], time.perf_counter()
    for name in ablation_topology.TOPOLOGIES:
        zero()
        r = ablation_topology.run_topology(name, steps=ABLATION_STEPS)
        launches = read()
        want = r["rounds_per_step"] * r["steps"]
        check(launches["gossip_mix_update_flat"] == want,
              f"ablation {name}: gossip launches "
              f"{launches['gossip_mix_update_flat']} != {want} "
              f"({r['rounds_per_step']} rounds x {r['steps']} steps)")
        only(launches, ("gossip_mix_update_flat",), f"ablation {name}")
        gossip[f"ablation_{name}"] = launches["gossip_mix_update_flat"]
        r["kernel_launches"] = launches["gossip_mix_update_flat"]
        rows.append(r)
    ablation_topology.check(rows)
    derived = ablation_topology.derived(rows)
    us = sum(r["us_per_step"] for r in rows) / len(rows)
    print(f"ablation_topology,{us:.0f},{derived}", flush=True)
    out["ablation"] = {"rows": rows, "derived": derived,
                       "wall_s": time.perf_counter() - t0}

    for key, mod, runs in (("table4", table4_lr_tuning,
                            len(table4_lr_tuning.LRS)),
                           ("fig4", fig4_noise_decomp, 1),
                           ("table5", table5_asr_proxy,
                            len(table5_asr_proxy.LRS))):
        zero()
        t0 = time.perf_counter()
        res = mod.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read()
        want = 120 * runs               # 120 DPSGD steps a run
        check(launches["gossip_mix_update_flat"] == want,
              f"{key}: gossip launches {launches} != {want}")
        only(launches, ("gossip_mix_update_flat",), key)
        gossip[f"{key}_dpsgd"] = launches["gossip_mix_update_flat"]
        rows = res["rows"]
        check(all(np.isfinite(x) for r in rows for x in r[1:]
                  if isinstance(x, float)), f"{key}: non-finite {rows}")
        if hasattr(mod, "check"):       # table5: what the reference gives
            mod.check(rows)
        derived = mod.derived(rows)
        print(f"{mod.__name__.rsplit('.', 1)[1]},{res['us_per_step']:.0f},"
              f"{derived}", flush=True)
        print(f"{key} gossip launches "
              f"{launches['gossip_mix_update_flat']}", flush=True)
        out[key] = {"rows": rows, "derived": derived, "wall_s": wall,
                    "us_per_step": res["us_per_step"],
                    "kernel_launches": launches}
    out["paper_mnist_repro"], gossip["paper_mnist_repro_dpsgd"] = \
        paper_mnist_twin(zero, read, only)
    return out, gossip, reorth


def paper_mnist_twin(zero, read, only):
    """``repro_torch.paper_mnist_repro`` at its full settings, each
    algorithm with the launch counts zeroed just before it and read just
    after: DPSGD launches the gossip kernel once a step and nothing else,
    SSGD and SSGD* (the pytree engine) nothing; every field finite, the
    accuracy in [0, 1], and the reference's verdict at the last row.
    Returns (record, DPSGD's gossip launches)."""
    from repro_torch import paper_mnist_repro as twin

    rows, launches, wall = {}, {}, {}
    for algo in twin.ALGOS:
        zero()
        t0 = time.perf_counter()
        rows[algo] = twin.run(algo)
        torch.cuda.synchronize()
        wall[algo] = time.perf_counter() - t0
        launches[algo] = read()
    check(launches["dpsgd"]["gossip_mix_update_flat"] == twin.STEPS,
          f"paper_mnist_repro: DPSGD gossip launches "
          f"{launches['dpsgd']['gossip_mix_update_flat']} != {twin.STEPS}")
    only(launches["dpsgd"], ("gossip_mix_update_flat",),
         "paper_mnist_repro DPSGD")
    for algo in ("ssgd", "ssgd_star"):
        only(launches[algo], (), f"paper_mnist_repro {algo}")
    want_steps = list(range(0, twin.STEPS, twin.EVERY))
    for algo, rs in rows.items():
        check([r[1] for r in rs] == want_steps,
              f"paper_mnist_repro {algo}: rows at {[r[1] for r in rs]}")
        check(all(np.isfinite(r[2:]).all() and 0.0 <= r[7] <= 1.0
                  for r in rs), f"paper_mnist_repro {algo}: {rs}")
    last = {algo: rs[-1] for algo, rs in rows.items()}
    check(last["ssgd"][2] > MNIST_FAIL_LOSS
          and last["ssgd"][7] < MNIST_FAIL_ACC,
          f"paper_mnist_repro: SSGD's last row {last['ssgd']} does not "
          f"fail as the reference's does")
    for algo in ("ssgd_star", "dpsgd"):
        check(last[algo][2] < MNIST_OK_LOSS
              and last[algo][7] >= MNIST_OK_ACC,
              f"paper_mnist_repro: {algo}'s last row {last[algo]} does not "
              f"converge as the reference's does")
    print("paper_mnist_repro last rows " + json.dumps(last), flush=True)
    return {"header": twin.HEADER, "rows": rows, "last_rows": last,
            "wall_s": wall, "kernel_launches": launches}, \
        launches["dpsgd"]["gossip_mix_update_flat"]


# ---------------------------------------------------------------------------
# phases 11-12: the moe and hybrid families (granite-moe, jamba)
# ---------------------------------------------------------------------------

def moe_profile(api, params, n_slots, reps=5):
    """Device time of a serve step's MoE layers: each MoE layer's
    ``moe_forward`` on an (n_slots, 1, d) input, ``reps`` steps under the
    profiler, beside the bytes of every expert weight (at decode every
    expert runs its capacity bucket, so a step reads them all)."""
    from repro_torch.models import moe

    cfg = api.cfg
    layers = [lp.mlp for period in params.periods for lp in period.values()
              if isinstance(lp.mlp, moe.MoEParams)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((n_slots, 1, cfg.d_model), generator=gen,
                    device="cuda").to(layers[0].w1.dtype)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.experts_per_tok,
              capacity_factor=cfg.capacity_factor)

    def step():
        for mp in layers:
            moe.moe_forward(mp, x, **kw)

    with torch.inference_mode():
        step()
        times, _, wall, _ = device_times(
            lambda: [step() for _ in range(reps)])
    busy_ms = sum(v[0] for v in times.values()) / 1e3 / reps
    nbytes = sum(sum(t.numel() * t.element_size()
                     for t in (mp.w1, mp.w2, mp.w3)) for mp in layers)
    return {"moe_layers": len(layers),
            "capacity_per_expert": max(1, int(
                cfg.capacity_factor * cfg.experts_per_tok * n_slots
                / cfg.n_experts)),
            "device_ms_per_step": busy_ms,
            "wall_ms_per_step_profiled": 1e3 * wall / reps,
            "expert_bytes_per_step": nbytes,
            "expert_bytes_bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}


def recurrent_checks(eng, api, params):
    """On the served engine's cache: one more served step with half the
    slots not advancing keeps their recurrent leaves bitwise (the others
    move), and ``reset_slot`` zeroes one slot's leaves and no other's."""
    from repro_torch.models.transformer import PAGED

    S = eng.n_slots
    cache = eng.cache
    leaves = {f"{layer}/{name}": x for layer, c in cache.items()
              for name, x in c.items() if name not in PAGED}
    before = {k: x.clone() for k, x in leaves.items()}
    check(all(bool(x.abs().sum() > 0) for x in before.values()),
          "a recurrent leaf is all 0 after serving")
    advance = torch.arange(S, device="cuda") % 2 == 0
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(1, api.cfg.vocab, (S, 1))).to(
        torch.int32).cuda()
    positions = torch.tensor([s.pos for s in eng.slots], dtype=torch.int32,
                             device="cuda")
    api.paged_decode_step(params, cache, tokens, positions,
                          torch.from_numpy(eng.page_table).cuda(), advance)
    torch.cuda.synchronize()
    frozen = [i for i in range(S) if not bool(advance[i])]
    for k, x in leaves.items():
        check(torch.equal(x[:, frozen], before[k][:, frozen]),
              f"{k}: a slot with advance=False changed")
    # an advancing slot moves every leaf of its state, except an sLSTM
    # cell whose input gate has underflowed: its forget pre-activation
    # (bias 3) adds ~3-6 to m every token, so exp(i - m) reaches 0 within
    # a few dozen tokens and c and n then hold bitwise while h and m move
    still = 0
    for layer, c in cache.items():
        names = [n for n in c if n not in PAGED]
        for i in range(S):
            if not bool(advance[i]):
                continue
            kept = [n for n in names
                    if torch.equal(c[n][:, i], before[f"{layer}/{n}"][:, i])]
            check(set(kept) <= ({"c", "n"} if set(names) == {"c", "h", "m",
                                                             "n"} else set()),
                  f"{layer}: advancing slot {i} kept {kept}")
            still += len(kept)
    after = {k: x.clone() for k, x in leaves.items()}
    api.reset_slot(cache, 1)
    for k, x in leaves.items():
        check(bool((x[:, 1] == 0).all()), f"{k}: reset_slot left slot 1")
        others = [i for i in range(S) if i != 1]
        check(torch.equal(x[:, others], after[k][:, others]),
              f"{k}: reset_slot touched another slot")
    return {"recurrent_leaves": len(leaves), "frozen_slots": frozen,
            "advance_false_bitwise": True, "reset_slot_zeroes_slot": True,
            "saturated_slstm_leaves_held_while_advancing": still}


def zoo_prefill_phase(name, n_layers, seq, kernels):
    """``api.apply`` of one ``seq``-token prompt on the flash route (the
    routing recorded) against the chunked route (that routing replayed):
    every attention layer one flash launch, finite logits, the last
    GEMMA_LAST positions within GEMMA_BF16_RTOL.  Returns (record, flash
    launches)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, moe

    cfg = dataclasses.replace(get_config(name), n_layers=n_layers,
                              use_pallas=True)
    api = build_model(cfg)
    api_c = build_model(dataclasses.replace(cfg, use_pallas=False))
    n_attn, _ = layer_counts(cfg)
    params = api.init(SEED)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (1, seq))).cuda()
    pin = SharedRouting(moe.route)
    moe.route = pin
    runs = {}
    try:
        for label, a, mode in (("flash", api, "record"),
                               ("chunked", api_c, "replay")):
            for k in kernels:
                k.launches = 0
            pin.mode = mode
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits = a.apply(params, {"tokens": tokens})
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            check(logits.shape == (1, seq, cfg.padded_vocab)
                  and logits.dtype == getattr(torch, cfg.compute_dtype),
                  f"{name} logits {tuple(logits.shape)} {logits.dtype}")
            check(bool(torch.isfinite(logits).all()),
                  f"non-finite {name} {label} logits")
            runs[label] = {"last": logits[:, -GEMMA_LAST:].clone(),
                           "wall_ms": wall,
                           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "launches": {k.__name__: k.launches
                                        for k in kernels}}
            del logits
            torch.cuda.empty_cache()
    finally:
        moe.route = pin.fn
    flash, chunked = runs["flash"], runs["chunked"]
    check(flash["launches"]["flash_attention_fwd"] == n_attn
          and sum(flash["launches"].values()) == n_attn,
          f"{name} prefill launches {flash['launches']}")
    check(sum(chunked["launches"].values()) == 0,
          f"the chunked route launched {chunked['launches']}")
    pin.check(f"{name} prefill, chunked against flash")
    rel = _rel(flash["last"], chunked["last"])
    check(rel <= GEMMA_BF16_RTOL,
          f"{name} prefill: last {GEMMA_LAST} positions differ from the "
          f"chunked route by {rel} relative")
    del params
    torch.cuda.empty_cache()
    return {"tokens": seq, "attention_layers": n_attn,
            "flash_wall_ms": flash["wall_ms"],
            "chunked_wall_ms": chunked["wall_ms"],
            "flash_peak_gb": flash["peak_gb"],
            "chunked_peak_gb": chunked["peak_gb"],
            "flash_launches": flash["launches"]["flash_attention_fwd"],
            "last_positions": GEMMA_LAST,
            "last_logits_rel_diff_vs_chunked": rel,
            "last_logits_max_abs_diff_vs_chunked": float(
                (flash["last"].float() - chunked["last"].float()).abs()
                .max()),
            "tier_rel": GEMMA_BF16_RTOL,
            "routing_shared": pin.record()}, \
        flash["launches"]["flash_attention_fwd"]


# ---------------------------------------------------------------------------
# phases 13-14: the ssm, vlm and audio families (xlstm, qwen2-vl, seamless)
# ---------------------------------------------------------------------------

def held(what, sound, control, tier):
    """A bf16 reading within its tier, and its control (one mantissa bit
    below bf16) beyond it: a tier the control passes is too loose."""
    check(sound <= tier, f"{what}: {sound} relative > its tier {tier}")
    check(control > tier, f"{what}: the control one mantissa bit below "
          f"bf16 reads {control}, within the tier {tier}")
    return {"rel": sound, "control_one_bit_below_bf16": control,
            "tier_rel": tier}


def step_rel(got, want):
    """Per step t: ||got[t] - want[:, t]|| / ||want[:, t]|| over the batch
    (got: a list of (B, V) logits, want: (B, T, V))."""
    return [_rel(g, want[:, t]) for t, g in enumerate(got)]


def xlstm_decode_vs_prefill(api, params):
    """Phase 13b: paged decode of one XLSTM_PREFILL-token prompt, token by
    token, against ``api.apply``'s logits at the same positions; then the
    same in float32 (fresh float32 weights)."""
    from repro_torch.models import build_model

    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, api.cfg.vocab, (1, XLSTM_PREFILL))).cuda()
    pages = -(-XLSTM_PREFILL // PAGE)
    table = torch.arange(1, 1 + pages, dtype=torch.int32,
                         device="cuda")[None]

    def prefill(a, p):
        with torch.no_grad():
            return a.apply(p, {"tokens": tokens})[0, :, :a.cfg.vocab]

    def decode(a, p):
        cache = a.init_paged_cache(p, 1, 1 + pages, PAGE)
        out = []
        for pos in range(XLSTM_PREFILL):
            lg, cache = a.paged_decode_step(
                p, cache, tokens[:, pos:pos + 1].to(torch.int32),
                torch.full((1,), pos, dtype=torch.int32, device="cuda"),
                table)
            out.append(lg[0, 0, :a.cfg.vocab].float())
        return torch.stack(out)

    full = prefill(api, params)
    sound = _rel(decode(api, params), full)
    with CoarseBF16():
        control = _rel(decode(api, params), full)
    api32 = build_model(dataclasses.replace(api.cfg, param_dtype="float32",
                                            compute_dtype="float32"))
    params32 = api32.init(SEED)
    rel32 = _rel(decode(api32, params32), prefill(api32, params32))
    check(rel32 <= XLSTM_DECODE_F32_RTOL, f"xlstm-350m float32: decode "
          f"differs from prefill by {rel32} relative")
    del params32
    return {"prompt_tokens": XLSTM_PREFILL, **held(
        "xlstm-350m decode against prefill", sound, control,
        XLSTM_DECODE_RTOL), "float32_rel": rel32,
        "float32_tier_rel": XLSTM_DECODE_F32_RTOL}


def xlstm_train(api, kernels):
    """Phase 13c: XLSTM_TRAIN_STEPS DPSGD steps of xlstm-350m through the
    gossip kernel, then as many with ``kernel_backend="ref"`` from the same
    start: the stores within TRAIN_REF_ATOL.  Returns (record, gossip
    launches)."""
    from repro_torch.core import flat_meta
    from repro_torch.data import ShardedLoader, SyntheticTokenStream

    tree = api.param_tree(api.init(SEED))
    meta = flat_meta(tree)
    loader = ShardedLoader(SyntheticTokenStream(vocab=api.cfg.vocab),
                           n_learners=TRAIN_LEARNERS,
                           local_batch=TRAIN_BATCH,
                           extra_args=(XLSTM_TRAIN_SEQ,), seed=SEED)
    batches = [loader.batch(i) for i in range(XLSTM_TRAIN_STEPS)]
    trainer = _train_100m_trainer(api, "auto")
    state = trainer.init(SEED, tree)
    check(trainer.is_flat and trainer.is_fused,
          "xlstm DPSGD did not take the fused flat engine")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    step_ms, losses = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, b)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m.loss))
    launches = {k.__name__: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = XLSTM_TRAIN_STEPS * trainer.rounds_per_step
    check(launches["gossip_mix_update_flat"] == want
          and sum(launches.values()) == want,
          f"xlstm training launches {launches}, want {want} gossip")
    check(all(np.isfinite(losses)), f"non-finite xlstm losses {losses}")
    after = state.params.clone()
    rows = state.params.shape[1]
    del trainer, state
    torch.cuda.empty_cache()
    ref = _train_100m_trainer(api, "ref")
    ref_state = ref.init(SEED, tree)
    for b in batches:
        ref_state, _ = ref.train_step(ref_state, b)
    err = float((ref_state.params - after).abs().max())
    check(err <= TRAIN_REF_ATOL, f"xlstm: kernel and plain training differ "
          f"by {err} after {XLSTM_TRAIN_STEPS} steps")
    del ref, ref_state, after, tree
    torch.cuda.empty_cache()
    return {"learners": TRAIN_LEARNERS, "local_batch": TRAIN_BATCH,
            "seq": XLSTM_TRAIN_SEQ, "algo": "dpsgd",
            "topology": "random_pair", "lr": TRAIN_LR,
            "store_rows": rows, "leaves": len(meta.dtypes),
            "bf16_leaves": sum(d == torch.bfloat16 for d in meta.dtypes),
            "step_wall_ms": step_ms, "losses": losses,
            "max_memory_allocated_gb": peak_gb, "kernel_launches": launches,
            f"ref_backend_max_abs_diff_after_{XLSTM_TRAIN_STEPS}_steps": err,
            "tier_abs": TRAIN_REF_ATOL}, launches["gossip_mix_update_flat"]


def xlstm_phase(kernels):
    """Phase 13: xlstm-350m at full width, served at XLSTM_LAYERS layers,
    decoded against its prefill and trained at full depth.  Returns
    (record, gossip launches)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    record, _ = cut_serve_phase(
        "xlstm-350m", XLSTM_LAYERS,
        "12 of 24 layers (6 mLSTM + 6 sLSTM), for the run's time limit",
        kernels, tier=XLSTM_SERVE_RTOL)
    torch.cuda.empty_cache()
    api = build_model(get_config("xlstm-350m"))
    params = api.init(SEED)
    record["decode_against_prefill"] = xlstm_decode_vs_prefill(api, params)
    del params
    torch.cuda.empty_cache()
    record["train"], gossip = xlstm_train(api, kernels)
    return record, gossip


def decode_profile(step, n=ZOO_PROFILED_STEPS):
    """Device busy ms and idle share of ``n`` calls of ``step()``."""
    times, _, wall, _ = device_times(lambda: [step() for _ in range(n)])
    busy_us = sum(v[0] for v in times.values())
    return {"steps": n, "wall_ms_per_step_profiled": 1e3 * wall / n,
            "device_busy_ms_per_step": busy_us / 1e3 / n,
            "device_idle_share": 1 - busy_us / 1e6 / wall,
            "device_kernels_per_step": sum(v[1] for v in times.values()) / n}


def zoo_decode(api, params, first, n_steps, cache_fn, prompt=None):
    """Greedy ``decode_step`` from ``cache_fn()``: the prompt's tokens
    (B, P) are fed first, then each step's argmax; with ``prompt`` None
    ``first`` (B,) starts it.  Returns (fed tokens (B, n_steps), logits a
    step, host ms a step)."""
    vocab = api.cfg.vocab
    cache = cache_fn()
    tok = first
    fed, logits, ms = [], [], []
    for pos in range(n_steps):
        if prompt is not None and pos < prompt.shape[1]:
            tok = prompt[:, pos]
        t0 = time.perf_counter()
        lg, cache = api.decode_step(params, cache, tok[:, None], pos)
        tok_next = lg[:, 0, :vocab].argmax(-1)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        fed.append(tok)
        logits.append(lg[:, 0, :vocab].float())
        tok = tok_next
    return torch.stack(fed, 1), logits, ms, cache


def forced_decode(api, params, tokens, cache_fn):
    """``decode_step`` fed ``tokens`` (B, T) -> logits a step."""
    cache, out = cache_fn(), []
    for pos in range(tokens.shape[1]):
        lg, cache = api.decode_step(params, cache, tokens[:, pos:pos + 1],
                                    pos)
        out.append(lg[:, 0, :api.cfg.vocab].float())
    return out


def cut_against_cpu(cfg, batch_fn, layer_owner, layer_fn, n_calls):
    """``cfg`` (depth cut to CUT_LAYERS) applied on the card and on the
    CPU to one batch: the logits' error and each layer's output's (the
    calls of ``layer_owner.layer_fn``), the CPU run once more one mantissa
    bit below bf16."""
    from repro_torch.models import build_model

    api, cpu_api = build_model(cfg), build_model(cfg, device="cpu")
    params = api.init(SEED)
    batch = batch_fn()
    layers = LayerOutputs(getattr(layer_owner, layer_fn), n_calls)
    setattr(layer_owner, layer_fn, layers)
    try:
        layers.on = True
        with torch.no_grad():
            card = api.apply(params, batch)[..., :cfg.vocab].float().cpu()
        card_layers, layers.kept = layers.kept, []
        cpu_params = module_on(params, "cpu")
        del params
        torch.cuda.empty_cache()
        cpu_batch = {k: v.cpu() for k, v in batch.items()}
        t0 = time.perf_counter()
        with torch.no_grad():
            cpu = cpu_api.apply(cpu_params, cpu_batch)[..., :cfg.vocab]
        cpu_s = time.perf_counter() - t0
        layers.on = False
        with torch.no_grad(), CoarseBF16():
            coarse = cpu_api.apply(cpu_params, cpu_batch)[..., :cfg.vocab]
    finally:
        setattr(layer_owner, layer_fn, layers.fn)
    check(len(card_layers) == len(layers.kept) == n_calls,
          f"{cfg.name}: kept {len(card_layers)} / {len(layers.kept)} of "
          f"{n_calls} layer outputs")
    by_layer = [_rel(a, b) for a, b in zip(card_layers, layers.kept)]
    return {"n_layers": cfg.n_layers, "enc_layers": cfg.enc_layers,
            "input_positions": {k: list(v.shape) for k, v in batch.items()},
            "cpu_s": cpu_s, "hidden_rel_err_by_layer": by_layer,
            "logits": held(f"{cfg.name} card against CPU", _rel(card, cpu),
                           _rel(card, coarse), CUT_RTOL)}


def vlm_phase():
    """Phase 14a: qwen2-vl-7b at full width and depth."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, transformer

    cfg = get_config("qwen2-vl-7b")
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = api.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    P = cfg.n_frontend_tokens
    batch = {"patch_embeds": (torch.randn((1, P, cfg.d_model), generator=gen,
                                          device="cuda")
                              .to(torch.bfloat16) * 0.1),
             "tokens": torch.randint(0, cfg.vocab, (1, VLM_TEXT),
                                     generator=gen, device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = api.apply(params, batch)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    check(logits.shape == (1, P + VLM_TEXT, cfg.padded_vocab)
          and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()),
          f"qwen2-vl prefill logits {tuple(logits.shape)} {logits.dtype}")
    prefill_peak = torch.cuda.max_memory_allocated() / 1e9
    del logits

    prompt = torch.randint(0, cfg.vocab, (ZOO_DECODE_SEQS, ZOO_PROMPT),
                           generator=gen, device="cuda")
    n = ZOO_PROMPT + ZOO_NEW

    def cache_fn():
        return api.init_cache(params, ZOO_DECODE_SEQS, n)

    fed, got, ms, cache = zoo_decode(api, params, None, n, cache_fn, prompt)
    with torch.no_grad():
        want = transformer.apply(params, cfg, fed)[..., :cfg.vocab]
    errs = step_rel(got, want)
    with CoarseBF16():
        coarse = step_rel(forced_decode(api, params, fed, cache_fn), want)
    tok = fed[:, -1:]
    prof = decode_profile(lambda: api.decode_step(params, cache, tok, n - 1))
    del params, cache, want, got
    torch.cuda.empty_cache()
    cut = cut_against_cpu(
        dataclasses.replace(cfg, n_layers=CUT_LAYERS,
                            n_frontend_tokens=CUT_INPUT),
        lambda: {"patch_embeds": (torch.randn(
            (1, CUT_INPUT, cfg.d_model), generator=gen, device="cuda")
            .to(torch.bfloat16) * 0.1),
            "tokens": torch.randint(0, cfg.vocab, (1, CUT_INPUT),
                                    generator=gen, device="cuda")},
        transformer, "_layer_forward", CUT_LAYERS)
    torch.cuda.empty_cache()
    return {"model": cfg.name, "n_layers": cfg.n_layers,
            "n_params": n_params, "dtype": cfg.param_dtype, "init_s": init_s,
            "prefill": {"patches": P, "text_tokens": VLM_TEXT,
                        "wall_ms": prefill_ms,
                        "max_memory_allocated_gb": prefill_peak,
                        "route": "chunked (M-RoPE; no flash route)"},
            "decode": {"sequences": ZOO_DECODE_SEQS,
                       "prompt_tokens": ZOO_PROMPT, "new_tokens": ZOO_NEW,
                       "step_ms_mean": float(np.mean(ms)),
                       "step_ms_median": float(np.median(ms)),
                       "step_ms_p95": float(np.percentile(ms, 95)),
                       "profile": prof,
                       "against_apply": held(
                           "qwen2-vl decode against apply", max(errs),
                           min(coarse), ZOO_DECODE_RTOL)},
            "cut_against_cpu": cut}


def audio_phase():
    """Phase 14b: seamless-m4t-large-v2 at full width and depth."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, encdec

    cfg = get_config("seamless-m4t-large-v2")
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = api.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    frames = (torch.randn((ZOO_DECODE_SEQS, AUDIO_FRAMES, cfg.d_model),
                          generator=gen, device="cuda")
              .to(torch.bfloat16) * 0.1)
    first = torch.randint(0, cfg.vocab, (ZOO_DECODE_SEQS,), generator=gen,
                          device="cuda")
    torch.cuda.reset_peak_memory_stats()

    def cache_fn():
        return api.init_cache(params, frames, ZOO_NEW)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache_fn()
    torch.cuda.synchronize()
    encode_ms = 1e3 * (time.perf_counter() - t0)
    fed, got, ms, cache = zoo_decode(api, params, first, ZOO_NEW, cache_fn)
    with torch.no_grad():
        want = api.apply(params, {"frames": frames,
                                  "tokens": fed})[..., :cfg.vocab]
    check(bool(torch.isfinite(want).all()), "non-finite seamless logits")
    errs = step_rel(got, want)
    with CoarseBF16():
        coarse = step_rel(forced_decode(api, params, fed, cache_fn), want)
    peak = torch.cuda.max_memory_allocated() / 1e9
    tok = fed[:, -1:]
    prof = decode_profile(
        lambda: api.decode_step(params, cache, tok, ZOO_NEW - 1))
    del params, cache, want, got
    torch.cuda.empty_cache()
    cut = cut_against_cpu(
        dataclasses.replace(cfg, n_layers=CUT_LAYERS, enc_layers=CUT_LAYERS),
        lambda: {"frames": (torch.randn((1, CUT_INPUT, cfg.d_model),
                                        generator=gen, device="cuda")
                            .to(torch.bfloat16) * 0.1),
                 "tokens": torch.randint(0, cfg.vocab, (1, CUT_INPUT),
                                         generator=gen, device="cuda")},
        encdec, "_ff", 2 * CUT_LAYERS)
    torch.cuda.empty_cache()
    return {"model": cfg.name, "n_layers": cfg.n_layers,
            "enc_layers": cfg.enc_layers, "n_params": n_params,
            "dtype": cfg.param_dtype, "init_s": init_s,
            "encode": {"frames": [ZOO_DECODE_SEQS, AUDIO_FRAMES],
                       "init_cache_wall_ms": encode_ms},
            "decode": {"sequences": ZOO_DECODE_SEQS, "new_tokens": ZOO_NEW,
                       "step_ms_mean": float(np.mean(ms)),
                       "step_ms_median": float(np.median(ms)),
                       "step_ms_p95": float(np.percentile(ms, 95)),
                       "profile": prof,
                       "against_teacher_forced_apply": held(
                           "seamless decode against apply", max(errs),
                           min(coarse), ZOO_DECODE_RTOL)},
            "max_memory_allocated_gb": peak,
            "cut_against_cpu": cut}


# ---------------------------------------------------------------------------
# phase 15: the elastic fleet
# ---------------------------------------------------------------------------

def _window(trainer, state, batches, lo, hi):
    """Steps ``lo`` to ``hi`` of ``batches``; returns (state, metrics, ms
    a step on the host clock, ending in a sync)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms = []
    for i in range(lo, hi):
        state, m = trainer.train_step(state, batches[i])
        ms.append(m)
    torch.cuda.synchronize()
    return state, ms, 1e3 * (time.perf_counter() - t0) / (hi - lo)


def _poisoned_twin(api, tree, trainer, state, dead):
    """A second fleet holding ``state`` with learner ``dead``'s parameter
    and momentum rows set to NaN (through ``state_from_view``)."""
    from repro_torch.tree import tree_map

    def poison(x):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()
                and x.dim() >= 1 and x.shape[0] == TRAIN_LEARNERS):
            return x
        y = x.clone()
        y[dead] = float("nan")
        return y
    twin = _train_100m_trainer(api, "auto")
    twin.init(SEED, tree)
    view = trainer.state_view(state)
    return twin, twin.state_from_view(view._replace(
        params=tree_map(poison, view.params),
        opt_state=tree_map(poison, view.opt_state)))


def elastic_checkpoint(trainer, state):
    """Phase 15b: the elastic state (its ``state_view``: parameters,
    momentum, the membership arrays) saved, verified and restored into the
    trainer through ``state_from_view``, bitwise; a torn copy standing as
    a newer step is skipped.  Returns (state, record)."""
    import os
    import tempfile

    from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                        save_checkpoint, verify_checkpoint)
    from repro_torch.tree import tree_leaves

    view = trainer.state_view(state)
    saved = [x.clone() for x in tree_leaves(view)
             if isinstance(x, torch.Tensor)]
    n_bytes = sum(x.numel() * x.element_size() for x in saved)
    step = state.step
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = save_checkpoint(d, step, view)
        write_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        ok = verify_checkpoint(d, step)
        verify_s = time.perf_counter() - t0
        check(ok, "the elastic checkpoint does not verify")
        torn = os.path.join(d, f"ckpt_{step + 1}.npz")
        with open(path, "rb") as src, open(torn, "wb") as dst:
            dst.write(src.read(CKPT_TORN_BYTES))
        check(latest_step(d) == step + 1 and not verify_checkpoint(
            d, step + 1), "the torn copy is not an unverified newer step")
        t0 = time.perf_counter()
        back, got_step = restore_checkpoint(d, view)
        state = trainer.state_from_view(back)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    check(got_step == step, f"restored step {got_step}, not {step}: the "
          "torn newer file was not skipped")
    got = [x for x in tree_leaves(trainer.state_view(state))
           if isinstance(x, torch.Tensor)]
    check(len(got) == len(saved) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, saved)),
        "the restored elastic state is not bitwise the saved one")
    del saved, back, got, view
    torch.cuda.empty_cache()
    return state, {"state_bytes": n_bytes, "file_bytes": file_bytes,
                   "write_s": write_s, "verify_s": verify_s,
                   "restore_s": restore_s,
                   "torn_newer_step_skipped": True, "bitwise": True}


def elastic_script(api, tree, batches, backend, extras=False):
    """Phase 15a's script on a fresh fleet of 4: ELASTIC_WINDOW steps
    healthy, ``crash(ELASTIC_DEAD)``, as many with one dead, ``admit``
    (consensus) and ``rejoin``, as many again; the dead learner's
    parameter and momentum rows bitwise frozen while it is dead, the
    admitted row the live mean.  ``extras`` (the kernel run): a
    NaN-poisoned twin fleet steps the dead window beside it, and phase
    15b's checkpoint follows that window.  Returns (trainer, state,
    record)."""
    from repro_torch.core import Membership, admit

    W, dead = ELASTIC_WINDOW, ELASTIC_DEAD
    live = [i for i in range(TRAIN_LEARNERS) if i != dead]
    tr = _train_100m_trainer(api, backend)
    mem = Membership(TRAIN_LEARNERS)
    st = tr.set_membership(tr.init(SEED, tree), mem)
    rec, n_active = {}, []
    st, ms, rec["healthy_ms_per_step"] = _window(tr, st, batches, 0, W)
    rec["healthy_params"] = st.params.clone()
    n_active.append(float(ms[-1].n_active))

    mem.crash(dead)
    st = tr.set_membership(st, mem)
    mu = tr._fused.read_mu(st.opt_state)
    frozen = (st.params[dead].clone(), mu[dead].clone())
    if extras:
        twin, tw = _poisoned_twin(api, tree, tr, st, dead)
        poisoned = tw.params[dead].view(torch.int32).clone()
        check(bool(torch.isnan(tw.params[dead]).any()), "no NaN in the "
              "twin's dead row")
    st, ms, rec["one_dead_ms_per_step"] = _window(tr, st, batches, W, 2 * W)
    mu = tr._fused.read_mu(st.opt_state)
    check(torch.equal(st.params[dead], frozen[0])
          and torch.equal(mu[dead], frozen[1]),
          f"{backend}: the dead learner's parameter or momentum row moved")
    n_active.append(float(ms[-1].n_active))
    del frozen
    if extras:
        tw, tw_ms, _ = _window(twin, tw, batches, W, 2 * W)
        tw_mu = twin._fused.read_mu(tw.opt_state)
        check(torch.equal(tw.params[live], st.params[live])
              and torch.equal(tw_mu[live], mu[live])
              and bool(torch.isfinite(st.params[live]).all())
              and [float(m.loss) for m in tw_ms]
              == [float(m.loss) for m in ms],
              "a NaN-poisoned dead row changed the live learners")
        check(torch.equal(tw.params[dead].view(torch.int32), poisoned),
              "the poisoned row did not stay quarantined bitwise")
        rec["nan_twin_live_rows_bitwise"] = True
        del twin, tw, tw_mu, tw_ms, poisoned
        torch.cuda.empty_cache()
        st, rec["checkpoint"] = elastic_checkpoint(tr, st)

    st = admit(tr, st, dead, mode="consensus")
    mean = torch.mean(st.params[live], dim=0)
    rec["admit_rel_err"] = float((st.params[dead] - mean).abs().max()
                                 / mean.abs().max())
    check(rec["admit_rel_err"] <= ADMIT_RTOL,
          f"{backend}: the admitted row is {rec['admit_rel_err']} from the "
          "live mean")
    check(not bool(tr._fused.read_mu(st.opt_state)[dead].any()),
          "admit kept the joiner's old momentum")
    del mean
    mem.rejoin(dead)
    st = tr.set_membership(st, mem)
    st, ms, rec["rejoined_ms_per_step"] = _window(tr, st, batches, 2 * W,
                                                  3 * W)
    n_active.append(float(ms[-1].n_active))
    rec["n_active_by_window"] = n_active
    rec["losses_rejoined"] = [float(m.loss) for m in ms]
    check(n_active == [4.0, 3.0, 4.0]
          and all(np.isfinite(rec["losses_rejoined"]))
          and bool(torch.isfinite(st.params).all()),
          f"{backend}: n_active {n_active}, losses "
          f"{rec['losses_rejoined']}")
    return tr, st, rec


def elastic_ring(api, tree, batches):
    """Phase 15a on ``ring``: one crash before the first step, so the
    fleet runs ``reschedule``'s K = 2 tables for 3 live learners at full
    width, ELASTIC_WINDOW steps with the kernel against ``ref``.  Returns
    (record, gossip launches of the kernel run)."""
    from repro_torch.core import AlgoConfig, Membership, MultiLearnerTrainer
    from repro_torch.optim import scale_by_schedule, sgd, warmup_linear_scale

    out = {}
    for backend in ("auto", "ref"):
        opt = scale_by_schedule(sgd(TRAIN_LR, momentum=0.9),
                                warmup_linear_scale(10, 1.0))
        tr = MultiLearnerTrainer(
            api.loss_fn, opt,
            AlgoConfig(algo="dpsgd", topology="ring",
                       n_learners=TRAIN_LEARNERS),
            kernel_backend=backend, params_from_tree=api.params_from_tree)
        mem = Membership(TRAIN_LEARNERS)
        mem.crash(ELASTIC_DEAD)
        st = tr.set_membership(tr.init(SEED, tree), mem)
        K = int(st.members.partners.shape[1])
        row = st.params[ELASTIC_DEAD].clone()
        st, ms, step_ms = _window(tr, st, batches, 0, ELASTIC_WINDOW)
        check(torch.equal(st.params[ELASTIC_DEAD], row)
              and all(np.isfinite(float(m.loss)) for m in ms),
              f"ring {backend}: the dead row moved or a loss is not finite")
        out[backend] = (st.params.clone(), K, step_ms)
        del tr, st, row
        torch.cuda.empty_cache()
    err = float((out["auto"][0] - out["ref"][0]).abs().max())
    check(out["auto"][1] == 2 and err <= TRAIN_REF_ATOL,
          f"ring, one dead: K {out['auto'][1]}, kernel against ref {err}")
    return {"K": out["auto"][1], "ms_per_step": out["auto"][2],
            "ref_max_abs_diff": err, "steps": ELASTIC_WINDOW}


def elastic_train_phase(kernels):
    """Phase 15a-b (module docstring).  Returns (record, gossip launches
    of the path)."""
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, SyntheticTokenStream
    from repro_torch.models import build_model

    W = ELASTIC_WINDOW
    cfg = get_config("transformer-100m")
    api = build_model(cfg)
    tree = api.param_tree(api.init(SEED))
    loader = ShardedLoader(SyntheticTokenStream(vocab=cfg.vocab),
                           n_learners=TRAIN_LEARNERS,
                           local_batch=TRAIN_BATCH, extra_args=(TRAIN_SEQ,),
                           seed=SEED)
    batches = [loader.batch(i) for i in range(3 * W + 1)]

    # the fixed fleet's first W steps: what the healthy window must equal
    legacy = _train_100m_trainer(api, "auto")
    st = legacy.init(SEED, tree)
    for i in range(W):
        st, _ = legacy.train_step(st, batches[i])
    legacy_params = st.params.clone()
    del legacy, st
    torch.cuda.empty_cache()

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    tr, st, rec = elastic_script(api, tree, batches, "auto", extras=True)
    check(torch.equal(rec.pop("healthy_params"), legacy_params),
          "the all-active elastic fleet is not bitwise the fixed fleet")
    del legacy_params
    final = st.params.clone()
    # one more step, profiled: where the rejoined fleet's time goes
    times, api_calls, wall, host = device_times(
        lambda: tr.train_step(st, batches[3 * W]))
    rec["profile_rejoined"] = train_profile(times, api_calls, wall, host, 1)
    del tr, st
    torch.cuda.empty_cache()
    ring = elastic_ring(api, tree, batches)
    launches = {k.__name__: k.launches for k in kernels}
    wall_s = time.perf_counter() - t0
    want = 3 * W + W + 1 + W        # script, twin, profiled step, ring
    check(launches["gossip_mix_update_flat"] == want
          and sum(launches.values()) == want,
          f"elastic training launches {launches}, want {want} of the "
          "gossip kernel alone")

    _, ref_st, _ = elastic_script(api, tree, batches, "ref")
    ref_err = float((ref_st.params - final).abs().max())
    check(ref_err <= TRAIN_REF_ATOL,
          f"elastic script: kernel and plain differ by {ref_err}")
    del ref_st, final
    torch.cuda.empty_cache()
    rec.update({
        "model": cfg.name, "learners": TRAIN_LEARNERS, "seq": TRAIN_SEQ,
        "local_batch": TRAIN_BATCH, "window_steps": W,
        "dead": ELASTIC_DEAD, "all_active_bitwise_legacy": True,
        "ref_max_abs_diff_after_script": ref_err, "ring_one_dead": ring,
        "wall_s_kernel_runs": wall_s, "kernel_launches": launches})
    return rec, launches["gossip_mix_update_flat"]


def _faults_plan(steps):
    """``benchmarks/faults.py``'s crash-rejoin scenario: learner 1 dies at
    a third of the run and rejoins (consensus) at two thirds, learner 0 is
    a 2x straggler throughout."""
    from repro_torch.core import FaultPlan
    plan = FaultPlan.crash_rejoin(1, steps // 3, 2 * steps // 3)
    return FaultPlan(plan.events + FaultPlan.straggler(0, 2).events)


def fc_faults_phase(kernels):
    """Phase 15c: the FC net through ``train_fc(fault_plan=...)``, each run
    with the kernel and with ``kernel_backend="ref"``: the final stores
    within TRAIN_REF_ATOL, the supervisors' reports equal, every loss
    finite.  Returns (record, gossip launches)."""
    from repro_torch.bench.common import final_loss, train_fc
    from repro_torch.core import FaultEvent, FaultPlan
    from repro_torch.core.schedule import DETERMINISTIC_TOPOLOGIES

    S = FAULT_STEPS
    cases = [  # (name, algo, topology, n, steps, plan, what must happen)
        ("crash_rejoin_dpsgd", "dpsgd", "random_pair", FAULT_N, S,
         _faults_plan(S), dict(crashes=[(S // 3, 1)],
                               rejoins=[(2 * S // 3, 1)])),
        ("crash_rejoin_adpsgd", "adpsgd", "random_pair", FAULT_N, S,
         _faults_plan(S), dict(crashes=[(S // 3, 1)],
                               rejoins=[(2 * S // 3, 1)])),
        ("chaos_random_0_120_8", "dpsgd", "random_pair", 8, 120,
         FaultPlan.random(0, 120, 8), {}),
        ("sticky_hang_evicted", "dpsgd", "random_pair", FAULT_N, S,
         FaultPlan((FaultEvent(0, "hang", 2, True),)),
         dict(evictions=[(HANG_EVICTED_AT, 2)]))]
    cases += [(f"crash_{t}", "dpsgd", t, FAULT_N, S // 2,
               FaultPlan.crash_rejoin(1, S // 6),
               dict(crashes=[(S // 6, 1)]))
              for t in DETERMINISTIC_TOPOLOGIES]
    out = {}
    gossip_kernel = {k.__name__: k for k in kernels}["gossip_mix_update_flat"]
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    for name, algo, topology, n, steps, plan, want in cases:
        kw = dict(n=n, local_batch=FAULT_BATCH, steps=steps,
                  topology=topology, fault_plan=plan,
                  algo_kwargs=(dict(max_staleness=4) if algo == "adpsgd"
                               else None))
        before = gossip_kernel.launches
        run = train_fc(algo, FAULT_LR, **kw)
        gossip = gossip_kernel.launches - before
        ref = train_fc(algo, FAULT_LR, kernel_backend="ref", **kw)
        err = float((run["state"].params - ref["state"].params).abs().max())
        rep, rep_ref = run["supervisor"].report, ref["supervisor"].report
        report = {f: getattr(rep, f) for f in (
            "crashes", "rejoins", "retries", "evictions", "dropped_rounds")}
        check(report == {f: getattr(rep_ref, f) for f in report},
              f"{name}: the kernel and ref runs' reports differ")
        check(all(report[f] == v for f, v in want.items()),
              f"{name}: report {report}, want {want}")
        check(err <= TRAIN_REF_ATOL and all(np.isfinite(run["losses"])),
              f"{name}: kernel against ref {err}, or a non-finite loss")
        check(gossip >= steps, f"{name}: {gossip} gossip launches in "
              f"{steps} steps")
        out[name] = {"algo": algo, "topology": topology, "n": n,
                     "steps": steps, "events": len(plan.events),
                     "report": report,
                     "n_active_end": run["supervisor"].membership.n_active,
                     "final_loss": final_loss(run["losses"]),
                     "ref_max_abs_diff": err,
                     "us_per_step": run["us_per_step"],
                     "gossip_launches": gossip}
    launches = {k.__name__: k.launches for k in kernels}
    check(sum(launches.values()) == launches["gossip_mix_update_flat"],
          f"the FC fault runs launched another path's kernel: {launches}")
    out["wall_s"] = time.perf_counter() - t0
    return out, launches["gossip_mix_update_flat"]


def fig3_phase(kernels):
    """Phase 15d: the Fig. 3 twin at its full settings, held to what the
    reference's run shows (``fig3_straggler.check``).  Returns (record,
    gossip launches)."""
    from repro_torch.bench import fig3_straggler as f3

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = f3.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    f3.check(res["rows"], res["steps"])
    want = (1 + len(f3.SLOW_FACTORS)) * f3.STEPS     # one round a step
    check(launches["gossip_mix_update_flat"] == want
          and sum(launches.values()) == want,
          f"fig3 launches {launches}, want {want} gossip launches")
    derived = f3.derived(res["rows"])
    print(f"fig3_straggler,{res['wall_us']:.0f},{derived}", flush=True)
    return {"rows": res["rows"], "columns": f3.COLUMNS, "derived": derived,
            "wall_s": wall, "kernel_launches": launches}, want


def elastic_phase(kernels):
    """Phase 15: a-d.  Returns (record, gossip launches by path)."""
    train, train_gossip = elastic_train_phase(kernels)
    faults, faults_gossip = fc_faults_phase(kernels)
    fig3, fig3_gossip = fig3_phase(kernels)
    return {"transformer_100m": train, "fc_faults": faults, "fig3": fig3}, {
        "transformer_100m_elastic_training": train_gossip,
        "fc_elastic_faults": faults_gossip, "fig3_straggler": fig3_gossip}


# ---------------------------------------------------------------------------
# phase 16: the launch path on torch.distributed
# ---------------------------------------------------------------------------

def _launch_opt():
    from repro_torch import train_100m
    return train_100m.recipe(TRAIN_LR)


def _tree_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_paths(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _save_stacked(api, wdir, n=LAUNCH_RANKS):
    """Each learner's initial weights (transformer-100m from seed SEED + r,
    on the card), stacked over the n learners as the reference's stacked
    state is: one .npy per leaf and an index of the leaves' paths."""
    trees = [_tree_paths(api.param_tree(api.init(SEED + r)))
             for r in range(n)]
    paths = sorted(trees[0])
    for i, path in enumerate(paths):
        np.save(Path(wdir) / f"{i}.npy",
                np.stack([t[path].cpu().numpy() for t in trees]))
    (Path(wdir) / "index.json").write_text(json.dumps(paths))


def _load_stacked(wdir):
    """``_save_stacked``'s tree, every leaf memory-mapped."""
    tree = {}
    paths = json.loads((Path(wdir) / "index.json").read_text())
    for i, path in enumerate(paths):
        node = tree
        *head, leaf = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = np.load(Path(wdir) / f"{i}.npy", mmap_mode="r")
    return tree


def _launch_step(name, api):
    from repro_torch.launch.train import (make_adpsgd_train_step,
                                          make_dpsgd_train_step)
    if name == "adpsgd":
        return make_adpsgd_train_step(
            api, _launch_opt(), max_staleness=LAUNCH_STALENESS,
            slow_learner=LAUNCH_SLOW, slow_factor=LAUNCH_SLOW_FACTOR)
    return make_dpsgd_train_step(api, _launch_opt(),
                                 topology=name.split("_", 1)[1])


def _launch_loader(cfg):
    from repro_torch.data import ShardedLoader, SyntheticTokenStream
    return ShardedLoader(SyntheticTokenStream(vocab=cfg.vocab),
                         n_learners=LAUNCH_RANKS, local_batch=TRAIN_BATCH,
                         extra_args=(TRAIN_SEQ,), seed=SEED)


def launch_rank(rank, port, wdir, queue, cases=LAUNCH_CASES):
    """One gloo rank of phase 16a (and 18c), run in a spawned process:
    puts (rank, record, None) on ``queue``, or (rank, None, the
    traceback)."""
    import traceback
    try:
        queue.put((rank, _launch_rank(rank, port, wdir, cases), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def _launch_rank(rank, port, wdir, cases=LAUNCH_CASES):
    """Train every case of ``cases`` as rank ``rank``: the first step
    warms up, the others are timed (host clock ending in a sync, split by
    the step's own timing into compute, exchange and kernel).  Then phase
    18c, the launch step's audit.  Rank 0 gathers every rank's final rows
    and holds them against the trainer."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import gossip_mix
    from repro_torch.launch import init_learner_group
    from repro_torch.launch.train import rank_state_from_numpy
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_learner_group(rank, LAUNCH_RANKS, f"tcp://127.0.0.1:{port}",
                       backend="gloo", timeout_s=LAUNCH_TIMEOUT_S)
    cfg = get_config("transformer-100m")
    api = build_model(cfg)
    params = _load_stacked(wdir)
    loader = _launch_loader(cfg)
    kernel = gossip_mix.gossip_mix_update_flat
    kernel.launches = 0
    records, finals = {}, {}
    for name, steps in cases:
        batches = [tree_map(lambda x: x[rank], loader.batch(t))
                   for t in range(steps)]
        step = _launch_step(name, api)
        state = rank_state_from_numpy(
            step, params, buffer=params if name == "adpsgd" else None,
            seed=SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = kernel.launches
        losses, walls, rounds = [], [], []
        for t in range(steps):
            if t == 1:
                step.timing = {}
            t0 = time.perf_counter()
            state, m = step(state, batches[t])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(m["loss"])
            rounds.append(step.last_rounds)
        timed = steps - 1
        records[name] = {
            "steps": steps, "timed_steps": timed,
            "ms_per_step": 1e3 * sum(walls[1:]) / timed,
            "first_step_ms": 1e3 * walls[0],
            "parts_ms_per_step": {k: 1e3 * v / timed
                                  for k, v in step.timing.items()},
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
            / 1e9,
            "launches": kernel.launches - before,
            "rounds": rounds, "sends": step.sends, "recvs": step.recvs,
            "bytes_received": step.bytes_received,
            "store_bytes": state.params.numel()
            * state.params.element_size(),
            "losses": torch.stack(losses).tolist()}
        finals[name] = [state.params[0].cpu()] + (
            [state.buffer[0].cpu()] if name == "adpsgd" else [])
        del step, state, batches
        torch.cuda.empty_cache()
    record = {"cases": records, "audit": _launch_audit(rank, api, params,
                                                        loader)}
    gathered = {}
    t0 = time.perf_counter()
    for name, rows in finals.items():
        for j, row in enumerate(rows):
            out = ([torch.empty_like(row) for _ in range(LAUNCH_RANKS)]
                   if rank == 0 else None)
            dist.gather(row, out, dst=0)
            gathered[(name, j)] = out
    record["gather_s"] = time.perf_counter() - t0
    del finals
    if rank == 0 and cases:
        record["against_trainer"] = _launch_against_trainer(
            api, params, loader, gathered)
    dist.destroy_process_group()
    return record


def _launch_audit(rank, api, params, loader):
    """Phase 18c, in this rank of phase 16's group: the auditor's launch
    rules (``analysis.targets.audit_launch_step``) over LAUNCH_AUDIT_STEPS
    DPSGD steps on ring with the point-to-point backend at full width:
    sends against the live slots the rank takes part in, the wire dtype,
    no parameter-sized concatenate, no host read, the stores written in
    place.  gloo stages CUDA tensors through the host and syncs the stream
    by design, so these steps do not run under the sync debug mode."""
    from repro_torch.analysis.targets import audit_launch_step
    from repro_torch.kernels import gossip_mix
    from repro_torch.launch.train import (make_dpsgd_train_step,
                                          rank_state_from_numpy)
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    step = make_dpsgd_train_step(api, _launch_opt(), topology="ring",
                                 gossip_backend="ppermute")
    state = rank_state_from_numpy(step, params, seed=SEED)
    shapes = tree_map(lambda a: torch.empty(a.shape[1:], device="meta"),
                      params)
    batches = [tree_map(lambda x: x[rank], loader.batch(t))
               for t in range(LAUNCH_AUDIT_STEPS)]
    kernel = gossip_mix.gossip_mix_update_flat
    before = kernel.launches
    report = {}
    found = audit_launch_step(step, state, batches, params_tree=shapes,
                              target=f"launch.dpsgd_step[ppermute]@rank"
                                     f"{rank}", report=report)
    report.update(findings=[str(f) for f in found],
                  gossip_launches=kernel.launches - before,
                  seconds=time.perf_counter() - t0)
    del step, state, batches
    torch.cuda.empty_cache()
    return report


def _launch_against_trainer(api, params, loader, gathered):
    """The single-process ``MultiLearnerTrainer`` (4 learners on the card,
    ``kernel_backend="ref"``: the gossip kernel's plain version) from the
    same weights, fed the same batches and tables (the host-drawn
    matchings, the hypercube for AD-PSGD): each case's max abs gap to the
    ranks' final rows, which kernel #2 made at n = 1."""
    from repro_torch.core import AlgoConfig, MultiLearnerTrainer
    from repro_torch.core.dpsgd import hypercube_tables
    from repro_torch.core.flatstate import flat_meta
    from repro_torch.launch.train import drawn_rounds
    from repro_torch.models.convert import tree_from_jax
    from repro_torch.tree import tree_map

    stacked = tree_from_jax(params, device="cuda")
    single = tree_map(lambda x: x[0], stacked)
    out = {}
    for name, steps in LAUNCH_CASES:
        if name == "adpsgd":
            algo = AlgoConfig(algo="adpsgd", topology="random_pair",
                              n_learners=LAUNCH_RANKS,
                              max_staleness=LAUNCH_STALENESS,
                              slow_learner=LAUNCH_SLOW,
                              slow_factor=LAUNCH_SLOW_FACTOR)
        else:
            algo = AlgoConfig(algo="dpsgd", topology=name.split("_", 1)[1],
                              n_learners=LAUNCH_RANKS)
        tr = MultiLearnerTrainer(api.loss_fn, _launch_opt(), algo,
                                 kernel_backend="ref",
                                 params_from_tree=api.params_from_tree)
        state = tr.init(SEED, single)
        state.params.copy_(flat_meta(single).flatten(stacked))
        if state.buffer is not None:
            state.buffer.copy_(state.params)
        for t in range(steps):
            rounds = ([hypercube_tables(t, LAUNCH_RANKS)]
                      if name == "adpsgd" else
                      drawn_rounds(SEED, t, LAUNCH_RANKS)
                      if name == "dpsgd_random_pair" else None)
            state, _ = tr.train_step(state, loader.batch(t), rounds)
        rec = {}
        for j, (what, want) in enumerate(
                (("params", state.params), ("buffer", state.buffer))):
            if (name, j) in gathered:
                got = torch.stack(gathered[(name, j)]).to("cuda")
                rec[f"{what}_max_abs_err"] = float(
                    (got - want).abs().max())
                del got
        out[name] = rec
        del tr, state
        torch.cuda.empty_cache()
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launch_ranks(wdir, cases=LAUNCH_CASES):
    """Phase 16a's ranks (and 18c's), spawned together; returns {rank:
    record}.  A failed rank fails the phase, and every rank is joined or
    ended."""
    import queue as queues

    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=launch_rank,
                         args=(r, port, wdir, results, cases))
             for r in range(LAUNCH_RANKS)]
    for p in procs:
        p.start()
    out = {}
    try:
        deadline = time.monotonic() + LAUNCH_TIMEOUT_S
        while len(out) < LAUNCH_RANKS:
            left = deadline - time.monotonic()
            try:
                rank, record, err = results.get(timeout=max(left, 1))
            except queues.Empty:
                raise RuntimeError(f"launch ranks silent for "
                                   f"{LAUNCH_TIMEOUT_S} s; got {sorted(out)}")
            check(err is None, f"launch rank {rank} failed:\n{err}")
            out[rank] = record
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    check(all(p.exitcode == 0 for p in procs),
          f"launch rank exit codes {[p.exitcode for p in procs]}")
    return out


def _launch_nccl(api, wdir):
    """Phase 16b: world size 1 over NCCL in this process: one SSGD step
    (its gradient all_reduce through NCCL) and one solo DPSGD step, each
    against the trainer (plain kernels) at n = 1 from the same weights and
    batch.  Each step runs under ``torch.cuda.set_sync_debug_mode("error")``,
    so a host sync in it fails the phase.  At world size 1 the DPSGD step
    has no neighbour: no point-to-point op and no gossip kernel runs here
    (they wait for a machine with more than one card)."""
    import torch.distributed as dist

    from repro_torch.core import AlgoConfig, MultiLearnerTrainer
    from repro_torch.launch import init_learner_group
    from repro_torch.launch.train import (make_dpsgd_train_step,
                                          make_ssgd_train_step,
                                          rank_state_from_numpy)
    from repro_torch.models.convert import tree_from_jax
    from repro_torch.tree import tree_map

    init_learner_group(0, 1, f"tcp://127.0.0.1:{_free_port()}",
                       device=torch.device("cuda", 0), timeout_s=120)
    out = {"backend": dist.get_backend()}
    try:
        params = _load_stacked(wdir)
        single = tree_from_jax(tree_map(lambda a: a[0], params),
                               device="cuda")
        stacked = tree_map(lambda x: x[:1], _launch_loader(api.cfg).batch(0))
        batch = tree_map(lambda x: x[0], stacked)
        warm = torch.ones(1, device="cuda")   # the communicator, made now
        dist.all_reduce(warm)
        for algo, make in (("ssgd", make_ssgd_train_step),
                           ("dpsgd", make_dpsgd_train_step)):
            step = make(api, _launch_opt())
            state = rank_state_from_numpy(step, params, seed=SEED)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                state, m = step(state, batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            tr = MultiLearnerTrainer(
                api.loss_fn, _launch_opt(),
                AlgoConfig(algo=algo, topology="random_pair", n_learners=1),
                engine="flat", kernel_backend="ref",
                params_from_tree=api.params_from_tree)
            ts, tm = tr.train_step(tr.init(SEED, single), stacked)
            err = float((state.params - ts.params).abs().max())
            check(err <= TRAIN_REF_ATOL,
                  f"nccl {algo} step and the trainer differ by {err}")
            check(np.isfinite(float(m["loss"])), f"nccl {algo} loss")
            out[algo] = {"ms_first_step": ms, "max_abs_err": err,
                         "host_syncs_in_step": 0,
                         "all_reduces": step.collectives,
                         "sends": step.sends, "recvs": step.recvs,
                         "loss": float(m["loss"]),
                         "trainer_loss": float(tm.loss)}
            del step, state, tr, ts
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def launch_phase(kernels):
    """Phase 16: a-b, with 18c in a's ranks.  Returns (record, gossip
    launches by path, 18c's record)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import analytic
    from repro_torch.models import build_model

    cfg = get_config("transformer-100m")
    api = build_model(cfg)
    with tempfile.TemporaryDirectory() as wdir:
        t0 = time.perf_counter()
        _save_stacked(api, wdir)
        torch.cuda.empty_cache()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = _launch_ranks(wdir)
        ranks_s = time.perf_counter() - t0
        nccl = _launch_nccl(api, wdir)

    store = ranks[0]["cases"]["dpsgd_ring"]["store_bytes"]
    record = {
        "transport": "gloo over TCP loopback, every collective (each "
                     "exchange, the loss all_reduce) staged through pinned "
                     "host memory; 4 ranks sharing one H100 (not NCCL)",
        "model": cfg.name, "ranks": LAUNCH_RANKS, "local_batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "lr": TRAIN_LR, "weights_setup_s": setup_s,
        "ranks_wall_s": ranks_s, "store_bytes": store,
        "analytic_ring_link_bytes_per_rank_round":
            analytic.gossip_link_bytes_per_chip(cfg, LAUNCH_RANKS,
                                                LAUNCH_RANKS, "ppermute"),
        "cases": {}, "nccl_world_size_1": nccl}
    launches = {}
    for name, steps in LAUNCH_CASES:
        K = 2 if name == "dpsgd_ring" else 1
        per = [ranks[r]["cases"][name] for r in range(LAUNCH_RANKS)]
        launches[name] = sum(c["launches"] for c in per)
        check(launches[name] == LAUNCH_RANKS * steps,
              f"{name}: {launches[name]} gossip launches, not "
              f"{LAUNCH_RANKS} ranks x {steps} steps x 1 round")
        for r, c in enumerate(per):
            check(c["rounds"] == [[(K, K)]] * steps,
                  f"{name} rank {r}: point-to-point ops {c['rounds']}, "
                  f"not one send and one receive per live slot ({K})")
            check(c["bytes_received"] == steps * K * store,
                  f"{name} rank {r}: {c['bytes_received']} bytes received")
            check(all(np.isfinite(c["losses"])),
                  f"{name} rank {r}: losses {c['losses']}")
        gaps = ranks[0]["against_trainer"][name]
        check(all(v <= TRAIN_REF_ATOL for v in gaps.values()),
              f"{name}: the ranks and the trainer differ by {gaps}")
        record["cases"][name] = {
            "steps": steps, "slots_per_round": K,
            "bytes_received_per_rank_round": K * store,
            "gossip_launches": launches[name],
            "against_trainer": gaps,
            "ms_per_step_by_rank": [c["ms_per_step"] for c in per],
            "first_step_ms_by_rank": [c["first_step_ms"] for c in per],
            "parts_ms_per_step_by_rank": [c["parts_ms_per_step"]
                                          for c in per],
            "max_memory_allocated_gb_by_rank": [
                c["max_memory_allocated_gb"] for c in per],
            "losses_rank0": per[0]["losses"]}
    record["gather_s_rank0"] = ranks[0]["gather_s"]
    launches = {f"launch_{k}_4_gloo_ranks": v for k, v in launches.items()}
    audit = launch_audit_record(ranks)
    launches["launch_audit_ring_ppermute_4_gloo_ranks"] = audit[
        "gossip_launches"]
    return record, launches, audit


def launch_audit_record(ranks):
    """Phase 18c's checks over each rank's audit: no finding, two sends a
    step (ring at n = 4: two live slots) in float32, kernel #2 once a
    step, the stores written in place."""
    per = [ranks[r]["audit"] for r in range(LAUNCH_RANKS)]
    for r, a in enumerate(per):
        check(a["findings"] == [], f"18c rank {r}: findings {a['findings']}")
        check(a["sends"] == a["live_slot_sends"] == 2,
              f"18c rank {r}: {a['sends']} sends a step, live slots "
              f"{a['live_slot_sends']}")
        check(a["wire"] == ["float32"], f"18c rank {r}: wire {a['wire']}")
        check(a["launches"] == {"gossip_mix_update_flat": 1},
              f"18c rank {r}: traced step launched {a['launches']}")
        check(a["gossip_launches"] == LAUNCH_AUDIT_STEPS,
              f"18c rank {r}: {a['gossip_launches']} gossip launches")
        check(a["aliased_bytes"] == a["state_bytes"],
              f"18c rank {r}: {a['aliased_bytes']} of {a['state_bytes']} "
              "state bytes written in place")
    return {"ranks": LAUNCH_RANKS, "steps": LAUNCH_AUDIT_STEPS,
            "topology": "ring", "gossip_backend": "ppermute",
            "findings": 0, "sends_per_step": per[0]["sends"],
            "wire": per[0]["wire"], "ops_traced_step": [a["ops"] for a in per],
            "max_concat_elems": per[0]["max_concat_elems"],
            "state_bytes_in_place": per[0]["aliased_bytes"],
            "host_reads": [a["host_reads"] for a in per],
            "fresh_state_sized_outputs": [a["fresh"] for a in per],
            "sync_checked": per[0]["sync_checked"],
            "seconds_by_rank": [a["seconds"] for a in per],
            "gossip_launches": sum(a["gossip_launches"] for a in per)}


# ---------------------------------------------------------------------------
# phase 17: the model axis (a learner over several ranks of a DeviceMesh)
# ---------------------------------------------------------------------------

def _mesh_loader(cfg):
    from repro_torch.data import ShardedLoader, SyntheticTokenStream
    return ShardedLoader(SyntheticTokenStream(vocab=cfg.vocab),
                         n_learners=MESH_SHAPE[0], local_batch=TRAIN_BATCH,
                         extra_args=(TRAIN_SEQ,), seed=SEED)


def _mesh_step(name, api, mesh, gather="whole"):
    from repro_torch.launch.train import (make_adpsgd_train_step,
                                          make_dpsgd_train_step,
                                          make_ssgd_train_step)
    if name == "adpsgd":
        return make_adpsgd_train_step(
            api, _launch_opt(), mesh=mesh, max_staleness=LAUNCH_STALENESS,
            slow_learner=LAUNCH_SLOW, slow_factor=LAUNCH_SLOW_FACTOR,
            gather=gather)
    if name == "ssgd":
        return make_ssgd_train_step(api, _launch_opt(), mesh=mesh,
                                    gather=gather)
    return make_dpsgd_train_step(api, _launch_opt(), mesh=mesh,
                                 topology=name.split("_", 1)[1],
                                 gather=gather)


def mesh_rank(rank, port, wdir, queue):
    """One gloo rank of phase 17, run in a spawned process: puts (rank,
    record, None) on ``queue``, or (rank, None, the traceback)."""
    import traceback
    try:
        queue.put((rank, _mesh_rank(rank, port, wdir), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def _probe_draws(api, full_meta):
    """The probe's Lanczos start vector and Hutchinson probes as full trees,
    drawn alike on every rank from one seed."""
    from repro_torch.core.util import tree_gaussian_like
    from repro_torch.landscape.hvp import tree_rademacher_like
    like = full_meta.view_tree(torch.zeros((full_meta.rows, 128),
                                           device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    q0 = tree_gaussian_like(gen, like, 1.0)
    return q0, [tree_rademacher_like(gen, like)
                for _ in range(MESH_PROBE[1])]


def _mesh_rank(rank, port, wdir):
    """Phase 17 as rank ``rank``: a (data 2, model 2) mesh trains every case
    of MESH_CASES (the first step warms up, the others are timed; the
    learners' gathered stores go to rank 0, which holds them against the
    trainer), probes after the DPSGD and SSGD cases, then a (1, 4) mesh
    runs granite-moe's MoE block through the all-to-all."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import gossip_mix, reorth
    from repro_torch.launch import init_learner_group
    from repro_torch.launch.mesh import learner_rank, make_mesh, model_rank
    from repro_torch.launch.train import (gather_learner, make_probe_step,
                                          rank_state_from_numpy)
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_learner_group(rank, LAUNCH_RANKS, f"tcp://127.0.0.1:{port}",
                       backend="gloo", timeout_s=LAUNCH_TIMEOUT_S)
    mesh = make_mesh(MESH_SHAPE, ("data", "model"))
    i, j = learner_rank(mesh), model_rank(mesh)
    cfg = get_config("transformer-100m")
    api = build_model(cfg)
    params = _load_stacked(wdir)
    single = tree_map(lambda a: np.broadcast_to(a[:1], a.shape), params)
    loader = _mesh_loader(cfg)
    kernel = gossip_mix.gossip_mix_update_flat
    records, finals, probes, whole_shards = {}, {}, {}, {}
    period_probes, draws = {}, None
    for name, steps in MESH_CASES:
        batches = [tree_map(lambda x: x[i], loader.batch(t))
                   for t in range(steps)]
        step = _mesh_step(name, api, mesh)
        state = rank_state_from_numpy(
            step, single if name == "ssgd" else params,
            buffer=params if name == "adpsgd" else None, seed=SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel.launches = 0
        losses, walls, model = [], [], []
        for t in range(steps):
            if t == 1:
                step.timing = {}
            m0 = step.model_bytes
            t0 = time.perf_counter()
            state, m = step(state, batches[t])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(m["loss"])
            model.append(step.model_bytes - m0)
        launches = kernel.launches
        timed = steps - 1
        records[name] = {
            "steps": steps, "timed_steps": timed,
            "ms_per_step": 1e3 * sum(walls[1:]) / timed,
            "first_step_ms": 1e3 * walls[0],
            "parts_ms_per_step": {k: 1e3 * v / timed
                                  for k, v in step.timing.items()},
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
            / 1e9,
            "launches": launches,
            "model_collectives_per_step": step.model_collectives / steps,
            "model_bytes_per_step": model[-1],
            "gossip_bytes_per_step": step.bytes_received / steps,
            "rounds": step.last_rounds, "store_bytes":
                state.params.numel() * state.params.element_size(),
            "losses": torch.stack(losses).tolist()}
        finals[name] = [gather_learner(step, state.params).cpu()] + (
            [gather_learner(step, state.buffer).cpu()]
            if name == "adpsgd" else [])
        if name in dict(MESH_PERIOD_CASES):
            whole_shards[name] = state.params.clone()
        if name in ("dpsgd_ring", "ssgd"):
            if draws is None:
                draws = _probe_draws(api, step._layout.full)
            stacked = name != "ssgd"
            for gather in ("whole", "period"):
                probe = make_probe_step(api, mesh, alpha=TRAIN_LR,
                                        stacked=stacked,
                                        lanczos_iters=MESH_PROBE[0],
                                        hutchinson_samples=MESH_PROBE[1],
                                        gather=gather)
                reorth.reorth_dots.launches = 0
                reorth.reorth_axpy.launches = 0
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                r = probe(state.params, batches[0], q0=draws[0],
                          probes=draws[1])
                torch.cuda.synchronize()
                (probes if gather == "whole" else period_probes)[
                    "stacked" if stacked else "single"] = {
                    "wall_s": time.perf_counter() - t0,
                    "result": {f: float(getattr(r, f)) for f in r._fields},
                    "reorth_dots_launches": reorth.reorth_dots.launches,
                    "reorth_axpy_launches": reorth.reorth_axpy.launches,
                    "model_collectives": probe.model.calls,
                    "model_kinds": dict(probe.model.kinds),
                    "learner_collectives": probe.learners.calls,
                    "model_bytes": probe.model.bytes,
                    "learner_bytes": probe.learners.bytes,
                    "max_full_bytes": probe.max_full_bytes,
                    "max_memory_allocated_gb":
                        torch.cuda.max_memory_allocated() / 1e9}
                del probe, r
                torch.cuda.empty_cache()
        del step, state, batches
        torch.cuda.empty_cache()
    record = {"cases": records, "probe": probes,
              "period_probe": period_probes, "learner": i, "model_rank": j}
    # each learner's gathered store, from its model rank 0 to rank 0
    gathered = {}
    for name, rows in finals.items():
        for k, row in enumerate(rows):
            if rank == 0:
                got = [row]
                for r in range(1, MESH_SHAPE[0]):
                    got.append(torch.empty_like(row))
                    dist.recv(got[-1], src=r * MESH_SHAPE[1])
                gathered[(name, k)] = got
            elif j == 0:
                dist.send(row, dst=0)
    del finals
    if rank == 0:
        record["against_trainer"] = _mesh_against_trainer(
            api, params, loader, gathered, draws)
    del draws, gathered
    torch.cuda.empty_cache()
    _progress(rank, "17a-b")
    record["period"] = _mesh_period(api, mesh, params, single, loader,
                                    whole_shards, i)
    del whole_shards
    torch.cuda.empty_cache()
    _progress(rank, "17d")
    line = make_mesh(SEQ_DECODE_MESH, ("data", "model"))
    record["moe"] = _mesh_moe(line, rank)
    torch.cuda.empty_cache()
    _progress(rank, "17c")
    record["decode"] = _mesh_decode(line, rank, params)
    torch.cuda.empty_cache()
    record["prefill"] = _mesh_prefill(mesh, rank, params, loader)
    _progress(rank, "17f")
    torch.cuda.empty_cache()
    record["audio"] = _mesh_audio(line, mesh, rank)
    _progress(rank, "17g")
    dist.destroy_process_group()
    return record


def _mesh_against_trainer(api, params, loader, gathered, draws):
    """The single-process trainer (n = 2 learners, plain gossip kernel)
    from the same weights and batches: each case's max abs gap to the
    learners' gathered stores; then the single-process probe_landscape of
    the DPSGD learners (and of SSGD's replica, ``stacked=False``) with the
    same draws, its reorthogonalization the plain version."""
    from repro_torch.core import AlgoConfig, MultiLearnerTrainer
    from repro_torch.core.dpsgd import hypercube_tables
    from repro_torch.core.flatstate import flat_meta
    from repro_torch.landscape import probe_landscape
    from repro_torch.models.convert import tree_from_jax
    from repro_torch.tree import tree_map

    n = MESH_SHAPE[0]
    stacked = tree_from_jax(params, device="cuda")
    single = tree_map(lambda x: x[0], stacked)
    meta = flat_meta(single)
    out = {}
    for name, steps in MESH_CASES:
        kw = {}
        if name == "adpsgd":
            algo = AlgoConfig(algo="adpsgd", topology="random_pair",
                              n_learners=n, max_staleness=LAUNCH_STALENESS,
                              slow_learner=LAUNCH_SLOW,
                              slow_factor=LAUNCH_SLOW_FACTOR)
        elif name == "ssgd":
            algo = AlgoConfig(algo="ssgd", n_learners=n)
            kw = dict(engine="flat")
        else:
            algo = AlgoConfig(algo="dpsgd", topology=name.split("_", 1)[1],
                              n_learners=n)
        tr = MultiLearnerTrainer(api.loss_fn, _launch_opt(), algo,
                                 kernel_backend="ref",
                                 params_from_tree=api.params_from_tree, **kw)
        state = tr.init(SEED, single)
        if name != "ssgd":
            state.params.copy_(meta.flatten(stacked))
        if state.buffer is not None:
            state.buffer.copy_(state.params)
        for t in range(steps):
            rounds = ([hypercube_tables(t, n)] if name == "adpsgd"
                      else None)
            state, _ = tr.train_step(state, loader.batch(t), rounds)
        rec = {}
        for k, (what, want) in enumerate(
                (("params", state.params), ("buffer", state.buffer))):
            if (name, k) in gathered:
                got = torch.stack(gathered[(name, k)]).to("cuda")
                rec[f"{what}_max_abs_err"] = float((got - want).abs().max())
                del got
        if name in ("dpsgd_ring", "ssgd"):
            rows = torch.stack(gathered[(name, 0)]).to("cuda")
            tree = meta.unflatten(rows if name != "ssgd" else rows[0])
            t0 = time.perf_counter()
            r = probe_landscape(
                api.loss_fn, tree, loader.batch(0), alpha=TRAIN_LR,
                lanczos_iters=MESH_PROBE[0],
                hutchinson_samples=MESH_PROBE[1], reorth="ref",
                params_from_tree=api.params_from_tree, q0=draws[0],
                probes=draws[1], stacked=name != "ssgd")
            torch.cuda.synchronize()
            rec["probe"] = {f: float(getattr(r, f)) for f in r._fields}
            rec["probe_wall_s"] = time.perf_counter() - t0
            del rows, tree
        out[name] = rec
        del tr, state
        torch.cuda.empty_cache()
    return out


def _mesh_moe(mesh, rank):
    """Phase 17c on one rank of the (1, 4) mesh: granite-moe's MoE block,
    this rank's MOE_EP_TOKENS / 4 tokens, forward and backward through the
    all-to-all against the einsum path on the same tokens (and the
    all-to-all run one mantissa bit below bf16, the control).  Returns the
    rank's readings."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import moe_shardmap as ms
    from repro_torch.models.moe import init_moe_params, moe_forward
    from repro_torch.models.shard_hints import use_mesh

    cfg = get_config("granite-moe-3b-a800m")
    d, E, k = cfg.d_model, cfg.n_experts, cfg.experts_per_tok
    M = LAUNCH_RANKS
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_moe_params(gen, d, cfg.d_ff, E, torch.bfloat16)
    x_all = torch.randn((1, MOE_EP_TOKENS, d), generator=gen,
                        device="cuda").to(torch.bfloat16)
    dy_all = torch.randn((1, MOE_EP_TOKENS, d), generator=gen,
                         device="cuda")
    T = MOE_EP_TOKENS // M
    x0 = x_all[:, rank * T:(rank + 1) * T].contiguous()
    dy = dy_all[:, rank * T:(rank + 1) * T].contiguous()

    def run(fn):
        for p in params.parameters():
            p.grad = None
        x = x0.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fn(x)
        torch.sum(y.float() * dy).backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (y.detach(), x.grad, params.w1.grad.float(),
                params.router.grad.clone(), wall)

    stats = {}

    def ep(x):
        with use_mesh(mesh):
            return ms.moe_forward_shardmap(params, x, n_experts=E, top_k=k,
                                           capacity_factor=MOE_EP_CF,
                                           stats=stats)

    def einsum(x):
        return moe_forward(params, x, n_experts=E, top_k=k,
                           capacity_factor=MOE_EINSUM_CF)

    ep(x0)                                        # warm-up
    calls0 = ms.all_to_all.calls
    y, dx, dw1, drouter, ep_s = run(ep)
    calls = ms.all_to_all.calls - calls0
    yr, dxr, dw1r, drouterr, einsum_s = run(einsum)
    with CoarseBF16():
        yc, dxc, dw1c, _, _ = run(ep)
    for g in (dw1, dw1r, dw1c):       # every rank's tokens' contributions
        host = g.cpu()
        dist.all_reduce(host)
        g.copy_(host)
    return {"tokens_per_rank": T, "local_experts": E // M,
            "cap_send": stats["cap_send"], "cap_expert": stats["cap_expert"],
            "dropped": int(stats["dropped_send"]) + int(
                stats["dropped_expert"]),
            "all_to_all_calls_fwd_bwd": calls,
            "ep_fwd_bwd_ms": 1e3 * ep_s, "einsum_fwd_bwd_ms": 1e3 * einsum_s,
            "y_rel": _rel(y, yr), "y_rel_control": _rel(yc, yr),
            "dx_rel": _rel(dx, dxr), "dx_rel_control": _rel(dxc, dxr),
            "dw1_rel": _rel(dw1, dw1r), "dw1_rel_control": _rel(dw1c, dw1r),
            "drouter_rel": _rel(drouter, drouterr)}


def _progress(rank, what):
    """A line on stderr as a mesh rank finishes a part: the wall clock and
    the rank's peak host memory (a part that dies leaves its last line)."""
    import resource
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"mesh rank {rank}: {what} done at {time.strftime('%H:%M:%S')}, "
          f"host peak {peak:.2f} GB", file=sys.stderr, flush=True)


def _mesh_period(api, mesh, params, single, loader, whole, i):
    """Phase 17d on one rank: each case of MESH_PERIOD_CASES again with
    ``gather="period"`` from a's initial state and batches; the rank's
    shard against a's ``"whole"`` shard (``whole``), ms a step, peak
    memory, the model group's collectives and bytes a step, kernel #2's
    launches."""
    from repro_torch.kernels import gossip_mix
    from repro_torch.launch.train import rank_state_from_numpy
    from repro_torch.tree import tree_map

    kernel = gossip_mix.gossip_mix_update_flat
    out = {}
    for name, steps in MESH_PERIOD_CASES:
        batches = [tree_map(lambda x: x[i], loader.batch(t))
                   for t in range(steps)]
        step = _mesh_step(name, api, mesh, gather="period")
        state = rank_state_from_numpy(
            step, single if name == "ssgd" else params, seed=SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel.launches = 0
        walls, kinds, model = [], [], []
        for t in range(steps):
            if t == 1:
                step.timing = {}
            k0, m0 = step.model_kinds, step.model_bytes
            t0 = time.perf_counter()
            state, m = step(state, batches[t])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            kinds.append({k: v - k0.get(k, 0)
                          for k, v in step.model_kinds.items()})
            model.append(step.model_bytes - m0)
        launches = kernel.launches
        timed = steps - 1
        out[name] = {
            "steps": steps, "launches": launches,
            "max_abs_vs_whole": float((state.params - whole[name])
                                      .abs().max()),
            "bitwise_whole": bool(torch.equal(state.params, whole[name])),
            "ms_per_step": 1e3 * sum(walls[1:]) / timed,
            "first_step_ms": 1e3 * walls[0],
            "parts_ms_per_step": {k: 1e3 * v / timed
                                  for k, v in step.timing.items()},
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
            / 1e9,
            "model_kinds_per_step": kinds[-1],
            "model_bytes_per_step": model[-1],
            "max_full_bytes": step.max_full_bytes,
            "losses": [float(m["loss"])]}
        del step, state, batches
        torch.cuda.empty_cache()
    return out


def _seq_decode(api, mesh, rank, make_tree, buf, steps, control=False,
                frames=None):
    """Phase 17e for one model on one rank of the (1, 4) mesh: the
    sequence-sharded decode of SEQ_DECODE_B sequences (the same seeded
    tokens on every rank) from this rank's shard of ``make_tree()``'s
    weights; rank 0 first runs the single-process ``decode_step`` on the
    whole tree and holds every step's logits to it; ``control`` runs the
    sharded decode again one mantissa bit below bf16.  ``frames`` (the
    audio family, 17g): the cache encodes them (the whole batch: one
    learner), the sharded one through ``init_cache(store=, frames=)``,
    timed (``encode_s``)."""
    from repro_torch.launch.train import make_decode_step
    from repro_torch.models.moe_shardmap import all_to_all

    cfg = api.cfg
    step = make_decode_step(api, mesh)
    tree = make_tree()
    store = step.shard(tree)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    tokens = torch.randint(0, cfg.vocab, (steps, SEQ_DECODE_B, 1),
                           generator=gen, device="cuda", dtype=torch.int32)
    want, single_ms = None, None
    if rank == 0:
        params = api.params_from_tree(tree)
        cache = api.init_cache(params, SEQ_DECODE_B if frames is None
                               else frames, buf)
        want = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(steps):
            lg, cache = api.decode_step(params, cache, tokens[t], t)
            want.append(lg)
        torch.cuda.synchronize()
        single_ms = 1e3 * (time.perf_counter() - t0) / steps
        del params, cache
    del tree
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step.params(store)                  # the weights, gathered once
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    weight_bytes = step.comm.bytes
    torch.cuda.empty_cache()

    def run():
        torch.cuda.synchronize()
        t0, a2a = time.perf_counter(), all_to_all.calls
        cache = step.init_cache(SEQ_DECODE_B, buf, **(
            {} if frames is None else {"store": store, "frames": frames}))
        torch.cuda.synchronize()
        encode_s, a2a = time.perf_counter() - t0, all_to_all.calls - a2a
        logits, c0, b0 = [], step.seq_comm.calls, step.seq_comm.bytes
        t0 = time.perf_counter()
        for t in range(steps):
            if t == 1:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            lg, cache = step(store, cache, tokens[t], t)
            logits.append(lg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return logits, {
            "ms_per_step": 1e3 * (t2 - t1) / (steps - 1),
            "first_step_ms": 1e3 * (t1 - t0), "init_cache_s": encode_s,
            "init_cache_all_to_alls": a2a,
            "collectives_per_step": (step.seq_comm.calls - c0) / steps,
            "bytes_per_step": (step.seq_comm.bytes - b0) / steps}

    torch.cuda.reset_peak_memory_stats()
    logits, rec = run()
    rec.update(weights_gather_s=gather_s, weight_bytes_in=weight_bytes,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9, store_bytes=store.numel() * 4, buf_len=buf,
               steps=steps, sequences=SEQ_DECODE_B,
               finite=bool(all(torch.isfinite(x).all() for x in logits)))
    if want is not None:
        rec["rel_per_step"] = [_rel(g, w) for g, w in zip(logits, want)]
        rec["single_process_ms_per_step"] = single_ms
    del logits
    if control:
        with CoarseBF16():
            coarse, _ = run()
        if want is not None:
            rec["control_rel_per_step"] = [_rel(g, w)
                                           for g, w in zip(coarse, want)]
        del coarse
    del want, step, store
    return rec


def _mesh_decode(mesh, rank, params):
    """Phase 17e on one rank: transformer-100m (learner 0's weights of
    a), then gemma2-27b at GEMMA_LAYERS (bf16, from seed SEED on every
    rank), each through ``_seq_decode``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.convert import tree_from_jax
    from repro_torch.tree import tree_map

    api = build_model(get_config("transformer-100m"))
    out = {"transformer_100m": _seq_decode(
        api, mesh, rank, lambda: tree_from_jax(
            tree_map(lambda a: np.asarray(a[0]), params), device="cuda"),
        SEQ_DECODE_BUF, SEQ_DECODE_STEPS)}
    torch.cuda.empty_cache()
    _progress(rank, "17e transformer-100m")
    cfg = dataclasses.replace(get_config("gemma2-27b"),
                              n_layers=GEMMA_LAYERS)
    api = build_model(cfg)
    out["gemma2_27b"] = _seq_decode(
        api, mesh, rank, lambda: api.param_tree(api.init(SEED)),
        GEMMA_SEQ_BUF, GEMMA_SEQ_STEPS, control=True)
    torch.cuda.empty_cache()
    return out


def _mesh_prefill(mesh, rank, params, loader):
    """Phase 17f on one rank of a's mesh: transformer-100m with
    ``use_pallas``, the rank's rows of its learner's first batch through
    ``make_prefill_step`` (kernel #6 on the gathered weights), against the
    single-process flash prefill of the same rows (its launches not
    counted)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.mesh import learner_rank, model_rank
    from repro_torch.launch.train import gather_rows, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.convert import tree_from_jax
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("transformer-100m"),
                              use_pallas=True)
    api = build_model(cfg)
    i, j = learner_rank(mesh), model_rank(mesh)
    tree = tree_from_jax(tree_map(lambda a: np.asarray(a[i]), params),
                         device="cuda")
    batch = tree_map(lambda x: x[i], loader.batch(0))
    step = make_prefill_step(api, mesh)
    store = step.shard(tree)
    step.params(store)                  # the weights, gathered once
    kernel = flash_attention.flash_attention_fwd
    kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mine = step(store, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = kernel.launches
    rows = mine.shape[0]
    learner = gather_rows(step, mine)
    with torch.no_grad():
        want = api.apply(api.params_from_tree(tree),
                         tree_map(lambda x: x[j * rows:(j + 1) * rows],
                                  batch))
    return {"rows": rows, "seq": TRAIN_SEQ, "launches": launches,
            "ms": ms, "rel": _rel(mine, want),
            "learner_rows": learner.shape[0],
            "finite": bool(torch.isfinite(mine).all())}


def _mesh_audio(line, mesh, rank):
    """Phase 17g on one rank: seamless-m4t-large-v2 at full width, depth
    cut to AUDIO_MESH_LAYERS encoder and decoder layers, bf16, from seed
    SEED on every rank.  The sequence-sharded decode on the (1, 4) mesh
    ``line`` through ``_seq_decode`` (the frames encoded each model rank
    its rows, one all-to-all of the cross K/V; two collectives a decoder
    layer a step), then the sharded prefill on (a)'s mesh ``mesh``: the
    rank's rows of its learner's frames and tokens through
    ``make_prefill_step`` against the single-process ``apply`` of the same
    rows."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import learner_rank, model_rank
    from repro_torch.launch.train import gather_rows, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("seamless-m4t-large-v2"),
                              n_layers=AUDIO_MESH_LAYERS,
                              enc_layers=AUDIO_MESH_LAYERS)
    api = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    frames = (torch.randn((SEQ_DECODE_B, AUDIO_FRAMES, cfg.d_model),
                          generator=gen, device="cuda")
              .to(torch.bfloat16) * 0.1)
    out = {"decode": _seq_decode(
        api, line, rank, lambda: api.param_tree(api.init(SEED)),
        SEQ_DECODE_BUF, AUDIO_MESH_STEPS, control=True, frames=frames)}
    out["decode"]["frames"] = [SEQ_DECODE_B, AUDIO_FRAMES]
    torch.cuda.empty_cache()
    _progress(rank, "17g decode")
    n, M = MESH_SHAPE
    i, j = learner_rank(mesh), model_rank(mesh)
    b = SEQ_DECODE_B // n
    tokens = torch.randint(0, cfg.vocab, (SEQ_DECODE_B, AUDIO_MESH_TOKENS),
                           generator=gen, device="cuda", dtype=torch.int32)
    batch = {"frames": frames[i * b:(i + 1) * b],
             "tokens": tokens[i * b:(i + 1) * b]}
    tree = api.param_tree(api.init(SEED))
    step = make_prefill_step(api, mesh)
    store = step.shard(tree)
    step.params(store)                  # the weights, gathered once
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mine = step(store, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    rows = mine.shape[0]
    learner = gather_rows(step, mine)
    with torch.no_grad():
        want = api.apply(api.params_from_tree(tree),
                         tree_map(lambda x: x[j * rows:(j + 1) * rows],
                                  batch))
    out["prefill"] = {"rows": rows, "frames": AUDIO_FRAMES,
                      "tokens": AUDIO_MESH_TOKENS, "ms": ms,
                      "rel": _rel(mine, want),
                      "learner_rows": learner.shape[0],
                      "finite": bool(torch.isfinite(mine).all())}
    del tree, step, store, mine, want, learner
    torch.cuda.empty_cache()
    return out


def _mesh_ranks(wdir):
    """Phase 17's ranks, spawned together; returns {rank: record}."""
    import queue as queues

    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=mesh_rank, args=(r, port, wdir, results))
             for r in range(LAUNCH_RANKS)]
    for p in procs:
        p.start()
    out = {}
    try:
        deadline = time.monotonic() + LAUNCH_TIMEOUT_S
        while len(out) < LAUNCH_RANKS:
            left = deadline - time.monotonic()
            try:
                rank, record, err = results.get(timeout=max(left, 1))
            except queues.Empty:
                raise RuntimeError(f"mesh ranks silent for "
                                   f"{LAUNCH_TIMEOUT_S} s; got {sorted(out)}")
            check(err is None, f"mesh rank {rank} failed:\n{err}")
            out[rank] = record
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    check(all(p.exitcode == 0 for p in procs),
          f"mesh rank exit codes {[p.exitcode for p in procs]}")
    return out


def mesh_phase(kernels):
    """Phase 17: a-f.  Returns (record, gossip launches by path, reorth
    launches by kernel, flash launches by path)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    from repro_torch.launch.dryrun import step_memory

    cfg = get_config("transformer-100m")
    api = build_model(cfg)
    predicted = {}
    for name, _ in MESH_PERIOD_CASES:
        mem = step_memory(api, MESH_SHAPE[1], name.split("_")[0])
        predicted[name] = {g: (mem["resident"] + mem["transient"][g]) / 1e9
                           for g in ("whole", "period")}
    with tempfile.TemporaryDirectory() as wdir:
        t0 = time.perf_counter()
        _save_stacked(api, wdir, MESH_SHAPE[0])
        del api
        torch.cuda.empty_cache()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = _mesh_ranks(wdir)
        ranks_s = time.perf_counter() - t0

    n, M = MESH_SHAPE
    trainer = ranks[0]["against_trainer"]
    record = {
        "transport": "gloo over TCP loopback, every collective (the model "
                     "group's, the gossip exchange, the learner group's "
                     "all_reduces, the MoE all-to-all) staged through "
                     "pinned host memory; 4 ranks sharing one H100 (not "
                     "NCCL)",
        "torch": torch.__version__, "model": cfg.name,
        "mesh": {"data": n, "model": M},
        "local_batch": TRAIN_BATCH, "rows_per_model_rank": TRAIN_BATCH // M,
        "seq": TRAIN_SEQ, "lr": TRAIN_LR, "weights_setup_s": setup_s,
        "ranks_wall_s": ranks_s, "cases": {}}
    launches = {}
    for name, steps in MESH_CASES:
        per = [ranks[r]["cases"][name] for r in range(LAUNCH_RANKS)]
        launches[name] = sum(c["launches"] for c in per)
        want = 0 if name == "ssgd" else LAUNCH_RANKS * steps
        check(launches[name] == want,
              f"{name}: {launches[name]} gossip launches, not {want}")
        for r, c in enumerate(per):
            check(c["model_collectives_per_step"] == 3,
                  f"{name} rank {r}: {c['model_collectives_per_step']} "
                  "model-group collectives a step, not 3")
            if name != "ssgd":
                check(c["gossip_bytes_per_step"] == c["store_bytes"],
                      f"{name} rank {r}: {c['gossip_bytes_per_step']} "
                      f"gossip bytes a step, not one shard store")
            check(all(np.isfinite(c["losses"])),
                  f"{name} rank {r}: losses {c['losses']}")
        gaps = {k: v for k, v in trainer[name].items()
                if k.endswith("_max_abs_err")}
        check(all(v <= TRAIN_REF_ATOL for v in gaps.values()),
              f"{name}: the mesh ranks and the trainer differ by {gaps}")
        record["cases"][name] = {
            "steps": steps, "gossip_launches": launches[name],
            "against_trainer": gaps,
            "store_bytes_per_rank": per[0]["store_bytes"],
            "ms_per_step_by_rank": [c["ms_per_step"] for c in per],
            "first_step_ms_by_rank": [c["first_step_ms"] for c in per],
            "parts_ms_per_step_by_rank": [c["parts_ms_per_step"]
                                          for c in per],
            "model_bytes_per_step_by_rank": [c["model_bytes_per_step"]
                                             for c in per],
            "gossip_bytes_per_step_by_rank": [c["gossip_bytes_per_step"]
                                              for c in per],
            "max_memory_allocated_gb_by_rank": [
                c["max_memory_allocated_gb"] for c in per],
            "losses_rank0": per[0]["losses"]}
    reorth_launches = {"reorth_dots": 0, "reorth_axpy": 0}
    probe = {}
    for tag, case in (("stacked", "dpsgd_ring"), ("single", "ssgd")):
        per = [ranks[r]["probe"][tag] for r in range(LAUNCH_RANKS)]
        want = trainer[case]["probe"]
        got = per[0]["result"]
        rel = {f: abs(got[f] - want[f]) / max(abs(want[f]), 1e-30)
               for f in want}
        check(rel["sharpness"] <= MESH_PROBE_RTOL,
              f"probe {tag}: sharpness {got['sharpness']} against "
              f"{want['sharpness']} (rel {rel['sharpness']})")
        for r, c in enumerate(per):
            check(c["result"] == got, f"probe {tag}: rank {r} reads "
                  f"{c['result']}, rank 0 {got}")
            check(c["reorth_dots_launches"] == 2 * MESH_PROBE[0]
                  and c["reorth_axpy_launches"] == 2 * MESH_PROBE[0],
                  f"probe {tag} rank {r}: reorth launches "
                  f"{c['reorth_dots_launches']} / "
                  f"{c['reorth_axpy_launches']}")
            reorth_launches["reorth_dots"] += c["reorth_dots_launches"]
            reorth_launches["reorth_axpy"] += c["reorth_axpy_launches"]
        probe[tag] = {"sharded": got, "single_process": want, "rel": rel,
                      "wall_s_by_rank": [c["wall_s"] for c in per],
                      "single_process_wall_s": trainer[case]["probe_wall_s"],
                      "model_collectives": per[0]["model_collectives"],
                      "learner_collectives": per[0]["learner_collectives"],
                      "model_bytes_rank0": per[0]["model_bytes"],
                      "learner_bytes_rank0": per[0]["learner_bytes"]}
    record["probe"] = probe
    record["period_probe"], period_reorth = _period_probe_record(ranks)
    moe = [ranks[r]["moe"] for r in range(LAUNCH_RANKS)]
    for r, c in enumerate(moe):
        check(c["dropped"] == 0, f"moe rank {r}: {c['dropped']} dropped")
        check(c["all_to_all_calls_fwd_bwd"] == 5,
              f"moe rank {r}: {c['all_to_all_calls_fwd_bwd']} all-to-alls")
        check(c["dw1_rel"] <= MOE_EP_RTOL and c["drouter_rel"] <= MOE_EP_RTOL,
              f"moe rank {r}: dw1 {c['dw1_rel']}, drouter "
              f"{c['drouter_rel']} past {MOE_EP_RTOL}")
    worst = max(range(LAUNCH_RANKS), key=lambda r: moe[r]["y_rel"])
    record["moe_block"] = {
        "model": "granite-moe-3b-a800m", "mesh": {"data": 1,
                                                  "model": LAUNCH_RANKS},
        "tokens": MOE_EP_TOKENS, "by_rank": moe,
        "y": held("EP MoE output against einsum", moe[worst]["y_rel"],
                  min(c["y_rel_control"] for c in moe), MOE_EP_RTOL),
        "dx": held("EP MoE dx against einsum",
                   max(c["dx_rel"] for c in moe),
                   min(c["dx_rel_control"] for c in moe), MOE_EP_RTOL)}
    record["period_gather"], period_launches = _period_record(
        ranks, record["cases"], predicted)
    record["seq_decode"] = _decode_record(ranks)
    record["sharded_prefill"], flash_launches = _prefill_record(ranks)
    record["audio"] = _audio_record(ranks)
    gossip = {f"mesh_2x2_{k}_4_gloo_ranks": v for k, v in launches.items()}
    gossip.update({f"mesh_2x2_period_{k}_4_gloo_ranks": v
                   for k, v in period_launches.items()})
    return record, gossip, {
        "transformer_100m_mesh_2x2_probes_4_gloo_ranks": reorth_launches,
        "transformer_100m_mesh_2x2_period_probes_4_gloo_ranks":
            period_reorth}, {
        "transformer_100m_mesh_2x2_sharded_prefill_4_gloo_ranks":
            flash_launches}


def _period_probe_record(ranks):
    """17h's checks and record: the period probe against b's whole probe
    on the same state and draws (every field), its reorth launches on the
    shard, its full weights and peak memory beside the whole probe's.
    Returns it and kernels #4 / #5's launches."""
    launches = {"reorth_dots": 0, "reorth_axpy": 0}
    out = {}
    for tag in ("stacked", "single"):
        per = [ranks[r]["period_probe"][tag] for r in range(LAUNCH_RANKS)]
        whole = [ranks[r]["probe"][tag] for r in range(LAUNCH_RANKS)]
        got, want = per[0]["result"], whole[0]["result"]
        rel = {f: abs(got[f] - want[f]) / max(abs(want[f]), 1e-30)
               for f in want}
        check(all(np.isfinite(v) for v in got.values()),
              f"17h {tag}: {got}")
        check(max(rel.values()) <= MESH_PROBE_RTOL,
              f"17h {tag}: the period probe {got} against the whole "
              f"probe {want} (rel {rel})")
        for r, c in enumerate(per):
            check(c["result"] == got, f"17h {tag}: rank {r} reads "
                  f"{c['result']}, rank 0 {got}")
            check(c["reorth_dots_launches"] == 2 * MESH_PROBE[0]
                  and c["reorth_axpy_launches"] == 2 * MESH_PROBE[0],
                  f"17h {tag} rank {r}: reorth launches "
                  f"{c['reorth_dots_launches']} / "
                  f"{c['reorth_axpy_launches']}")
            check(0 < c["max_full_bytes"] < whole[r]["max_full_bytes"],
                  f"17h {tag} rank {r}: {c['max_full_bytes']} full bytes, "
                  f"the whole probe {whole[r]['max_full_bytes']}")
            launches["reorth_dots"] += c["reorth_dots_launches"]
            launches["reorth_axpy"] += c["reorth_axpy_launches"]
        out[tag] = {
            "period": got, "whole": want, "rel": rel,
            "tier_rel": MESH_PROBE_RTOL,
            "wall_s_by_rank": [c["wall_s"] for c in per],
            "whole_wall_s_by_rank": [c["wall_s"] for c in whole],
            "max_memory_allocated_gb_by_rank": [
                c["max_memory_allocated_gb"] for c in per],
            "whole_max_memory_allocated_gb_by_rank": [
                c["max_memory_allocated_gb"] for c in whole],
            "max_full_bytes": per[0]["max_full_bytes"],
            "whole_max_full_bytes": whole[0]["max_full_bytes"],
            "reorth_launches_by_rank": [
                [c["reorth_dots_launches"], c["reorth_axpy_launches"]]
                for c in per],
            "model_kinds_rank0": per[0]["model_kinds"],
            "whole_model_kinds_rank0": whole[0]["model_kinds"],
            "model_bytes_rank0": per[0]["model_bytes"],
            "whole_model_bytes_rank0": whole[0]["model_bytes"]}
    return out, launches


def _audio_record(ranks):
    """17g's checks and record: the sequence-sharded decode against the
    single-process decode (its tier against its control), two collectives
    a decoder layer a step, one all-to-all of the cross K/V; the sharded
    prefill against the single-process apply."""
    per = [ranks[r]["audio"]["decode"] for r in range(LAUNCH_RANKS)]
    r0 = per[0]
    calls = 2 * AUDIO_MESH_LAYERS
    check(all(c["finite"] for c in per), "17g: non-finite logits")
    for r, c in enumerate(per):
        check(c["collectives_per_step"] == calls,
              f"17g rank {r}: {c['collectives_per_step']} collectives a "
              f"step, not {calls}")
        check(c["init_cache_all_to_alls"] == 1,
              f"17g rank {r}: {c['init_cache_all_to_alls']} all-to-alls "
              "building the cache, not 1")
    pre = [ranks[r]["audio"]["prefill"] for r in range(LAUNCH_RANKS)]
    for r, c in enumerate(pre):
        check(c["finite"] and c["rel"] <= MESH_PREFILL_RTOL,
              f"17g prefill rank {r}: {c['rel']} from the single-process "
              "apply")
        check(c["learner_rows"] == SEQ_DECODE_B // MESH_SHAPE[0],
              f"17g prefill rank {r}: {c['learner_rows']} learner rows")
    return {
        "model": "seamless-m4t-large-v2", "layers": [AUDIO_MESH_LAYERS,
                                                     AUDIO_MESH_LAYERS],
        "decode": {
            "mesh": {"data": SEQ_DECODE_MESH[0],
                     "model": SEQ_DECODE_MESH[1]},
            "sequences": r0["sequences"], "frames": r0["frames"],
            "buf_len": r0["buf_len"], "steps": r0["steps"],
            "tier": held("17g seamless sequence-sharded decode against the "
                         "single-process decode", max(r0["rel_per_step"]),
                         min(r0["control_rel_per_step"]), GEMMA_SEQ_RTOL),
            "rel_first_steps": r0["rel_per_step"][:8],
            "collectives_per_step": r0["collectives_per_step"],
            "bytes_per_step_by_rank": [c["bytes_per_step"] for c in per],
            "ms_per_step_by_rank": [c["ms_per_step"] for c in per],
            "first_step_ms_by_rank": [c["first_step_ms"] for c in per],
            "single_process_ms_per_step": r0["single_process_ms_per_step"],
            "encode_and_all_to_all_s_by_rank": [c["init_cache_s"]
                                                for c in per],
            "weights_gather_s_by_rank": [c["weights_gather_s"]
                                         for c in per],
            "weight_bytes_in_by_rank": [c["weight_bytes_in"] for c in per],
            "init_cache_all_to_alls": r0["init_cache_all_to_alls"],
            "store_bytes_per_rank": r0["store_bytes"],
            "max_memory_allocated_gb_by_rank": [
                c["max_memory_allocated_gb"] for c in per]},
        "prefill": {"mesh": {"data": MESH_SHAPE[0], "model": MESH_SHAPE[1]},
                    "rows_per_rank": pre[0]["rows"],
                    "frames": pre[0]["frames"], "tokens": pre[0]["tokens"],
                    "rel_by_rank": [c["rel"] for c in pre],
                    "ms_by_rank": [c["ms"] for c in pre],
                    "tier_rel": MESH_PREFILL_RTOL}}


def _period_record(ranks, whole_cases, predicted):
    """17d's checks and record: each case's shards against the whole
    gather's, its collectives a step, kernel #2's launches, and each
    rank's peak memory in both modes beside the dry run's prediction."""
    out, launches = {}, {}
    for name, steps in MESH_PERIOD_CASES:
        per = [ranks[r]["period"][name] for r in range(LAUNCH_RANKS)]
        launches[name] = sum(c["launches"] for c in per)
        want = 0 if name == "ssgd" else LAUNCH_RANKS * steps
        check(launches[name] == want,
              f"17d {name}: {launches[name]} gossip launches, not {want}")
        gaps = [c["max_abs_vs_whole"] for c in per]
        check(max(gaps) <= MESH_PERIOD_ATOL,
              f"17d {name}: gather='period' differs from 'whole' by {gaps}")
        check(all(np.isfinite(c["losses"]).all() for c in per),
              f"17d {name}: losses")
        out[name] = {
            "steps": steps, "gossip_launches": launches[name],
            "max_abs_vs_whole_by_rank": gaps,
            "bitwise_whole_by_rank": [c["bitwise_whole"] for c in per],
            "ms_per_step_by_rank": [c["ms_per_step"] for c in per],
            "whole_ms_per_step_by_rank": whole_cases[name][
                "ms_per_step_by_rank"],
            "first_step_ms_by_rank": [c["first_step_ms"] for c in per],
            "parts_ms_per_step_by_rank": [c["parts_ms_per_step"]
                                          for c in per],
            "model_kinds_per_step_by_rank": [c["model_kinds_per_step"]
                                             for c in per],
            "model_bytes_per_step_by_rank": [c["model_bytes_per_step"]
                                             for c in per],
            "max_full_bytes_by_rank": [c["max_full_bytes"] for c in per],
            "max_memory_allocated_gb_by_rank": [
                c["max_memory_allocated_gb"] for c in per],
            "whole_max_memory_allocated_gb_by_rank": whole_cases[name][
                "max_memory_allocated_gb_by_rank"],
            "dry_run_prediction_gb": predicted[name]}
    return out, launches


def _decode_record(ranks):
    """17e's checks and record."""
    out = {}
    for key, tier in (("transformer_100m", SEQ_DECODE_RTOL),
                      ("gemma2_27b", GEMMA_SEQ_RTOL)):
        per = [ranks[r]["decode"][key] for r in range(LAUNCH_RANKS)]
        r0 = per[0]
        check(all(c["finite"] for c in per), f"17e {key}: non-finite")
        check(all(c["collectives_per_step"] == per[0]["collectives_per_step"]
                  for c in per), f"17e {key}: collectives differ by rank")
        rec = {"buf_len": r0["buf_len"], "steps": r0["steps"],
               "sequences": r0["sequences"],
               "max_rel_per_step": max(r0["rel_per_step"]),
               "rel_first_steps": r0["rel_per_step"][:8],
               "collectives_per_step": r0["collectives_per_step"],
               "bytes_per_step_by_rank": [c["bytes_per_step"] for c in per],
               "ms_per_step_by_rank": [c["ms_per_step"] for c in per],
               "first_step_ms_by_rank": [c["first_step_ms"] for c in per],
               "single_process_ms_per_step":
                   r0["single_process_ms_per_step"],
               "weights_gather_s_by_rank": [c["weights_gather_s"]
                                            for c in per],
               "weight_bytes_in_by_rank": [c["weight_bytes_in"]
                                           for c in per],
               "store_bytes_per_rank": r0["store_bytes"],
               "max_memory_allocated_gb_by_rank": [
                   c["max_memory_allocated_gb"] for c in per]}
        if "control_rel_per_step" in r0:
            rec["tier"] = held(f"17e {key} sharded decode against the "
                               "single-process decode",
                               max(r0["rel_per_step"]),
                               min(r0["control_rel_per_step"]), tier)
        else:
            check(rec["max_rel_per_step"] <= tier,
                  f"17e {key}: logits {rec['max_rel_per_step']} from the "
                  f"single-process decode, past {tier}")
            rec["tier_rel"] = tier
        out[key] = rec
    return out


def _prefill_record(ranks):
    """17f's checks and record; returns it and kernel #6's launches."""
    per = [ranks[r]["prefill"] for r in range(LAUNCH_RANKS)]
    for r, c in enumerate(per):
        check(c["finite"] and c["rel"] <= MESH_PREFILL_RTOL,
              f"17f rank {r}: {c['rel']} from the single-process flash "
              "prefill")
        check(c["launches"] > 0, f"17f rank {r}: kernel #6 never launched")
        check(c["learner_rows"] == TRAIN_BATCH,
              f"17f rank {r}: {c['learner_rows']} learner rows")
    return {"rows_per_rank": per[0]["rows"], "seq": per[0]["seq"],
            "rel_by_rank": [c["rel"] for c in per],
            "launches_by_rank": [c["launches"] for c in per],
            "ms_by_rank": [c["ms"] for c in per],
            "tier_rel": MESH_PREFILL_RTOL}, sum(c["launches"] for c in per)


# ---------------------------------------------------------------------------
# phase 18: the static auditor on the card
# ---------------------------------------------------------------------------

def _launch_counts(kernels):
    return {k.__name__: k.launches for k in kernels}


def audit_train_phase(kernels):
    """18a: the trainer's audit (the FC net, the reference's fixture), then
    the same rules on transformer-100m at full width.  Each traced step
    runs under ``torch.cuda.set_sync_debug_mode("error")``.  Returns
    (record, gossip launches by path)."""
    from repro_torch import train_100m
    from repro_torch.analysis import format_findings
    from repro_torch.analysis.targets import audit_train_step, audit_trainer
    from repro_torch.configs import get_config
    from repro_torch.core import Membership
    from repro_torch.data import ShardedLoader, SyntheticTokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import scale_by_controller

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    fc = audit_trainer()
    fc_s = time.perf_counter() - t0
    fc_launches = _launch_counts(kernels)
    check(fc == [], f"18a FC net audit:\n{format_findings(fc)}")
    check(fc_launches["gossip_mix_update_flat"] == AUDIT_TRAIN_STEPS
          and sum(fc_launches.values()) == AUDIT_TRAIN_STEPS,
          f"18a FC net audit launched {fc_launches}")

    t0 = time.perf_counter()
    cfg = get_config("transformer-100m")
    api = build_model(cfg)
    tree = api.param_tree(api.init(SEED))
    n_params = sum(t.numel() for t in _leaves(tree))
    loader = ShardedLoader(SyntheticTokenStream(vocab=cfg.vocab),
                           n_learners=TRAIN_LEARNERS,
                           local_batch=TRAIN_BATCH, extra_args=(TRAIN_SEQ,),
                           seed=SEED)
    batches = [loader.batch(i) for i in range(AUDIT_TRAIN_STEPS)]
    trainer = train_100m.make_trainer(
        api, scale_by_controller(train_100m.recipe(TRAIN_LR)),
        learners=TRAIN_LEARNERS)
    state = trainer.set_membership(trainer.init(SEED, tree),
                                   Membership(TRAIN_LEARNERS))
    del tree
    check(trainer.is_fused, "18a: the 100m trainer is not fused")
    setup_s = time.perf_counter() - t0
    for k in kernels:
        k.launches = 0
    report = {}
    t0 = time.perf_counter()
    found = audit_train_step(trainer, state, batches, bound=n_params // 100,
                             report=report)
    audit_s = time.perf_counter() - t0
    launches = _launch_counts(kernels)
    check(found == [], f"18a 100m audit:\n{format_findings(found)}")
    rounds = trainer.rounds_per_step
    check(report["launches"] == {"gossip_mix_update_flat": rounds},
          f"18a: the traced step launched {report['launches']}, not kernel "
          f"#2 once a gossip round ({rounds})")
    check(launches["gossip_mix_update_flat"] == AUDIT_TRAIN_STEPS * rounds
          and sum(launches.values()) == AUDIT_TRAIN_STEPS * rounds,
          f"18a: the audited steps launched {launches}")
    check(report["aliased_bytes"] == report["state_bytes"],
          f"18a: {report['aliased_bytes']} of {report['state_bytes']} state "
          "bytes written in place")
    del trainer, state, batches, loader
    torch.cuda.empty_cache()
    return {
        "fc_net": {"learners": 4, "hidden": 32, "topology": "ring",
                   "findings": 0, "steps": AUDIT_TRAIN_STEPS,
                   "kernel_launches": fc_launches, "seconds": fc_s},
        "transformer_100m": {
            "n_params": n_params, "learners": TRAIN_LEARNERS,
            "local_batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "algo": "dpsgd", "topology": "random_pair",
            "optimizer": "scale_by_controller(phase 4's recipe)",
            "concat_bound_elems": n_params // 100, "findings": 0,
            "sync_debug_mode": "error", "traced_step": report,
            "steps": AUDIT_TRAIN_STEPS, "kernel_launches": launches,
            "setup_s": setup_s, "audit_s": audit_s}}, {
        "audit_fc_trainer": fc_launches["gossip_mix_update_flat"],
        "audit_transformer_100m_trainer":
            launches["gossip_mix_update_flat"]}


def audit_serve_phase(kernels):
    """18b: the serve engine's paged decode step for transformer-100m at
    full width (phase 3's engine), traced under the sync debug mode, and
    its sentinel window of admissions, joins and evictions.  Returns
    (record, decode launches)."""
    from repro_torch.analysis import format_findings
    from repro_torch.analysis.targets import audit_serve_engine
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = get_config("transformer-100m")
    api = build_model(cfg)
    params = api.init(SEED)
    n_params = sum(p.numel() for p in params.parameters())
    eng = ServeEngine(api, params, n_slots=N_SLOTS, page_size=PAGE,
                      max_len=MAX_LEN)
    for k in kernels:
        k.launches = 0
    report = {}
    t0 = time.perf_counter()
    found = audit_serve_engine(eng, bound=n_params // 100, report=report,
                               target="serve.paged_decode_step"
                                      "[transformer-100m]")
    seconds = time.perf_counter() - t0
    launches = _launch_counts(kernels)
    check(found == [], f"18b serve audit:\n{format_findings(found)}")
    layers = cfg.n_layers
    check(report["launches"] == {"paged_decode_attention_fwd": layers},
          f"18b: the traced step launched {report['launches']}, not the "
          f"decode kernel once a layer ({layers})")
    calls = 2 + report["window_calls"]
    check(launches["paged_decode_attention_fwd"] == calls * layers
          and sum(launches.values()) == calls * layers,
          f"18b: {calls} decode steps launched {launches}")
    check(report["aliased_bytes"] == report["state_bytes"],
          f"18b: {report['aliased_bytes']} of {report['state_bytes']} pool "
          "bytes written in place")
    del eng, params
    torch.cuda.empty_cache()
    return {"model": cfg.name, "n_params": n_params, "n_slots": N_SLOTS,
            "page_size": PAGE, "max_len": MAX_LEN, "findings": 0,
            "sync_debug_mode": "error", "traced_step": report,
            "decode_steps": calls, "kernel_launches": launches,
            "seconds": seconds}, launches["paged_decode_attention_fwd"]


def twins_phase(kernels):
    """18d: ``repro_torch.serve_batched`` at its defaults, then
    ``repro_torch.train_100m --preset full --seq 512``: TWIN_STEPS steps
    and a checkpoint, then a run that resumes from it, trains one more
    step and evaluates.  Returns (record, decode launches, gossip
    launches)."""
    import tempfile

    from repro_torch import serve_batched, train_100m

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    served = serve_batched.main([])
    serve_s = time.perf_counter() - t0
    serve_launches = _launch_counts(kernels)
    check(served["tokens"] == 256
          and [len(g) for g in served["generated"]] == [32] * 8,
          f"18d serve_batched: {served['tokens']} tokens")
    for k in kernels:
        k.launches = 0
    args = ["--preset", "full", "--seq", str(TRAIN_SEQ), "--learners",
            str(TWIN_LEARNERS), "--ckpt-every", "0"]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        first = train_100m.main(args + ["--ckpt-dir", d, "--steps",
                                        str(TWIN_STEPS)])
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = train_100m.main(args + ["--ckpt-dir", d, "--steps",
                                          str(TWIN_STEPS + 1)])
        resumed_s = time.perf_counter() - t0
        ckpt_bytes = Path(resumed["checkpoint"]).stat().st_size
    train_launches = _launch_counts(kernels)
    check(first["resumed_from"] is None
          and resumed["resumed_from"] == TWIN_STEPS
          and resumed["steps"] == 1,
          f"18d train_100m: resumed from {resumed['resumed_from']}")
    losses = first["losses"] + resumed["losses"]
    check(all(np.isfinite(losses)) and np.isfinite(resumed["heldout"]),
          f"18d train_100m: losses {losses}, held out {resumed['heldout']}")
    check(train_launches["gossip_mix_update_flat"] == TWIN_STEPS + 1,
          f"18d train_100m launched {train_launches}")
    torch.cuda.empty_cache()
    return {"serve_batched": {
                "ms_per_step": served["ms_per_step"],
                "tokens_per_s": served["tokens_per_s"],
                "tokens": served["tokens"], "steps": served["steps"],
                "requests": served["requests"], "wall_s": serve_s,
                "kernel_launches": serve_launches},
            "train_100m": {
                "preset": "full", "seq": TRAIN_SEQ,
                "learners": TWIN_LEARNERS, "n_params": first["n_params"],
                "losses": losses, "heldout_loss": resumed["heldout"],
                "resumed_from": resumed["resumed_from"],
                "checkpoint_bytes": ckpt_bytes, "first_run_s": first_s,
                "resumed_run_s": resumed_s,
                "kernel_launches": train_launches}}, \
        serve_launches["paged_decode_attention_fwd"], \
        train_launches["gossip_mix_update_flat"]


def audit_phase(kernels, launch_audit=None):
    """Phase 18: a, b and d here; c from phase 16's ranks, or, run alone,
    from 4 ranks spawned for it.  Returns (record, decode launches by
    path, gossip launches by path)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    train, gossip = audit_train_phase(kernels)
    serve, audit_decode = audit_serve_phase(kernels)
    if launch_audit is None:
        api = build_model(get_config("transformer-100m"))
        with tempfile.TemporaryDirectory() as wdir:
            _save_stacked(api, wdir)
            del api
            torch.cuda.empty_cache()
            launch_audit = launch_audit_record(_launch_ranks(wdir, ()))
    gossip["launch_audit_ring_ppermute_4_gloo_ranks"] = launch_audit[
        "gossip_launches"]
    twins, twin_decode, twin_gossip = twins_phase(kernels)
    gossip["train_100m_twin"] = twin_gossip
    return {"a_trainer": train, "b_serve": serve, "c_launch": launch_audit,
            "d_twins": twins}, {
        "transformer_100m_audit_serving": audit_decode,
        "serve_batched_twin_serving": twin_decode}, gossip


# --only: one phase alone, its record printed (no kernels line)
ONLY = {
    "2": lambda k: {"decode": decode_attention_phase(),
                    "gossip": gossip_phase(), "reorth": reorth_phase(),
                    "flash": flash_phase(), "flash_bwd": flash_bwd_phase(),
                    "gossip_single": gossip_single_phase(k)},
    "3": lambda k: serve_phase(k)[0],
    "4": lambda k: train_phase(k)[0],
    "5": fc_phase,
    "6": table1_phase,
    "7": lambda k: gemma2_phase(k)[0],
    "10": lambda k: paper_phase(k)[0],
    "13": lambda k: xlstm_phase(k)[0],
    "14": lambda k: {"vlm": vlm_phase(), "audio": audio_phase()},
    "15": lambda k: elastic_phase(k)[0],
    "16": lambda k: launch_phase(k)[0],
    "17": lambda k: mesh_phase(k)[0],
    "18": lambda k: audit_phase(k)[0],
}


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port on one GPU.")
    ap.add_argument("--only", choices=sorted(ONLY, key=int),
                    help="run one phase alone (default: every phase)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import cuda_build
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     gossip_mix, reorth)

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products in
    torch.backends.cudnn.allow_tf32 = False         # full float32

    card = card_line()
    print(f"card: {card}", flush=True)
    sources = [decode_attention.SOURCE, gossip_mix.SOURCE, reorth.SOURCE,
               flash_attention.SOURCE, flash_attention.BWD_SOURCE]
    t0 = time.perf_counter()
    cuda_build.build_all(sources)
    print(f"build: {len(sources)} kernel source(s) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    kernels = [decode_attention.paged_decode_attention_fwd,
               gossip_mix.gossip_mix_update_flat,
               reorth.reorth_dots, reorth.reorth_axpy,
               gossip_mix.gossip_mix_update,
               flash_attention.flash_attention_fwd,
               flash_attention.flash_attention_bwd]
    if args.only is not None:
        print(json.dumps({f"phase_{args.only}": ONLY[args.only](kernels)}),
              flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    seconds, last = {}, [time.perf_counter()]

    def mark(phase):
        """Wall seconds since the previous mark, under ``phase``."""
        now = time.perf_counter()
        seconds[phase] = seconds.get(phase, 0.0) + now - last[0]
        last[0] = now

    decode_record = decode_attention_phase()
    mark("2a_decode")
    gossip_record = gossip_phase()
    torch.cuda.empty_cache()
    mark("2b_gossip")
    dots_record, axpy_record = reorth_phase()
    torch.cuda.empty_cache()
    mark("2c_reorth")
    flash_record = flash_phase()
    mark("2d_flash")
    flash_bwd_record = flash_bwd_phase()
    torch.cuda.empty_cache()
    mark("2f_flash_bwd")
    single_record = gossip_single_phase(kernels)
    torch.cuda.empty_cache()
    mark("2e_gossip_single")

    serve, launches = serve_phase(kernels)
    print(json.dumps({"serve": serve}), flush=True)
    mark("3_serve_100m")

    serve_launches = {"transformer_100m_serving": launches,
                      "transformer_100m_open_loop_serving":
                          serve["open_loop"]["decode_launches"]}
    for key, name, layers, why in (
            ("serve_gemma2", "gemma2-27b", GEMMA_LAYERS,
             "one local/global period"),
            ("serve_granite", "granite-20b", GRANITE_LAYERS,
             "phase 3b's depth")):
        record, launches = cut_serve_phase(name, layers, why, kernels)
        print(json.dumps({key: record}), flush=True)
        serve_launches[name.replace("-", "_") + "_serving"] = launches
        del record
        torch.cuda.empty_cache()
        mark("3b_serve_gemma2" if key == "serve_gemma2"
             else "3c_serve_granite")
    train, gossip_record["launches"], probe, probe_launches, \
        bridge_launches = train_phase(kernels)
    serve_launches["transformer_100m_bridge_serving"] = bridge_launches[
        "paged_decode_attention_fwd"]
    dots_record["launches"] = probe_launches["reorth_dots"]
    axpy_record["launches"] = probe_launches["reorth_axpy"]
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"probe": probe}), flush=True)
    mark("4_train_probe_bridge")
    fc = fc_phase(kernels)
    print(json.dumps({"fc": fc}), flush=True)
    mark("5_fc")
    table1 = table1_phase(kernels)
    print(json.dumps({"table1": table1}), flush=True)
    mark("6_table1")
    gemma, (gemma_launches, gemma_bwd) = gemma2_phase(kernels)
    print(json.dumps({"gemma2": gemma}), flush=True)
    mark("7_gemma2")
    flash_train, (train_launches, train_bwd) = flash_train_phase(kernels,
                                                                 train)
    print(json.dumps({"flash_train": flash_train}), flush=True)
    mark("8_flash_train")
    flash_record["launches"] = gemma_launches + train_launches
    flash_record["launches_by_path"] = {
        "gemma2_prefill_and_loss_backward": gemma_launches,
        "transformer_100m_use_pallas_training": train_launches}
    flash_bwd_record["launches_by_path"] = {
        "gemma2_loss_backward": gemma_bwd,
        "transformer_100m_use_pallas_training": train_bwd}
    flash_bwd_record["launches"] = gemma_bwd + train_bwd
    pytree, pytree_gossip = pytree_phase(kernels, train)
    print(json.dumps({"pytree_engine": pytree}), flush=True)
    mark("9_pytree_engine")
    paper, paper_gossip, fig2_reorth = paper_phase(kernels)
    print(json.dumps({"paper_fc": paper}), flush=True)
    mark("10_paper_fc")
    zoo_flash = {}
    for key, name, layers, why, seq in ZOO:
        record, launches = cut_serve_phase(name, layers, why, kernels)
        serve_launches[name.replace("-", "_") + "_serving"] = launches
        torch.cuda.empty_cache()
        record["prefill"], zoo_flash[name.replace("-", "_") + "_prefill"] = \
            zoo_prefill_phase(name, layers, seq, kernels)
        record["decode_kernel_at_its_decode_shape"] = {
            k: v for k, v in decode_record["per_shape"].items()
            if k.startswith(key.split("_", 1)[1])}
        print(json.dumps({key: record}), flush=True)
        del record
        torch.cuda.empty_cache()
        mark("11_granite_moe" if key == "serve_granite_moe" else "12_jamba")
    xlstm, xlstm_gossip = xlstm_phase(kernels)
    print(json.dumps({"ssm_xlstm": xlstm}), flush=True)
    del xlstm
    mark("13_xlstm")
    print(json.dumps({"vlm_qwen2_vl": vlm_phase()}), flush=True)
    print(json.dumps({"audio_seamless": audio_phase()}), flush=True)
    torch.cuda.empty_cache()
    mark("14_vlm_audio")
    elastic, elastic_gossip = elastic_phase(kernels)
    print(json.dumps({"elastic": elastic}), flush=True)
    torch.cuda.empty_cache()
    mark("15_elastic")
    launch, launch_gossip, launch_audit = launch_phase(kernels)
    print(json.dumps({"launch": launch}), flush=True)
    torch.cuda.empty_cache()
    mark("16_launch")
    mesh, mesh_gossip, mesh_reorth, mesh_flash = mesh_phase(kernels)
    print(json.dumps({"mesh": mesh}), flush=True)
    mark("17_mesh")
    audit, audit_decode, audit_gossip = audit_phase(kernels, launch_audit)
    print(json.dumps({"audit": audit}), flush=True)
    mark("18_audit")
    serve_launches.update(audit_decode)
    launch_gossip = {k: v for k, v in launch_gossip.items()
                     if k not in audit_gossip}
    decode_record["launches"] = sum(serve_launches.values())
    decode_record["launches_by_path"] = serve_launches
    flash_record["launches_by_path"].update(zoo_flash)
    flash_record["launches_by_path"].update(mesh_flash)
    flash_record["launches"] = sum(flash_record["launches_by_path"].values())
    gossip_record["launches_by_path"] = {
        "transformer_100m_dpsgd_training": gossip_record["launches"],
        "transformer_100m_bridge_training": bridge_launches[
            "gossip_mix_update_flat"],
        **pytree_gossip, **paper_gossip,
        "xlstm_350m_dpsgd_training": xlstm_gossip, **elastic_gossip,
        **launch_gossip, **mesh_gossip, **audit_gossip}
    gossip_record["launches"] = sum(
        gossip_record["launches_by_path"].values())
    for record in (dots_record, axpy_record):
        name = record["name"]
        record["launches_by_path"] = {
            "transformer_100m_probe": record["launches"],
            "fig2_probes": fig2_reorth[name],
            **{path: n[name] for path, n in mesh_reorth.items()}}
        record["launches"] = sum(record["launches_by_path"].values())

    print(json.dumps({"phase_seconds": seconds}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [decode_record, gossip_record, dots_record,
                                  axpy_record, single_record,
                                  flash_record, flash_bwd_record]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
