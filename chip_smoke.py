#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                       # every phase, one card
    python3 chip_smoke.py --only kernels,mm     # those phases alone, no
                                                # result line
    python3 chip_smoke.py --profile results/prof
                        # then also profile one admission and one decode
                        # tick of each serving slice, and one full-width
                        # training step of each training slice

1. Setup: prints the card's name and power limit (``nvidia-smi``) and
   builds every kernel of the port from the ``.cu`` sources in this checkout
   (one ``nvcc`` per source, all started together).
2. Kernels vs plain: each kernel's wrapper against its plain PyTorch version
   on the card, with the kernel's time, the plain version's time, one
   library call's time where one PyTorch call computes the same function (a
   yardstick timed here only, never called by the port) and the least time
   the card could take for the same work.  Kernel and library times
   (``ms``, ``library_ms``) are device times: calls captured in one CUDA
   graph and replayed (``graph_ms``); ``ms_stream`` and
   ``library_ms_stream`` are the same calls issued one by one from the host
   (``time_ms``), as the rows of earlier runs were timed.  ``flash_fwd`` at
   every ``FLASH_CASES`` shape of the JAX package's kernel tests, at the Qwen
   slice's prefill shape and at the training shape (batch 8), and at head
   dim 80 (Zamba2's prefill and training shapes, a ragged case in f32 and
   bf16), at head dim 160 (StableLM-2-12B's prefill shape, a ragged and a
   windowed case, each in f32 and bf16), at DeepSeekMoE-16B's prefill
   and training shapes (dh 128), and at Whisper-tiny's and
   LLaVA-NeXT-34B's prefill shapes with a ragged LLaVA case in f32 and
   bf16 (56 query heads over 8 kv heads); ``ssd_scan`` at every ``SSD_CASES``
   shape, at the Mamba2 slice's shape, at the training shape, on a
   multi-group case and at Zamba2's shape (H 80, P 64, N 64).
3. Slice 1: ``serve_benchmark`` on full-width Qwen1.5-0.5B with
   ``use_flash_kernel=True``, batch 8, prompt 1024, 32 generated tokens,
   seeded random weights.  Checks the flash kernel's launch count over that
   call, the generated tokens, and that the prefill logits of one request
   match the plain-attention path on the same weights.
4. Slice 2: the same on full-width Mamba2-780M, whose prefill runs the SSD
   kernel in every layer; the plain comparison runs ``ssd_chunked`` in its
   place on the same weights.  Then the same on full-width StableLM-2-12B
   (40 layers, flash at dh 160) and full-width DeepSeekMoE-16B (28 layers:
   1 dense, 27 MoE of 64 routed experts, top 6, and 2 shared; flash at dh
   128), whose prefill logits are held against the plain attention (both)
   and against ``moe_dense`` in place of the MoE main path (the MoE) in
   bf16 and f32 (``check_logits``: beside each the plain path's own spread,
   a control that must fail where the check says so, and the token-layer
   pairs routed to another expert set).  Then DeepSeek-V3 at every width
   of its config, depth cut to 4 (the 3 dense layers and one MoE layer of
   256 routed experts, top 8, 1 shared; MLA, which runs no kernel, as in
   JAX), with ``dsv3_checks``: 2 requests' decode against ``apply`` (f32),
   the absorbed decode against the expanded one (f32, bf16), the full MLA
   path against the blockwise one, and the MoE main path against
   ``moe_dense`` beside a control that drops each token's k-th expert.
   Then the encoder-decoder and the VLM patch prefix (``MM_SLICES``):
   Whisper-tiny at every width and depth (batch 8, prompt 416, 32 tokens,
   zero frames) and LLaVA-NeXT-34B at every width, depth cut to 20 (batch
   4, 576 zero patch rows + a 448-token prompt, 32 tokens), each through
   ``serve_benchmark`` with ``use_flash_kernel=True`` (one prefill: one
   ``flash_fwd`` a decoder layer), its prefill logits through the kernel
   against the plain attention in bf16 and f32 (``check_logits`` on seeded
   frames or patches, with the control), the shim's decode of 2 requests
   teacher-forced at its own cache length and positions against ``apply``
   in f32; then 3 ``make_train_step`` steps on one batch with seeded
   frames or patches (Whisper 8 x 416, LLaVA at depth 2, 2 x (576 + 448)),
   the launches, and one step's loss and gradients through the kernel
   against the plain path.
5. Training (``repro_torch.run.api`` on ``examples/configs/quickstart.yaml``,
   its dataset written to a temporary directory): the unchanged document's
   60 steps; then full-width Qwen1.5-0.5B through the flash kernel (10
   steps at batch 8 × 1024, ``remat: full``), with one step's loss and
   gradients through the kernel against the plain attention path on the
   same params and batch; then full-width Mamba2-780M through the SSD kernel
   (3 steps), the same comparison against ``ssd_chunked``; then full-width
   Zamba2-2.7B through both kernels (3 steps), against both plain versions;
   then DeepSeekMoE-16B at full width and depth 4 (1 dense + 3 MoE layers)
   through the flash kernel (3 steps), its ``router_lb`` printed, the
   router's gradients among those held against the plain path; then
   DeepSeek-V3 at full width and depth 3 (the dense layers) with its MTP
   head (3 steps), its ce, MTP and total losses by step, one step's loss
   and gradients through the full MLA path against the blockwise one.
   Then the ``bench`` kind (``Gym.bench`` through the run API): (a)
   ``bench.yaml`` unchanged but for its data and output directories
   (reduced Qwen, 30 steps after 3, 5 windows; no kernel launch, the
   tracked ``BENCH_quickstart.json``'s keys, its bytes untouched); (b)
   full-width Qwen1.5-0.5B through the flash kernel at 8 x 1024, three
   times, each run's windows and the runs' spread printed beside the
   training phase's median ms/step; (c) full-width Mamba2-780M through the
   SSD kernel (10 steps after 1).
6. Checkpoints: the two commands in ``warmstart.yaml``'s header (the
   unchanged quickstart with ``gym.config.ckpt_every=20``, then the
   unchanged ``warmstart.yaml`` from its checkpoint); then full-width
   Qwen1.5-0.5B at 12 of its 24 layers (``DONOR_LAYERS``) through the
   flash kernel (``TRAIN_SLICES``' document, batch 8 × 1024): 6 steps
   straight; 3 steps with an async checkpoint at step
   3, its ``resolved.yaml`` and ``manifest.json``; resumed in a new run to
   the budget of 6 (losses and params against the straight run within
   ``RESUME_TOL``, bit-equality printed); its params served from the
   checkpoint (``==`` the step-3 params; one prefill's logits ``==``); a
   warmstart of 2 steps from it; ``replay`` of the interrupted run's
   directory (the same fingerprint, the same losses).  Prints the
   snapshot's stall, the writer's seconds and bytes and the restore time.
7. Resilience and run accounting: full-width Qwen1.5-0.5B at 6 of its 24
   layers (``RESIL_LAYERS``) through the flash kernel (batch 8 x 1024, a
   checkpoint every 2 steps, 6 steps)
   straight with a ``torch.profiler`` window at step 3 (its ``flash_fwd``
   kernel events counted in the trace); with telemetry off (losses ``==``);
   with ``nan_loss`` at 2 and ``nan_params`` at 5 under the sentinel (two
   rollbacks, to the seeded init and to step 4; losses and params against
   the straight run within ``RESUME_TOL``, bit-equality printed); with two
   injected checkpoint-IO failures retried; with an injected preemption at
   3 and its resume; then a real SIGTERM to ``python -m repro_torch train``
   on the quickstart (exit 75, the resumed curve ``==`` a straight run's)
   and a stalled engine tick under the watchdog.  The train phases print
   ``model_flops_per_step`` (6·N·D) and ``mfu`` against the card's peak.
8. Post-training: full-width Qwen1.5-0.5B at ``DONOR_LAYERS`` (the
   checkpoint phase's depth) through the flash kernel with LoRA rank 8
   (alpha 16, the default targets): (a) on one 1024-token
   prompt, the injected forward ``==`` the base forward, ``apply(merge(p))``
   ``==`` the on-the-fly forward, an adapter checkpoint reloaded into a
   fresh init ``==``, the merged export restacked ``==`` ``merge(p)``; (b)
   the ``sft`` kind warmstarted strictly from the checkpoint phase's step-3
   checkpoint (fresh optimizer: the adapter exemption), on packed
   ``sft_synthetic`` rows of 8 x 1024: 6 steps straight (adapter
   checkpoint and merged export), 3 with a checkpoint and resumed to 6
   (within ``RESUME_TOL``), the checkpoint's base leaves ``==`` the
   donor's, the logged trainable count, one step's adapter gradients
   through the kernel against the plain path; (c) the ``dpo`` kind on
   static 1024-token pairs (8 a step) from the donor: first loss ``log 2``,
   margin 0, then positive; (d) pairs sampled twice through the paged
   engine (``==``) and a 2-step on-policy ``dpo`` run; (e) ``sft.yaml`` and
   ``dpo.yaml``.  Each run prints ms/step, ``mfu`` and peak memory.
9. The data pipeline and sweeps (``--only sweep``): a seeded JSONL corpus
   (16,384 documents, ~4.3 MiB) indexed and tokenized with the byte
   tokenizer by the producer-consumer pipeline (4 spawned workers) and by
   the serial baseline (the files byte-equal; each one's tok/s, host
   numbers of the card's machine), a BPE tokenizer of 256 merges trained
   on 2,048 documents and the corpus tokenized with it by the pipeline;
   full-width Qwen1.5-0.5B at 12 of its 24 layers (``SWEEP_LAYERS``)
   through the flash kernel (batch 8 x 1024, ``remat: full``) trained 3
   steps on those BPE tokens
   (``dataset/packed_chunked``) through the ``train`` kind; then the same
   document as the base of a sweep (a ``zip`` axis over
   ``optimizer.config.lr`` x ``seeds: [0, 1]``, 4 trials of 3 steps) run
   through the CLI with ``--max-trials 2``, again (the 2 missing trials),
   and a third time (4 resumed, no launch): 4 x 3 x 24 launches, the
   report's ranking, the trial equal to the train run ``==`` its loss, the
   card's memory back within 1 GiB after every trial, each trial's ms/step
   and peak; then ``lr_sweep.yaml`` unchanged but for its directories (6
   trials, no launch) and an ``sft`` run on a JSONL of pairs through
   ``tokenizer/byte``.
10. Training under sharding plans (``--only mesh``, ROADMAP A8a): a
   one-rank NCCL group over a ``(1, 1)`` ``data x model`` mesh; full-width
   Qwen1.5-0.5B at 6 of its 24 layers through the flash kernel (8 x 1024,
   ``remat: full``) 3 steps with no mesh and under ``ddp``, ``fsdp`` and
   ``fsdp_tp``, and full-width Mamba2-780M at 12 of its 48 layers through
   the SSD kernel 2 steps with no mesh and under ``fsdp_tp``, each run through the gym its document resolves to
   (``mesh_provider/local``, ``sharding_plan/<plan>``): the param and
   moment leaves DTensors with the plan's placements, the kernel's
   launches a step, losses and final params against the no-mesh run (bit
   equality required), ms/step and peak memory beside the no-mesh run's;
   then a checkpoint of the ``fsdp_tp`` Qwen state restored under ``ddp``
   and with no mesh, equal to the saved state, its manifest's specs the
   plan's.  The group is destroyed at the end of the phase.
10b. The GPipe schedule and expert parallelism (``--only pp``, ROADMAP
   A8b's training half): full-width Qwen1.5-0.5B at 12 of its 24 layers
   through ``flash_fwd`` (8 x 1024, ``remat: full``) 3 AdamW steps through
   the pipelined backbone stage-local (a ``MeshContext`` with ``pp`` 2, 4
   microbatches, no pipe group) beside 3 unpipelined steps: 96 launches a
   step (12 layers x 4 microbatches x 2), one step's loss and per-leaf
   gradients against the
   unpipelined step within ``TRAIN_SLICES['qwen']``'s bf16 tolerances,
   both curves, ms/step and peak memory; then full-width DeepSeekMoE-16B at
   depth 4 under ``fsdp_tp_ep`` on a ``(1, 1)`` NCCL mesh (EP degree 1,
   ``C_e`` 960) through the gym beside the no-mesh run (8 launches and 6
   EP bodies a step), the dropped share of each MoE layer's assignments,
   and one step's loss and gradients against ``moe_dense`` with the
   dropped assignments' gates zeroed (or the no-mesh step where none
   drops) within ``moe16b``'s bf16 tolerances.
10c. Serving under sharding plans (``--only serve_mesh``, ROADMAP A8b's
   serving half), each run beside the same run with no mesh: (e) first,
   one full-width Qwen1.5-0.5B decode step (8 slots, a cache of 1024)
   under ``ddp`` on a ``(1, 1)`` NCCL mesh under the dryrun's counter
   beside its dryrun on a fake world (FLOPs, bytes, collectives and
   argument bytes equal); then on a ``(1, 1)`` NCCL mesh (a) Qwen's static
   shim at 6 of its layers, 8 x 1024 x 32, through ``flash_fwd`` under
   ``fsdp_tp`` (streams ``==``, 6 launches an admission, tok/s and peak
   memory), (b) Qwen's paged engine at ``ENGINE_QWEN_LAYERS`` under
   ``ddp`` on 8 requests of the engine phase's traffic (streams and prefix
   hit rate ``==``), (c) Mamba2's shim at 12 of its layers, 8 x 1024 x 32,
   through ``ssd_scan`` under ``fsdp_tp`` (streams ``==``, 12 launches an
   admission), (d) DeepSeekMoE-16B at depth 4 through its shim at 8 x 512
   x 32 under ``serve_ep`` (EP degree 1: every admission's and tick's T·k
   and dropped share, first-token logits within the bf16 MoE bound of the
   no-mesh shim, streams equal or parted where the no-mesh logits tie
   within that bound).  The group is destroyed at the end of the phase.
10d. Post-training and DeepSeek-V3 under sharding plans (``--only
   a8b_post``, the third part of ROADMAP A8b), each run beside the same
   run with no mesh on a ``(1, 1)`` NCCL mesh, bit equality required:
   (a) full-width Qwen1.5-0.5B at 12 of its 24 layers (``A8B_POST_LAYERS``)
   with LoRA rank 8 through ``flash_fwd``, 3
   ``sft`` steps of 8 x 1024 under ``fsdp_tp`` (24 launches a step, every
   param leaf a DTensor with the plan's placements, the frozen base its
   init); (c) that run's adapter checkpoint restored with no mesh and
   through ``load_adapter(shardings=)`` under ``ddp``, its merged export
   against the no-mesh export; (b) 2 ``dpo`` steps on static pairs under
   ``fsdp`` (72 launches a step, first loss ``log 2``) and a ``dpo`` step
   on on-policy pairs (the pairs, 0 launches while sampling); (d) the
   engine over a LoRA model (Qwen at ``ENGINE_QWEN_LAYERS``) under
   ``fsdp_tp`` against the engine over ``merge(params)``; (e) full-width
   DeepSeek-V3 at ``DSV3_TRAIN_LAYERS`` with the MTP head, 2 gym steps
   under ``fsdp_tp``, its shim with the expanded and the absorbed decode,
   and one absorbed decode step against its dryrun (FLOPs, bytes,
   collectives, argument bytes equal), 0 launches; (f) the full-width
   DeepSeek-V3-671B dryruns of ``train_4k`` and ``decode_32k`` under
   ``fsdp_tp_ep`` on 256 fake ranks, each a CLI child on the host beside
   the card's checks: ``model_flops_global`` against 6·N·D, the plan, the
   warnings, the collectives, and each child's word that it never
   initialised CUDA.  Every phase's line carries ms/step or tok/s and peak
   memory beside the no-mesh run's.
10e. The hybrid, Whisper and LLaVA under sharding plans (``--only
   a8b_rest``, the rest of ROADMAP A8b), each run beside the same run with
   no mesh on a ``(1, 1)`` NCCL mesh, bit equality required: (a)
   full-width Zamba2-2.7B at ``A8B_ZAMBA_GROUPS`` of its 9 groups (5
   Mamba2 layers and one use of the shared block each) through both
   kernels, 2 gym steps of 8 x 1024 under ``fsdp_tp`` (``flash_fwd`` uses
   x 2 x steps, ``ssd_scan`` Mamba2 layers x 2 x steps), then its
   checkpoint restored under ``ddp`` and with no mesh; (b) the Zamba2
   engine at that depth under ``fsdp_tp`` (dense pool, 4 greedy requests
   of 256 + 32 tokens), both kernels in every admission; (c) full-size
   Whisper-tiny's shim (the ``mm`` slice's 8 x 416 x 32) under
   ``fsdp_tp`` and one train step under ``fsdp``; (d) full-width
   LLaVA-NeXT-34B at ``A8B_LLAVA_LAYERS`` layers, its shim (4 x (576 +
   448) x 32) under ``fsdp_tp``, and one train step at depth 2; (e) one
   Zamba2 decode step (8 slots, a cache of 1024) under ``ddp`` against
   its dryrun: FLOPs, bytes, collectives and argument bytes equal.  Each
   line carries ms/step, tok/s or tpot and peak memory beside the no-mesh
   run's.
11. The dryrun, trace and dryrun sweep (``--only dryrun``, ROADMAP A9b's
   dryrun half): (a) ``dryrun.yaml`` and ``trace.yaml`` unchanged through
   the port's CLI, each in a child process on the host from a temporary
   working directory, and ``ablation_dryrun.yaml`` with its sweep
   directory moved there (12 trials ``ok``, then a second call that
   resumes all 12): each result's terms, dominant term, FLOPs and
   collective bytes per device and trace seconds, ``model_flops_global``
   against 6·N·D, and each child's word that it never initialised CUDA;
   (b) meanwhile, on the card, one full-width step of Qwen1.5-0.5B through
   ``flash_fwd`` and of Mamba2-780M through ``ssd_scan`` (8 x 1024, a
   ``(1, 1)`` mesh under ``ddp``) under the dryrun's counter beside the
   dryrun of the same step on a fake world: FLOPs per device, collective
   kinds and argument bytes equal (those also equal to what
   ``memory_allocated`` gives back when a freshly built state and batch
   are dropped), 48 / 96 launches, the measured ms/step beside
   ``max(terms)`` and the traced peak beside ``max_memory_allocated``.
12. The continuous-batching engine: ``serve_engine.yaml`` unchanged but for
   its output directory; full-width Qwen at 6 of its 24 layers
   (``ENGINE_QWEN_LAYERS``) on the paged engine; full-width
   Mamba2 and full-width Zamba2-2.7B (``use_flash_kernel=True``) on the
   dense engine and full-width DeepSeekMoE-16B on the paged engine (pages
   of 16, chunk 256), each 16 sampled requests of 256/512/1024 prompt
   tokens, with two solo streams, and for Zamba2 three prompts' prefill
   logits through the kernels against the plain path, beside a control
   that the bounds must reject; last, DeepSeek-V3 at depth 4 on the paged
   engine, the same trace with the expanded and with the absorbed MLA
   decode, and the latent cache's bytes.

Every launch counter is set to 0 just before a slice drives its main path
(the serve run, the training run, the bench run, the engine run) and read
just after; the
``kernels`` line adds up every path's launches.  Imports neither JAX nor the JAX package.  Exits
non-zero, printing no result, without a CUDA device or without the port next
to it; exits non-zero when any phase fails.  The last line is the JSON
result object.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor-core and f32
# (CUDA-core) operations/s
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}

SLICE_BATCH, SLICE_PROMPT, SLICE_GEN = 8, 1024, 32
# flash vs plain attention, last-token prefill logits of one request, full
# width, bf16 through 24 layers (see LOGITS_TOL_WHY)
LOGITS_TOL = 0.125
LOGITS_TOL_WHY = (
    "bf16 activations through 24 layers: the kernel returns its f32 "
    "softmax-weighted sum rounded once to bf16, the plain path rounds the "
    "probabilities to bf16 before PV; each layer's difference of about one "
    "bf16 step of the attention output enters the residual stream and grows "
    "through the remaining layers. Logits here are of size ~1-3, where a bf16 "
    "step is 2**-7..2**-6 (0.008-0.016); the bound allows eight steps of "
    "2**-6, about twice the 0.057 seen on an H100 with these seeds")
# SSD kernel vs ssd_chunked, the same, bf16 through 48 Mamba2 layers
SSM_LOGITS_TOL = 0.5
SSM_LOGITS_TOL_WHY = (
    "bf16 activations through 48 layers: kernel and plain scan both compute "
    "y in f32 from the same bf16 inputs and round it once to bf16, so they "
    "differ only where their f32 sums, taken in other orders, straddle a "
    "bf16 rounding step, and each such step grows through the remaining "
    "layers. That is this model's own noise floor, printed beside it: the "
    "plain scan at chunk 64 (the same function, summed in another order) "
    "differs from it at chunk 128 by about 0.2 at logits of size ~3.5 on an "
    "H100 with these seeds; the bound is about twice that")
# the same prefill with f32 activations, where only f32 sum order differs
SSM_LOGITS_F32_TOL = 5e-4
SSM_LOGITS_F32_TOL_WHY = (
    "f32 activations through 48 layers: the plain scan at chunk 64 differs "
    "from it at chunk 128 by about 6e-5 on an H100 with these seeds (the "
    "floor printed beside it); the bound is about ten times that")
# the final state is f32 on both sides, from the same inputs: each element
# sums up to S decayed f32 products in other orders, whose rounding stays
# under S * 2**-24 (6e-5 at S = 1024) of the largest state
SSD_STATE_TOL = 1e-4


# DeepSeek-V3 (arXiv:2412.19437) at every width of its config, depth cut:
# serving runs the 3 leading dense layers and one MoE layer of 256 routed
# experts, top 8, 1 shared (14,388,066,304 params, 53.6 GiB in f32; the 61
# layers' 671 B would not fit one card), training the 3 dense layers and
# the MTP head (2,880,780,288 params; with the MoE layer, params, gradients
# and AdamW moments would take ~214 GiB).
DSV3_SERVE_LAYERS, DSV3_TRAIN_LAYERS = 4, 3

# training: the quickstart document at full width, the steps of each run,
# and for each activation dtype the (loss, gradient) tolerances of one step
# through the kernel against the plain path (see TRAIN_TOL_WHY)
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
# "flops": 6·N·D at TRAIN_BATCH x TRAIN_SEQ, N counted on the meta device
# (the JAX package's eval_shape count: tests/test_torch_telemetry.py)
TRAIN_SLICES = {
    "qwen": {"arch": "qwen1p5_0p5b", "steps": 10, "kernel": "flash_fwd",
             "sets": ["arch.config.use_flash_kernel=true"],
             "flops": 6.0 * 463987712 * 8 * 1024,
             "tols": {"bfloat16": (1e-3, 0.06), "float32": (1e-5, 1e-4)}},
    "mamba2": {"arch": "mamba2_780m", "steps": 3, "kernel": "ssd_scan",
               "sets": ["arch.variant_key=mamba2_780m"],
               "flops": 6.0 * 857379072 * 8 * 1024,
               "tols": {"bfloat16": (1e-3, 0.5), "float32": (1e-5, 1e-3)}},
    # both kernels: the shared attention block through flash_fwd (9 uses),
    # the 45 Mamba2 layers through ssd_scan
    "zamba2": {"arch": "zamba2_2p7b", "steps": 3,
               "kernel": "flash_fwd and ssd_scan",
               "sets": ["arch.variant_key=zamba2_2p7b",
                        "arch.config.use_flash_kernel=true"],
               "flops": 6.0 * 2063676080 * 8 * 1024,
               "tols": {"bfloat16": (2e-3, 0.25), "float32": (1e-5, 1e-3)}},
    # full width, depth cut to 4 (1 dense + 3 MoE layers: the 28 layers'
    # params, gradients and AdamW moments would take 243 GiB); N counts the
    # 6 of 64 routed experts a token uses (703,219,712 of 2,208,450,560)
    "moe16b": {"arch": "deepseek_moe_16b", "steps": 3, "kernel": "flash_fwd",
               "sets": ["arch.variant_key=deepseek_moe_16b",
                        "arch.config.n_layers=4",
                        "arch.config.use_flash_kernel=true"],
               "flops": 6.0 * 703219712 * 8 * 1024,
               "tols": {"bfloat16": (2e-3, 0.25), "float32": (1e-5, 5e-5)}},
    # full width, depth cut to DSV3_TRAIN_LAYERS (the dense layers, an
    # empty MoE stack) + the MTP head; no kernel (MLA is einsums, as in
    # JAX): its step holds the full MLA path against the blockwise one
    "dsv3": {"arch": "deepseek_v3_671b", "steps": 3,
             "kernel": "no kernel (MLA's einsums)",
             "sets": ["arch.variant_key=deepseek_v3_671b",
                      f"arch.config.n_layers={DSV3_TRAIN_LAYERS}"],
             "flops": 6.0 * 2880780288 * 8 * 1024,
             "compare": "full MLA path vs blockwise",
             "tols": {"bfloat16": (1e-3, 0.06), "float32": (1e-5, 1e-4)}},
}
TRAIN_TOL_WHY = {
    "bfloat16": (
        "bf16 activations and their gradients through every layer: kernel "
        "and plain path round at other places (the flash kernel rounds its "
        "f32 attention output once, the plain path its probabilities before "
        "PV; the SSD kernel and ssd_chunked sum in other orders) and each "
        "difference grows through the remaining layers and the backward; a "
        "leaf's gradient sums such differences over 8192 tokens, with "
        "cancellation (A_log, biases). The model's own spread, a second "
        "plain path of the same function summed in another order, is "
        "printed beside it: on an H100 with these seeds its worst leaf is "
        "0.027 (Qwen) and 0.12 (Mamba2), the kernel's 0.028 and 0.24, and "
        "each gradient bound is about twice the larger; the loss bound "
        "(1e-4 of the loss) is above the Mamba2 floor's 7.4e-4. Zamba2 "
        "(both kernels): floor 0.091 and |dloss| 5.1e-4, the kernels' "
        "0.106 and 9.8e-4; its bounds are about twice the larger, 0.25 and "
        "2e-3. DeepSeekMoE-16B at depth 4, where bf16 rounding also "
        "reroutes tokens at router near-ties: floor 0.101 and |dloss| "
        "4.2e-4, the kernel's 0.115 and 7.9e-4, both worst at the router; "
        "bounds 0.25 and 2e-3. DeepSeek-V3 at depth 3 + MTP holds its full "
        "MLA path (probabilities rounded to bf16 before PV) against the "
        "blockwise one (f32 probabilities), beside the floor of the "
        "blockwise path at kv blocks of 512 against 256: on an H100 with "
        "these seeds |dloss| 2.6e-4 and worst leaf 0.020 (the MTP block's "
        "q_norm), floor 9.9e-5 and 0.016; Qwen's bounds, 1e-3 and 0.06, "
        "about three times the larger"),
    "float32": (
        "f32 activations, where kernel and plain path differ only in f32 "
        "summation order (and the SSD kernel's hi/lo bf16 split of f32 "
        "operands): on an H100 with these seeds the worst leaf is 4.8e-6 "
        "(Qwen), 1.0e-4 (Mamba2, floor 3e-5), 7.6e-5 (Zamba2, floor "
        "3.3e-5) and 4.8e-6 (DeepSeekMoE-16B, floor 5.2e-6); each bound is "
        "about ten times that, the loss bound ten times the 9.5e-7 seen. "
        "DeepSeek-V3 (full vs blockwise MLA): 6.5e-6, floor 6.3e-6, |dloss| "
        "0; Qwen's bound, 1e-4"),
}
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def demangle(name: str) -> str:
    """A kernel's mangled name as ``kernel<template arguments>`` (through
    ``c++filt``), or as it is where that fails."""
    import re

    try:
        out = subprocess.run(["c++filt", name], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return name
    m = re.search(r"\w+<[^<>]*>", out)
    return m.group(0) if m else out.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``fn`` over ``iters`` calls issued back to back from the
    host and timed with two CUDA events: the host's issue rate is part of
    the number.  Used for the plain versions and, as ``ms_stream``, beside
    ``graph_ms`` for comparison with earlier stream-timed rows."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, warmup: int = 3, replays: int = 5) -> float:
    """Device ms of one ``fn`` call: ``iters`` calls captured in one CUDA
    graph after ``warmup`` eager calls, the graph replayed ``replays`` times
    between two CUDA events, so the host's launch rate is out of the number.
    A failed capture raises (a failed phase, no fallback)."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()                       # one untimed replay
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def flash_cases():
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    # B, Sq, Skv, H, K, dh, causal, window, dtype: FLASH_CASES of the JAX
    # package's kernel tests, then the serving slice's prefill shape
    return [
        ("B2S256x256H4K2d64cw0f32", (2, 256, 256, 4, 2, 64, True, 0, f32)),
        ("B1S300x300H4K4d64cw0f32", (1, 300, 300, 4, 4, 64, True, 0, f32)),
        ("B2S256x256H8K2d64cw64bf16", (2, 256, 256, 8, 2, 64, True, 64, bf16)),
        ("B1S128x128H2K1d128bw0f32", (1, 128, 128, 2, 1, 128, False, 0, f32)),
        ("B1S128x384H4K4d64bw0f32", (1, 128, 384, 4, 4, 64, False, 0, f32)),
        ("B2S192x192H4K2d32cw0bf16", (2, 192, 192, 4, 2, 32, True, 0, bf16)),
        # the f32 cases again in bf16: bf16 takes the tensor-core path, so
        # its ragged edge, dh=128, MQA and Sq != Skv are held here too
        ("B1S300x300H4K4d64cw0bf16", (1, 300, 300, 4, 4, 64, True, 0, bf16)),
        ("B1S128x128H2K1d128bw0bf16", (1, 128, 128, 2, 1, 128, False, 0, bf16)),
        ("B1S128x384H4K4d64bw0bf16", (1, 128, 384, 4, 4, 64, False, 0, bf16)),
        # causal + window with Sq != Skv: both indices from the same origin
        ("B1S128x384H4K2d64cw32f32", (1, 128, 384, 4, 2, 64, True, 32, f32)),
        ("B1S128x384H4K2d64cw32bf16", (1, 128, 384, 4, 2, 64, True, 32, bf16)),
        # a ragged last kv tile behind a full ring stage, and dh 128 at the
        # slice's length: the ring's prefetch of partial and wide tiles
        ("B1S1000H16K16d64cw0bf16", (1, 1000, 1000, 16, 16, 64, True, 0, bf16)),
        ("B1S1024H16K16d128cw0bf16",
         (1, 1024, 1024, 16, 16, 128, True, 0, bf16)),
        # the slice's shape in f32 times the f32 (CUDA-core) path there
        ("B1S1024H16K16d64cw0f32", (1, 1024, 1024, 16, 16, 64, True, 0, f32)),
        ("slice_B1S1024H16K16d64c_bf16",
         (1, 1024, 1024, 16, 16, 64, True, 0, bf16)),
        # the training slice's shape (batch 8 x 1024)
        ("train_B8S1024H16K16d64c_bf16",
         (8, 1024, 1024, 16, 16, 64, True, 0, bf16)),
        # dh 80, Zamba2's shared attention block: its prefill shape, its
        # training shape and a ragged case in both paths
        ("zamba2_B1S1024H32K32d80c_bf16",
         (1, 1024, 1024, 32, 32, 80, True, 0, bf16)),
        ("zamba2_train_B8S1024H32K32d80c_bf16",
         (8, 1024, 1024, 32, 32, 80, True, 0, bf16)),
        ("B1S300H32K32d80cw0f32", (1, 300, 300, 32, 32, 80, True, 0, f32)),
        ("B1S300H32K32d80cw0bf16", (1, 300, 300, 32, 32, 80, True, 0, bf16)),
        # dh 160, StableLM-2-12B (32 query heads over 8 kv heads): its
        # prefill shape, a ragged case and a window in both paths
        ("stablelm12b_B1S1024H32K8d160c_bf16",
         (1, 1024, 1024, 32, 8, 160, True, 0, bf16)),
        ("B1S1024H32K8d160cw0f32", (1, 1024, 1024, 32, 8, 160, True, 0, f32)),
        ("B1S300H32K8d160cw0bf16", (1, 300, 300, 32, 8, 160, True, 0, bf16)),
        ("B1S300H32K8d160cw0f32", (1, 300, 300, 32, 8, 160, True, 0, f32)),
        ("B1S1024H32K8d160cw256bf16",
         (1, 1024, 1024, 32, 8, 160, True, 256, bf16)),
        ("B1S1024H32K8d160cw256f32",
         (1, 1024, 1024, 32, 8, 160, True, 256, f32)),
        # DeepSeekMoE-16B (16 heads = 16 kv heads of 128): its prefill and
        # training shapes
        ("moe16b_B1S1024H16K16d128c_bf16",
         (1, 1024, 1024, 16, 16, 128, True, 0, bf16)),
        ("moe16b_train_B8S1024H16K16d128c_bf16",
         (8, 1024, 1024, 16, 16, 128, True, 0, bf16)),
        # Whisper-tiny's decoder prefill (6 heads of 64 at 416 = 6.5 q
        # tiles: the paired q tiles of dh <= 64 meet a ragged last one),
        # LLaVA-NeXT-34B's prefill (576 patches + 448 tokens; 56 query
        # heads over 8 kv heads, a group of 7) and a ragged LLaVA case in
        # both paths
        ("whisper_B8S416H6K6d64c_bf16",
         (8, 416, 416, 6, 6, 64, True, 0, bf16)),
        ("llava_B4S1024H56K8d128c_bf16",
         (4, 1024, 1024, 56, 8, 128, True, 0, bf16)),
        ("B1S600H56K8d128cw0bf16", (1, 600, 600, 56, 8, 128, True, 0, bf16)),
        ("B1S600H56K8d128cw0f32", (1, 600, 600, 56, 8, 128, True, 0, f32)),
    ]


def _mask(Sq, Skv, causal, window, device):
    import torch

    pq = torch.arange(Sq, device=device)[:, None]
    pk = torch.arange(Skv, device=device)[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        m &= pq >= pk
    if window > 0:
        m &= pq - pk < window
    return m


def phase_kernels(results: dict) -> bool:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash import ops
    from repro_torch.kernels.flash.ref import attention_ref

    ok = True
    gen = torch.Generator(device="cuda")
    for name, (B, Sq, Skv, H, K, dh, causal, window, dt) in flash_cases():
        gen.manual_seed(0)
        q = torch.randn((B, Sq, H, dh), generator=gen, device="cuda", dtype=dt)
        k = torch.randn((B, Skv, K, dh), generator=gen, device="cuda", dtype=dt)
        v = torch.randn((B, Skv, K, dh), generator=gen, device="cuda", dtype=dt)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = 2.5e-2 if dt == torch.bfloat16 else 1e-5
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        # the share of the bound atol + rtol * |ref| the worst element uses
        tol_use = float((diff / (tol + tol * ref.float().abs())).max())
        good = tol_use <= 1.0
        ok &= good
        kern = lambda: ops.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                           window=window)
        kern_ms, kern_stream_ms = graph_ms(kern), time_ms(kern)
        plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=causal,
                                                 window=window), iters=5)
        # the yardstick: one library call on the layout it wants; a plain
        # causal mask goes as is_causal so SDPA may take its flash backend
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = _mask(Sq, Skv, causal, window, "cuda")
        if causal and window == 0 and Sq == Skv:
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=H != K)
        else:
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=H != K)
        lib_ms, lib_stream_ms = graph_ms(sdpa), time_ms(sdpa)
        pairs = int(mask.sum())
        n_bytes = 2 * (q.nbytes + k.nbytes)        # q, k, v read; o written
        n_ops = 4 * dh * pairs * B * H             # QK^T and PV, 2 ops a MAC
        peak = PEAK_OPS_S["bfloat16" if dt == torch.bfloat16 else "float32"]
        t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / peak
        row = {"case": name, "max_abs_err": err, "tol": tol,
               "tol_use": tol_use, "ok": good,
               "ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "ms_stream": kern_stream_ms, "library_ms_stream": lib_stream_ms,
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": n_bytes, "ops": n_ops}
        print("flash_fwd " + json.dumps(row), flush=True)
        results.setdefault("flash_cases", []).append(row)
        del q, k, v, out, ref
    return ok


def ssd_cases():
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    # B, S, H, P, G, N, chunk, dtype: SSD_CASES of the JAX package's kernel
    # tests, then the Mamba2 slice's prefill shape and a multi-group case
    return [
        ("B2S256H4P64G1N64c128f32", (2, 256, 4, 64, 1, 64, 128, f32)),
        ("B1S128H4P32G2N16c32f32", (1, 128, 4, 32, 2, 16, 32, f32)),
        ("B2S256H8P64G1N128c128bf16", (2, 256, 8, 64, 1, 128, 128, bf16)),
        ("B1S96H2P16G1N8c32f32", (1, 96, 2, 16, 1, 8, 32, f32)),
        ("B2S384H8P32G4N64c128bf16", (2, 384, 8, 32, 4, 64, 128, bf16)),
        # the kernel's passes: one chunk, and 3 chunks across B 2 and G 4;
        # a chunk and a P that are no multiples of 16 or 32
        ("B1S128H4P64G1N128c128bf16", (1, 128, 4, 64, 1, 128, 128, bf16)),
        ("B2S96H8P16G4N16c32f32", (2, 96, 8, 16, 4, 16, 32, f32)),
        ("B1S72H4P48G2N24c24f32", (1, 72, 4, 48, 2, 24, 24, f32)),
        # the slice's shape in f32 takes the most shared memory
        ("B1S1024H48P64G1N128c128f32", (1, 1024, 48, 64, 1, 128, 128, f32)),
        ("slice_B1S1024H48P64G1N128c128_bf16",
         (1, 1024, 48, 64, 1, 128, 128, bf16)),
        ("train_B8S1024H48P64G1N128c128_bf16",
         (8, 1024, 48, 64, 1, 128, 128, bf16)),
        # Zamba2's Mamba2 layers: 80 heads of 64, state 64
        ("zamba2_B1S1024H80P64G1N64c128_bf16",
         (1, 1024, 80, 64, 1, 64, 128, bf16)),
    ]


def ssd_work(B, S, H, P, G, N, Q, itemsize):
    """Bytes the scan must move (each input read once, y and h_final written
    once) and the operations of its products (2 a multiply-add): C B^T over
    the lower triangle once per group and chunk, M x over the lower triangle,
    C h^T and x^T (B . decay) per head and chunk."""
    n_bytes = (2 * B * S * H * P * itemsize          # x, y
               + 2 * B * S * G * N * itemsize        # Bm, Cm
               + B * S * H * 4 + 2 * H * 4           # dt; A, D
               + B * H * P * N * 4)                  # h_final
    tri = Q * (Q + 1) // 2
    n_ops = 2 * B * (S // Q) * (G * tri * N + H * (tri * P + 2 * Q * P * N))
    return n_bytes, n_ops


def phase_ssd(results: dict) -> bool:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_chunked

    ok = True
    gen = torch.Generator(device="cuda")
    for name, (B, S, H, P, G, N, Q, dt_) in ssd_cases():
        gen.manual_seed(1)
        rnd = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                         device="cuda")
        x = rnd(B, S, H, P).to(dt_)
        dt = F.softplus(rnd(B, S, H))
        A = -torch.exp(rnd(H) * 0.5)
        Bm = (rnd(B, S, G, N) * 0.3).to(dt_)
        Cm = (rnd(B, S, G, N) * 0.3).to(dt_)
        D = torch.ones((H,), device="cuda")
        args = (x, dt, A, Bm, Cm, D)
        y, h = ops.ssd_scan(*args, chunk=Q)
        torch.cuda.synchronize()
        y_ref, h_ref = ssd_chunked(*args, chunk=Q)
        torch.cuda.synchronize()
        rel = 3e-2 if dt_ == torch.bfloat16 else 3e-5
        tol = rel * float(y_ref.float().abs().max())
        htol = SSD_STATE_TOL * float(h_ref.abs().max())
        err = float((y.float() - y_ref.float()).abs().max())
        herr = float((h - h_ref).abs().max())
        good = (err <= tol and herr <= htol
                and bool(torch.isfinite(y.float()).all()))
        ok &= good
        kern = lambda: ops.ssd_scan(*args, chunk=Q)  # noqa: E731
        kern_ms, kern_stream_ms = graph_ms(kern), time_ms(kern)
        plain_ms = time_ms(lambda: ssd_chunked(*args, chunk=Q), iters=5)
        n_bytes, n_ops = ssd_work(B, S, H, P, G, N, Q, x.element_size())
        peak = PEAK_OPS_S["bfloat16" if dt_ == torch.bfloat16 else "float32"]
        t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / peak
        row = {"case": name, "max_abs_err": err, "tol": tol,
               "tol_use": err / tol, "h_max_abs_err": herr, "h_tol": htol,
               "h_tol_use": herr / htol, "ok": good,
               "ms": kern_ms, "plain_ms": plain_ms, "library_ms": None,
               "ms_stream": kern_stream_ms,
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": n_bytes, "ops": n_ops}
        print("ssd_scan " + json.dumps(row), flush=True)
        results.setdefault("ssd_cases", []).append(row)
        del x, dt, Bm, Cm, y, h, y_ref, h_ref
    return ok


def _plain_ssm_scan(chunk_override=0):
    """``ssd_chunked`` in the SSD wrapper's place; with ``chunk_override``
    it scans at that chunk instead (the same function, summed in another
    order), to show the model's own rounding spread."""
    from repro_torch.kernels.ssd.ref import ssd_chunked

    def scan(x, dt, A, Bm, Cm, D, *, chunk):
        return ssd_chunked(x, dt, A, Bm, Cm, D,
                           chunk=min(chunk, chunk_override or chunk))

    return scan


# StableLM-2-12B's and DeepSeekMoE-16B's prefill logits (one 1024-token
# prompt, seed 1) against the plain paths, as check_logits takes them:
# (activations, what is plain, bound, whether the control must fail it, why)
STABLELM12B_LOGITS = [
    ("bfloat16", "attention", 0.25, True,
     "bf16 activations through 40 layers at dh 160: kernel and blockwise "
     "loop sum the same f32 products in other orders and round the output "
     "once to bf16; each difference grows through the later layers. On an "
     "H100 with this seed the kernel reads 0.131 and the two plain "
     "attentions differ by 0.133 (the floor); the bound is about twice the "
     "larger, and the control reads 2.08"),
    ("float32", "attention", 1e-4, True,
     "f32 activations: only f32 sum orders differ. Kernel 1.8e-5, floor "
     "2.0e-5, control 2.01 on an H100; the bound is five times the larger"),
]
MOE16B_LOGITS = [
    ("bfloat16", "attention", 0.75, True,
     "bf16 activations through 28 layers: at init the router's 64 "
     "probabilities are close to uniform, so a token whose k-th and "
     "(k+1)-th probabilities nearly tie takes another expert when its "
     "hidden state moves by a bf16 step (a quarter of the token-layer "
     "pairs on an H100 with this seed), and its state jumps. Kernel 0.254, "
     "floor 0.363, control 2.30: the bound is about twice the larger"),
    ("float32", "attention", 5e-4, True,
     "f32 activations: f32 sum orders only, and no pair rerouted. Kernel "
     "9.3e-6, floor 1.0e-4, control 2.34 on an H100; the bound is five "
     "times the larger"),
    ("bfloat16", "MoE", 0.75, True,
     "the MoE layers' main path against moe_dense, attention through the "
     "kernel on both: one bf16 rounding of each routed output on both, "
     "from f32 sums of other orders, and the router ties that reaches "
     "(3939 of 27648 pairs rerouted on an H100). Main path 0.258 against "
     "the floor's 0.363, control 2.43: the attention row's bound"),
    ("float32", "MoE", 5e-4, True,
     "f32 activations: the same products summed in other orders, no pair "
     "rerouted. Main path 8.0e-6 on an H100: the attention row's bound"),
]

# each slice: the arch and its config, the kernel its prefill runs, and the
# bound on its kernel-vs-plain prefill logits for each activation dtype
# (``tols``), or the checks of ``check_logits`` (``logits``)
SLICES = {
    "qwen": {"arch": "qwen1p5_0p5b", "with": {"use_flash_kernel": True},
             "kernel": "flash_fwd",
             "tols": {"bfloat16": (LOGITS_TOL, LOGITS_TOL_WHY)}},
    "mamba2": {"arch": "mamba2_780m", "with": {}, "kernel": "ssd_scan",
               "tols": {"bfloat16": (SSM_LOGITS_TOL, SSM_LOGITS_TOL_WHY),
                        "float32": (SSM_LOGITS_F32_TOL,
                                    SSM_LOGITS_F32_TOL_WHY)}},
    "stablelm12b": {"arch": "stablelm_12b", "with": {"use_flash_kernel": True},
                    "kernel": "flash_fwd", "logits": STABLELM12B_LOGITS},
    "moe16b": {"arch": "deepseek_moe_16b", "with": {"use_flash_kernel": True},
               "kernel": "flash_fwd", "logits": MOE16B_LOGITS},
    # full width, depth cut to DSV3_SERVE_LAYERS; no kernel (MLA is einsums,
    # as in JAX), its checks are dsv3_checks'
    "dsv3": {"arch": "deepseek_v3_671b",
             "with": {"n_layers": DSV3_SERVE_LAYERS}, "kernel": "flash_fwd",
             # (a lambda: dsv3_checks is defined further down)
             "checks": lambda *a: dsv3_checks(*a)},
}

# the decode checks teacher-force the first DSV3_CHECK_REQUESTS of the
# slice's requests along their generated tokens; the MoE check runs a
# DSV3_MOE_PROMPT-token prompt (moe_dense's [T, 256, 7168] f32 outputs at
# 1024 tokens would not fit beside the params)
DSV3_CHECK_REQUESTS, DSV3_MOE_PROMPT = 2, 256
# (name, activations, bound, why) of each DeepSeek-V3 serving check
DSV3_DECODE_TOL = 5e-4
DSV3_DECODE_WHY = (
    "JAX's bound for decode against the forward in f32 "
    "(tests/test_decode_consistency.py): the latent cache holds the "
    "forward's own rows, so only f32 sum orders differ")
DSV3_BF16_TOL = 1.0
DSV3_BF16_WHY = (
    "bf16 activations: the two paths round at other places (the absorbed "
    "decode scores in the latent space; the full forward rounds its "
    "probabilities to bf16 before PV, the blockwise one keeps them in f32) "
    "and a token-layer pair at a near-tie of the MoE layer's 256 router "
    "probabilities takes another expert set. On an H100 with these seeds "
    "the floor (the expanded decode against the forward, bf16) reads "
    "0.477, absorbed vs expanded 0.512 and full vs blockwise 0.109 at "
    "logits of size ~9; the bound is about twice the floor")
DSV3_MOE_TOLS = {
    "float32": (5e-4, "f32 activations: the same expert products summed in "
                "other orders, and a single MoE layer, so no pair is "
                "rerouted between the two paths. Main path 7.6e-6, floor "
                "2.1e-5, control 0.291 on an H100: DSV3_DECODE_TOL"),
    "bfloat16": (0.1, "bf16 activations, the routing the same on both paths "
                 "(one MoE layer, the last): one bf16 rounding of each "
                 "routed output from f32 sums of other orders. Main path "
                 "0.031, control 0.258 on an H100 with this seed (the "
                 "attention's floor, 0.42, is another path's): the bound "
                 "lies between the two"),
}


def _counters():
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    return {"flash_fwd": flash_ops, "ssd_scan": ssd_ops}


def add_launches(results: dict, counts: dict) -> None:
    """Add one main path's launch counts to the run's totals (the
    ``kernels`` line)."""
    total = results.setdefault("launches", {})
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def kernel_layers(cfg) -> dict:
    """Layers of ``cfg`` that launch each kernel once per forward: its
    attention layers (dense and MoE blocks, or each use of the hybrid's
    shared block) through ``flash_fwd`` when ``use_flash_kernel`` is set,
    its Mamba2 layers through ``ssd_scan``."""
    from repro_torch.models import build_model

    kinds = build_model(cfg).kinds
    attn = sum(k in ("dense_block", "moe_block", "attn_block") for k in kinds)
    return {"flash_fwd": attn if cfg.use_flash_kernel else 0,
            "ssd_scan": kinds.count("ssm")}


def _prefill_logits(cfg, params, tok, dtype, attention="kernel",
                    ssd="kernel", chunk_override: int = 0, moe="main",
                    routes=None, extra=None):
    """One request's last-token prefill logits with activations in
    ``dtype`` on the same weights and the card.  ``attention``: the model's
    ``flash_fwd`` (``"kernel"``, where ``cfg`` sets ``use_flash_kernel``),
    the plain attention that rounds its probabilities to ``dtype`` before PV
    (``"full"``), the plain online-softmax loop that keeps them in f32 as
    the kernel does (``"blockwise"``), or a function called in the flash
    wrapper's place (a control).  ``ssd``: the SSD kernel (``"kernel"``) or
    ``ssd_chunked`` at ``chunk_override`` or the model's chunk
    (``"plain"``).  ``moe``: the MoE layers' main path (``"main"``), the
    plain ``moe_dense`` (``"dense"``) or a function called in
    ``moe_routed``'s place (a control); ``routes``, a list, receives each
    MoE layer's expert indices.  ``extra`` goes into the batch beside the
    tokens (an audio arch's ``frames``, a VLM's ``patch_embeds``)."""
    model, stack = _patched(cfg, dtype, attention, ssd, chunk_override, moe,
                            routes)
    with stack:
        logits, _ = model.prefill(params, {"tokens": tok, **(extra or {})})
    return logits.float()


def _patched(cfg, dtype, attention="kernel", ssd="kernel",
             chunk_override: int = 0, moe="main", routes=None):
    """(model, context): ``cfg``'s model and the patches that
    ``_prefill_logits`` describes, to enter around the calls."""
    import contextlib

    import repro_torch.models.attention as attn
    import repro_torch.models.moe as moe_mod
    import repro_torch.models.ssm as ssm
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.models import build_model

    plain_attn = attention in ("full", "blockwise")
    model = build_model(cfg.with_(use_flash_kernel=False) if plain_attn
                        else cfg)
    stack = contextlib.ExitStack()
    stack.enter_context(_acts_patch(model, dtype))
    if ssd == "plain":
        stack.enter_context(mock.patch.object(
            ssm, "ssd_scan", _plain_ssm_scan(chunk_override)))
    if attention == "blockwise":
        stack.enter_context(mock.patch.object(attn, "_BLOCKWISE_AT", 0))
    elif callable(attention):
        stack.enter_context(mock.patch.object(
            flash_ops, "flash_attention", attention))
    if moe == "dense":
        stack.enter_context(mock.patch.object(
            moe_mod, "moe_routed", moe_mod.moe_dense))
    elif callable(moe):
        stack.enter_context(mock.patch.object(moe_mod, "moe_routed", moe))
    if routes is not None:
        route = moe_mod.route_stats

        def recording(cfg_, w, x):
            out = route(cfg_, w, x)
            routes.append(out[0])
            return out

        stack.enter_context(mock.patch.object(moe_mod, "route_stats",
                                              recording))
    return model, stack


def phase_slice(key: str, results: dict, profile_dir: str = "") -> bool:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_benchmark
    from repro_torch.models import build_model
    from repro_torch.serve.engine import load_params

    spec = SLICES[key]
    ok = True
    cfg = get_config(spec["arch"]).with_(**spec["with"])
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = load_params(model, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"slice {key}: {cfg.name} full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab}), seeded init "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    res = serve_benchmark(model, batch=SLICE_BATCH, prompt_len=SLICE_PROMPT,
                          gen=SLICE_GEN, seed=0, params=params, device="cuda")
    counts = {name: c.launches for name, c in counters.items()}
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = counts[spec["kernel"]]
    layers = kernel_layers(cfg)[spec["kernel"]]
    want = layers * (SLICE_BATCH + 1)
    print(f"slice {key}: launches over serve_benchmark {counts}; "
          f"{spec['kernel']} {launches} (want {layers} layers x "
          f"({SLICE_BATCH} admissions + 1 warm-up) = {want})", flush=True)
    ok &= launches == want
    add_launches(results, counts)
    ids = res["generated_ids"]
    tokens_ok = (len(ids) == SLICE_BATCH and all(
        len(r) == SLICE_GEN and all(0 <= t < cfg.vocab for t in r) for r in ids))
    print(f"slice {key}: {len(ids)} requests, each {SLICE_GEN} tokens in "
          f"[0, {cfg.vocab}): {tokens_ok}", flush=True)
    ok &= tokens_ok
    tp = res["tpot_ms"]
    print(f"slice {key}: prefill_tok_s {res['prefill_tok_s']} decode_tok_s "
          f"{res['decode_tok_s']} tpot_ms p50 {tp['p50']:.4f} p90 "
          f"{tp['p90']:.4f} peak_mem_gib {peak_gib:.3f}", flush=True)

    # one request's prefill: kernel vs plain version, same weights
    prompt = np.random.default_rng(1).integers(
        3, cfg.vocab, size=(1, SLICE_PROMPT), dtype=np.int32)
    tok = torch.as_tensor(prompt, dtype=torch.int64, device="cuda")
    if "logits" in spec:
        ok &= check_logits(f"slice {key}", 1, cfg, params, tok,
                           spec["logits"])
    if "checks" in spec:
        ok &= spec["checks"](cfg, params, res, tok)
    for dname, (tol, why) in spec.get("tols", {}).items():
        dtype = getattr(torch, dname)
        lk = _prefill_logits(cfg, params, tok, dtype)
        lp = _prefill_logits(cfg, params, tok, dtype, "full", "plain")
        torch.cuda.synchronize()
        d = (lk - lp).abs()
        err = float(d.max())
        size = float(lp.abs().max())
        same_top = int(lk.argmax(-1)) == int(lp.argmax(-1))
        floor = ""
        if key == "mamba2":
            l64 = _prefill_logits(cfg, params, tok, dtype, "full", "plain",
                                  64)
            floor = (f", plain chunk 64 vs 128 (the floor) "
                     f"{float((l64 - lp).abs().max()):.6g}")
        print(f"slice {key}: prefill logits ({dname}) {spec['kernel']} vs "
              f"plain: max abs diff {err:.6g}, mean {float(d.mean()):.6g}, "
              f"max |logit| {size:.4f}, same argmax {same_top}{floor}; tol "
              f"{tol} ({why})", flush=True)
        ok &= bool(torch.isfinite(lk).all()) and err <= tol
    if profile_dir:
        profile_slice(model, params, profile_dir, key)
    del params, res
    _free()
    return ok


def _decode_logits(cfg, params, prompts, gen, dtype, routes=None):
    """Teacher-forced decode on the dense latent cache: ``prompts [B, P]``
    prefilled into a cache of ``dtype`` with P + G rows, then
    ``gen[:, :G - 1]`` decoded a token a step; the logits that predict
    positions P .. P + G - 1, ``[B, G, vocab]`` in f32."""
    import torch

    model, stack = _patched(cfg, dtype, routes=routes)
    B, P = prompts.shape
    G = gen.shape[1]
    outs = []
    with stack, torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompts},
                                      max_len=P + G, cache_dtype=dtype)
        outs.append(logits.float())
        for j in range(G - 1):
            logits, cache = model.decode_step(
                params, cache, gen[:, j],
                torch.full((B,), P + j, dtype=torch.int64,
                           device=prompts.device))
            outs.append(logits.float())
    return torch.stack(outs, 1)


def _forward_logits(cfg, params, prompts, gen, dtype, attention="kernel"):
    """``apply`` on ``prompts`` followed by ``gen[:, :G - 1]``: the logits
    at the positions ``_decode_logits`` returns, in f32."""
    import torch

    model, stack = _patched(cfg, dtype, attention)
    P, G = prompts.shape[1], gen.shape[1]
    with stack, torch.no_grad():
        logits, _ = model.apply(params, {"tokens": torch.cat(
            [prompts, gen[:, :G - 1]], 1)})
    return logits[:, P - 1:].float().contiguous()


def _moe_without_last_expert():
    """The MoE main path with each token's k-th expert left out (its gate
    set to 0): a control that a bound on the MoE logits has to reject."""
    import torch

    import repro_torch.models.moe as moe_mod

    routed = moe_mod.moe_routed

    def moe(cfg, p, x, idx, gate):
        keep = torch.arange(gate.shape[1], device=gate.device) < \
            gate.shape[1] - 1
        return routed(cfg, p, x, idx, gate * keep)

    return moe


def _dsv3_row(label, err, size, tol, floor, floor_what, why, extra="",
              control=None):
    """Print one DeepSeek-V3 check; True when ``err`` is within ``tol`` and
    the ``control`` reading, where there is one, outside it."""
    good = err <= tol and (control is None or control > tol)
    print(f"slice dsv3: {label}: max abs diff {err:.6g}, max |logit| "
          f"{size:.4f}{extra}; {floor_what} (the floor) {floor:.6g}; tol "
          f"{tol}: {'ok' if good else 'FAILED'} ({why})", flush=True)
    return good


def dsv3_checks(cfg, params, res, tok) -> bool:
    """DeepSeek-V3's serving checks on the card, on the slice's weights:
    (1) the decode of the first ``DSV3_CHECK_REQUESTS`` requests,
    teacher-forced along their generated tokens, against ``apply`` on
    prompt + tokens, f32; (2) the absorbed decode against the expanded one,
    f32 and bf16; (3) ``mla_forward``'s full path against
    ``_mla_blockwise`` (``_BLOCKWISE_AT`` lowered here only) on one prompt's
    prefill logits, f32 and bf16; (4) the MoE main path against
    ``moe_dense`` on a ``DSV3_MOE_PROMPT``-token prompt, f32 and bf16,
    beside a control that drops each token's k-th expert.  bf16 rows count
    the token-layer pairs routed to another expert set."""
    import numpy as np
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    n = DSV3_CHECK_REQUESTS
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        3, cfg.vocab, size=(SLICE_BATCH, SLICE_PROMPT), dtype=np.int32)[:n],
        dtype=torch.int64, device="cuda")
    gen = torch.as_tensor(res["generated_ids"][:n], dtype=torch.int64,
                          device="cuda")
    G = gen.shape[1]
    absorbed = cfg.with_(mla_absorb=True)
    what = f"{n} requests x {G} positions"
    ok = True

    dec = _decode_logits(cfg, params, prompts, gen, f32)
    fwd = _forward_logits(cfg, params, prompts, gen, f32)
    floor32 = float((fwd - _forward_logits(cfg, params, prompts, gen, f32,
                                           "blockwise")).abs().max())
    fw32 = "full vs blockwise forward, f32"
    ok &= _dsv3_row(f"(1) decode vs forward (float32, {what})",
                    float((dec - fwd).abs().max()), float(fwd.abs().max()),
                    DSV3_DECODE_TOL, floor32, fw32, DSV3_DECODE_WHY)
    ok &= bool(torch.isfinite(dec).all())
    dec_a = _decode_logits(absorbed, params, prompts, gen, f32)
    ok &= _dsv3_row(f"(2) absorbed vs expanded decode (float32, {what})",
                    float((dec_a - dec).abs().max()), float(dec.abs().max()),
                    DSV3_DECODE_TOL, floor32, fw32, DSV3_DECODE_WHY)
    del dec, fwd, dec_a
    ra, rb = [], []
    dec16 = _decode_logits(cfg, params, prompts, gen, bf16, routes=ra)
    dec16_a = _decode_logits(absorbed, params, prompts, gen, bf16,
                             routes=rb)
    floor16 = float((dec16 - _forward_logits(cfg, params, prompts, gen,
                                             bf16)).abs().max())
    fw16 = "expanded decode vs forward, bf16"
    r, total = _rerouted(ra, rb)
    ok &= _dsv3_row(f"(2) absorbed vs expanded decode (bfloat16, {what})",
                    float((dec16_a - dec16).abs().max()),
                    float(dec16.abs().max()), DSV3_BF16_TOL, floor16, fw16,
                    DSV3_BF16_WHY, f"; token-layer pairs routed to another "
                    f"expert set {r} of {total}")
    del dec16, dec16_a

    for dname, tol, floor, fwhat, why in (
            ("float32", DSV3_DECODE_TOL, floor32, fw32, DSV3_DECODE_WHY),
            ("bfloat16", DSV3_BF16_TOL, floor16, fw16, DSV3_BF16_WHY)):
        dt = getattr(torch, dname)
        r1, r2 = [], []
        lf = _prefill_logits(cfg, params, tok, dt, routes=r1)
        lb = _prefill_logits(cfg, params, tok, dt, "blockwise", routes=r2)
        r, total = _rerouted(r1, r2)
        ok &= _dsv3_row(
            f"(3) prefill logits of one {tok.shape[1]}-token prompt, "
            f"mla_forward full vs _mla_blockwise ({dname})",
            float((lf - lb).abs().max()), float(lf.abs().max()), tol, floor,
            fwhat, why, f", same argmax {int(lf.argmax()) == int(lb.argmax())}"
            f"; token-layer pairs routed to another expert set {r} of "
            f"{total}")

    short = tok[:, :DSV3_MOE_PROMPT]
    control = _moe_without_last_expert()
    for dname, (tol, why) in DSV3_MOE_TOLS.items():
        dt = getattr(torch, dname)
        r1, r2 = [], []
        lm = _prefill_logits(cfg, params, short, dt, routes=r1)
        ld = _prefill_logits(cfg, params, short, dt, moe="dense", routes=r2)
        lc = _prefill_logits(cfg, params, short, dt, moe=control)
        floor = float((lm - _prefill_logits(cfg, params, short, dt,
                                            "blockwise")).abs().max())
        r, total = _rerouted(r1, r2)
        ctl = float((lc - ld).abs().max())
        ok &= _dsv3_row(
            f"(4) prefill logits of one {DSV3_MOE_PROMPT}-token prompt, the "
            f"MoE main path vs moe_dense ({dname})",
            float((lm - ld).abs().max()), float(ld.abs().max()), tol, floor,
            "full vs blockwise attention", why,
            f"; token-layer pairs routed to another expert set {r} of "
            f"{total}; control, each token's k-th expert dropped, {ctl:.6g} "
            f"(must exceed the tol)", control=ctl)
    return bool(ok)


def _free() -> None:
    """Drop what the last phase left (a reference cycle can hold a run's
    params) before the next phase allocates: the MoE phases need 61 GiB of
    the card's 79."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def profile_slice(model, params, out_dir: str, key: str) -> None:
    """Where the time of one admission (prefill into a slot) and one decode
    tick goes, at the slice's shape: ``torch.profiler`` over each, after the
    serve run has warmed every path.  Prints wall time, the device's busy
    time and idle share, and the ops with the most device time; writes the
    full tables and chrome traces under ``out_dir``."""
    import torch

    from repro_torch.serve.engine import ServeEngine

    os.makedirs(out_dir, exist_ok=True)
    engine = ServeEngine(model, params, n_slots=SLICE_BATCH,
                         max_len=SLICE_PROMPT + SLICE_GEN, greedy=True,
                         block_len=0)
    prompt = torch.randint(3, model.cfg.vocab, (SLICE_PROMPT,), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(2))
    steps = engine.step_probes(prompt)
    torch.cuda.synchronize()
    for name, fn in steps.items():
        profile_call(f"{key}_{name}", fn, out_dir)


def profile_call(name: str, fn, out_dir: str) -> dict:
    """``fn`` once to warm it, then once under ``torch.profiler``: prints
    the wall time, the device's busy time and idle share, the kernel
    launches and aten ops and the ops with the most device time; writes the
    full table and a chrome trace under ``out_dir``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    avg = prof.key_averages()
    # device work is the kernels' own time; the aten ops that launched
    # them carry the same time again, so they are left out of the sum
    kern = [e for e in avg if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)
    row = {"wall_ms": wall_ms, "device_ms": dev_us / 1e3,
           "idle_share": 1 - dev_us / 1e3 / wall_ms,
           "kernel_launches": int(sum(e.count for e in kern)),
           "cpu_ops": int(sum(e.count for e in avg
                              if e.key.startswith("aten::"))),
           "top": [{"op": e.key, "device_ms": e.self_device_time_total / 1e3,
                    "count": e.count} for e in top[:12]]}
    print(f"profile {name}: wall {wall_ms:.3f} ms, device busy "
          f"{row['device_ms']:.3f} ms, idle share {row['idle_share']:.4f}, "
          f"{row['kernel_launches']} kernel launches, {row['cpu_ops']} aten "
          f"ops", flush=True)
    for t in row["top"]:
        print(f"profile {name}:   {t['device_ms']:9.4f} ms  x{t['count']:<5d} "
              f"{t['op'][:90]}", flush=True)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(avg.table(sort_by="self_device_time_total", row_limit=60))
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    return row


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def train_doc(data_dir: str, name: str, *sets: str) -> dict:
    """``examples/configs/quickstart.yaml`` with ``sets`` applied and its
    synthetic dataset written to ``data_dir/name.*``."""
    from repro_torch.config.resolver import load_yaml
    from repro_torch.run.overrides import apply_overrides, parse_overrides

    doc = load_yaml(os.path.join(ROOT, "examples", "configs",
                                 "quickstart.yaml"))
    return apply_overrides(doc, parse_overrides(
        [f"dataset.config.prefix={os.path.join(data_dir, name)}",
         *sets]))


def _quiet(_msg):
    pass


def mfu_line(name: str, res: dict, median_ms: float, want_flops: float,
             card: str) -> bool:
    """Print a train run's model FLOPs per step and its ``mfu`` (JAX's
    definition, the result's own: wall over dispatched steps, the first
    step included) beside a steady ``mfu`` from the median ms/step, both
    against the card's peak; True when the FLOPs are the expected 6·N·D."""
    from repro_torch.device import PEAK_FLOPS_BF16

    flops = res.get("model_flops_per_step")
    steady = flops / (median_ms / 1e3) / PEAK_FLOPS_BF16 if flops else 0.0
    ok = flops == want_flops
    print(f"{name}: model_flops_per_step {flops!r} (want {want_flops!r}), "
          f"mfu {res.get('mfu', 0.0):.6f} (wall {res['wall_s']:.3f} s over "
          f"{res['steps_dispatched']} dispatched steps), steady mfu "
          f"{steady:.6f} (median {median_ms:.3f} ms/step), peak "
          f"{PEAK_FLOPS_BF16:.4g} FLOP/s [{card}]: "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    return ok


def phase_train_quickstart(data_dir: str) -> bool:
    """The quickstart document's 60 steps on the card.  One batch's loss
    varies by about 0.015 around a curve that falls by some 0.02 over the
    run (the tokens are uniform, so ln 509 is the floor), so the check is
    on the means of the first and last ten logged losses."""
    import math

    from repro_torch.run import api

    t0 = time.perf_counter()
    res = api.execute_doc(train_doc(data_dir, "quickstart"), device="cuda",
                          log=_quiet)
    losses = [h["loss"] for h in res["history"]]
    head, tail = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    ok = (len(losses) == 60 and all(math.isfinite(x) for x in losses)
          and tail < head)
    print(f"train quickstart: {len(losses)} steps in "
          f"{time.perf_counter() - t0:.2f}s, first loss {losses[0]:.5f}, "
          f"final loss {losses[-1]:.5f}, mean of the first 10 {head:.5f}, "
          f"of the last 10 {tail:.5f}, tokens_per_s {res['tokens_per_s']}, "
          f"goodput {res['goodput']}: {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def _train_graph(doc):
    from repro_torch.config.resolver import resolve_config
    from repro_torch.core.components import register_all

    register_all()
    return resolve_config({k: v for k, v in doc.items() if k != "run"})


class _Capture:
    """An optimizer that keeps the gradients a train step hands it (of the
    leaves its ``trainable`` path predicate accepts, where it has one)."""

    def __init__(self, trainable=None):
        self.trainable = trainable

    def update(self, grads, state, params):
        self.grads = grads
        return params, state


def step_grads(model, params, batch, trainable=None, mesh_ctx=None,
               storage_axes=()):
    """One ``make_train_step`` of ``model`` (under ``mesh_ctx``): (loss,
    gradient tree), the gradients as plain tensors."""
    import torch

    from repro_torch.models.base import is_dtensor
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import tree_map

    cap = _Capture(trainable)
    state = {"params": params, "opt": {},
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    _, metrics = make_train_step(model, cap, mesh_ctx, storage_axes)(state,
                                                                     batch)
    return float(metrics["loss"]), tree_map(
        lambda g: g.full_tensor() if is_dtensor(g) else g, cap.grads)


def grad_diff(a, b, zero_leaves=()):
    """|loss a - loss b|, per leaf max|dg| / max|g| of ``a``, the worst.
    A leaf whose path ends in one of ``zero_leaves`` takes gradient 0 in
    exact arithmetic (an attention's key bias: ``q . bk`` is the same for
    every key of a query, and the softmax drops it), so both sides hold
    rounding noise there: its difference is taken over the tree's largest
    gradient instead."""
    from repro_torch.tree import tree_leaves

    la, ga = a
    lb, gb = b
    rel = {}
    top = max(float(x.float().abs().max()) for x in tree_leaves(ga)
              if x.numel())
    for path, x, y in zip(_leaf_paths(ga), tree_leaves(ga), tree_leaves(gb)):
        if not x.numel():
            continue          # an empty stack (DeepSeek-V3 at depth 3)
        scale = (top if path.endswith(tuple(zero_leaves))
                 else float(x.float().abs().max()))
        rel[path] = float((x.float() - y.float()).abs().max()) / max(
            scale, 1e-30)
    worst = max(rel, key=rel.get)
    return abs(la - lb), rel, worst


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _leaf_paths(v, f"{prefix}/{k}" if prefix else k)]
    return [prefix]


def _acts(model, dtype):
    """``model`` with its activations (the embedding's output) in
    ``dtype``, as ``_prefill_logits`` does for serving."""
    _acts_patch(model, dtype).start()
    return model


def _acts_patch(model, dtype):
    """A patch that puts ``model``'s activations in ``dtype``: the
    decoder's embedding output, or the encoder-decoder's ``act_dtype``."""
    if not hasattr(model, "embed_tokens"):
        return mock.patch.object(model, "act_dtype", dtype)
    embed = model.embed_tokens
    return mock.patch.object(model, "embed_tokens",
                             lambda p, t: embed(p, t, dtype=dtype))


def compare_train_step(key, cfg, params, batch, lora=None,
                       label="", spec=None) -> bool:
    """One step's loss and gradients through the slice's kernel against the
    plain path, in bf16 and in f32 activations, beside the model's own
    spread (two plain paths).  With ``lora`` (Qwen) the model is wrapped in
    those adapters and the gradients are the adapters' alone.  ``spec``
    (``TRAIN_SLICES[key]`` by default) holds the ``tols``, and its
    ``zero_leaves`` the leaves ``grad_diff`` scales by the tree's
    largest gradient."""
    import functools
    import math

    import torch

    import repro_torch.models.attention as attn
    import repro_torch.models.ssm as ssm
    from repro_torch.models import build_model
    from repro_torch.posttrain import lora as LO
    from repro_torch.tree import tree_leaves

    label = label or f"train {key}"
    trainable = LO.is_adapter_path if lora is not None else None

    def wrap(model):
        return model if lora is None else LO.LoRAModel(model, lora)

    def paths(dtype):
        """(plain path, a second plain path for the floor, what the floor
        compares), each a call that returns one step's (loss, grads)."""
        if key in ("qwen", "moe16b", "whisper", "llava"):
            plain_model = wrap(_acts(build_model(
                cfg.with_(use_flash_kernel=False)), dtype))

            def other():
                # the online-softmax path (f32 probabilities) in place of
                # _full_attn (probabilities rounded to the activation dtype
                # before PV): the same function summed in another order
                with mock.patch.object(attn, "_BLOCKWISE_AT", 0):
                    return step_grads(plain_model, params, batch, trainable)

            return (lambda: step_grads(plain_model, params, batch, trainable),
                    other, "plain full vs plain blockwise attention")
        if key == "dsv3":
            # no kernel: the full MLA path against the blockwise loop, and
            # the blockwise loop at two block sizes as the floor
            model = _acts(build_model(cfg), dtype)

            def plain():
                with mock.patch.object(attn, "_BLOCKWISE_AT", 0):
                    return step_grads(model, params, batch)

            def other():
                with mock.patch.object(attn, "_BLOCKWISE_AT", 0), \
                        mock.patch.object(attn, "_mla_blockwise",
                                          functools.partial(
                                              attn._mla_blockwise,
                                              kv_block=256)):
                    return step_grads(model, params, batch)

            return plain, other, "blockwise at kv blocks of 512 vs 256"
        if key == "zamba2":
            model = _acts(build_model(cfg.with_(use_flash_kernel=False)),
                          dtype)

            def plain():
                with mock.patch.object(ssm, "ssd_scan", _plain_ssm_scan()):
                    return step_grads(model, params, batch)

            def other():
                with mock.patch.object(ssm, "ssd_scan", _plain_ssm_scan(64)), \
                        mock.patch.object(attn, "_BLOCKWISE_AT", 0):
                    return step_grads(model, params, batch)

            return plain, other, ("plain full attention and chunk 128 vs "
                                  "plain blockwise attention and chunk 64")
        model = _acts(build_model(cfg), dtype)

        def plain():
            with mock.patch.object(ssm, "ssd_scan", _plain_ssm_scan()):
                return step_grads(model, params, batch)

        def other():
            with mock.patch.object(ssm, "ssd_scan", _plain_ssm_scan(64)):
                return step_grads(model, params, batch)

        return plain, other, "plain chunk 128 vs plain chunk 64"

    spec = spec or TRAIN_SLICES[key]
    zero = spec.get("zero_leaves", ())
    ok = True
    for dname, (loss_tol, grad_tol) in spec["tols"].items():
        dtype = getattr(torch, dname)
        plain_fn, other_fn, floor_what = paths(dtype)
        # two gradient trees live at a time: a full-width one is 10.7 GiB
        # in f32 for DeepSeek-V3 at depth 3
        kernel = step_grads(wrap(_acts(build_model(cfg), dtype)), params,
                            batch, trainable)
        plain = plain_fn()
        torch.cuda.synchronize()
        dloss, rel, worst = grad_diff(plain, kernel, zero)
        finite = math.isfinite(kernel[0]) and all(
            bool(torch.isfinite(g).all()) for g in tree_leaves(kernel[1]))
        nonzero = all(float(g.float().abs().max()) > 0
                      for g in tree_leaves(kernel[1]) if g.numel())
        kernel_loss = kernel[0]
        del kernel
        other = other_fn()
        floss, frel, fworst = grad_diff(plain, other, zero)
        good = (finite and nonzero and dloss <= loss_tol
                and rel[worst] <= grad_tol)
        ok &= good
        vs = spec.get("compare", "kernel vs plain")
        print(f"{label}: one step ({dname}) {vs}: loss "
              f"{kernel_loss:.6f} vs {plain[0]:.6f}, |dloss| {dloss:.6g} (tol "
              f"{loss_tol}); worst leaf {worst} max|dg|/max|g| "
              f"{rel[worst]:.6g} (tol {grad_tol}); every leaf's gradient "
              f"finite {finite} and non-zero {nonzero}: "
              f"{'ok' if good else 'FAILED'}", flush=True)
        print(f"{label}: ({dname}) per leaf max|dg|/max|g| {vs} "
              f"{json.dumps({p: float(f"{v:.4g}") for p, v in rel.items()})}",
              flush=True)
        print(f"{label}: ({dname}) the model's own spread "
              f"({floor_what}): |dloss| {floss:.6g}, per leaf "
              f"{json.dumps({p: float(f"{v:.4g}") for p, v in frel.items()})}; "
              f"tolerances: {spec.get('why', TRAIN_TOL_WHY)[dname]}",
              flush=True)
        del plain, other
    return ok


def phase_train_full(key: str, data_dir: str, results: dict, card: str,
                     profile_dir: str = "") -> bool:
    """Full width and depth through the run API on the card, the slice's
    kernel in every layer, forward and remat recompute; then one step
    through the kernel against the plain path."""
    import math
    import statistics

    import numpy as np
    import torch

    from repro_torch.data.prefetch import place_batch
    from repro_torch.run import api

    spec = TRAIN_SLICES[key]
    steps = spec["steps"]
    n_tokens = (steps + 2) * TRAIN_BATCH * (TRAIN_SEQ + 1)
    doc = train_doc(
        data_dir, key, "arch.config.reduced=false",
        f"variables.seq_len={TRAIN_SEQ}",
        f"loader.config.global_batch={TRAIN_BATCH}",
        f"dataset.config.n_tokens={n_tokens}", f"run.train.steps={steps}",
        *spec["sets"])
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    res = api.execute_doc(doc, device="cuda", log=_quiet)
    counts = {name: c.launches for name, c in counters.items()}
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    graph = _train_graph(doc)
    cfg = graph["arch"]
    layers = kernel_layers(cfg)
    want = {name: n * 2 * steps for name, n in layers.items()}
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    # step s's wall_s is read after step s-1 has finished (its metrics are
    # fetched one window late) and step s has been issued
    walls = [h["wall_s"] for h in hist]
    step_ms = [1e3 * (b - a) for a, b in zip(walls, walls[1:])]
    med = statistics.median(step_ms)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (med / 1e3)
    ok = (counts == want and len(losses) == steps
          and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0])
    print(f"train {key}: {cfg.name} full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab}), batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, remat {cfg.remat}, {steps} steps", flush=True)
    print(f"train {key}: loss per step "
          f"{json.dumps([round(x, 5) for x in losses])}; final < first "
          f"{losses[-1] < losses[0]}", flush=True)
    if cfg.moe:
        lbs = [h["router_lb"] for h in hist]
        routed = cfg.n_layers > cfg.moe.n_dense_layers
        print(f"train {key}: router_lb (the balance loss, in the total) per "
              f"step {json.dumps([round(x, 7) for x in lbs])}, finite "
              f"{all(math.isfinite(x) for x in lbs)}"
              f"{'' if routed else ' (no MoE layer at this depth: 0)'}",
              flush=True)
        ok &= all(math.isfinite(x) and (x > 0 if routed else x == 0)
                  for x in lbs)
    if cfg.mtp:
        mtps = [h["mtp"] for h in hist]
        totals = [h["loss"] + h["router_lb"] + 0.3 * m
                  for h, m in zip(hist, mtps)]
        def fmt(xs):
            return json.dumps([round(x, 5) for x in xs])

        print(f"train {key}: ce per step {fmt(losses)}, mtp (the MTP head's "
              f"loss) {fmt(mtps)}, total (ce + router_lb + 0.3 mtp) "
              f"{fmt(totals)}; each finite and "
              f"falling {all(math.isfinite(x) for x in mtps + totals)} and "
              f"{mtps[-1] < mtps[0] and totals[-1] < totals[0]}", flush=True)
        ok &= (all(math.isfinite(x) for x in mtps + totals)
               and mtps[-1] < mtps[0] and totals[-1] < totals[0])
    print(f"train {key}: launches over the run {counts} (want, for "
          f"{spec['kernel']}: {layers['flash_fwd']} attention layers and "
          f"{layers['ssd_scan']} SSM layers, each x 2 (forward and remat "
          f"recompute) x {steps} steps = {want})", flush=True)
    print(f"train {key}: ms/step over steps 2-{steps} "
          f"{json.dumps([round(x, 3) for x in step_ms])}, median "
          f"{med:.3f} ms, tokens_per_s {tok_s:.1f} (the run's own "
          f"{res['tokens_per_s']}, first step included), peak_mem_gib "
          f"{peak_gib:.3f}", flush=True)
    ok &= mfu_line(f"train {key}", res, med, spec["flops"], card)
    add_launches(results, counts)
    results.setdefault("train_median_ms", {})[key] = med

    gen = torch.Generator(device="cuda").manual_seed(0)
    from repro_torch.models import build_model

    params = build_model(cfg).init(gen)
    batch = place_batch(next(iter(graph["loader"].batches(1))),
                        torch.device("cuda"))
    ok &= compare_train_step(key, cfg, params, batch)
    if profile_dir:
        profile_train_step(key, cfg, params, batch, profile_dir)
    del params, batch, res
    _free()
    return bool(ok)


def profile_train_step(key, cfg, params, batch, out_dir: str) -> None:
    """One full-width training step (forward, backward, AdamW) under
    ``torch.profiler``."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.steps import make_train_step

    os.makedirs(out_dir, exist_ok=True)
    model = build_model(cfg)
    opt = AdamW(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
    step = make_train_step(model, opt)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    profile_call(f"{key}_train_step", lambda: step(state, batch), out_dir)


# ---------------------------------------------------------------------------
# checkpoints: save, resume, serve, warmstart, replay
# ---------------------------------------------------------------------------
CKPT_STEPS, CKPT_AT, WARM_STEPS = 6, 3, 2
# full-width Qwen cut to 12 of its 24 layers in the ckpt phase and in the
# posttrain phase, which warmstarts from ckpt's checkpoint (their steps are
# host-bound: a step's time goes with its layers), to keep the script
# within its time with the a8b_post phase
DONOR_LAYERS = 12
# 6·N·D at DONOR_LAYERS, N counted on the meta device (309,785,600)
DONOR_FLOPS = 6.0 * 309785600 * TRAIN_BATCH * TRAIN_SEQ
# the resumed run against the straight one (JAX's bound in
# tests/test_ckpt.py); the step is deterministic on the card, so the run
# prints whether they are also bit-equal
# ---------------------------------------------------------------------------
# the bench kind
# ---------------------------------------------------------------------------
# bench.yaml's own settings (30 steps after 3 of warm-up, 5 windows) for
# full-width Qwen, run BENCH_QWEN_RUNS times for the spread; Mamba2's
# ~2.6 s step gets 10 after 1
BENCH_QWEN_RUNS = 3
BENCH_SLICES = {
    "qwen": {"steps": 30, "warmup": 3, "runs": BENCH_QWEN_RUNS,
             "sets": ["arch.config.use_flash_kernel=true"]},
    "mamba2": {"steps": 10, "warmup": 1, "runs": 1,
               "sets": ["arch.variant_key=mamba2_780m"]},
}


def bench_doc(data_dir: str, name: str, *sets: str) -> dict:
    """``examples/configs/bench.yaml`` with ``sets`` applied, its dataset
    written to ``data_dir/bench_name.*`` and its run (and so, through
    ``bench_dir: "."``, its bench file) under ``data_dir``."""
    from repro_torch.config.resolver import load_yaml
    from repro_torch.run.overrides import apply_overrides, parse_overrides

    doc = load_yaml(os.path.join(ROOT, "examples", "configs", "bench.yaml"))
    return apply_overrides(doc, parse_overrides(
        [f"dataset.config.prefix={os.path.join(data_dir, 'bench_' + name)}",
         f"run.output_dir={os.path.join(data_dir, 'bench_run_' + name)}",
         *sets]))


def _bench_run(doc: dict) -> tuple:
    """One run of the ``bench`` kind on the card with every launch counter
    set to 0 just before it; (result, launches)."""
    import torch

    from repro_torch.run import api

    counters = _counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    res = api.execute_doc(doc, device="cuda", write_result=True, log=_quiet)
    return res, {name: c.launches for name, c in counters.items()}


def _bench_line(label: str, res: dict, card: str) -> str:
    win = [w["step_ms"] for w in res["windows"]]
    return (f"{label}: steady_step_ms {res['steady_step_ms']} (median of "
            f"{len(win)} windows of {[w['steps'] for w in res['windows']]} "
            f"steps; windows min {min(win)}, max {max(win)}), "
            f"steady_step_ms_mean {res['steady_step_ms_mean']}, "
            f"tokens_per_s {res.get('tokens_per_s')}, mfu "
            f"{res.get('mfu', 0.0):.6f}, compile_s {res['compile_s']}, "
            f"setup_s {res['setup_s']}, final_loss {res['final_loss']} "
            f"[{card}]")


def phase_bench(data_dir: str, results: dict, card: str) -> bool:
    """The ``bench`` kind (``Gym.bench`` through the run API) on the card,
    after the train phases (the kernels are built and loaded, so
    ``compile_s`` is a warm first step): (a) ``bench.yaml`` unchanged but
    for its data and output directories: reduced Qwen, no kernel, the
    tracked ``BENCH_quickstart.json``'s keys and bytes; (b) full-width
    Qwen1.5-0.5B through ``flash_fwd`` at 8 x 1024, ``BENCH_QWEN_RUNS``
    times, with the spread of its windows and runs, beside ``train qwen``'s
    median ms/step; (c) full-width Mamba2-780M through ``ssd_scan``."""
    import math
    import statistics

    from repro_torch.configs import get_config

    tracked = os.path.join(ROOT, "BENCH_quickstart.json")
    with open(tracked, "rb") as f:
        tracked_bytes = f.read()
    keys_jax = set(json.loads(tracked_bytes))
    before = _checkout_files()
    res, counts = _bench_run(bench_doc(data_dir, "quickstart"))
    written = sorted(p for p, st in _checkout_files().items()
                     if before.get(p) != st)
    with open(res["bench_file"]) as f:
        keys = set(json.load(f))
    with open(tracked, "rb") as f:
        unchanged = f.read() == tracked_bytes
    ok = (counts == {"flash_fwd": 0, "ssd_scan": 0} and keys == keys_jax
          and unchanged and not written and res["goodput"] == 1.0
          and res["steps_dispatched"] == 30 and len(res["windows"]) == 5
          and math.isfinite(res["final_loss"]))
    print(_bench_line("bench (a) quickstart", res, card), flush=True)
    print(f"bench (a) quickstart: launches {counts} (want 0: bench.yaml "
          f"leaves use_flash_kernel off, as in JAX), goodput "
          f"{res['goodput']}, steps_dispatched {res['steps_dispatched']}; "
          f"{res['bench_file']} has the tracked BENCH_quickstart.json's keys "
          f"{keys == keys_jax} (differ: {sorted(keys ^ keys_jax)}), tracked "
          f"file unchanged {unchanged}, files written under the checkout "
          f"{written}: {'ok' if ok else 'FAILED'}", flush=True)
    add_launches(results, counts)
    _free()

    for key, spec in BENCH_SLICES.items():
        train = TRAIN_SLICES[key]
        n = 1 + spec["warmup"] + spec["steps"]
        sets = ["arch.config.reduced=false", f"variables.seq_len={TRAIN_SEQ}",
                f"loader.config.global_batch={TRAIN_BATCH}",
                f"dataset.config.n_tokens={n * TRAIN_BATCH * (TRAIN_SEQ + 1)}",
                f"run.bench.steps={spec['steps']}",
                f"run.bench.warmup={spec['warmup']}", *spec["sets"]]
        doc = bench_doc(data_dir, key, *sets)
        cfg = get_config(train["arch"])
        if "arch.config.use_flash_kernel=true" in spec["sets"]:
            cfg = cfg.with_(use_flash_kernel=True)
        want = {name: layers * 2 * n
                for name, layers in kernel_layers(cfg).items()}
        runs = []
        for i in range(spec["runs"]):
            res, counts = _bench_run(doc)
            run_ok = (counts == want and res["goodput"] == 1.0
                      and res["steps_dispatched"] == spec["steps"]
                      and res["model_flops_per_step"] == train["flops"]
                      and res["steady_step_ms"] > 0
                      and math.isfinite(res["final_loss"]))
            print(_bench_line(f"bench {key} run {i + 1}", res, card),
                  flush=True)
            print(f"bench {key} run {i + 1}: launches {counts} (want "
                  f"{want}: {kernel_layers(cfg)} layers x 2 (remat) x "
                  f"{n} steps), model_flops_per_step "
                  f"{res['model_flops_per_step']!r} (want "
                  f"{train['flops']!r}), steps_dispatched "
                  f"{res['steps_dispatched']}, goodput {res['goodput']}: "
                  f"{'ok' if run_ok else 'FAILED'}", flush=True)
            ok &= run_ok
            if i == 0:
                add_launches(results, counts)
            runs.append(res)
            del res
            _free()
        steady = [r["steady_step_ms"] for r in runs]
        windows = [w["step_ms"] for r in runs for w in r["windows"]]
        med = statistics.median(steady)
        line = (f"bench {key}: {cfg.name} full width, batch {TRAIN_BATCH} x "
                f"{TRAIN_SEQ}, remat {cfg.remat}, {spec['steps']} steps after "
                f"{spec['warmup']}; steady_step_ms over {len(runs)} run(s) "
                f"{steady}, median {med}, spread (max - min) "
                f"{max(steady) - min(steady):.3f} ms = "
                f"{(max(steady) - min(steady)) / med:.4f} of the median; "
                f"every window min {min(windows)}, max {max(windows)}; "
                f"tokens_per_s {[r.get('tokens_per_s') for r in runs]}, mfu "
                f"{[round(r.get('mfu', 0.0), 6) for r in runs]}")
        train_ms = results.get("train_median_ms", {}).get(key)
        if train_ms:
            line += (f"; train {key}'s median {train_ms:.3f} ms/step (steps "
                     f"2-{train['steps']}, a metrics fetch a step): bench "
                     f"- train {med - train_ms:+.3f} ms = "
                     f"{(med - train_ms) / train_ms:+.4f}")
        print(line + f" [{card}]", flush=True)
    return bool(ok)


RESUME_TOL = 1e-6


class _RunCapture:
    """Wraps ``Gym.run`` and ``Gym.restore`` for one run-API call: keeps
    the gym, its final state, the seconds ``restore`` took (None when the
    run restored nothing), and ``check(gym, state)``'s verdict on the state
    ``run`` was handed, taken before any step writes it in place."""

    def __init__(self, check=None):
        self.check, self.entry_ok, self.gym, self.out = check, None, None, None
        self.restore_s = None

    def __enter__(self):
        import torch

        from repro_torch.core.gym import Gym

        run, restore = Gym.run, Gym.restore

        def wrapped_run(gym, steps, state=None):
            if self.check is not None:
                self.entry_ok = self.check(gym, state)
            self.gym = gym
            self.out = run(gym, steps, state=state)
            return self.out

        def wrapped_restore(gym, state_like, source=""):
            t0 = time.perf_counter()
            out = restore(gym, state_like, source)
            torch.cuda.synchronize()
            self.restore_s = time.perf_counter() - t0
            return out

        self._patches = [mock.patch.object(Gym, "run", wrapped_run),
                         mock.patch.object(Gym, "restore", wrapped_restore)]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()
        # the patches hold closures over self: drop them, so that a capture
        # (and the train state it keeps) is freed with its last reference,
        # not at the next cycle collection
        self._patches = None
        return False


def _trees_equal(a, b) -> bool:
    import torch

    from repro_torch.ckpt.format import flatten_with_paths

    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    return [k for k, _ in fa] == [k for k, _ in fb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(fa, fb))


def _max_diff(a, b) -> float:
    from repro_torch.ckpt.format import flatten_with_paths

    return max(float((x.float() - y.float()).abs().max())
               for (_, x), (_, y) in zip(flatten_with_paths(a),
                                         flatten_with_paths(b)))


def _step_ms(hist) -> list:
    walls = [h["wall_s"] for h in hist]
    return [1e3 * (b - a) for a, b in zip(walls, walls[1:])]


def phase_ckpt_quickstart(data_dir: str) -> bool:
    """The two commands in ``warmstart.yaml``'s header on the card: the
    unchanged quickstart with ``gym.config.ckpt_every=20`` (the donor), then
    the unchanged ``warmstart.yaml`` from its checkpoint, both with their
    output (and the donor's data) in the temporary directory."""
    import math

    from repro_torch.ckpt import list_checkpoints
    from repro_torch.run import api

    donor = os.path.join(data_dir, "qs_donor")
    data = f"dataset.config.prefix={os.path.join(data_dir, 'qs_ckpt')}"
    t0 = time.perf_counter()
    res = api.execute_file(
        os.path.join(ROOT, "examples", "configs", "quickstart.yaml"),
        device="cuda", write_result=True, log=_quiet,
        overrides=["gym.config.ckpt_every=20", data,
                   f"run.output_dir={donor}"])
    t1 = time.perf_counter()
    warm = api.execute_file(
        os.path.join(ROOT, "examples", "configs", "warmstart.yaml"),
        device="cuda", write_result=True, log=_quiet,
        overrides=[f"run.warmstart.source={os.path.join(donor, 'ckpt')}",
                   data, f"run.output_dir={os.path.join(data_dir, 'qs_warm')}"])
    t2 = time.perf_counter()
    donor_ckpts = [s for s, _ in list_checkpoints(os.path.join(donor, "ckpt"))]
    warm_ckpts = [s for s, _ in list_checkpoints(
        os.path.join(data_dir, "qs_warm", "ckpt"))]
    losses = [h["loss"] for h in warm["history"]]
    ok = (donor_ckpts == [20, 40, 60] and warm["kind"] == "warmstart"
          and len(losses) == 40 and all(math.isfinite(x) for x in losses)
          and warm_ckpts == [20, 40])
    print(f"ckpt quickstart: donor {res['steps']} steps in {t1 - t0:.2f}s, "
          f"checkpoints {donor_ckpts}, final loss {res['final_loss']:.5f}; "
          f"warmstart.yaml {len(losses)} steps in {t2 - t1:.2f}s from "
          f"{warm['warmstart']['source']}, first loss {losses[0]:.5f}, final "
          f"{losses[-1]:.5f}, its own checkpoints {warm_ckpts}: "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    return ok


def phase_ckpt_qwen(data_dir: str, results: dict, card: str) -> bool:
    """Full-width Qwen1.5-0.5B at ``DONOR_LAYERS`` of its 24 layers through
    the flash kernel (``TRAIN_SLICES``' document and sets, batch 8 x 1024,
    ``remat: full``) through the run API
    on the card: a straight run of CKPT_STEPS steps; the same document
    stopped at CKPT_AT with a checkpoint there; resumed in the same output
    directory to the total budget; its params served from the checkpoint;
    a warmstart from it; and a replay of the interrupted run's directory."""
    import math

    import numpy as np
    import torch

    from repro_torch.ckpt import read_manifest
    from repro_torch.run import api
    from repro_torch.serve.engine import load_params

    spec = TRAIN_SLICES["qwen"]
    n_tokens = (CKPT_STEPS + 2) * TRAIN_BATCH * (TRAIN_SEQ + 1)
    base = ["arch.config.reduced=false", f"variables.seq_len={TRAIN_SEQ}",
            f"loader.config.global_batch={TRAIN_BATCH}",
            f"dataset.config.n_tokens={n_tokens}", *spec["sets"],
            f"arch.config.n_layers={DONOR_LAYERS}"]
    out_dir = os.path.join(data_dir, "ckpt_qwen_run")
    ckpt_dir = os.path.join(out_dir, "ckpt")
    step_dir = os.path.join(ckpt_dir, f"step_{CKPT_AT:08d}")
    counters = _counters()
    runs: dict = {}

    def drive(name, *sets, doc=None, replay=False, check=None, write=False):
        doc = doc or train_doc(data_dir, "ckpt_qwen", *base, *sets)
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        with _RunCapture(check) as cap:
            if replay:
                res = api.replay(out_dir, device="cuda", log=_quiet)
            else:
                res = api.execute_doc(doc, device="cuda", write_result=write,
                                      log=_quiet)
        torch.cuda.synchronize()
        counts = {n: c.launches for n, c in counters.items()}
        add_launches(results, counts)
        runs[name] = dict(res=res, cap=cap, counts=counts,
                          wall=time.perf_counter() - t0,
                          losses=[h["loss"] for h in res["history"]])
        return runs[name]

    layers = DONOR_LAYERS * 2  # attention layers x (forward + recompute)
    straight = drive("straight", f"run.train.steps={CKPT_STEPS}")
    part = drive("interrupted", f"run.train.steps={CKPT_AT}",
                 f"gym.config.ckpt_every={CKPT_AT}",
                 f"run.output_dir={out_dir}", write=True)
    resumed = drive("resumed", f"run.train.steps={CKPT_STEPS}",
                    f"gym.config.ckpt_every={CKPT_AT}",
                    f"run.output_dir={out_dir}", "run.train.resume=auto")
    ok = True
    for name, r in runs.items():
        want = layers * r["res"]["steps_this_run"]
        good = (r["counts"]["flash_fwd"] == want
                and all(math.isfinite(x) for x in r["losses"]))
        print(f"ckpt qwen: {name}: {r['res']['steps_this_run']} steps in "
              f"{r['wall']:.2f}s, losses "
              f"{json.dumps([round(x, 5) for x in r['losses']])}, flash_fwd "
              f"launches {r['counts']['flash_fwd']} (want {want}): "
              f"{'ok' if good else 'FAILED'}", flush=True)
        ok &= good

    # the interrupted run: its checkpoint and artifacts
    man = read_manifest(step_dir) if os.path.isdir(step_dir) else {}
    fp_graph = part["cap"].gym.run_fingerprint
    with open(os.path.join(out_dir, "manifest.json")) as f:
        run_man = json.load(f)
    art_ok = (man.get("n_leaves") == 44 and man.get("step") == CKPT_AT
              and man.get("fingerprint") == fp_graph
              and os.path.isfile(os.path.join(out_dir, "resolved.yaml"))
              and run_man["fingerprint"] == part["res"]["fingerprint"])
    save = part["res"]["ckpt_saves"][0]
    print(f"ckpt qwen: interrupted: step_{CKPT_AT:08d} committed with "
          f"{man.get('n_leaves')} leaves, manifest fingerprint "
          f"{man.get('fingerprint')} (the run's component graph "
          f"{fp_graph}); resolved.yaml + manifest.json "
          f"({run_man['fingerprint']}): {'ok' if art_ok else 'FAILED'}",
          flush=True)
    print(f"ckpt qwen: snapshot caller-thread stall "
          f"{1e3 * save['stall_s']:.3f} ms (of which allocating the pinned "
          f"host buffers {1e3 * save['alloc_s']:.3f} ms), writer "
          f"{save['write_s']:.3f} s for {save['bytes'] / 1e9:.4f} GB "
          f"({save['bytes']} bytes, "
          f"{save['bytes'] / 1e9 / save['write_s']:.3f} GB/s)", flush=True)
    ms_s, ms_p = _step_ms(straight["res"]["history"]), \
        _step_ms(part["res"]["history"])
    print(f"ckpt qwen: ms/step straight {json.dumps([round(x, 3) for x in ms_s])}"
          f" (median {float(np.median(ms_s)):.3f}), interrupted "
          f"{json.dumps([round(x, 3) for x in ms_p])} (median "
          f"{float(np.median(ms_p)):.3f})", flush=True)
    ok &= art_ok
    ok &= mfu_line("ckpt qwen: straight", straight["res"],
                   float(np.median(ms_s)), DONOR_FLOPS, card)

    # the resumed run against the straight one
    res_r = resumed["res"]
    want_l = straight["losses"][CKPT_AT:]
    got_l = resumed["losses"]
    p_straight = straight["cap"].out["state"]["params"]
    p_resumed = resumed["cap"].out["state"]["params"]
    loss_diff = max(abs(a - b) for a, b in zip(got_l, want_l)) \
        if len(got_l) == len(want_l) else math.inf
    param_diff = _max_diff(p_resumed, p_straight)
    bit = got_l == want_l and _trees_equal(p_resumed, p_straight)
    res_ok = (res_r.get("resumed_from") == CKPT_AT
              and res_r["steps_this_run"] == CKPT_STEPS - CKPT_AT
              and loss_diff <= RESUME_TOL and param_diff <= RESUME_TOL)
    print(f"ckpt qwen: resumed from {res_r.get('resumed_from')} (restore "
          f"of the train state {resumed['cap'].restore_s:.3f} s; step "
          f"{res_r.get('ckpt_saves', [{}])[0].get('step')} saved on the "
          f"way), losses {CKPT_AT + 1}-{CKPT_STEPS} vs straight: max abs "
          f"diff {loss_diff:.3g}, final params {param_diff:.3g} (tol "
          f"{RESUME_TOL}); bit-equal {bit}: {'ok' if res_ok else 'FAILED'}",
          flush=True)
    ok &= res_ok
    del straight["cap"].out, resumed["cap"].out, p_straight, p_resumed
    import shutil

    shutil.rmtree(os.path.join(ckpt_dir, f"step_{CKPT_STEPS:08d}"),
                  ignore_errors=True)      # keep the temp dir's disk small

    # serve the checkpoint's params: == the step-3 params in memory, and
    # one 1024-token prefill through the flash kernel == from memory
    from repro_torch.models import build_model

    cfg = part["cap"].gym.model.cfg
    p_mem = part["cap"].out["state"]["params"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_ckpt = load_params(build_model(cfg), ckpt=step_dir, device="cuda")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    prompt = np.random.default_rng(1).integers(
        3, cfg.vocab, size=(1, SLICE_PROMPT), dtype=np.int32)
    tok = torch.as_tensor(prompt, dtype=torch.int64, device="cuda")
    for c in counters.values():
        c.launches = 0
    l_ckpt = _prefill_logits(cfg, p_ckpt, tok, torch.bfloat16)
    l_mem = _prefill_logits(cfg, p_mem, tok, torch.bfloat16)
    torch.cuda.synchronize()
    counts = {n: c.launches for n, c in counters.items()}
    add_launches(results, counts)
    serve_ok = (_trees_equal(p_ckpt, p_mem) and torch.equal(l_ckpt, l_mem)
                and bool(torch.isfinite(l_ckpt).all())
                and counts["flash_fwd"] == 2 * DONOR_LAYERS)
    print(f"ckpt qwen: load_params(ckpt=step_{CKPT_AT:08d}) in "
          f"{t_restore:.3f}s: params == step {CKPT_AT}'s "
          f"{_trees_equal(p_ckpt, p_mem)}; prefill logits (1 x "
          f"{SLICE_PROMPT}, bf16) == from memory {torch.equal(l_ckpt, l_mem)}"
          f"; flash_fwd launches {counts['flash_fwd']} (want "
          f"{2 * DONOR_LAYERS}): "
          f"{'ok' if serve_ok else 'FAILED'}", flush=True)
    ok &= serve_ok
    del p_ckpt, l_ckpt, l_mem

    # warmstart from the checkpoint: fresh optimizer, 2 steps
    def warm_entry(gym, state):
        from repro_torch.tree import tree_leaves

        moments = tree_leaves(state["opt"]["m"]) + tree_leaves(
            state["opt"]["v"])
        return (_trees_equal(state["params"], p_mem)
                and all(bool((t == 0).all()) for t in moments)
                and int(state["step"]) == 0)

    wdoc = train_doc(data_dir, "ckpt_qwen", *base)
    wdoc["run"] = {"kind": "warmstart", "name": "ckpt_qwen_warm",
                   "output_dir": os.path.join(data_dir, "ckpt_qwen_warm"),
                   "warmstart": {"source": step_dir, "steps": WARM_STEPS,
                                 "optimizer": "fresh"}}
    warm = drive("warmstart", doc=wdoc, check=warm_entry)
    warm_ok = (warm["cap"].entry_ok and warm["res"]["kind"] == "warmstart"
               and len(warm["losses"]) == WARM_STEPS
               and all(math.isfinite(x) for x in warm["losses"])
               and warm["counts"]["flash_fwd"] == layers * WARM_STEPS)
    print(f"ckpt qwen: warmstart from step_{CKPT_AT:08d} (optimizer fresh): "
          f"params == donor's, m = v = 0, step 0 before step 1 "
          f"{warm['cap'].entry_ok}; losses "
          f"{json.dumps([round(x, 5) for x in warm['losses']])}; flash_fwd "
          f"{warm['counts']['flash_fwd']} (want {layers * WARM_STEPS}): "
          f"{'ok' if warm_ok else 'FAILED'}", flush=True)
    ok &= warm_ok
    del p_mem, part["cap"].out, warm["cap"].out

    # replay the interrupted run's directory
    rep = drive("replay", replay=True)
    rep_ok = (rep["res"]["fingerprint"] == part["res"]["fingerprint"]
              and rep["losses"] == part["losses"]
              and rep["counts"]["flash_fwd"] == layers * CKPT_AT)
    print(f"ckpt qwen: replay of {out_dir}: fingerprint "
          f"{rep['res']['fingerprint']} (interrupted run's "
          f"{part['res']['fingerprint']}); losses "
          f"{json.dumps([round(x, 5) for x in rep['losses']])}, bit-equal "
          f"to the interrupted run's {rep['losses'] == part['losses']}; "
          f"flash_fwd {rep['counts']['flash_fwd']} (want {layers * CKPT_AT}): "
          f"{'ok' if rep_ok else 'FAILED'}", flush=True)
    ok &= rep_ok
    del rep["cap"].out
    torch.cuda.empty_cache()
    return bool(ok)


# ---------------------------------------------------------------------------
# resilience and run accounting: rollback, retried IO, preemption, profiler
# ---------------------------------------------------------------------------
RESIL_STEPS = 6
# full-width Qwen cut to 6 of its 24 layers in the resil phase (its
# steps are host-bound: a step's time goes with its layers), to keep the
# script within its time with the serve_mesh and a8b_post phases
RESIL_LAYERS = 6
# the three chaos blocks of the resil phase, each a run.train.resilience
RESIL_ROLLBACK = {"sentinel": {"nan": True}, "max_rollbacks": 3,
                  "faults": [{"kind": "nan_loss", "at": 2},
                             {"kind": "nan_params", "at": 5}]}
RESIL_RETRY = {"ckpt_retry": {"max_attempts": 3, "base_delay_s": 0.01,
                              "max_delay_s": 0.05},
               "faults": [{"kind": "ckpt_io", "at": 0, "times": 2}]}
RESIL_PREEMPT = {"faults": [{"kind": "preempt", "at": 3}]}


def _flash_kernel_events(trace_path: str) -> int:
    """Kernel events of ``flash_fwd`` in a ``torch.profiler`` chrome
    trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel"
               and "flash_fwd" in e.get("name", ""))


def _ckpt_finite(path: str) -> bool:
    """Every leaf of a committed checkpoint, read back from disk, finite."""
    import torch

    from repro_torch.ckpt import read_manifest
    from repro_torch.ckpt.format import read_leaf

    return all(bool(torch.isfinite(read_leaf(path, e)).all())
               for e in read_manifest(path)["leaves"].values())


def _ckpt_steps(out_dir: str) -> list:
    from repro_torch.ckpt import list_checkpoints

    return [s for s, _ in list_checkpoints(os.path.join(out_dir, "ckpt"))]


def phase_resil_qwen(data_dir: str, results: dict, card: str) -> bool:
    """Full-width Qwen1.5-0.5B at ``RESIL_LAYERS`` of its 24 layers through
    the flash kernel (``TRAIN_SLICES``' document, batch 8 x 1024, ``remat:
    full``, a checkpoint every 2 steps,
    metrics every step), 6 steps, each run through the run API on the card:
    (a) straight with a ``torch.profiler`` window at step 3; (b) straight
    with telemetry off; (c) ``nan_loss`` at 2 and ``nan_params`` at 5 under
    the sentinel (rollbacks to the seeded init and to step 4); (d) two
    injected checkpoint-IO failures absorbed by retries; (e) an injected
    preemption at 3 and its resume; then (f) a real SIGTERM to the CLI and
    (g) a stalled engine tick under the watchdog."""
    import math
    import shutil

    import numpy as np
    import torch

    from repro_torch.core.gym import Gym
    from repro_torch.run import api

    from repro_torch.configs import get_config
    from repro_torch.device import MetaGenerator
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    spec = TRAIN_SLICES["qwen"]
    n_tokens = (RESIL_STEPS + 2) * TRAIN_BATCH * (TRAIN_SEQ + 1)
    base = ["arch.config.reduced=false", f"variables.seq_len={TRAIN_SEQ}",
            f"loader.config.global_batch={TRAIN_BATCH}",
            f"dataset.config.n_tokens={n_tokens}", *spec["sets"],
            f"arch.config.n_layers={RESIL_LAYERS}",
            f"run.train.steps={RESIL_STEPS}", "gym.config.ckpt_every=2",
            "gym.config.log_every=1"]
    counters = _counters()
    layers = RESIL_LAYERS * 2   # attention layers x (forward + recompute)
    # 6·N·D with N the cut model's params counted on meta
    n_params = sum(t.numel() for t in tree_leaves(build_model(
        get_config("qwen1p5_0p5b").with_(n_layers=RESIL_LAYERS)).init(
            MetaGenerator())))
    flops = 6.0 * n_params * TRAIN_BATCH * TRAIN_SEQ
    tag = f"[{card}]"
    t_phase = time.perf_counter()

    def drive(name, *sets, resilience=None, out=None):
        out = out or os.path.join(data_dir, f"resil_{name}")
        doc = train_doc(data_dir, "resil_qwen", *base,
                        f"run.output_dir={out}", *sets)
        if resilience is not None:
            doc["run"]["train"]["resilience"] = resilience
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        with _RunCapture() as cap:
            res = api.execute_doc(doc, device="cuda", write_result=True,
                                  log=_quiet)
        torch.cuda.synchronize()
        counts = {n: c.launches for n, c in counters.items()}
        add_launches(results, counts)
        return dict(res=res, state=cap.out["state"], counts=counts, out=out,
                    restore_s=cap.restore_s, wall=time.perf_counter() - t0,
                    losses=[h["loss"] for h in res["history"]])

    def drop_ckpts(r):
        shutil.rmtree(os.path.join(r["out"], "ckpt"), ignore_errors=True)

    def summary(name, r, want_launches):
        res = r["res"]
        good = (r["counts"]["flash_fwd"] == want_launches
                and all(math.isfinite(x) for x in r["losses"]))
        print(f"resil qwen: ({name}) {res['steps_this_run']} steps, "
              f"{res['steps_dispatched']} dispatched in {r['wall']:.2f}s, "
              f"losses {json.dumps([round(x, 5) for x in r['losses']])}, "
              f"flash_fwd launches {r['counts']['flash_fwd']} (want "
              f"{want_launches}), goodput {res['goodput']:.6f}, mfu "
              f"{res.get('mfu', 0.0):.6f} {tag}: "
              f"{'ok' if good else 'FAILED'}", flush=True)
        return good

    def versus(name, got_l, want_l, p_got, p_want):
        """Losses and final params against the straight run's."""
        loss_diff = max(abs(a - b) for a, b in zip(got_l, want_l)) \
            if len(got_l) == len(want_l) else math.inf
        param_diff = _max_diff(p_got, p_want)
        bit = got_l == want_l and _trees_equal(p_got, p_want)
        good = loss_diff <= RESUME_TOL and param_diff <= RESUME_TOL
        print(f"resil qwen: ({name}) vs straight: losses max abs diff "
              f"{loss_diff:.3g}, final params {param_diff:.3g} (tol "
              f"{RESUME_TOL}); bit-equal {bit}: {'ok' if good else 'FAILED'}",
              flush=True)
        return good

    ok = True
    # (a) straight, telemetry on, one profiled step
    a = drive("straight", "run.train.telemetry.profile={start_step: 3, "
                          "num_steps: 1}")
    ok &= summary("a, straight, profiled", a, layers * RESIL_STEPS)
    ms = _step_ms(a["res"]["history"])
    ok &= mfu_line("resil qwen: (a)", a["res"], float(np.median(ms)),
                   flops, card)
    trace = a["res"].get("profile_trace", "")
    n_ev = _flash_kernel_events(trace) if trace else 0
    prof_ok = bool(trace) and n_ev == layers
    print(f"resil qwen: (a) profile trace {trace} "
          f"({os.path.getsize(trace) if trace else 0} bytes), flash_fwd "
          f"kernel events in the step-3 window {n_ev} (want {layers}): "
          f"{'ok' if prof_ok else 'FAILED'}", flush=True)
    ok &= prof_ok
    p_a = a["state"]["params"]
    drop_ckpts(a)
    del a["state"]

    # (b) straight, telemetry off
    b = drive("quiet", "run.train.telemetry=false")
    ok &= summary("b, telemetry off", b, layers * RESIL_STEPS)
    b_ok = b["losses"] == a["losses"] and "telemetry" not in b["res"] \
        and not os.path.exists(os.path.join(b["out"], "telemetry.jsonl"))
    print(f"resil qwen: (b) losses == (a) {b['losses'] == a['losses']}, no "
          f"telemetry file {not os.path.exists(os.path.join(b['out'], 'telemetry.jsonl'))}: "
          f"{'ok' if b_ok else 'FAILED'}", flush=True)
    ok &= b_ok
    drop_ckpts(b)
    del b["state"]
    torch.cuda.empty_cache()

    # (c) anomaly rollback: nan_loss at 2 (no checkpoint before it: the
    # seeded init), nan_params at 5 (state corrupted on the card: step 4)
    survivors = []
    rollback = Gym._rollback

    def recording(gym, like, event, *rest):
        out = rollback(gym, like, event, *rest)
        survivors.append((event["step"], _ckpt_steps(os.path.dirname(
            gym.ckpt_dir))))
        return out

    with mock.patch.object(Gym, "_rollback", recording):
        c = drive("rollback", resilience=RESIL_ROLLBACK)
    res_c = c["res"]
    dispatched = res_c["steps_dispatched"]
    ok &= summary("c, rollback", c, layers * dispatched)
    anomalies = [e for e in res_c.get("events", [])
                 if e["kind"] == "anomaly"]
    step4 = os.path.join(c["out"], "ckpt", f"step_{4:08d}")
    finite4 = os.path.isdir(step4) and _ckpt_finite(step4)
    c_ok = ([(e["step"], e["reason"], e["restored_step"], e["rollbacks"])
             for e in anomalies] == [(2, "non_finite", 0, 1),
                                     (5, "non_finite", 4, 2)]
            and res_c["rollback_count"] == 2 and dispatched == 11
            and res_c["goodput"] == 6 / 11
            and survivors == [(2, []), (5, [2, 4])] and finite4)
    print(f"resil qwen: (c) events "
          f"{json.dumps([{k: e[k] for k in ('step', 'reason', 'restored_step', 'rollbacks')} for e in anomalies])}"
          f", rollback_count {res_c['rollback_count']}, steps_dispatched "
          f"{dispatched} (want 11), goodput {res_c['goodput']:.6f}; "
          f"checkpoints left by each rollback before its replay "
          f"{survivors} (want [(2, []), (5, [2, 4])]); step-4 checkpoint "
          f"finite {finite4}; final checkpoints {_ckpt_steps(c['out'])}: "
          f"{'ok' if c_ok else 'FAILED'}", flush=True)
    ok &= c_ok
    ok &= versus("c", c["losses"], a["losses"], c["state"]["params"], p_a)
    drop_ckpts(c)
    del c["state"]
    torch.cuda.empty_cache()

    # (d) two injected checkpoint-IO failures, absorbed by the retries
    d = drive("retry", resilience=RESIL_RETRY)
    ok &= summary("d, retried checkpoint IO", d, layers * RESIL_STEPS)
    saves = d["res"].get("ckpt_saves", [])
    d_ok = (d["res"]["retry_count"] == 2 and _ckpt_steps(d["out"]) == [2, 4, 6]
            and d["losses"] == a["losses"])
    print(f"resil qwen: (d) retry_count {d['res']['retry_count']} (want 2), "
          f"committed {_ckpt_steps(d['out'])} (want [2, 4, 6]), writer "
          f"seconds per save {[round(s['write_s'], 3) for s in saves]}, "
          f"losses == (a) {d['losses'] == a['losses']} {tag}: "
          f"{'ok' if d_ok else 'FAILED'}", flush=True)
    ok &= d_ok
    drop_ckpts(d)
    del d["state"]
    torch.cuda.empty_cache()

    # (e) an injected preemption at 3: a synchronous final save, then the
    # resume to the budget
    e_out = os.path.join(data_dir, "resil_preempt")
    e = drive("preempt", resilience=RESIL_PREEMPT, out=e_out)
    res_e = e["res"]
    ok &= summary("e, preempted", e, layers * 3)
    last = (res_e.get("ckpt_saves") or [{}])[-1]
    e_ok = (res_e.get("status") == "preempted" and res_e["graceful_exit"]
            and res_e.get("completed_steps") == 3 and last.get("step") == 3
            and 3 in _ckpt_steps(e_out))
    print(f"resil qwen: (e) status {res_e.get('status')}, graceful_exit "
          f"{res_e['graceful_exit']}, completed_steps "
          f"{res_e.get('completed_steps')}, committed {_ckpt_steps(e_out)}; "
          f"the preemption's synchronous save of step {last.get('step')}: "
          f"stall {1e3 * last.get('stall_s', 0):.3f} ms + writer "
          f"{last.get('write_s', 0):.3f} s for "
          f"{last.get('bytes', 0) / 1e9:.4f} GB {tag}: "
          f"{'ok' if e_ok else 'FAILED'}", flush=True)
    ok &= e_ok
    del e["state"]
    r = drive("resumed", "run.train.resume=auto", out=e_out)
    ok &= summary("e, resumed", r, layers * 3)
    r_ok = r["res"].get("resumed_from") == 3
    print(f"resil qwen: (e) resumed from {r['res'].get('resumed_from')} "
          f"(restore {r['restore_s']:.3f} s): {'ok' if r_ok else 'FAILED'}",
          flush=True)
    ok &= r_ok
    ok &= versus("e", r["losses"], a["losses"][3:], r["state"]["params"], p_a)
    drop_ckpts(r)
    del r["state"], p_a
    torch.cuda.empty_cache()

    ok &= _resil_sigterm(data_dir, card)
    ok &= _resil_serve_stall(data_dir)
    print(f"resil qwen: phase wall {time.perf_counter() - t_phase:.1f}s "
          f"{tag}", flush=True)
    return bool(ok)


def _resil_sigterm(data_dir: str, card: str) -> bool:
    """(f) ``python -m repro_torch train`` on the unchanged quickstart
    (reduced, no kernel) with preemption on, ``resume: auto`` and a
    checkpoint dir set through ``--set``, its metrics printed by the stdout
    tracker: a straight run and, beside it, the same command sent SIGTERM
    after its first metric line (exit 75, ``status: preempted``); then the
    same command again, resuming to the budget.  The two halves' curve ``==`` the
    straight one."""
    import signal

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))

    def command(name):
        out = os.path.join(data_dir, name)
        return [sys.executable, "-m", "repro_torch", "train", "--config",
                os.path.join(ROOT, "examples", "configs", "quickstart.yaml"),
                "--set", f"dataset.config.prefix={os.path.join(data_dir, 'qs_sig')}",
                "--set", f"run.output_dir={out}",
                "--set", f"gym.config.ckpt_dir={os.path.join(out, 'ckpt')}",
                "--set", "run.train.resume=auto",
                "--set", "run.train.resilience={preemption: true}",
                "--set", "gym.config.tracker={component_key: tracker, "
                         "variant_key: stdout}"], out

    def result(out):
        with open(os.path.join(out, "result.json")) as f:
            return json.load(f)

    def curve(*rs):
        merged = {}
        for r in rs:
            merged.update({h["step"]: h["loss"] for h in r["history"]})
        return merged

    t0 = time.perf_counter()
    cmd, out_s = command("sig_straight")
    # the straight run beside the interrupted one (the card holds both)
    straight = subprocess.Popen(cmd, env=env, cwd=ROOT,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
    cmd, out = command("sig_run")
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        first = ""
        for line in proc.stdout:
            if line.startswith("{") and '"loss"' in line:
                first = line.strip()
                proc.send_signal(signal.SIGTERM)
                break
        rest = proc.stdout.read()
        rc = proc.wait(timeout=600)
        part = result(out)
        resumed = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                                 text=True, timeout=600)
        straight.wait(timeout=600)
    finally:
        for p in (proc, straight):
            if p.poll() is None:
                p.kill()
                p.wait()
        proc.stdout.close()
    full = result(out)
    want = curve(result(out_s)) if straight.returncode == 0 else {}
    got = curve(part, full)
    stop = part.get("completed_steps")
    ok = (straight.returncode == 0 and bool(first) and rc == 75
          and part.get("status") == "preempted"
          and "preempted: resume with the same command (exit 75)" in rest
          and resumed.returncode == 0 and full.get("resumed_from") == stop
          and len(want) == 60 and got == want)
    print(f"resil qwen: (f) SIGTERM after the first metric line "
          f"{first[:60]}...: exit {rc} (want 75), status "
          f"{part.get('status')} at step {stop}, events "
          f"{json.dumps(part.get('events'))}; the same command resumed from "
          f"{full.get('resumed_from')} (exit {resumed.returncode}); curve of "
          f"{len(got)} steps == the straight run's ({len(want)} steps, exit "
          f"{straight.returncode}) {got == want}; {time.perf_counter() - t0:.1f}s "
          f"[{card}]: {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        print(f"resil qwen: (f) output of the interrupted run:\n{rest}\n"
              f"of the resumed run:\n{resumed.stdout[-2000:]}"
              f"{resumed.stderr[-2000:]}\nof the straight run:\n"
              f"{straight.stderr[-2000:]}", flush=True)
    return ok


def _resil_serve_stall(data_dir: str) -> bool:
    """(g) ``examples/configs/serve_engine.yaml`` (reduced, paged) with a
    ``serve_stall`` of 0.5 s at tick call 3 and a 0.25 s watchdog: the
    engine raises the watchdog's ``EngineError`` at tick 4, as JAX's."""
    import re

    from repro_torch.config.resolver import load_yaml
    from repro_torch.run import api
    from repro_torch.serve.engine import EngineError

    doc = load_yaml(os.path.join(ROOT, "examples", "configs",
                                 "serve_engine.yaml"))
    doc["run"]["output_dir"] = os.path.join(data_dir, "resil_serve")
    doc["run"]["serve"].update(
        watchdog_s=0.25, faults=[{"kind": "serve_stall", "at": 3,
                                  "seconds": 0.5}])
    err = ""
    try:
        api.execute_doc(doc, device="cuda", write_result=True, log=_quiet)
    except EngineError as e:      # the outcome under test
        err = str(e)
    tick = re.search(r"tick (\d+) took", err)
    ok = bool(tick) and int(tick.group(1)) == 4
    print(f"resil qwen: (g) serve_stall 0.5 s at tick call 3, watchdog 0.25 "
          f"s: {err or 'no error raised'}: {'ok' if ok else 'FAILED'}",
          flush=True)
    return ok


# ---------------------------------------------------------------------------
# post-training: LoRA, sft and dpo
# ---------------------------------------------------------------------------
POST_STEPS, POST_AT, DPO_STEPS, ONPOLICY_STEPS = 6, 3, 5, 2
POST_LORA = {"rank": 8, "alpha": 16.0}
# (trainable, total) of full-width Qwen1.5-0.5B at DONOR_LAYERS, rank 8,
# default targets (``n_trainable`` on ``meta``; its 24-layer count
# 15,977,472 / 479,965,184 is the JAX package's: tests/test_torch_posttrain.py)
POST_TRAINABLE = (7988736, 317774336)
# the SFT rows: packed prompt/response pairs that fill 8 rows of 1024
POST_SFT_DATA = {"n_examples": 128, "prompt_len": [64, 256],
                 "response_len": [256, 768], "seed": 0}
# the DPO pairs: prompt + completion up to 1024 tokens, one row each
POST_DPO_DATA = {"n_pairs": 64, "prompt_len": [256, 512],
                 "response_len": [384, 512], "seed": 0}
POST_DPO_BATCH = 8
# DPO's step size: a tenth of the SFT document's (at 1e-3 the full-width
# margin changes sign from step to step), no weight decay, as dpo.yaml
POST_DPO_OPT = ["optimizer.config.lr=0.0001",
                "optimizer.config.weight_decay=0.0"]
POST_ONPOLICY = {"n_prompts": 8, "prompt_len": 64, "gen_tokens": 64,
                 "temperature": 0.9, "n_slots": 8, "seed": 0}


def _lora_forward_checks(cfg, data_dir: str, counters) -> tuple:
    """(a) of the posttrain phase: the LoRA algebra at full width on one
    1024-token prompt, each forward through ``flash_fwd`` in every layer.
    Returns (ok, the params with their ``b`` factors perturbed)."""
    import numpy as np
    import torch

    from repro_torch.bridge import params_to_numpy
    from repro_torch.ckpt.format import flatten_with_paths
    from repro_torch.models import build_model
    from repro_torch.posttrain import lora as LO
    from repro_torch.tree import tree_map

    lm = LO.LoRAModel(build_model(cfg), LO.LoRAConfig(**POST_LORA))
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    base_params = {k: v for k, v in params.items() if k != LO.ADAPTER_KEY}
    tok = torch.as_tensor(np.random.default_rng(2).integers(
        3, cfg.vocab, size=(1, SLICE_PROMPT)), device="cuda")
    n_layers = cfg.n_layers
    checks = []

    def forward(model, p):
        with torch.no_grad():
            return model.apply(p, {"tokens": tok})[0]

    def check(name, fn, want_launches):
        torch.cuda.synchronize()
        before = counters["flash_fwd"].launches
        good = fn()
        torch.cuda.synchronize()
        n = counters["flash_fwd"].launches - before
        good = bool(good) and n == want_launches
        checks.append(good)
        print(f"posttrain qwen: (a) {name}: flash_fwd launches {n} (want "
              f"{want_launches}): {'ok' if good else 'FAILED'}", flush=True)

    check("injected forward == base forward (b = 0)",
          lambda: torch.equal(forward(lm, params),
                              forward(lm.base, base_params)), 2 * n_layers)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params[LO.ADAPTER_KEY] = tree_map(
        lambda b: b + 0.02 * torch.randn(b.shape, generator=gen,
                                         device="cuda"),
        params[LO.ADAPTER_KEY])
    with torch.no_grad():
        merged = lm.merge(params)
    on_the_fly = forward(lm, params)
    check("apply(merge(p)) == lm.apply(p), b perturbed",
          lambda: torch.equal(forward(lm.base, merged), on_the_fly)
          and not torch.equal(on_the_fly, forward(lm.base, base_params)),
          2 * n_layers)
    adir = os.path.join(data_dir, "post_adapter")
    LO.save_adapter(adir, 0, params, extra={"rank": POST_LORA["rank"]})
    fresh = LO.load_adapter(
        lm.init(torch.Generator(device="cuda").manual_seed(0)), adir)
    check("save_adapter -> load_adapter into a fresh init: forward ==",
          lambda: torch.equal(forward(lm, fresh), on_the_fly), n_layers)
    del fresh
    out = LO.export_merged(lm, params, os.path.join(data_dir, "post_merged"))
    flat = np.load(out)
    want = params_to_numpy(merged)

    def restacked():
        for path, leaf in flatten_with_paths(want):
            parts = path.split("/")
            if parts[0] == "blocks":
                got = np.stack([flat[f"model.blocks.{i}.{'.'.join(parts[1:])}"]
                                for i in range(leaf.shape[0])])
            else:
                got = flat[f"model.{'.'.join(parts)}"]
            if not np.array_equal(got, leaf):
                return False
        return True

    check(f"export_merged's export.npz ({os.path.getsize(out) / 1e9:.3f} "
          f"GB), read back and restacked, == merge(p)", restacked, 0)
    del merged, want, flat, on_the_fly
    return all(checks), params


def phase_posttrain_qwen(data_dir: str, results: dict, card: str) -> bool:
    """Full-width Qwen1.5-0.5B at ``DONOR_LAYERS`` of its 24 layers through
    the flash kernel (``TRAIN_SLICES``' document and sets, batch 8 x 1024,
    ``remat: full``) with LoRA rank 8,
    alpha 16 and the default targets, through the run API on the card:
    (a) the LoRA algebra on one 1024-token prompt; (b) ``sft`` warmstarted
    strictly from ``ckpt qwen``'s step-3 checkpoint (fresh optimizer, the
    adapter exemption), straight for 6 steps and interrupted at 3 then
    resumed, with one step's adapter gradients through the kernel against
    the plain path; (c) ``dpo`` on static pairs of 1024-token rows; (d)
    ``dpo`` on pairs sampled through the paged engine; (e) ``sft.yaml`` and
    ``dpo.yaml``."""
    import gc
    import math
    import re
    import statistics

    import numpy as np
    import torch

    from repro_torch.ckpt.format import (latest_checkpoint, read_leaf,
                                         read_manifest)
    from repro_torch.data.prefetch import place_batch
    from repro_torch.posttrain import lora as LO
    from repro_torch.posttrain.dpo import sample_onpolicy_pairs
    from repro_torch.run import api
    from repro_torch.tree import tree_map

    spec = TRAIN_SLICES["qwen"]
    tag = f"[{card}]"
    t_phase = time.perf_counter()
    counters = _counters()
    flash = counters["flash_fwd"]
    donor = os.path.join(data_dir, "ckpt_qwen_run", "ckpt",
                         f"step_{CKPT_AT:08d}")
    base_sets = ["arch.config.reduced=false", f"variables.seq_len={TRAIN_SEQ}",
                 f"loader.config.global_batch={TRAIN_BATCH}", *spec["sets"],
                 "gym.config.log_every=1",
                 f"arch.config.n_layers={DONOR_LAYERS}"]
    layers = DONOR_LAYERS
    flops = 6.0 * POST_TRAINABLE[1] * TRAIN_BATCH * TRAIN_SEQ

    def doc_for(kind, name, settings, dataset, *sets):
        doc = train_doc(data_dir, "post_qwen", *base_sets, *sets)
        doc["dataset"] = {"component_key": "dataset", "variant_key": dataset[0],
                          "config": {"seq_len": "${seq_len}",
                                     "vocab": "${vocab}", **dataset[1]}}
        doc["run"] = {"kind": kind, "name": name,
                      "output_dir": os.path.join(data_dir, name),
                      kind: {"lora": dict(POST_LORA), **settings}}
        return doc

    def drive(doc):
        logs = []
        gc.collect()        # each run's peak memory is its own
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.launches = 0
        t0 = time.perf_counter()
        with _RunCapture() as cap:
            res = api.execute_doc(doc, device="cuda", write_result=True,
                                  log=logs.append)
        torch.cuda.synchronize()
        counts = {n: c.launches for n, c in counters.items()}
        add_launches(results, counts)
        return dict(res=res, state=cap.out["state"], counts=counts, logs=logs,
                    wall=time.perf_counter() - t0,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    losses=[h["loss"] for h in res["history"]])

    def summary(name, r, per_step, want_steps):
        res = r["res"]
        steps = res["steps_this_run"]
        ms = _step_ms(res["history"])
        med = statistics.median(ms) if ms else float("nan")
        good = (r["counts"]["flash_fwd"] == per_step * steps
                and steps == want_steps and len(r["losses"]) == steps
                and all(math.isfinite(x) for x in r["losses"]))
        print(f"posttrain qwen: {name}: {steps} steps in {r['wall']:.2f}s, "
              f"losses {json.dumps([round(x, 5) for x in r['losses']])}, "
              f"flash_fwd launches {r['counts']['flash_fwd']} (want "
              f"{per_step} a step x {steps}), ms/step "
              f"{json.dumps([round(x, 3) for x in ms])} (median "
              f"{med:.3f}), max_memory_allocated {r['peak_gib']:.3f} GiB "
              f"{tag}: {'ok' if good else 'FAILED'}", flush=True)
        return good, med

    ok = True
    # (a) the LoRA algebra
    graph = _train_graph(train_doc(data_dir, "post_qwen", *base_sets))
    cfg = graph["arch"]
    flash.launches = 0
    a_ok, p_a = _lora_forward_checks(cfg, data_dir, counters)
    add_launches(results, {"flash_fwd": flash.launches})
    ok &= a_ok
    torch.cuda.empty_cache()

    # (b) sft: straight, interrupted at 3, resumed to 6
    sft_data = ("sft_synthetic", POST_SFT_DATA)
    ws = {"source": donor, "optimizer": "fresh", "strict": True}
    straight = drive(doc_for("sft", "post_sft_straight",
                             {"steps": POST_STEPS, "warmstart": ws,
                              "export_merged": True}, sft_data))
    good, med = summary("(b) sft straight", straight, 2 * layers, POST_STEPS)
    ok &= good
    # the final params wait on the host for the resumed run: each run's
    # peak memory is its own
    p_s = tree_map(lambda t: t.cpu(), straight.pop("state")["params"])
    line = next((m for m in straight["logs"] if m.startswith("lora: ")), "")
    counted = tuple(int(x.replace(",", "")) for x in re.findall(
        r"([\d,]+) (?:trainable|params)", line))
    exempt = any("donor has no adapters" in m for m in straight["logs"])
    res_s = straight["res"]
    art_ok = (counted == POST_TRAINABLE and exempt
              and os.path.isdir(res_s.get("adapter_ckpt", ""))
              and os.path.isfile(res_s.get("merged_export", "")))
    print(f"posttrain qwen: (b) log line {line!r}: (trainable, total) "
          f"{counted} (want {POST_TRAINABLE}); adapter exemption logged "
          f"{exempt}; adapter checkpoint {res_s.get('adapter_ckpt')} "
          f"({len(read_manifest(res_s['adapter_ckpt'])['leaves']) if res_s.get('adapter_ckpt') else 0} "
          f"leaves), merged export {res_s.get('merged_export')}: "
          f"{'ok' if art_ok else 'FAILED'}", flush=True)
    ok &= art_ok
    ok &= mfu_line("posttrain qwen: (b) sft", res_s, med, flops, card)
    part = drive(doc_for("sft", "post_sft_run",
                         {"steps": POST_AT, "warmstart": ws}, sft_data,
                         f"gym.config.ckpt_every={POST_AT}"))
    ok &= summary("(b) sft interrupted", part, 2 * layers, POST_AT)[0]
    del part["state"]
    resumed = drive(doc_for("sft", "post_sft_run",
                            {"steps": POST_STEPS, "resume": "auto"},
                            sft_data, f"gym.config.ckpt_every={POST_AT}"))
    ok &= summary("(b) sft resumed", resumed, 2 * layers,
                  POST_STEPS - POST_AT)[0]
    want_l, got_l = straight["losses"][POST_AT:], resumed["losses"]
    loss_diff = max(abs(a - b) for a, b in zip(got_l, want_l)) \
        if len(got_l) == len(want_l) else math.inf
    p_r = tree_map(lambda t: t.cpu(), resumed.pop("state")["params"])
    param_diff = _max_diff(p_r, p_s)
    bit = got_l == want_l and _trees_equal(p_r, p_s)
    res_ok = (resumed["res"].get("resumed_from") == POST_AT
              and loss_diff <= RESUME_TOL and param_diff <= RESUME_TOL)
    print(f"posttrain qwen: (b) resumed from "
          f"{resumed['res'].get('resumed_from')} vs straight: losses max abs "
          f"diff {loss_diff:.3g}, final params {param_diff:.3g} (tol "
          f"{RESUME_TOL}); bit-equal {bit}: {'ok' if res_ok else 'FAILED'}",
          flush=True)
    ok &= res_ok
    del p_s, p_r
    # the frozen base of the sft checkpoint is the donor's, leaf for leaf
    sft_ckpt = latest_checkpoint(os.path.join(data_dir, "post_sft_run",
                                              "ckpt"))
    sft_entries = read_manifest(sft_ckpt[1])["leaves"] if sft_ckpt else {}
    donor_entries = read_manifest(donor)["leaves"]
    base_keys = [k for k in sft_entries if k.startswith("params/")
                 and not LO.is_adapter_path(k.split("/", 1)[1])]
    same = [torch.equal(read_leaf(sft_ckpt[1], sft_entries[k]),
                        read_leaf(donor, donor_entries[k])) for k in base_keys]
    base_ok = (sft_ckpt is not None and all(same) and len(base_keys) == sum(
        k.startswith("params/") for k in donor_entries))
    print(f"posttrain qwen: (b) sft checkpoint {sft_ckpt and sft_ckpt[1]}: "
          f"{sum(same)} of {len(base_keys)} base leaves == the donor's "
          f"(weight decay 0.1 on, FrozenBaseOptimizer never writes them), "
          f"{len(sft_entries)} leaves in all: "
          f"{'ok' if base_ok else 'FAILED'}", flush=True)
    ok &= base_ok
    # one step's adapter gradients through the kernel vs the plain path
    batch = place_batch(next(iter(_train_graph(doc_for(
        "sft", "post_sft_cmp", {}, sft_data))["loader"].batches(1))),
        torch.device("cuda"))
    ok &= compare_train_step("qwen", cfg, p_a, batch,
                             lora=LO.LoRAConfig(**POST_LORA),
                             label="posttrain qwen: (b) sft")
    del batch
    torch.cuda.empty_cache()

    # (c) dpo on static pairs of 1024-token rows, from the donor's base
    # with fresh adapters (b = 0: the policy is the reference at step 1)
    dpo = drive(doc_for("dpo", "post_dpo",
                        {"steps": DPO_STEPS, "beta": 0.1, "warmstart": ws},
                        ("preference_synthetic", POST_DPO_DATA),
                        f"loader.config.global_batch={POST_DPO_BATCH}",
                        *POST_DPO_OPT))
    per_dpo = 2 * layers * 2 + 2 * layers   # policy (remat) + reference
    good, med = summary("(c) dpo static", dpo, per_dpo, DPO_STEPS)
    res_d = dpo["res"]
    hist = res_d["history"]
    first = hist[0]["loss"] if hist else math.nan
    margins = [round(h["margin"], 5) for h in hist]
    dpo_ok = (good and abs(first - math.log(2)) <= 1e-6
              and res_d.get("first_margin") == 0.0
              and res_d.get("final_margin", 0.0) > 0)
    print(f"posttrain qwen: (c) batch {POST_DPO_BATCH} pairs of "
          f"{TRAIN_SEQ} tokens, first loss {first!r} (log 2 = "
          f"{math.log(2)!r}, |diff| {abs(first - math.log(2)):.3g}, tol "
          f"1e-6), margins {json.dumps(margins)}, reward accuracy "
          f"{res_d.get('final_reward_accuracy')} {tag}: "
          f"{'ok' if dpo_ok else 'FAILED'}", flush=True)
    ok &= dpo_ok
    ok &= mfu_line("posttrain qwen: (c) dpo (JAX's 6*N*D: one forward and "
                   "backward a token)", res_d, med,
                   6.0 * POST_TRAINABLE[1] * POST_DPO_BATCH * TRAIN_SEQ, card)
    del dpo["state"]
    torch.cuda.empty_cache()

    # (d) dpo on pairs sampled through the paged engine
    from repro_torch.models import build_model

    with torch.no_grad():
        merged = LO.LoRAModel(build_model(cfg), LO.LoRAConfig(
            **POST_LORA)).merge(p_a)
    del p_a
    kw = dict(POST_ONPOLICY, vocab=cfg.vocab)
    flash.launches = 0
    t0 = time.perf_counter()
    pairs = [sample_onpolicy_pairs(build_model(cfg), merged, **kw)
             for _ in range(2)]
    t_sample = (time.perf_counter() - t0) / 2
    same_pairs = all(np.array_equal(x, y) for p, q in zip(*pairs)
                     for x, y in zip(p, q))
    lens = sorted({len(c) for _, c, _ in pairs[0]})
    sample_ok = same_pairs and flash.launches == 0 and len(pairs[0]) == 8 \
        and lens == [POST_ONPOLICY["gen_tokens"]]
    print(f"posttrain qwen: (d) {len(pairs[0])} prompts x 2 samples of "
          f"{POST_ONPOLICY['prompt_len']} + {POST_ONPOLICY['gen_tokens']} "
          f"tokens through the paged engine at temperature "
          f"{POST_ONPOLICY['temperature']}: {t_sample:.2f}s a call, twice "
          f"with one seed: pairs == {same_pairs}, flash_fwd launches "
          f"{flash.launches} (the paged path has no flash kernel, as in "
          f"JAX) {tag}: {'ok' if sample_ok else 'FAILED'}", flush=True)
    ok &= sample_ok
    del merged, pairs
    onp = drive(doc_for("dpo", "post_dpo_onpolicy",
                        {"steps": ONPOLICY_STEPS, "beta": 0.1,
                         "warmstart": dict(ws, source=sft_ckpt[1]),
                         "onpolicy": dict(POST_ONPOLICY)},
                        ("preference_synthetic", POST_DPO_DATA),
                        *POST_DPO_OPT))
    good, _ = summary("(d) dpo on-policy", onp, per_dpo, ONPOLICY_STEPS)
    onp_ok = good and any("on-policy pairs sampled" in m
                          for m in onp["logs"])
    print(f"posttrain qwen: (d) margins "
          f"{json.dumps([round(h['margin'], 5) for h in onp['res']['history']])}"
          f": {'ok' if onp_ok else 'FAILED'}", flush=True)
    ok &= onp_ok
    del onp["state"]
    torch.cuda.empty_cache()

    ok &= _posttrain_documents(data_dir)
    print(f"posttrain qwen: phase wall {time.perf_counter() - t_phase:.1f}s "
          f"{tag}", flush=True)
    return bool(ok)


def _posttrain_documents(data_dir: str) -> bool:
    """(e) ``sft.yaml`` unchanged but for its output directory and its
    donor (the quickstart checkpoint ``ckpt quickstart`` wrote with the
    command in ``sft.yaml``'s header), and ``dpo.yaml`` unchanged but for
    its output directory: reduced Qwen, no kernel."""
    import math

    from repro_torch.run import api

    cfgs = os.path.join(ROOT, "examples", "configs")
    t0 = time.perf_counter()
    sft = api.execute_file(
        os.path.join(cfgs, "sft.yaml"), device="cuda", write_result=True,
        log=_quiet, overrides=[
            f"run.sft.warmstart.source="
            f"{os.path.join(data_dir, 'qs_donor', 'ckpt')}",
            f"run.output_dir={os.path.join(data_dir, 'sft_demo')}"])
    t1 = time.perf_counter()
    dpo = api.execute_file(
        os.path.join(cfgs, "dpo.yaml"), device="cuda", write_result=True,
        log=_quiet,
        overrides=[f"run.output_dir={os.path.join(data_dir, 'dpo_demo')}"])
    t2 = time.perf_counter()
    ok = (sft["kind"] == "sft" and sft["logged_points"] == 40
          and math.isfinite(sft["final_loss"])
          and sft["final_loss"] < sft["first_loss"]
          and os.path.isdir(sft.get("adapter_ckpt", ""))
          and dpo["kind"] == "dpo" and dpo["logged_points"] == 30
          and abs(dpo["first_loss"] - math.log(2)) <= 1e-6
          and dpo["final_margin"] > 0)
    print(f"posttrain qwen: (e) sft.yaml {sft['logged_points']} steps in "
          f"{t1 - t0:.2f}s, loss {sft['first_loss']:.5f} -> "
          f"{sft['final_loss']:.5f}, adapter {sft.get('adapter_ckpt')}; "
          f"dpo.yaml {dpo['logged_points']} steps in {t2 - t1:.2f}s, loss "
          f"{dpo['first_loss']:.6f} -> {dpo['final_loss']:.5f}, margin "
          f"{dpo['first_margin']:.4f} -> {dpo['final_margin']:.4f}: "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    return ok


# ---------------------------------------------------------------------------
# the continuous-batching engine
# ---------------------------------------------------------------------------
# full-width Qwen on the paged engine: a prefix-heavy trace of sampled
# requests, every fourth greedy, closed loop; depth cut to 6 of its 24
# layers (the phase is host-bound, a tick's time goes with its layers) to
# keep the script within its time with the serve_mesh phase
ENGINE_QWEN_LAYERS = 6
ENGINE_QWEN = {"n_slots": 8, "max_len": 1024, "block_len": 16,
               "prefill_chunk": 256}
ENGINE_QWEN_TRACE = {"n_requests": 32, "prefix_len": 512, "n_prefixes": 2,
                     "prompt_lens": (64, 128, 256), "gen_tokens": (64,)}
SAMPLING = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
# full-width Mamba2 and Zamba2 on the dense engine (an SSM state has no
# pages): one trace of sampled requests, closed loop
ENGINE_DENSE_TRACE = {"n_slots": 8, "n_requests": 16,
                      "prompt_lens": (256, 512, 1024), "gen_tokens": (32,)}
# Zamba2's prefill logits, both kernels against the plain path whose
# attention keeps f32 probabilities as flash_fwd does (the blockwise online
# softmax): (activations, what else is plain, bound, whether the control
# must fail it, why), each checked at the prompts of seeds 1, 2 and 3,
# whose readings on an H100 the whys quote in that order.
ZAMBA2_LOGITS = [
    ("bfloat16", "attention", 0.2, True,
     "bf16 activations through 54 layers, the SSD kernel on both sides: only "
     "the 9 uses of the shared block differ, where kernel and plain loop sum "
     "the same f32 products in other orders and round the output once to "
     "bf16; each difference grows through the later layers. Kernel 0.148, "
     "0.148, 0.152; the two plain attentions differ by 0.141-0.174, so "
     "Qwen's 0.125 is below this model's floor; the control reads 0.242, "
     "0.25, 0.277. The bound lies between the kernel's largest and the "
     "control's smallest reading"),
    ("bfloat16", "attention and SSD scan", SSM_LOGITS_TOL, False,
     "both kernels against both plain versions: in 45 Mamba2 layers the SSD "
     "scan's f32 sums, taken in other orders, straddle bf16 rounding steps, "
     "as in Mamba2 (SSM_LOGITS_TOL_WHY). Kernels 0.234, 0.203, 0.227 against "
     "a floor of 0.203, 0.191, 0.262 (chunk 64 vs 128); the control's 0.305, "
     "0.344, 0.313 lies inside that noise, so no bf16 bound can reject it "
     "here: this row holds Mamba2's bound and the float32 row below is the "
     "one that catches a wrong kernel"),
    ("float32", "attention and SSD scan", SSM_LOGITS_F32_TOL, True,
     "f32 activations: only f32 sum orders differ. Kernels 1.23e-4, "
     "1.14e-4, 1.61e-4 against a floor of 4.8e-5, 3.7e-5, 5.3e-5 (chunk 64 "
     "vs 128), the control 0.227, 0.209, 0.209: the bound is Mamba2's, "
     "about ten times the floor and three times the kernels' largest"),
]
# the same trace on each model's engine: Mamba2 and Zamba2 on the dense
# pool (an SSM state has no pages), DeepSeekMoE-16B on the paged pool
ENGINE_SLICES = {
    "mamba2": {"arch": "mamba2_780m", "with": {}},
    "zamba2": {"arch": "zamba2_2p7b", "with": {"use_flash_kernel": True},
               "logits": ZAMBA2_LOGITS, "logit_seeds": (1, 2, 3)},
    "moe16b": {"arch": "deepseek_moe_16b", "with": {"use_flash_kernel": True},
               "engine": {"block_len": 16, "prefill_chunk": 256}},
    # the served depth (DSV3_SERVE_LAYERS), latent pages, run with the
    # expanded decode (JAX's default) and with the absorbed one
    "dsv3": {"arch": "deepseek_v3_671b",
             "with": {"n_layers": DSV3_SERVE_LAYERS},
             "engine": {"block_len": 16, "prefill_chunk": 256},
             "absorb": (False, True)},
}


def _checkout_files() -> dict:
    """Every file under the checkout with its size and mtime (not the chip
    tool's output directory, where a run may write its own log)."""
    out = {}
    for d, dirs, files in os.walk(ROOT):
        dirs[:] = [x for x in dirs if x not in ("__pycache__", "chiprun_out")]
        for f in files:
            st = os.stat(os.path.join(d, f))
            out[os.path.join(d, f)] = (st.st_size, st.st_mtime_ns)
    return out


# the sweep phase: a corpus of SWEEP_DOCS seeded documents, the BPE's
# training sample and merges, the steps of each full-width run
SWEEP_DOCS, SWEEP_BPE_DOCS, SWEEP_BPE_MERGES = 16384, 2048, 256
SWEEP_WORKERS, SWEEP_STEPS = 4, 3
SWEEP_WORDS = (
    "the of and to in is was for on that with as by at from it an be are "
    "this which or had not but have his they were their one all been has "
    "model data token layer train loss step batch sweep tokenizer corpus "
    "attention gradient optimizer schedule checkpoint ablation research "
    "pipeline throughput memory").split()
# the train run and the trial of the same patches and seed: one process,
# the same inputs and kernels, so the losses are equal
SWEEP_LR, SWEEP_SEED = 3e-4, 0
# the sweep's Qwen (its train run and its trials) at 12 of 24 layers, for
# the script's time (PR 30): 2 x 12 = 24 flash_fwd a step
SWEEP_LAYERS = 12
SWEEP_FLASH = 2 * SWEEP_LAYERS
SWEEP_MEM_SLACK = 2**30     # bytes the card may hold after a trial


def _sweep_corpus(data_dir: str) -> tuple:
    """A seeded JSONL corpus of ``SWEEP_DOCS`` documents from
    ``SWEEP_WORDS``, and a JSONL of 256 prompt/response pairs."""
    import numpy as np

    rng = np.random.default_rng(0)
    words = np.array(SWEEP_WORDS)
    path = os.path.join(data_dir, "corpus.jsonl")
    docs = []
    with open(path, "w") as f:
        for n in rng.integers(20, 76, size=SWEEP_DOCS):
            doc = " ".join(words[rng.integers(0, len(words), size=int(n))])
            docs.append(doc)
            f.write(json.dumps({"text": doc}) + "\n")
    sft = os.path.join(data_dir, "pairs.jsonl")
    with open(sft, "w") as f:
        for _ in range(256):
            q = " ".join(words[rng.integers(0, len(words), size=8)])
            a = " ".join(words[rng.integers(0, len(words), size=24)])
            f.write(json.dumps({"prompt": q, "response": a}) + "\n")
    return path, sft, docs


def _sweep_pipeline(data_dir: str, card: str) -> tuple:
    """Index and tokenize the corpus (byte: pipeline and serial; BPE:
    trained on a sample, then the pipeline); (ok, BPE prefix, sft path)."""
    from repro_torch.data.indexer import index_jsonl
    from repro_torch.data.packed_dataset import PackedDataset
    from repro_torch.data.tokenize_pipeline import (tokenize_file,
                                                    tokenize_file_serial)
    from repro_torch.data.tokenizer import BpeTokenizer, ByteTokenizer

    path, sft, docs = _sweep_corpus(data_dir)
    mib = os.path.getsize(path) / 2**20
    t0 = time.perf_counter()
    index = index_jsonl(path)
    t_index = time.perf_counter() - t0

    def timed(fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        return out, time.perf_counter() - t0

    par, t_par = timed(tokenize_file, path, os.path.join(data_dir, "byte_par"),
                       ByteTokenizer(), n_workers=SWEEP_WORKERS)
    ser, t_ser = timed(tokenize_file_serial, path,
                       os.path.join(data_dir, "byte_ser"), ByteTokenizer())
    same = all(open(par[k], "rb").read() == open(ser[k], "rb").read()
               for k in ("tokens_path", "docidx_path"))
    bpe, t_train = timed(BpeTokenizer.train, docs[:SWEEP_BPE_DOCS],
                         n_merges=SWEEP_BPE_MERGES)
    prefix = os.path.join(data_dir, "bpe")
    bp, t_bpe = timed(tokenize_file, path, prefix, bpe,
                      n_workers=SWEEP_WORKERS)
    ds = PackedDataset(prefix)
    roundtrip = all(bpe.decode(ds.document(i).tolist()[:-1]) == docs[i]
                    for i in (0, 1, SWEEP_DOCS // 2, SWEEP_DOCS - 1))
    ok = (len(index) == SWEEP_DOCS and par["n_docs"] == SWEEP_DOCS and same
          and len(bpe.merges) == SWEEP_BPE_MERGES and roundtrip
          and bp["n_docs"] == SWEEP_DOCS)
    print(f"sweep pipeline: corpus {SWEEP_DOCS} documents, {mib:.3f} MiB, "
          f"indexed in {t_index:.3f}s; os.cpu_count() {os.cpu_count()} "
          f"(host numbers of the card's machine [{card}])", flush=True)
    for name, r, t in (("byte, pipeline of "
                        f"{SWEEP_WORKERS} workers", par, t_par),
                       ("byte, serial", ser, t_ser),
                       (f"bpe ({SWEEP_BPE_MERGES} merges), pipeline of "
                        f"{SWEEP_WORKERS} workers", bp, t_bpe)):
        print(f"sweep pipeline: {name}: {r['n_docs']} docs, {r['n_tokens']} "
              f"tokens in {t:.3f}s, {r['n_tokens'] / t:.1f} tok/s",
              flush=True)
    print(f"sweep pipeline: bpe trained on {SWEEP_BPE_DOCS} documents in "
          f"{t_train:.3f}s ({len(bpe.merges)} merges, vocab "
          f"{bpe.vocab_size}); pipeline files == serial files {same}; bpe "
          f"documents decode to the corpus {roundtrip}: "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    return ok, prefix, sft


def _sweep_base(data_dir: str, prefix: str) -> dict:
    """Full-width Qwen at ``SWEEP_LAYERS`` layers through the flash kernel
    at 8 x 1024 on the BPE tokens, ``SWEEP_STEPS`` steps, lr ``SWEEP_LR``,
    seed ``SWEEP_SEED``."""
    doc = train_doc(
        data_dir, "sweep_unused", "arch.config.reduced=false",
        f"variables.seq_len={TRAIN_SEQ}",
        f"loader.config.global_batch={TRAIN_BATCH}",
        f"run.train.steps={SWEEP_STEPS}", f"optimizer.config.lr={SWEEP_LR}",
        f"gym.config.seed={SWEEP_SEED}", *TRAIN_SLICES["qwen"]["sets"],
        f"arch.config.n_layers={SWEEP_LAYERS}")
    doc["dataset"] = {"component_key": "dataset",
                      "variant_key": "packed_chunked",
                      "config": {"prefix": prefix, "seq_len": "${seq_len}"}}
    doc["run"]["name"] = "sweep_qwen_train"
    doc["run"]["output_dir"] = os.path.join(data_dir, "sweep_qwen_train")
    return doc


def _sweep_cli(args: list) -> tuple:
    """``python -m repro_torch sweep`` in this process; (exit code, the
    trials it ran, its flash_fwd launches, each trial's row)."""
    import gc

    import torch

    from repro_torch.run.cli import main as cli_main
    from repro_torch.sweep import runner as runner_mod

    flash = _counters()["flash_fwd"]
    real = runner_mod.SweepRunner._run_one
    rows = []

    def run_one(self, backend, trial, total):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = flash.launches
        rec = real(self, backend, trial, total)
        torch.cuda.synchronize()
        rows.append(dict(trial=trial.trial_id, record=rec,
                         launches=flash.launches - before,
                         peak=torch.cuda.max_memory_allocated(),
                         after=torch.cuda.memory_allocated()))
        return rec

    flash.launches = 0
    with mock.patch.object(runner_mod.SweepRunner, "_run_one", run_one):
        rc = cli_main(["sweep", *args])
    return rc, rows, flash.launches


# the mesh phase (ROADMAP A8a): full-width runs under sharding plans on a
# one-rank NCCL group, each beside the same run with no mesh
# full width at a quarter of the depth since PR 30 (Qwen 6 of 24 layers,
# Mamba2 12 of 48; half depth in PR 29): the steps are host-bound under
# DTensor, and the script keeps within its time
MESH_SLICES = {
    "qwen": {"steps": 3, "plans": ("ddp", "fsdp", "fsdp_tp"),
             "kernel": "flash_fwd",
             "sets": ["arch.config.use_flash_kernel=true",
                      "arch.config.n_layers=6"]},
    "mamba2": {"steps": 2, "plans": ("fsdp_tp",), "kernel": "ssd_scan",
               "sets": ["arch.variant_key=mamba2_780m",
                        "arch.config.n_layers=12"]},
}
MESH_TOL = (
    0, "bit equality of every step's loss and every final param: on one "
    "rank every redistribute is a no-op and DTensor runs the same aten ops "
    "on the same blocks, so any difference is a fault of the plan's step "
    "(a lost gradient, a leaf not updated); the largest differences are "
    "printed beside it")


def _mesh_doc(data_dir, key, spec, plan):
    sets = ["arch.config.reduced=false", f"variables.seq_len={TRAIN_SEQ}",
            f"loader.config.global_batch={TRAIN_BATCH}",
            f"dataset.config.n_tokens="
            f"{(spec['steps'] + 2) * TRAIN_BATCH * (TRAIN_SEQ + 1)}",
            # batches drawn on the step's thread: ms/step times the step
            "gym.config.prefetch=0", *spec["sets"]]
    if plan:
        sets += ["mesh={component_key: mesh_provider, variant_key: local, "
                 "config: {dp: 1, tp: 1}}",
                 "gym.config.mesh_provider={instance_key: mesh}",
                 f"gym.config.sharding_plan={{component_key: sharding_plan, "
                 f"variant_key: {plan}}}"]
    return train_doc(data_dir, f"mesh_{key}", *sets)


def _mesh_run(data_dir, key, spec, plan, telemetry=None):
    """One full-width run of ``spec['steps']`` on the card through the gym
    the document resolves to (recording into ``telemetry`` when given),
    with the launch counters set to 0 just before it; returns (gym, run
    output, launches, peak GiB, median ms/step, ms/step)."""
    import statistics

    import torch

    graph = _train_graph(_mesh_doc(data_dir, key, spec, plan))
    gym = graph["gym"]
    gym.device = "cuda"
    gym.telemetry = telemetry
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    out = gym.run(spec["steps"])
    torch.cuda.synchronize()
    counts = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    walls = [h["wall_s"] for h in out["history"]]
    ms = [1e3 * (b - a) for a, b in zip(walls, walls[1:])]
    return gym, out, counts, peak, statistics.median(ms), ms


def _mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


MESH_PHASES = ("forward", "backward", "exchange", "optimizer")


def _mesh_phases(rows, steps: int):
    """The train step's phases in a recorded run under a mesh: each
    ``gym/step`` holds ``step/forward``, ``step/backward``,
    ``step/exchange`` and ``step/optimizer`` in that order, and each has
    its ``device/*`` row; returns (ok, the device ms of each phase, a mean
    over the steps)."""
    spans = [r for r in rows if r["type"] == "span"]
    ok = True
    for st in (r for r in spans if r["name"] == "gym/step"):
        kids = sorted((r for r in spans if r["parent_id"] == st["span_id"]),
                      key=lambda r: r["t0_s"])
        ok &= [r["name"] for r in kids] == [f"step/{p}" for p in MESH_PHASES]
    ms = {}
    for p in MESH_PHASES:
        dev = [r for r in spans if r["name"] == f"device/{p}"]
        ok &= len(dev) == steps
        ms[p] = sum(1e3 * (r["t1_s"] - r["t0_s"]) for r in dev) / max(
            len(dev), 1)
    return bool(ok), ms


def _rounded(ms: dict) -> dict:
    return {k: round(v, 3) for k, v in ms.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flat(tree[k], f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tree)]


def _meta_like(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _meta_like(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), dtype=tree.dtype, device="meta")


def phase_mesh(data_dir: str, results: dict, card: str) -> bool:
    """Training under sharding plans on the card (ROADMAP A8a).  A one-rank
    NCCL group (``launch.mesh`` starts it on a ``FileStore``) carries a
    ``(1, 1)`` ``data x model`` mesh: full-width Qwen1.5-0.5B at 6 of its
    24 layers through ``flash_fwd`` (8 x 1024, ``remat: full``) 3 steps
    under ``ddp``, ``fsdp`` and ``fsdp_tp``, and full-width Mamba2-780M at
    12 of its 48 layers through ``ssd_scan`` 2 steps under ``fsdp_tp``
    (``MESH_SLICES``), each beside the same run with
    no mesh: every param and moment leaf a DTensor with the plan's
    placements, the kernel's launches a step, losses and final params
    against the no-mesh run (bit equality required, ``MESH_TOL``; the
    largest differences printed), ms/step and peak memory.  The runs
    under a plan record telemetry: each step's phases (forward, backward,
    the exchange, the optimizer) in order, each with its ``device/*`` row,
    whose ms a step are printed.
    Then a checkpoint of the ``fsdp_tp`` Qwen state restores under ``ddp``
    and with no mesh, equal to the saved params, its manifest's specs the
    plan's (JAX's ``spec_to_json`` strings).  The group is destroyed at
    the end of the phase."""
    import math

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import mesh as MESH
    from repro_torch.sharding import plans as PL
    from repro_torch.telemetry import TelemetryRecorder

    ok = True
    try:
        for key, spec in MESH_SLICES.items():
            steps, kernel = spec["steps"], spec["kernel"]
            gym, out, counts, base_peak, med, _ = _mesh_run(
                data_dir, key, spec, None)
            cfg = gym.model.cfg
            want = {name: n * 2 * steps
                    for name, n in kernel_layers(cfg).items()}
            base_losses = [h["loss"] for h in out["history"]]
            base = {k: v.detach().cpu()
                    for k, v in _flat(out["state"]["params"])}
            run_ok = counts == want and all(map(math.isfinite, base_losses))
            print(f"mesh {key}: {cfg.name} full width ({cfg.n_layers} "
                  f"layers), batch {TRAIN_BATCH} x {TRAIN_SEQ}, remat "
                  f"{cfg.remat}, {steps} steps, no mesh: losses "
                  f"{json.dumps([round(x, 5) for x in base_losses])}, "
                  f"{counts[kernel] // steps} {kernel} a step, "
                  f"{med:.3f} ms/step (median of steps 2-{steps}), peak "
                  f"{base_peak:.3f} GiB [{card}]", flush=True)
            add_launches(results, counts)
            del gym, out
            _free()
            for plan in spec["plans"]:
                # spans on under the plan, off in the no-mesh run: the
                # bit equality also holds the phases' marks to no change
                rec = TelemetryRecorder(run=f"mesh_{key}_{plan}",
                                        kind="train")
                gym, out, counts, peak, pmed, ms = _mesh_run(
                    data_dir, key, spec, plan, telemetry=rec)
                phases_ok, phase_ms = _mesh_phases(rec.rows, steps)
                state = out["state"]
                losses = [h["loss"] for h in out["history"]]
                # every param and moment leaf laid out as the plan says
                sh = dict(_flat(gym._state_sh))
                layout_ok = all(
                    isinstance(v, DTensor)
                    and list(v.placements) == list(sh[k].placements)
                    for k, v in _flat(state)
                    if k.startswith(("params/", "opt/m/", "opt/v/")))
                n_leaves = sum(1 for k, _ in _flat(state)
                               if k.startswith(("params/", "opt/m/",
                                                "opt/v/")))
                dloss = max(abs(a - b) / abs(b)
                            for a, b in zip(losses, base_losses))
                bit_loss = losses == base_losses
                dparam, bit_param = 0.0, True
                for k, v in _flat(state["params"]):
                    full = v.full_tensor().detach().cpu()
                    bit_param &= torch.equal(full, base[k])
                    dparam = max(dparam, float(
                        (full.float() - base[k].float()).abs().max()))
                plan_ok = (layout_ok and counts == want
                           and bit_loss and bit_param and phases_ok)
                print(f"mesh {key} {plan}: {PL.make_plan(plan).describe()} "
                      f"on mesh {_mesh_shape(gym._mesh)} "
                      f"({torch.distributed.get_backend()}, "
                      f"{torch.distributed.get_world_size()} rank); "
                      f"{n_leaves} param and moment leaves "
                      f"DTensors with the plan's placements {layout_ok}; "
                      f"{counts[kernel] // steps} {kernel} a step ({counts}, "
                      f"want {want}); losses "
                      f"{json.dumps([round(x, 5) for x in losses])}, vs no "
                      f"mesh max rel {dloss:.3e}, bit-equal {bit_loss}; "
                      f"final params max |d| {dparam:.3e}, bit-equal "
                      f"{bit_param} (tol {MESH_TOL[0]}: bit equality); "
                      f"ms/step {json.dumps([round(x, 3) for x in ms])}, "
                      f"median {pmed:.3f} (no mesh {med:.3f}, x"
                      f"{pmed / med:.3f}); peak {peak:.3f} GiB (no mesh "
                      f"{base_peak:.3f}); shard warnings "
                      f"{len(gym.shard_warnings)}; phases in order with "
                      f"their device rows {phases_ok}, device ms a step "
                      f"{json.dumps(_rounded(phase_ms))} [{card}]: "
                      f"{'ok' if plan_ok else 'FAILED'}", flush=True)
                add_launches(results, counts)
                run_ok &= plan_ok
                if key == "qwen" and plan == "fsdp_tp":
                    run_ok &= _mesh_elastic(data_dir, gym, state)
                del gym, out, state
                _free()
            ok &= run_ok
    finally:
        MESH.shutdown()
    return bool(ok)


def _mesh_elastic(data_dir: str, gym, state, name: str = "mesh_ckpt",
                  leaf: str = "params/blocks/attn/wq") -> bool:
    """A checkpoint saved under the gym's plan (``fsdp_tp``) into
    ``data_dir/name`` restores under ``ddp`` on the same mesh and with no
    mesh, each leaf ``==`` the saved one; the manifest's specs are the
    plan's (JAX's strings), ``leaf``'s printed."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.ckpt import AsyncCheckpointer, read_manifest
    from repro_torch.ckpt import elastic as EL
    from repro_torch.sharding import plans as PL

    ck_dir = os.path.join(data_dir, name)
    step = int(state["step"])
    t0 = time.perf_counter()
    ck = AsyncCheckpointer(ck_dir)
    ck.save(state, step)
    ck.wait()
    ck.close()
    save_s = time.perf_counter() - t0
    path = ck.latest()[1]
    manifest = read_manifest(path)["leaves"]
    specs = {k: PL.spec_to_json(v.spec) for k, v in _flat(gym._state_sh)}
    spec_ok = all(manifest[k]["spec"] == specs[k] for k in specs)
    sharded = sum(1 for v in manifest.values()
                  if v["spec"] and any(e for e in v["spec"]))
    saved = {k: v.full_tensor().detach() for k, v in _flat(state)}
    like = _meta_like(state)
    ddp = EL.restore_train_state(like, path, plan=PL.make_plan("ddp"),
                                 mesh=gym._mesh, model=gym.model,
                                 optimizer=gym.optimizer)
    ddp_ok = all(isinstance(v, DTensor)
                 and all(p.is_replicate() for p in v.placements)
                 and torch.equal(v.full_tensor(), saved[k])
                 for k, v in _flat(ddp))
    del ddp
    plain = EL.restore(like, path, device="cuda")
    plain_ok = all(type(v) is torch.Tensor and torch.equal(v, saved[k])
                   for k, v in _flat(plain))
    ok = spec_ok and ddp_ok and plain_ok and sharded > 0
    print(f"mesh elastic: step-{step} checkpoint of the fsdp_tp state "
          f"({len(saved)} leaves, {sharded} with a sharded spec, saved and "
          f"committed in {save_s:.2f}s): manifest specs == the plan's "
          f"spec_to_json {spec_ok} (e.g. {leaf} "
          f"{manifest[leaf]['spec']}); restored under "
          f"ddp (replicated DTensors) == saved {ddp_ok}; restored with no "
          f"mesh (plain tensors) == saved {plain_ok}: "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    del plain, saved
    return ok


# the pp phase (ROADMAP A8b's training half): full-width Qwen through the
# pipelined backbone, stage-local (2 stages of 12 layers, 4 microbatches),
# and full-width DeepSeekMoE-16B at depth 4 through expert parallelism
# Qwen at 12 of its 24 layers (2 stages of 6) since PR 30, for the
# script's time
PP_SLICE = {"steps": 3, "pp": 2, "n_micro": 4, "n_layers": 12}
EP_SLICE = {"steps": 2, "plan": "fsdp_tp_ep"}


def _timed_steps(step, state, batch, steps):
    """``steps`` calls of a train step: (state, losses, ms per step, peak
    GiB), the peak over the steps."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return state, losses, ms, torch.cuda.max_memory_allocated() / 2**30


# the serve_mesh phase (ROADMAP A8b's serving half): full-width serving
# under plans on a one-rank NCCL group, each beside the same run with no
# mesh.  Under serve_ep a decode tick of 8 slots (T·k 48) keeps every
# assignment (each expert's C_e is at least 8, and a token picks an expert
# once), but an admission of T prompt tokens gives each expert C_e =
# 1.25·T·k/E slots and drops what passes them, as JAX's EP does: the MoE
# shim's no-mesh run therefore mirrors those drops (moe_dense with the
# dropped assignments' gates zeroed, as the pp phase's reference), so the
# two differ only in bf16 summation order
# Qwen at 6 of its 24 layers, Mamba2 at 12 of 48 (since PR 30; 12 and 24
# in PR 29): a decode tick under a plan is host-bound, and the script
# keeps within its time
SERVE_MESH_SHIMS = {
    "qwen": {"arch": "qwen1p5_0p5b",
             "with": {"use_flash_kernel": True, "n_layers": 6},
             "plan": "fsdp_tp", "kernel": "flash_fwd", "prompt": 1024},
    "mamba2": {"arch": "mamba2_780m", "with": {"n_layers": 12},
               "plan": "fsdp_tp", "kernel": "ssd_scan", "prompt": 1024},
    "moe16b": {"arch": "deepseek_moe_16b",
               "with": {"n_layers": 4, "use_flash_kernel": True},
               "plan": "serve_ep", "kernel": "flash_fwd", "prompt": 512},
}
SERVE_MESH_ENGINE_TRACE = dict(ENGINE_QWEN_TRACE, n_requests=8,
                               gen_tokens=(32,))
# the MoE shim's first-token logits under serve_ep against the no-mesh
# shim: MOE16B_LOGITS' bf16 MoE row (the main path against moe_dense, one
# bf16 rounding of each routed output from f32 sums of other orders)
SERVE_MESH_MOE_TOL = next(t for d, plain, t, _, _ in MOE16B_LOGITS
                          if d == "bfloat16" and plain == "MoE")
SERVE_MESH_DECODE = {"batch": 8, "cache": 1024, "timed": 3}


def _shim_run(model, params, spec, mesh=None):
    """The static shim (``serve_benchmark``) at ``SLICE_BATCH`` x
    ``spec['prompt']`` x ``SLICE_GEN`` with every launch counter set to 0
    just before it: (result, launches, peak GiB, wall s)."""
    import torch

    from repro_torch.launch.serve import serve_benchmark
    from repro_torch.sharding import plans as PL

    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    res = serve_benchmark(
        model, batch=SLICE_BATCH, prompt_len=spec["prompt"], gen=SLICE_GEN,
        seed=0, params=params, device="cuda", mesh=mesh,
        plan=PL.make_plan(spec["plan"]) if mesh is not None else None,
        log=_quiet)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: c.launches for name, c in counters.items()}
    return res, counts, torch.cuda.max_memory_allocated() / 2**30, wall


def _shim_line(res, counts, peak, wall) -> str:
    return (f"prefill {res['prefill_tok_s']} tok/s, decode "
            f"{res['decode_tok_s']} tok/s, peak {peak:.3f} GiB, wall "
            f"{wall:.2f}s, launches {counts}")


def _moe_routes():
    """A patch of ``moe.capacity_buckets`` that tallies each EP call's
    assignments and the ones it drops, by T·k: (patch, {T·k: [calls,
    assignments, dropped]})."""
    from repro_torch.models import moe as MOE

    tally: dict = {}
    real = MOE.capacity_buckets

    def counted(cfg, idx, e0, E_loc, ep_size):
        out = real(cfg, idx, e0, E_loc, ep_size)
        local, keep = out[0], out[1]
        row = tally.setdefault(int(idx.numel()), [0, 0, 0])
        row[0] += 1
        row[1] += int(local.sum())
        row[2] += int((local & ~keep).sum())
        return out

    return mock.patch.object(MOE, "capacity_buckets", counted), tally


def _mirrored_drops(cfg):
    """A patch of ``moe.moe_routed`` (the no-mesh main path) by
    ``moe_dense`` with the gates of the assignments EP at degree 1 drops
    zeroed: the first ``C_e`` of each expert's, in row-major order, kept
    (:func:`_ep_capacity`, :func:`_first_per_expert`)."""
    from repro_torch.models import moe as MOE

    m = cfg.moe

    def kept_dense(cfg_, p, x_flat, idx, gate):
        C_e = _ep_capacity(x_flat.shape[0], m.top_k, m.n_routed, 1,
                           m.capacity_factor)
        keep = _first_per_expert(idx.reshape(-1), m.n_routed, C_e)
        return MOE.moe_dense(cfg_, p, x_flat, idx,
                             gate * keep.reshape(idx.shape).to(gate.dtype))

    return mock.patch.object(MOE, "moe_routed", kept_dense)


def _serve_mesh_shim(key: str, mesh, results: dict, card: str) -> bool:
    """(a), (c), (d): one model's static shim under its plan beside the
    same shim with no mesh."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import load_params
    from repro_torch.sharding import plans as PL

    spec = SERVE_MESH_SHIMS[key]
    cfg = get_config(spec["arch"]).with_(**spec["with"])
    model = build_model(cfg)
    params = load_params(model, seed=0, device="cuda")
    layers = kernel_layers(cfg)[spec["kernel"]]
    want = {name: 0 for name in _counters()}
    want[spec["kernel"]] = layers * (SLICE_BATCH + 1)
    if key == "moe16b":
        with _mirrored_drops(cfg):
            base, bcounts, bpeak, bwall = _shim_run(model, params, spec)
    else:
        base, bcounts, bpeak, bwall = _shim_run(model, params, spec)
    patch, tally = _moe_routes()
    with patch:
        res, counts, peak, wall = _shim_run(model, params, spec, mesh)
    add_launches(results, bcounts)
    add_launches(results, counts)
    got, ref = res["generated_ids"], base["generated_ids"]
    same = sum(a == b for a, b in zip(got, ref))
    ok = counts == want == bcounts and len(got) == SLICE_BATCH
    print(f"serve_mesh ({'a' if key == 'qwen' else 'c' if key == 'mamba2' else 'd'}) "
          f"{key}: {cfg.name} full width ({cfg.n_layers} layers), shim "
          f"{SLICE_BATCH} x {spec['prompt']} x {SLICE_GEN} under "
          f"{PL.make_plan(spec['plan']).describe()} on "
          f"{_mesh_shape(mesh)} ({torch.distributed.get_backend()}): "
          f"{_shim_line(res, counts, peak, wall)}; no mesh: "
          f"{_shim_line(base, bcounts, bpeak, bwall)}; {spec['kernel']} "
          f"{counts[spec['kernel']] // (SLICE_BATCH + 1)} an admission "
          f"(want {layers}: {want}); streams equal {same}/{len(ref)} "
          f"[{card}]", flush=True)
    if key != "moe16b":
        ok &= got == ref
    else:
        ok &= _serve_mesh_moe_checks(cfg, model, params, mesh, spec, got,
                                     ref, tally, card)
    print(f"serve_mesh {key}: {'ok' if ok else 'FAILED'}", flush=True)
    del params
    _free()
    return bool(ok)


def _serve_mesh_moe_checks(cfg, model, params, mesh, spec, got, ref, tally,
                           card) -> bool:
    """(d): every EP call's T·k and dropped share (0 in every tick), each
    prompt's first-token logits under ``serve_ep`` against the no-mesh
    prefill (the drops mirrored) within ``SERVE_MESH_MOE_TOL``, and each
    parted stream's first differing tokens within that bound of each other
    in the no-mesh logits of the common prefix (teacher-forced)."""
    import numpy as np
    import torch

    from repro_torch.sharding import plans as PL

    k = cfg.moe.top_k
    tick = tally.get(SLICE_BATCH * k, [0, 0, 0])
    ok = tick[0] > 0 and tick[2] == 0
    adm = tally.get(spec["prompt"] * k, [0, 0, 0])
    ok &= adm[0] > 0
    # the shim's prompts (serve_benchmark's, seed 0)
    prompts = np.random.default_rng(1).integers(
        3, cfg.vocab, size=(SLICE_BATCH, spec["prompt"]), dtype=np.int32)
    plan = PL.make_plan(spec["plan"])
    ctx = PL.mesh_context(plan, mesh)
    psh, _ = PL.param_shardings(plan, mesh, params, model.param_axes())
    dparams = PL.distribute(params, psh)
    errs, size = [], 0.0
    for row in prompts:
        tok = torch.as_tensor(row[None], dtype=torch.int64, device="cuda")
        with _mirrored_drops(cfg):
            lp, _ = model.prefill(params, {"tokens": tok})
        lm, _ = model.prefill(dparams, {"tokens": tok}, mesh_ctx=ctx)
        lm = lm.full_tensor()
        errs.append(float((lm.float() - lp.float()).abs().max()))
        size = max(size, float(lp.float().abs().max()))
    ok &= max(errs) <= SERVE_MESH_MOE_TOL
    ties = []
    for i, (a, b) in enumerate(zip(got, ref)):
        if a == b:
            continue
        j = next(t for t in range(len(a)) if a[t] != b[t])
        seq = np.concatenate([prompts[i], np.asarray(b[:j], np.int32)])
        tok = torch.as_tensor(seq[None], dtype=torch.int64, device="cuda")
        with _mirrored_drops(cfg):
            lp, _ = model.prefill(params, {"tokens": tok})
        gap = abs(float(lp[0, a[j]]) - float(lp[0, b[j]]))
        ties.append((i, j, round(gap, 4)))
        ok &= gap <= SERVE_MESH_MOE_TOL
    rows = {tk: f"{n} calls, {a} assignments, {d} dropped (share "
                f"{d / max(a, 1):.6g})" for tk, (n, a, d) in sorted(tally.items())}
    print(f"serve_mesh (d) moe16b: EP at degree 1 by T·k (a tick "
          f"{SLICE_BATCH * k}, an admission {spec['prompt'] * k}): {rows}; "
          f"first-token logits serve_ep vs no mesh (the admission's drops "
          f"mirrored) max abs diff {max(errs):.6g} (per prompt "
          f"{[round(e, 4) for e in errs]}), max |logit| {size:.4f}, tol "
          f"{SERVE_MESH_MOE_TOL} (MOE16B_LOGITS' bf16 MoE row); parted "
          f"streams (request, token, no-mesh logit gap) {ties} [{card}]",
          flush=True)
    del dparams
    return bool(ok)


def _serve_mesh_engine(mesh, results: dict, card: str) -> bool:
    """(b): full-width Qwen's paged engine at ``ENGINE_QWEN_LAYERS`` (the
    engine phase's depth) under ``ddp`` beside the engine with no mesh, on
    8 requests of the engine phase's traffic (2 shared 512-token prefixes,
    32 tokens each, every fourth greedy)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine, load_params
    from repro_torch.serve.workload import shared_prefix_trace
    from repro_torch.sharding import plans as PL

    cfg = get_config("qwen1p5_0p5b").with_(use_flash_kernel=True,
                                           n_layers=ENGINE_QWEN_LAYERS)
    model = build_model(cfg)
    params = load_params(model, seed=0, device="cuda")
    t = SERVE_MESH_ENGINE_TRACE
    rows = {}
    for label, kw in (("no mesh", {}),
                      ("ddp", {"mesh": mesh, "plan": PL.make_plan("ddp")})):
        trace = shared_prefix_trace(
            t["n_requests"], cfg.vocab, prefix_len=t["prefix_len"],
            n_prefixes=t["n_prefixes"], seed=0, prompt_lens=t["prompt_lens"],
            gen_tokens=t["gen_tokens"], max_len=ENGINE_QWEN["max_len"],
            **SAMPLING)
        for r in trace[::4]:
            r.temperature = 0.0
        engine = ServeEngine(model, params, **ENGINE_QWEN, **kw)
        counters = _counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        res = engine.run(trace, realtime=False)
        torch.cuda.synchronize()
        counts = {name: c.launches for name, c in counters.items()}
        add_launches(results, counts)
        rows[label] = (res, counts, torch.cuda.max_memory_allocated() / 2**30)
        del engine
        _free()
    (b, bc, bp), (m, mc, mp) = rows["no mesh"], rows["ddp"]
    streams = [r["gen_ids"] for r in m["requests"]]
    want = [r["gen_ids"] for r in b["requests"]]
    ok = (streams == want and m["completed"] == t["n_requests"]
          and m["prefill_cache_hit_rate"] == b["prefill_cache_hit_rate"] > 0
          and mc == bc == {name: 0 for name in _counters()})
    print(f"serve_mesh (b) qwen engine: {cfg.n_layers} layers, paged "
          f"(block_len {ENGINE_QWEN['block_len']}, chunk "
          f"{ENGINE_QWEN['prefill_chunk']}"
          f"), {t['n_requests']} requests on {t['n_prefixes']} prefixes of "
          f"{t['prefix_len']}, {t['gen_tokens'][0]} tokens each, "
          f"{SAMPLING}, every fourth greedy; under ddp on "
          f"{_mesh_shape(mesh)}: {m['tok_s']} tok/s, decode "
          f"{m['decode_tok_s']} tok/s, tpot p50 {m['tpot_ms']['p50']:.3f} "
          f"ms, elapsed {m['elapsed_s']}s, peak {mp:.3f} GiB, hit rate "
          f"{m['prefill_cache_hit_rate']}, launches {mc}; no mesh: "
          f"{b['tok_s']} tok/s, decode {b['decode_tok_s']} tok/s, tpot p50 "
          f"{b['tpot_ms']['p50']:.3f} ms, elapsed {b['elapsed_s']}s, peak "
          f"{bp:.3f} GiB, hit rate {b['prefill_cache_hit_rate']}; streams "
          f"equal {streams == want} [{card}]: {'ok' if ok else 'FAILED'}",
          flush=True)
    del params
    _free()
    return bool(ok)


def _serve_mesh_decode(results: dict, card: str) -> bool:
    """(e): one full-width Qwen decode step (``make_serve_step`` at
    ``SERVE_MESH_DECODE``'s batch and cache) on the card under the
    dryrun's counter beside its dryrun: FLOPs, bytes, collectives and
    argument bytes equal, ms/step beside ``max(terms)``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch.hlo_analysis import CostCounter
    from repro_torch.models import build_model
    from repro_torch.sharding import plans as PL

    d = SERVE_MESH_DECODE
    cfg = get_config("qwen1p5_0p5b")
    shape = InputShape("card", d["cache"], d["batch"], "decode")
    plan = PL.make_plan("ddp")
    dry = DR.compile_run(cfg, shape, MESH.LocalMesh(1, 1), plan)
    roofline = max(dry["compute_term_s"], dry["memory_term_s"],
                   dry["collective_term_s"])
    try:
        mesh = MESH.make_local_mesh(1, 1, device_type="cuda")
        setup = DR.build_step(build_model(cfg), shape, mesh, plan,
                              device="cuda")
        counters = _counters()
        for c in counters.values():
            c.launches = 0
        with CostCounter(arguments=setup.args) as counter:
            out = setup.fn(*setup.args)
            torch.cuda.synchronize()
        launches = {name: c.launches for name, c in counters.items()}
        add_launches(results, launches)
        ana, mem = counter.analyze(), counter.memory(setup.args, out)
        ms = []
        params, cache, tokens, positions = setup.args
        for _ in range(d["timed"]):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
            setup.fn(params, cache, tokens, positions)
            t1.record()
            torch.cuda.synchronize()
            ms.append(t0.elapsed_time(t1))
        tok = out[0]
        run_ok = (ana["flops"] == dry["hlo_flops_per_dev"]
                  and ana["bytes"] == dry["hlo_bytes_per_dev"]
                  and ana["collective_counts"] == dry["collective_counts"]
                  and mem["mem_argument_size_in_bytes"]
                  == dry["mem_argument_size_in_bytes"]
                  and tok.shape == (d["batch"],)
                  and 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab
                  and all(n == 0 for n in launches.values()))
        med = sorted(ms)[len(ms) // 2]
        print(f"serve_mesh (e) decode: {cfg.name} full width, make_serve_step"
              f" at batch {d['batch']} x cache {d['cache']} under ddp on a "
              f"(1, 1) mesh; flops/device card {ana['flops']!r} vs dryrun "
              f"{dry['hlo_flops_per_dev']!r}; bytes/device card "
              f"{ana['bytes']!r} vs dryrun {dry['hlo_bytes_per_dev']!r}; "
              f"collectives card {ana['collective_counts']} vs dryrun "
              f"{dry['collective_counts']}; arguments card "
              f"{mem['mem_argument_size_in_bytes']} B vs dryrun "
              f"{dry['mem_argument_size_in_bytes']} B; launches {launches}; "
              f"ms/step {json.dumps([round(x, 3) for x in ms])}, median "
              f"{med:.3f} vs max(terms) {roofline * 1e3:.4f} ms (dominant "
              f"{dry['dominant_term']}) [{card}]: "
              f"{'ok' if run_ok else 'FAILED'}", flush=True)
        del setup, out, params, cache
    finally:
        MESH.shutdown()
        _free()
    return bool(run_ok)


def phase_serve_mesh(results: dict, card: str) -> bool:
    """Serving under sharding plans on the card (ROADMAP A8b's serving
    half): (e) the decode step against its dryrun, then (a)-(d) on a
    one-rank NCCL group's ``(1, 1)`` mesh, each beside the same run with
    no mesh.  The group is destroyed at the end of the phase."""
    from repro_torch.launch import mesh as MESH

    ok = _serve_mesh_decode(results, card)
    try:
        mesh = MESH.make_local_mesh(1, 1, device_type="cuda")
        ok &= _serve_mesh_shim("qwen", mesh, results, card)
        ok &= _serve_mesh_engine(mesh, results, card)
        ok &= _serve_mesh_shim("mamba2", mesh, results, card)
        ok &= _serve_mesh_shim("moe16b", mesh, results, card)
    finally:
        MESH.shutdown()
    return bool(ok)


def phase_pp(data_dir: str, results: dict, card: str) -> bool:
    """The GPipe schedule and expert parallelism on the card (ROADMAP
    A8b's training half).

    (a) Full-width Qwen1.5-0.5B at ``PP_SLICE['n_layers']`` (12) of its
    24 layers through ``flash_fwd`` (8 x 1024, ``remat: full``) through the
    pipelined backbone, stage-local (a ``MeshContext`` with ``pp`` 2, 4
    microbatches and no pipe group: both stages of 6 layers on this card),
    ``PP_SLICE['steps']`` AdamW steps beside the same steps unpipelined:
    ``flash_fwd`` launches 12 layers x 4 microbatches x 2 (forward and
    remat recompute) = 96 a step, each at batch 2; one
    step's loss and per-leaf gradients, pipelined against unpipelined,
    within ``TRAIN_SLICES['qwen']``'s bf16 tolerances; both curves,
    ms/step and peak memory.

    (b) Full-width DeepSeekMoE-16B at ``TRAIN_SLICES['moe16b']``'s depth 4
    (1 dense + 3 MoE layers of 64 experts, top 6) through ``flash_fwd``,
    under ``fsdp_tp_ep`` on the ``(1, 1)`` NCCL mesh of the mesh phase: EP
    degree 1, all 64 experts local, T·k = 49,152 > 4096 so the capacity
    path runs with ``C_e`` 960.  Through the gym its document resolves to,
    ``EP_SLICE['steps']`` steps beside the no-mesh run (ms/step, peak,
    ``flash_fwd`` 8 a step, the EP body's calls 6 a step); then one step's
    loss and per-leaf gradients against the no-mesh step (the dropless
    ``moe_routed``) where no assignment dropped, else against ``moe_dense``
    with the dropped assignments' gates zeroed, within ``moe16b``'s bf16
    tolerances; the share of dropped assignments per MoE layer."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as MESH
    from repro_torch.models import base as B
    from repro_torch.models import build_model
    from repro_torch.models import moe as MOE
    from repro_torch.optim.adamw import AdamW
    from repro_torch.sharding import plans as PL
    from repro_torch.train import steps as ST
    from repro_torch.tree import tree_leaves

    ok = True
    # (a) the pipelined Qwen step, stage-local
    spec = TRAIN_SLICES["qwen"]
    loss_tol, grad_tol = spec["tols"]["bfloat16"]
    cfg = get_config(spec["arch"]).with_(use_flash_kernel=True,
                                         n_layers=PP_SLICE["n_layers"])
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tok = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                        generator=gen, device="cuda", dtype=torch.int32)
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    ctx = B.MeshContext(pp=PP_SLICE["pp"], n_micro=PP_SLICE["n_micro"])
    steps = PP_SLICE["steps"]
    counters = _counters()
    runs = {}
    for name, mctx in (("unpipelined", None), ("pipelined", ctx)):
        opt = AdamW(lr=3e-4)
        state = ST.init_train_state(
            model, opt, torch.Generator(device="cuda").manual_seed(0))
        step = ST.make_train_step(model, opt, mctx)
        for c in counters.values():
            c.launches = 0
        state, losses, ms, peak = _timed_steps(step, state, batch, steps)
        counts = {n: c.launches for n, c in counters.items()}
        add_launches(results, counts)
        runs[name] = (losses, ms, peak, counts)
        del state, opt, step
        _free()
    per_step = cfg.n_layers * PP_SLICE["n_micro"] * 2
    want = {"flash_fwd": per_step * steps, "ssd_scan": 0}
    (ul, ums, upeak, ucounts), (pl, pms, ppeak, pcounts) = (
        runs["unpipelined"], runs["pipelined"])
    run_ok = (pcounts == want and all(map(math.isfinite, pl + ul))
              and ucounts["flash_fwd"] == cfg.n_layers * 2 * steps)
    print(f"pp qwen: {cfg.name} full width ({cfg.n_layers} layers), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, remat {cfg.remat}, {steps} AdamW "
          f"steps; pipelined stage-local: {ctx.pp} stages of "
          f"{cfg.n_layers // ctx.pp} layers, {ctx.n_micro} microbatches of "
          f"{TRAIN_BATCH // ctx.n_micro} (bubble "
          f"{PL.pipeline_info(PL.make_plan('pp2_fsdp'), {'pipe': 2}, TRAIN_BATCH)['bubble_fraction']:.3f} "
          f"of a pipe-sharded schedule)", flush=True)
    print(f"pp qwen: losses unpipelined {json.dumps([round(x, 5) for x in ul])}"
          f", pipelined {json.dumps([round(x, 5) for x in pl])}; ms/step "
          f"unpipelined {json.dumps([round(x, 3) for x in ums])}, pipelined "
          f"{json.dumps([round(x, 3) for x in pms])}; peak {upeak:.3f} / "
          f"{ppeak:.3f} GiB [{card}]", flush=True)
    print(f"pp qwen: flash_fwd launches pipelined {pcounts['flash_fwd']} "
          f"({pcounts['flash_fwd'] // steps} a step; want {cfg.n_layers} "
          f"layers x {ctx.n_micro} microbatches x 2 (forward and remat "
          f"recompute) = {per_step}, each at batch "
          f"{TRAIN_BATCH // ctx.n_micro}), unpipelined "
          f"{ucounts['flash_fwd'] // steps} a step: "
          f"{'ok' if run_ok else 'FAILED'}", flush=True)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    ref = step_grads(model, params, batch)
    for c in counters.values():
        c.launches = 0
    got = step_grads(model, params, batch, mesh_ctx=ctx)
    counts = {n: c.launches for n, c in counters.items()}
    add_launches(results, counts)
    torch.cuda.synchronize()
    dloss, rel, worst = grad_diff(ref, got)
    finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(got[1]))
    grad_ok = (finite and dloss <= loss_tol and rel[worst] <= grad_tol
               and counts["flash_fwd"] == per_step)
    print(f"pp qwen: one step (bfloat16) pipelined vs unpipelined: loss "
          f"{got[0]:.6f} vs {ref[0]:.6f}, |dloss| {dloss:.6g} (tol "
          f"{loss_tol}); worst leaf {worst} max|dg|/max|g| {rel[worst]:.6g} "
          f"(tol {grad_tol}); finite {finite}; {counts['flash_fwd']} "
          f"flash_fwd: {'ok' if grad_ok else 'FAILED'}", flush=True)
    print(f"pp qwen: per leaf max|dg|/max|g| "
          f"{json.dumps({p: float(f'{v:.4g}') for p, v in rel.items()})}",
          flush=True)
    ok &= run_ok and grad_ok
    del params, ref, got, model, batch
    _free()

    # (b) DeepSeekMoE-16B at depth 4 under fsdp_tp_ep on a (1, 1) mesh
    mspec = TRAIN_SLICES["moe16b"]
    loss_tol, grad_tol = mspec["tols"]["bfloat16"]
    espec = {"steps": EP_SLICE["steps"], "kernel": "flash_fwd",
             "sets": mspec["sets"]}
    body = MOE._ep_local
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return body(*args, **kw)

    try:
        gym, out, base_counts, base_peak, base_med, base_ms = _mesh_run(
            data_dir, "moe16b", espec, None)
        cfg = gym.model.cfg
        base_losses = [h["loss"] for h in out["history"]]
        add_launches(results, base_counts)
        del gym, out
        _free()
        with mock.patch.object(MOE, "_ep_local", counted):
            gym, out, counts, peak, med, ms = _mesh_run(
                data_dir, "moe16b", espec, EP_SLICE["plan"])
        ep_calls = len(calls)
        losses = [h["loss"] for h in out["history"]]
        lbs = [h["router_lb"] for h in out["history"]]
        add_launches(results, counts)
        n_moe = cfg.n_layers - cfg.moe.n_dense_layers
        want = {"flash_fwd": cfg.n_layers * 2 * espec["steps"],
                "ssd_scan": 0}
        run_ok = (counts == want and ep_calls == n_moe * 2 * espec["steps"]
                  and all(map(math.isfinite, losses + lbs)))
        print(f"pp moe16b: {cfg.name} full width, depth {cfg.n_layers} "
              f"({cfg.moe.n_dense_layers} dense + {n_moe} MoE layers of "
              f"{cfg.moe.n_routed} experts, top {cfg.moe.top_k}), batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}, {espec['steps']} steps through "
              f"the gym: no mesh losses "
              f"{json.dumps([round(x, 5) for x in base_losses])}, "
              f"{PL.make_plan(EP_SLICE['plan']).describe()} on mesh "
              f"{_mesh_shape(gym._mesh)} losses "
              f"{json.dumps([round(x, 5) for x in losses])}, router_lb "
              f"{json.dumps([round(x, 7) for x in lbs])}; flash_fwd "
              f"{counts['flash_fwd'] // espec['steps']} a step (want "
              f"{want['flash_fwd'] // espec['steps']}), the EP body "
              f"{ep_calls // espec['steps']} calls a step ({n_moe} MoE "
              f"layers x 2); ms/step {json.dumps([round(x, 3) for x in ms])}"
              f" (no mesh {json.dumps([round(x, 3) for x in base_ms])}); "
              f"peak {peak:.3f} GiB (no mesh {base_peak:.3f}) [{card}]: "
              f"{'ok' if run_ok else 'FAILED'}", flush=True)
        mesh = gym._mesh
        model = gym.model
        del gym, out
        _free()
        ok &= run_ok & _ep_grads(model, mesh, results, card, loss_tol,
                                 grad_tol)
    finally:
        MESH.shutdown()
    return bool(ok)


def _ep_capacity(T: int, k: int, n_experts: int, ep: int, cf: float) -> int:
    """The slots ``C_e`` of each local expert on an EP rank of ``T`` tokens
    (JAX's ``_capacity`` and ``_ep_local``), worked out here from the
    config: dropless up to 4096 assignments, else ``cf`` times an even
    share, rounded up to 128 over the rank, then ``cf`` again over its
    experts."""
    import math

    total = T * k
    c_total = total
    if total > 4096:
        c = math.ceil(cf * total / ep)
        c_total = min(total, -(-c // 128) * 128)
    return max(8, -(-int(c_total * cf) // (n_experts // ep)))


def _first_per_expert(e, n_experts: int, C_e: int):
    """[N] bool: whether each of the row-major assignments ``e`` [N] is
    among the first ``C_e`` of its expert, by a stable sort by expert (not
    the program's running count)."""
    import torch

    order = torch.argsort(e, stable=True)
    counts = torch.bincount(e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(e)
    rank[order] = torch.arange(e.numel(), device=e.device) - starts[e[order]]
    return rank < C_e


def _ep_grads(model, mesh, results, card, loss_tol, grad_tol) -> bool:
    """One step of ``model`` under ``fsdp_tp_ep`` on ``mesh`` against its
    reference: the no-mesh step (``moe_routed``, dropless) where no
    assignment dropped, else ``moe_dense`` with the dropped assignments'
    gates zeroed, the dropped ones chosen here (:func:`_ep_capacity`,
    :func:`_first_per_expert`).  Each EP call's drops, the program's
    (``capacity_buckets``) against these, and the dropped share of each MoE
    layer printed."""
    import torch

    from repro_torch.models import moe as MOE
    from repro_torch.sharding import plans as PL
    from repro_torch.tree import tree_leaves

    cfg = model.cfg
    m = cfg.moe
    plan = PL.make_plan(EP_SLICE["plan"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    tok = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                        generator=gen, device="cuda", dtype=torch.int32)
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    sh, _ = PL.param_shardings(plan, mesh, params, model.param_axes())
    laid = PL.distribute(params, sh)
    lbatch = PL.distribute(batch, PL.batch_shardings(plan, mesh, batch))
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    body = MOE._ep_local
    calls = []

    def recorded(cfg_, x, idx, gate, wg, wu, wd, *, e0, ep_size):
        E_loc = wg.shape[0]
        local, keep = MOE.capacity_buckets(cfg_, idx, e0, E_loc, ep_size)[:2]
        e = idx.reshape(-1)
        mine = (e >= e0) & (e < e0 + E_loc)
        C_e = _ep_capacity(x.shape[0], m.top_k, m.n_routed, ep_size,
                           m.capacity_factor)
        kept = mine & _first_per_expert(
            torch.where(mine, e - e0, E_loc), E_loc + 1, C_e)
        calls.append(((local & ~keep).sum(), (mine & ~kept).sum(),
                      mine.sum()))
        return body(cfg_, x, idx, gate, wg, wu, wd, e0=e0, ep_size=ep_size)

    with mock.patch.object(MOE, "_ep_local", recorded):
        got = step_grads(model, laid, lbatch,
                         mesh_ctx=PL.mesh_context(plan, mesh),
                         storage_axes=plan.ep_storage_axes)
    calls = [tuple(int(v) for v in c) for c in calls]
    add_launches(results, {n: c.launches for n, c in counters.items()})
    del laid
    _free()
    n_moe = cfg.n_layers - m.n_dense_layers
    fwd = calls[:n_moe]          # the forward's calls; the rest recompute
    drops_ok = len(calls) == 2 * n_moe and all(a == b for a, b, _ in calls)
    shares = [d / n for _, d, n in fwd]
    dropped = any(d for _, d, _ in fwd)
    C_e = _ep_capacity(TRAIN_BATCH * TRAIN_SEQ, m.top_k, m.n_routed, 1,
                       m.capacity_factor)
    if not dropped:
        ref = step_grads(model, params, batch)
        what = "the no-mesh step (moe_routed, dropless)"
    else:
        def kept_dense(cfg_, p, x_flat, idx, gate):
            keep = _first_per_expert(idx.reshape(-1), m.n_routed, C_e)
            return MOE.moe_dense(cfg_, p, x_flat, idx,
                                 gate * keep.reshape(idx.shape).to(gate.dtype))

        with mock.patch.object(MOE, "moe_routed", kept_dense):
            ref = step_grads(model, params, batch)
        what = "moe_dense with the dropped assignments' gates zeroed"
    torch.cuda.synchronize()
    dloss, rel, worst = grad_diff(ref, got)
    finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(got[1]))
    good = (finite and drops_ok and dloss <= loss_tol
            and rel[worst] <= grad_tol)
    print(f"pp moe16b: one step (bfloat16) under {EP_SLICE['plan']} (EP "
          f"degree 1, C_e {C_e} per expert for T·k "
          f"{TRAIN_BATCH * TRAIN_SEQ * m.top_k}): dropped share per MoE "
          f"layer {json.dumps([round(x, 6) for x in shares])} "
          f"({json.dumps([[d, n] for _, d, n in fwd])} of the assignments); "
          f"the program's drops per EP call "
          f"{json.dumps([a for a, _, _ in calls])} vs a stable sort's "
          f"{json.dumps([b for _, b, _ in calls])} ({len(calls)} calls, want "
          f"{2 * n_moe}); vs {what}: loss {got[0]:.6f} vs {ref[0]:.6f}, "
          f"|dloss| {dloss:.6g} (tol {loss_tol}); worst leaf {worst} "
          f"max|dg|/max|g| {rel[worst]:.6g} (tol {grad_tol}); finite "
          f"{finite} [{card}]: {'ok' if good else 'FAILED'}", flush=True)
    print(f"pp moe16b: per leaf max|dg|/max|g| "
          f"{json.dumps({p: float(f'{v:.4g}') for p, v in rel.items()})}",
          flush=True)
    del params, ref, got
    _free()
    return good


def phase_sweep(data_dir: str, results: dict, card: str) -> bool:
    """The data pipeline, then full-width Qwen trained on its tokens, then
    an ablation sweep of that run and ``lr_sweep.yaml``, then an ``sft``
    run on a JSONL of pairs (module docstring, item 9)."""
    import math
    import statistics

    import torch
    import yaml

    from repro_torch.config.resolver import load_yaml
    from repro_torch.run import api

    t_phase = time.perf_counter()
    tag = f"[{card}]"
    before = _checkout_files()
    ok, prefix, sft = _sweep_pipeline(data_dir, card)
    total = 0

    # the pipeline-fed run, through the train kind
    _free()
    base_mem = torch.cuda.memory_allocated()
    flash = _counters()["flash_fwd"]
    doc = _sweep_base(data_dir, prefix)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.launches = 0
    res = api.execute_doc(doc, device="cuda", write_result=True, log=_quiet)
    torch.cuda.synchronize()
    launches = flash.launches
    total += launches
    losses = [h["loss"] for h in res["history"]]
    ms = _step_ms(res["history"])
    run_ok = (len(losses) == SWEEP_STEPS and launches == SWEEP_FLASH * SWEEP_STEPS
              and all(math.isfinite(x) for x in losses))
    print(f"sweep qwen train: full width on the bpe tokens, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, lr {SWEEP_LR}, seed {SWEEP_SEED}, "
          f"losses {json.dumps(losses)}, flash_fwd {launches} (want "
          f"{SWEEP_FLASH * SWEEP_STEPS}), ms/step {json.dumps([round(x, 3) for x in ms])}, "
          f"peak_mem_gib {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"{tag}: {'ok' if run_ok else 'FAILED'}", flush=True)
    ok &= run_ok
    del res
    _free()

    # the ablation: the same document as the base of a sweep
    sweep_dir = os.path.join(data_dir, "sweep_qwen")
    spec_path = os.path.join(data_dir, "sweep_qwen.yaml")
    base = {k: v for k, v in doc.items() if k != "run"}
    with open(spec_path, "w") as f:
        yaml.safe_dump({"sweep": {
            "name": "qwen_lr_ablation", "backend": "gym",
            "steps": SWEEP_STEPS, "base": base, "output_dir": sweep_dir,
            "seeds": [0, 1], "seed_path": "gym.config.seed",
            "axes": [{"type": "zip", "parameters": {
                "optimizer.config.lr": [1e-4, SWEEP_LR]}}]}}, f)
    args = ["--config", spec_path, "--device", "cuda"]
    runs = [_sweep_cli(args + ["--max-trials", "2"]), _sweep_cli(args),
            _sweep_cli(args)]
    with open(os.path.join(sweep_dir, "report.json")) as f:
        report = json.load(f)
    records = {}
    with open(os.path.join(sweep_dir, "records.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            records[rec["trial_id"]] = rec
    mine = f"lr={SWEEP_LR}__seed={SWEEP_SEED}"
    values = [r["value"] for r in report["ranking"]]
    trial_launches = [row["launches"] for _, rows, _ in runs for row in rows]
    sweep_launches = sum(n for _, _, n in runs)
    total += sweep_launches
    held = [row["after"] - base_mem for _, rows, _ in runs for row in rows]
    sweep_ok = ([rc for rc, _, _ in runs] == [0, 0, 0]
                and [len(rows) for _, rows, _ in runs] == [2, 2, 0]
                and runs[2][2] == 0
                and trial_launches == [SWEEP_FLASH * SWEEP_STEPS] * 4
                and sweep_launches == 4 * SWEEP_STEPS * SWEEP_FLASH
                and report["by_status"] == {"ok": 4}
                and len(values) == 4 and values == sorted(values)
                and all(math.isfinite(v) for v in values)
                and records[mine]["metrics"]["final_loss"] == losses[-1]
                and all(h < SWEEP_MEM_SLACK for h in held))
    for _, rows, _ in runs:
        for row in rows:
            with open(os.path.join(sweep_dir, row["record"]["run_dir"],
                                   "result.json")) as f:
                hist = json.load(f)["history"]
            ms = _step_ms(hist)
            print(f"sweep qwen trial {row['trial']}: final_loss "
                  f"{row['record']['metrics']['final_loss']}, flash_fwd "
                  f"{row['launches']}, ms/step "
                  f"{json.dumps([round(x, 3) for x in ms])} (median "
                  f"{statistics.median(ms):.3f}), peak_mem_gib "
                  f"{row['peak'] / 2**30:.3f}, held after the trial "
                  f"{(row['after'] - base_mem) / 2**30:.4f} GiB above the "
                  f"sweep's start, trial wall {row['record']['wall_s']} s "
                  f"{tag}", flush=True)
    print(f"sweep qwen: 3 invocations ran {[len(r) for _, r, _ in runs]} "
          f"trials (want [2, 2, 0]), exit codes {[rc for rc, _, _ in runs]}, "
          f"flash_fwd {sweep_launches} (want {4 * SWEEP_STEPS * SWEEP_FLASH}); report "
          f"by_status {report['by_status']}, ranking "
          f"{[(r['trial_id'], r['value']) for r in report['ranking']]}; "
          f"trial {mine} final_loss "
          f"{records[mine]['metrics']['final_loss']} == the train run's "
          f"{losses[-1]}; held after each trial <= "
          f"{max(held) / 2**30:.4f} GiB (bound 1 GiB): "
          f"{'ok' if sweep_ok else 'FAILED'}", flush=True)
    ok &= sweep_ok
    _free()

    # lr_sweep.yaml, unchanged but for its directories: its base's dataset
    # moves into the temporary directory with the sweep's output
    qs = load_yaml(os.path.join(ROOT, "examples", "configs",
                                "quickstart.yaml"))
    qs["dataset"]["config"]["prefix"] = os.path.join(data_dir, "lr_sweep_qs")
    qs_path = os.path.join(data_dir, "quickstart_lr_sweep.yaml")
    with open(qs_path, "w") as f:
        yaml.safe_dump(qs, f)
    lr_dir = os.path.join(data_dir, "lr_sweep")
    t0 = time.perf_counter()
    rc, rows, n = _sweep_cli(
        ["--config", os.path.join(ROOT, "examples", "configs",
                                  "lr_sweep.yaml"),
         "--output-dir", lr_dir, "--set", f"sweep.base_config={qs_path}",
         "--device", "cuda"])
    with open(os.path.join(lr_dir, "report.json")) as f:
        lr_report = json.load(f)
    lr_ok = (rc == 0 and len(rows) == 6 and n == 0
             and lr_report["by_status"] == {"ok": 6})
    print(f"sweep lr_sweep.yaml: {len(rows)} trials in "
          f"{time.perf_counter() - t0:.2f}s, exit {rc}, flash_fwd {n} (want "
          f"0: use_flash_kernel stays False, as in JAX), best "
          f"{lr_report['best']['trial_id']} = {lr_report['best']['value']} "
          f"{tag}: {'ok' if lr_ok else 'FAILED'}", flush=True)
    ok &= lr_ok

    # sft on a JSONL of pairs through tokenizer/byte
    sdoc = train_doc(data_dir, "sweep_sft_unused", "variables.seq_len=128")
    sdoc["tokenizer"] = {"component_key": "tokenizer", "variant_key": "byte"}
    sdoc["dataset"] = {"component_key": "dataset", "variant_key": "sft_jsonl",
                       "config": {"path": sft, "seq_len": "${seq_len}",
                                  "tokenizer": {"instance_key": "tokenizer"}}}
    sdoc["run"] = {"kind": "sft", "name": "sweep_sft",
                   "output_dir": os.path.join(data_dir, "sweep_sft"),
                   "sft": {"steps": 4}}
    flash.launches = 0
    sres = api.execute_doc(sdoc, device="cuda", write_result=True,
                           log=_quiet)
    total += flash.launches
    slosses = [h["loss"] for h in sres["history"]]
    sft_ok = len(slosses) == 4 and all(math.isfinite(x) for x in slosses)
    print(f"sweep sft_jsonl: reduced Qwen, 256 pairs through tokenizer/byte "
          f"at seq_len 128, losses {json.dumps(slosses)}: "
          f"{'ok' if sft_ok else 'FAILED'}", flush=True)
    ok &= sft_ok
    add_launches(results, {"flash_fwd": total})
    written = sorted(p for p, st in _checkout_files().items()
                     if before.get(p) != st)
    ok &= not written
    print(f"sweep: phase wall {time.perf_counter() - t_phase:.1f}s, "
          f"flash_fwd {total}, files written under the checkout {written} "
          f"{tag}", flush=True)
    return bool(ok)


# ---------------------------------------------------------------------------
# the dryrun, trace and the dryrun sweep (ROADMAP A9b's dryrun half)
# ---------------------------------------------------------------------------
#: (a): the two documents run unchanged through the port's CLI, each from a
#: temporary working directory (their relative ``output_dir`` lands there)
DRYRUN_DOCS = ("dryrun", "trace")
DRYRUN_SWEEP = "ablation_dryrun"
DRYRUN_SWEEP_TRIALS = 12
#: (b): a full-width step on the card held against its dryrun, on a
#: ``(1, 1)`` ``local`` mesh under ``ddp``, at the train phases' 8 x 1024
DRYRUN_CARD = {
    "qwen": ("qwen1p5_0p5b", {"use_flash_kernel": True}, "flash_fwd", 48),
    "mamba2": ("mamba2_780m", {}, "ssd_scan", 96),
}
DRYRUN_TIMED_STEPS = 3
#: the CUDA caching allocator's sizes (``CUDACachingAllocator.cpp``):
#: its smallest block, the request from which a segment is sized to fit,
#: that segment's rounding, and the remainder below which a block is not
#: split (``kMinBlockSize``, ``kMinLargeAlloc``, ``kRoundLarge``,
#: ``kSmallSize``)
ALLOC_BLOCK, ALLOC_LARGE = 512, 10 << 20
ALLOC_SEGMENT, ALLOC_SPLIT = 2 << 20, 1 << 20

# runs ``python -m repro_torch <argv>``'s main in a child and reports
# whether the child ever initialised CUDA (a dryrun must not)
_CLI_CHILD = (
    "import sys, torch\n"
    "from repro_torch.run.cli import main\n"
    "rc = main(sys.argv[1:])\n"
    "print(f'cuda_initialized={torch.cuda.is_initialized()}', flush=True)\n"
    "sys.exit(rc)\n")


def _dryrun_cli(argv: list, cwd: str) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.Popen([sys.executable, "-c", _CLI_CHILD, *argv],
                            cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _terms(res: dict) -> str:
    return (f"compute {res['compute_term_s']:.6g} s, memory "
            f"{res['memory_term_s']:.6g} s, collective "
            f"{res['collective_term_s']:.6g} s, dominant "
            f"{res['dominant_term']}, {res['hlo_flops_per_dev']:.6g} "
            f"flops/device, {res['collective_bytes_per_dev']:.6g} collective "
            f"bytes/device, traced in {res['compile_s']} s (state "
            f"{res['lower_s']} s)")


def _dryrun_documents(out_dir: str) -> dict:
    """(a) ``dryrun.yaml`` and ``trace.yaml`` through the CLI (each its
    own process, on the host's CPU, while (b) holds the card), and
    ``ablation_dryrun.yaml`` with its sweep directory moved under
    ``out_dir``, started here and read by :func:`_dryrun_documents_check`;
    {name: (start time, process, working directory)}."""
    cfgs = os.path.join(ROOT, "examples", "configs")
    sweep_dir = os.path.join(out_dir, "sweep")
    procs = {}
    for name in DRYRUN_DOCS:
        cwd = os.path.join(out_dir, name)
        os.makedirs(cwd)
        argv = [name, "--config", os.path.join(cfgs, name + ".yaml")]
        if name == "dryrun":
            argv += ["--json", os.path.join(cwd, "result.json")]
        procs[name] = (time.perf_counter(), _dryrun_cli(argv, cwd), cwd)
    sweep_argv = ["sweep", "--config",
                  os.path.join(cfgs, DRYRUN_SWEEP + ".yaml"),
                  "--output-dir", sweep_dir]
    procs["sweep"] = (time.perf_counter(), _dryrun_cli(sweep_argv, out_dir),
                      out_dir)
    return procs


def _dryrun_documents_check(procs: dict, out_dir: str, card: str) -> bool:
    """(a)'s checks, once its processes end: each document's result, the
    card untouched, ``model_flops_global`` == 6·N·D, the schedule; the
    sweep's 12 trials ``ok`` and a second call that resumes all 12."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.telemetry.accounting import model_flops

    ok = True
    outs = {}
    for name, (t0, proc, cwd) in procs.items():
        text, _ = proc.communicate(timeout=900)
        outs[name] = (proc.returncode, text, time.perf_counter() - t0, cwd)
    for name in DRYRUN_DOCS:
        rc, text, wall, cwd = outs[name]
        run = glob.glob(os.path.join(cwd, "results", "runs", "*",
                                     "result.json"))
        res = {}
        if run:
            with open(run[0]) as f:
                res = json.load(f)
        clean = "cuda_initialized=False" in text
        doc_ok = rc == 0 and bool(res.get("chips")) and clean
        line = (f"dryrun (a) {name}.yaml: exit {rc}, {wall:.1f} s wall; "
                f"card untouched {clean}")
        if res.get("chips"):
            line += (f"; {res['arch']} x {res['shape']} on {res['mesh']} "
                     f"({res['plan']}): {_terms(res)}; temp "
                     f"{res['mem_temp_size_in_bytes']} B/device, arguments "
                     f"{res['mem_argument_size_in_bytes']} B/device")
        if name == "dryrun" and res:
            with open(os.path.join(cwd, "result.json")) as f:
                doc_ok &= json.load(f) == res
            cfg = get_config("stablelm_1p6b").with_(scan_block_size=4)
            want = model_flops(cfg, SHAPES["train_4k"])[0]
            line += (f"; model_flops_global {res['model_flops_global']} "
                     f"== 6·N·D {want}: {res['model_flops_global'] == want}")
            doc_ok &= res["model_flops_global"] == want
        if name == "trace":
            doc_ok &= "# collective schedule:" in text
            sched = [ln for ln in text.splitlines()
                     if ln.startswith(("all-", "reduce-", "collective-"))]
            line += f"; schedule rows {len(sched)}: {sched[:4]}"
        print(f"{line} [{card}]: {'ok' if doc_ok else 'FAILED'}", flush=True)
        if not doc_ok:
            print(text[-4000:], flush=True)
        ok &= doc_ok

    # the sweep: 12 trials ok, then a second call that runs none
    rc, text, wall, _ = outs["sweep"]
    records = _sweep_records(os.path.join(out_dir, "sweep"))
    n_ok = sum(r.get("status") == "ok" for r in records)
    sweep_ok = (rc == 0 and n_ok == DRYRUN_SWEEP_TRIALS
                and "cuda_initialized=False" in text)
    t0 = time.perf_counter()
    again = _dryrun_cli(["sweep", "--config", os.path.join(
        ROOT, "examples", "configs", DRYRUN_SWEEP + ".yaml"),
        "--output-dir", os.path.join(out_dir, "sweep")], out_dir)
    text2, _ = again.communicate(timeout=600)
    wall2 = time.perf_counter() - t0
    resumed = (f"done: {DRYRUN_SWEEP_TRIALS} records "
               f"({DRYRUN_SWEEP_TRIALS} resumed, 0 failed)") in text2
    sweep_ok &= again.returncode == 0 and resumed
    best = [ln for ln in text.splitlines() if ln.startswith("best trial")]
    print(f"dryrun (a) {DRYRUN_SWEEP}.yaml: exit {rc}, {wall:.1f} s wall, "
          f"{n_ok}/{DRYRUN_SWEEP_TRIALS} trials ok; second call exit "
          f"{again.returncode}, {wall2:.1f} s, all resumed {resumed}; "
          f"{best[0] if best else 'no best trial'} [{card}]: "
          f"{'ok' if sweep_ok else 'FAILED'}", flush=True)
    for r in records:
        m = r.get("metrics", {})
        print(f"dryrun (a) trial {r.get('trial_id')}: {r.get('status')}, "
              f"roofline_step_s {m.get('roofline_step_s')}, dominant "
              f"{m.get('dominant_term')}, compute {m.get('compute_term_s')}, "
              f"memory {m.get('memory_term_s')}, collective "
              f"{m.get('collective_term_s')}, traced in "
              f"{m.get('compile_s')} s", flush=True)
    if not sweep_ok:
        print(text[-4000:], text2[-2000:], flush=True)
    return bool(ok and sweep_ok)


def _sweep_records(sweep_dir: str) -> list:
    path = os.path.join(sweep_dir, "records.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _alloc_bytes(tree) -> int:
    """The bytes ``memory_allocated`` counts for ``tree``'s distinct
    storages, each allocated on its own from an emptied cache: the CUDA
    caching allocator rounds a request up to ``ALLOC_BLOCK``, gives a
    request of ``ALLOC_LARGE`` or more a segment rounded up to
    ``ALLOC_SEGMENT``, and hands out the whole segment (and counts it)
    where less than ``ALLOC_SPLIT`` of it would remain."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_leaves

    seen, total = set(), 0
    for t in tree_leaves(tree):
        st = (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        n = max(ALLOC_BLOCK, -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK)
        if n >= ALLOC_LARGE:
            seg = -(-n // ALLOC_SEGMENT) * ALLOC_SEGMENT
            if seg - n <= ALLOC_SPLIT:
                n = seg
        total += n
    return total


def _dryrun_vs_card(key: str, results: dict, card: str) -> bool:
    """(b) One full-width step on the card under the dryrun's counter
    beside the dryrun of the same step: per-device FLOPs and the collective
    kinds equal, the argument bytes equal (and equal to what
    ``memory_allocated`` counts), the kernel's launches in the step, the
    measured ms/step beside ``max(terms)`` and the traced peak beside
    ``max_memory_allocated``."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch.hlo_analysis import CostCounter
    from repro_torch.models import build_model
    from repro_torch.sharding import plans as PL

    arch, overrides, kernel, want_launches = DRYRUN_CARD[key]
    cfg = get_config(arch).with_(**overrides)
    shape = InputShape("card", TRAIN_SEQ, TRAIN_BATCH, "train")
    plan = PL.make_plan("ddp")
    dry = DR.compile_run(cfg, shape, MESH.LocalMesh(1, 1), plan)
    roofline = max(dry["compute_term_s"], dry["memory_term_s"],
                   dry["collective_term_s"])
    counters = _counters()
    try:
        mesh = MESH.make_local_mesh(1, 1, device_type="cuda")
        model = build_model(cfg)
        # what memory_allocated counts for the state and the batch: the
        # bytes it gives back when a freshly built pair is dropped (what
        # else building allocates and keeps is not theirs)
        _free()
        setup = DR.build_step(model, shape, mesh, plan, device="cuda")
        alloc = _alloc_bytes({"state": setup.args[0], "batch": setup.args[1]})
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        del setup
        _free()
        held -= torch.cuda.memory_allocated()
        setup = DR.build_step(model, shape, mesh, plan, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        for c in counters.values():
            c.launches = 0
        with CostCounter(arguments=setup.args) as counter:
            state, metrics = setup.fn(*setup.args)
            torch.cuda.synchronize()
        launches = {name: c.launches for name, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() - before
        ana = counter.analyze()
        mem = counter.memory(setup.args, (state, metrics))
        loss = float(metrics["loss"])
        ms = []
        for _ in range(DRYRUN_TIMED_STEPS):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
            state, metrics = setup.fn(state, setup.args[1])
            t1.record()
            torch.cuda.synchronize()
            ms.append(t0.elapsed_time(t1))
        add_launches(results, launches)
        flops_ok = ana["flops"] == dry["hlo_flops_per_dev"]
        coll_ok = ana["collective_counts"] == dry["collective_counts"]
        args_ok = (mem["mem_argument_size_in_bytes"]
                   == dry["mem_argument_size_in_bytes"] and alloc == held)
        launch_ok = launches[kernel] == want_launches and all(
            n == 0 for name, n in launches.items() if name != kernel)
        run_ok = (flops_ok and coll_ok and args_ok and launch_ok
                  and math.isfinite(loss))
        med = sorted(ms)[len(ms) // 2]
        print(f"dryrun (b) {key}: {cfg.name} full width ({cfg.n_layers} "
              f"layers, remat {cfg.remat}), {TRAIN_BATCH} x {TRAIN_SEQ} on a "
              f"(1, 1) mesh under ddp; flops/device card {ana['flops']!r} vs "
              f"dryrun {dry['hlo_flops_per_dev']!r} (equal {flops_ok}); "
              f"bytes/device card {ana['bytes']!r} vs dryrun "
              f"{dry['hlo_bytes_per_dev']!r}; collectives card "
              f"{ana['collective_counts']} vs dryrun "
              f"{dry['collective_counts']} (equal {coll_ok}); arguments "
              f"card {mem['mem_argument_size_in_bytes']} B vs dryrun "
              f"{dry['mem_argument_size_in_bytes']} B, {alloc} B as the "
              f"allocator counts them vs memory_allocated {held} B (equal "
              f"{args_ok}); {kernel} launches {launches[kernel]} (want "
              f"{want_launches}) {launches}; loss {loss:.5f}; ms/step "
              f"{json.dumps([round(x, 3) for x in ms])}, median {med:.3f} vs "
              f"max(terms) {roofline * 1e3:.3f} ms (x{med / (roofline * 1e3):.2f}"
              f", dominant {dry['dominant_term']}); traced peak card "
              f"{mem['mem_temp_size_in_bytes']} B, dryrun "
              f"{dry['mem_temp_size_in_bytes']} B vs max_memory_allocated "
              f"{peak} B above the arguments; dryrun traced in "
              f"{dry['compile_s']} s [{card}]: "
              f"{'ok' if run_ok else 'FAILED'}", flush=True)
        del setup, state, metrics
    finally:
        MESH.shutdown()
        _free()
    return bool(run_ok)


def phase_dryrun(data_dir: str, results: dict, card: str) -> bool:
    """The dryrun, trace and dryrun sweep (``--only dryrun``): (a) the
    three documents in child processes on the host, (b) the dryrun held
    against the card meanwhile."""
    out_dir = os.path.join(data_dir, "dryrun")
    os.makedirs(out_dir)
    procs = _dryrun_documents(out_dir)
    ok = True
    try:
        for key in DRYRUN_CARD:
            ok &= _dryrun_vs_card(key, results, card)
    finally:
        ok &= _dryrun_documents_check(procs, out_dir, card)
    return bool(ok)


def phase_engine_quickstart(out_dir: str) -> bool:
    """``examples/configs/serve_engine.yaml`` through the run API, unchanged
    but for ``run.output_dir`` (and so the bench file's directory): reduced
    Qwen, Poisson arrivals at 4 requests/s, 12 requests, paged, with the
    static-shim baseline."""
    from repro_torch.config.resolver import load_yaml
    from repro_torch.run import api

    doc = load_yaml(os.path.join(ROOT, "examples", "configs",
                                 "serve_engine.yaml"))
    doc["run"]["output_dir"] = os.path.join(out_dir, "serve_quickstart")
    before = _checkout_files()
    t0 = time.perf_counter()
    res = api.execute_doc(doc, device="cuda", write_result=True, log=_quiet)
    wall = time.perf_counter() - t0
    written = sorted(p for p, st in _checkout_files().items()
                     if before.get(p) != st)
    bench = os.path.join(doc["run"]["output_dir"],
                         "BENCH_serve_quickstart.json")
    with open(os.path.join(ROOT, "BENCH_serve_quickstart.json")) as f:
        keys_jax = set(json.load(f))
    keys = set(json.load(open(bench))) if os.path.exists(bench) else set()
    ok = (res["completed"] == res["n_requests"] == 12
          and res["prefill_cache_hit_rate"] > 0 and keys == keys_jax
          and not written)
    print(f"engine quickstart: {res['completed']}/{res['n_requests']} "
          f"requests in {wall:.2f}s, prefill_cache_hit_rate "
          f"{res['prefill_cache_hit_rate']}, tok_s {res['tok_s']}, "
          f"decode_tok_s {res['decode_tok_s']} (static shim "
          f"{res['static_shim']['decode_tok_s']}), ttft_s p50 "
          f"{res['ttft_s']['p50']:.4f}, compile_s {res['compile_s']}; "
          f"{bench} has the JAX artifact's keys {keys == keys_jax}; files "
          f"written under the checkout {written}: "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    return ok


def _expected_cached(trace, chunk: int):
    """Prompt tokens each request should find cached: none for the first
    request on each prefix, else its prefix floored to the chunk grid and
    capped one token short of the prompt (``admit_paged``'s match)."""
    seen, out = set(), []
    for r in trace:
        key = tuple(r.prompt[:ENGINE_QWEN_TRACE["prefix_len"]])
        full = min(ENGINE_QWEN_TRACE["prefix_len"], r.prompt_len - 1)
        out.append((full // chunk) * chunk if key in seen else 0)
        seen.add(key)
    return out


def phase_engine_qwen(results: dict, profile_dir: str = "") -> bool:
    """Full-width Qwen1.5-0.5B (``use_flash_kernel=True``) on the paged
    engine, seeded random weights: the main run, then the determinism
    contract on the card (four requests alone, the prefix cache off), the
    first-token logits of a cold chunked prefill against the plain dense
    prefill, the dense engine's greedy streams (a diagnostic) and the
    threefry noise against the CPU's."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import prng
    from repro_torch.serve.engine import ServeEngine, load_params
    from repro_torch.serve.sampling import request_key, token_key
    from repro_torch.serve.workload import shared_prefix_trace

    cfg = get_config("qwen1p5_0p5b").with_(use_flash_kernel=True,
                                           n_layers=ENGINE_QWEN_LAYERS)
    model = build_model(cfg)
    params = load_params(model, seed=0, device="cuda")
    t = ENGINE_QWEN_TRACE
    trace = shared_prefix_trace(
        t["n_requests"], cfg.vocab, prefix_len=t["prefix_len"],
        n_prefixes=t["n_prefixes"], seed=0, prompt_lens=t["prompt_lens"],
        gen_tokens=t["gen_tokens"], max_len=ENGINE_QWEN["max_len"],
        **SAMPLING)
    for r in trace[::4]:
        r.temperature = 0.0                  # every fourth request greedy
    engine = ServeEngine(model, params, **ENGINE_QWEN)
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    res = engine.run(trace, realtime=False)
    counts = {name: c.launches for name, c in counters.items()}
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rows = res["requests"]
    streams = [r["gen_ids"] for r in rows]
    pg = res["paging"]
    ok = True
    done = (res["completed"] == len(trace) == t["n_requests"]
            and all(len(s) == r.max_new and all(0 <= x < cfg.vocab for x in s)
                    for r, s in zip(trace, streams)))
    want = _expected_cached(trace, ENGINE_QWEN["prefill_chunk"])
    got = [r["cached_tokens"] for r in rows]
    rate = round(sum(want) / sum(r.prompt_len for r in trace), 4)
    lost = sorted({int(trace[i].rid) % t["n_prefixes"]
                   for i in range(len(trace)) if got[i] < want[i]})
    hits_ok = got == want and res["prefill_cache_hit_rate"] == rate
    print(f"engine qwen: {cfg.name} full width, depth {cfg.n_layers} of "
          f"24, paged (block_len "
          f"{pg['block_len']}, n_blocks {pg['n_blocks']}, prefill_chunk "
          f"{pg['prefill_chunk']}), {len(trace)} requests (prefix "
          f"{t['prefix_len']} x {t['n_prefixes']}, tails {t['prompt_lens']}, "
          f"{t['gen_tokens'][0]} tokens each, {SAMPLING}, every fourth "
          f"greedy), closed loop: {res['completed']} complete, tokens in "
          f"[0, {cfg.vocab}): {done}", flush=True)
    print(f"engine qwen: prefill_cache_hit_rate {res['prefill_cache_hit_rate']}"
          f" (want {rate}: 0 cached for the first request on each prefix, "
          f"{max(want)} for the others), cached tokens as the trace says "
          f"{got == want}"
          f"; evictions {pg['evictions']}, prefixes lost {lost}: "
          f"{'ok' if hits_ok else 'FAILED'}", flush=True)
    print(f"engine qwen: launches over the run {counts}; flash_fwd must be "
          f"0: JAX's paged prefill chunk (gqa_prefill_chunk) computes its "
          f"attention with einsums, outside any Pallas kernel, and the port "
          f"does the same", flush=True)
    ok &= done and hits_ok and counts["flash_fwd"] == 0
    tp = res["tpot_ms"]
    print(f"engine qwen: tok_s {res['tok_s']} decode_tok_s "
          f"{res['decode_tok_s']} ttft_s p50 {res['ttft_s']['p50']:.4f} p95 "
          f"{res['ttft_s']['p95']:.4f} ttft_hit_s p50 "
          f"{res['ttft_hit_s']['p50']:.4f} ttft_cold_s p50 "
          f"{res['ttft_cold_s']['p50']:.4f} prefill_hit_s p50 "
          f"{res['prefill_hit_s']['p50']:.4f} prefill_cold_s p50 "
          f"{res['prefill_cold_s']['p50']:.4f} tpot_ms p50 {tp['p50']:.4f} "
          f"p90 {tp['p90']:.4f} slot_utilization {res['slot_utilization']} "
          f"interleaved_decode_ticks {res['interleaved_decode_ticks']} ticks "
          f"{res['ticks']} peak_blocks {pg['peak_blocks']} evictions "
          f"{pg['evictions']} compile_s {res['compile_s']} elapsed_s "
          f"{res['elapsed_s']} peak_mem_gib {peak_gib:.3f}", flush=True)
    add_launches(results, counts)

    # the determinism contract on the card: greedy and sampled, cold and hit
    picks = [0, 1, 4, 5]
    solo = ServeEngine(model, params, **ENGINE_QWEN)
    same = {trace[i].rid: solo.run([trace[i]], realtime=False)["requests"][0][
        "gen_ids"] == streams[i] for i in picks}
    off = ServeEngine(model, params, prefix_cache=False, **ENGINE_QWEN).run(
        trace, realtime=False)
    off_same = [r["gen_ids"] for r in off["requests"]] == streams
    kinds = {trace[i].rid: ("greedy" if trace[i].temperature == 0
                            else "sampled") + (" hit" if want[i] else " cold")
             for i in picks}
    print(f"engine qwen: alone in a fresh engine of the same pool shape, "
          f"the same stream {same} ({kinds}); prefix_cache off, the same "
          f"{len(trace)} streams {off_same} (hit rate "
          f"{off['prefill_cache_hit_rate']})", flush=True)
    ok &= all(same.values()) and off_same

    # first-token logits of a cold request: chunked prefill vs plain prefill
    r0 = trace[0]
    prompt = torch.as_tensor(np.asarray(r0.prompt, np.int64), device="cuda")
    C, P = ENGINE_QWEN["prefill_chunk"], r0.prompt_len
    pool = model.init_paged_cache(engine.max_pages, engine.block_len,
                                  device="cuda")
    row = torch.arange(engine.max_pages, dtype=torch.int32, device="cuda")
    toks = torch.zeros((-(-P // C) * C,), dtype=torch.int64, device="cuda")
    toks[:P] = prompt
    for lo in range(0, P, C):
        lk, pool = model.prefill_chunk(params, pool, row, toks[lo:lo + C], lo,
                                       min(C, P - lo))
    plain = build_model(cfg.with_(use_flash_kernel=False))
    lp, _ = plain.prefill(params, {"tokens": prompt[None]})
    torch.cuda.synchronize()
    d = float((lk.float() - lp.float()).abs().max())
    print(f"engine qwen: first-token logits of request 0 (cold, {P} tokens), "
          f"paged chunks vs plain dense prefill: max abs diff {d:.6g}, max "
          f"|logit| {float(lp.float().abs().max()):.4f}; tol {LOGITS_TOL} "
          f"({LOGITS_TOL_WHY})", flush=True)
    ok &= bool(torch.isfinite(lk).all()) and d <= LOGITS_TOL
    del pool

    # a diagnostic: the dense engine's greedy streams
    greedy = [r for r in trace if r.temperature == 0]
    dense = ServeEngine(model, params, block_len=0, greedy=True,
                        n_slots=ENGINE_QWEN["n_slots"],
                        max_len=ENGINE_QWEN["max_len"]).run(greedy,
                                                            realtime=False)
    by_rid = {r["id"]: r["gen_ids"] for r in rows}
    parts = [next((j for j, (a, b) in enumerate(zip(r["gen_ids"],
                                                     by_rid[r["id"]]))
                   if a != b), None) for r in dense["requests"]]
    print(f"engine qwen: greedy streams equal to the dense engine's "
          f"(block_len 0, prefill through flash_fwd): "
          f"{parts.count(None)} of {len(greedy)}; first differing token of "
          f"each {parts} (a diagnostic: the two paths round in other "
          f"programs, and random weights leave small top-2 margins)",
          flush=True)

    # threefry on the card against the CPU, 8 keys x the full vocabulary
    keys = torch.stack([token_key(request_key(r.seed), 7) for r in trace[:8]])
    tiny = torch.finfo(torch.float32).tiny
    bits_ok = torch.equal(prng.random_bits32(keys.cuda(), cfg.vocab).cpu(),
                          prng.random_bits32(keys, cfg.vocab))
    u_ok = torch.equal(prng.uniform(keys.cuda(), cfg.vocab, tiny).cpu(),
                       prng.uniform(keys, cfg.vocab, tiny))
    g = float((prng.gumbel(keys.cuda(), cfg.vocab).cpu()
               - prng.gumbel(keys, cfg.vocab)).abs().max())
    print(f"engine qwen: threefry on the card vs the CPU, 8 keys x "
          f"{cfg.vocab}: bits equal {bits_ok}, uniforms equal {u_ok}, gumbel "
          f"max abs diff {g:.3g} (each device's own log)", flush=True)
    ok &= bits_ok and u_ok
    if profile_dir:
        profile_engine(engine, profile_dir)
    del params, engine, solo
    torch.cuda.empty_cache()
    return bool(ok)


def profile_engine(engine, out_dir: str) -> None:
    """One paged admission (a 256-token prompt: one prefill chunk and the
    first token's sampling) and one paged sampled decode tick of the Qwen
    engine, and the sampling head alone over the tick's 8 rows."""
    import torch

    from repro_torch.serve.sampling import sample_tokens, token_key

    os.makedirs(out_dir, exist_ok=True)
    V = engine.model.cfg.vocab
    gen = torch.Generator("cuda").manual_seed(2)
    prompt = torch.randint(3, V, (ENGINE_QWEN["prefill_chunk"],),
                           device="cuda", generator=gen)
    steps = engine.step_probes(prompt, **SAMPLING)
    torch.cuda.synchronize()
    for name, fn in steps.items():
        profile_call(f"engine_qwen_{name}", fn, out_dir)
    n = engine.n_slots
    logits = torch.randn((n, V), device="cuda", generator=gen)
    keys = torch.zeros((n, 2), dtype=torch.int64, device="cuda")
    knobs = (torch.full((n,), SAMPLING["temperature"], device="cuda"),
             torch.full((n,), SAMPLING["top_k"], dtype=torch.int32,
                        device="cuda"),
             torch.full((n,), SAMPLING["top_p"], device="cuda"))
    n_gen = torch.ones((n,), dtype=torch.int32, device="cuda")
    profile_call("engine_qwen_sampling_head",
                 lambda: sample_tokens(logits, token_key(keys, n_gen),
                                       *knobs), out_dir)


def phase_engine_model(key: str, results: dict) -> bool:
    """A full-width model on its engine, sampled, closed loop.  On the dense
    engine every admission's prefill runs the model's kernels in every
    layer (Mamba2: ``ssd_scan`` in 48 layers; Zamba2: ``ssd_scan`` in 45
    Mamba2 layers and ``flash_fwd`` in the 9 uses of the shared attention
    block); on the paged engine (DeepSeekMoE-16B, DeepSeek-V3) the chunked
    prefill runs no kernel, as JAX's.  Then two requests alone in a fresh
    engine, and for Zamba2 three 1024-token prompts' prefill logits
    through the kernels against the plain path.  DeepSeek-V3 runs the trace
    twice on the same weights, with the expanded and the absorbed MLA
    decode."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import load_params

    spec = ENGINE_SLICES[key]
    cfg = get_config(spec["arch"]).with_(**spec["with"])
    params = load_params(build_model(cfg), seed=0, device="cuda")
    ok = True
    for absorb in spec.get("absorb", (None,)):
        run_cfg = cfg if absorb is None else cfg.with_(mla_absorb=absorb)
        label = key if absorb is None else (
            f"{key} ({'absorbed' if absorb else 'expanded'} decode)")
        ok &= _engine_run(label, spec, run_cfg, params, results)
    m = ENGINE_DENSE_TRACE
    for seed in spec.get("logit_seeds", ()):
        prompt = np.random.default_rng(seed).integers(
            3, cfg.vocab, size=(1, max(m["prompt_lens"])), dtype=np.int32)
        tok = torch.as_tensor(prompt, dtype=torch.int64, device="cuda")
        ok &= check_logits(f"engine {key}", seed, cfg, params, tok,
                           spec["logits"])
    del params
    _free()
    return bool(ok)


def _engine_run(key: str, spec: dict, cfg, params, results: dict) -> bool:
    """``ENGINE_DENSE_TRACE`` through ``cfg``'s engine, its launches, its
    metrics, and its first two requests alone in a fresh engine."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.workload import synthetic_trace

    model = build_model(cfg)
    m = ENGINE_DENSE_TRACE
    max_len = max(m["prompt_lens"]) + max(m["gen_tokens"])
    trace = synthetic_trace(m["n_requests"], cfg.vocab, seed=0,
                            prompt_lens=m["prompt_lens"],
                            gen_tokens=m["gen_tokens"], max_len=max_len,
                            **SAMPLING)
    paging = spec.get("engine", {})
    engine = ServeEngine(model, params, n_slots=m["n_slots"], max_len=max_len,
                         **paging)
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    res = engine.run(trace, realtime=False)
    counts = {name: c.launches for name, c in counters.items()}
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    add_launches(results, counts)
    lengths = sorted({r.prompt_len for r in trace})
    layers = kernel_layers(cfg)
    admissions = len(trace) + len(lengths)
    want = {name: 0 if paging else n * admissions
            for name, n in layers.items()}
    streams = [r["gen_ids"] for r in res["requests"]]
    done = (res["completed"] == len(trace) and engine.paged == bool(paging)
            and all(len(s) == m["gen_tokens"][0]
                    and all(0 <= x < cfg.vocab for x in s) for s in streams))
    solo = ServeEngine(model, params, n_slots=m["n_slots"], max_len=max_len,
                       **paging)
    same = {r.rid: solo.run([r], realtime=False)["requests"][0]["gen_ids"]
            == streams[r.rid] for r in trace[:2]}
    tp = res["tpot_ms"]
    pool = (f"paged engine (block_len {engine.block_len}, prefill_chunk "
            f"{paging['prefill_chunk']})" if paging else "dense engine")
    print(f"engine {key}: {cfg.name} full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}), {pool}, {len(trace)} requests "
          f"(prompts {m['prompt_lens']}, {m['gen_tokens'][0]} tokens each, "
          f"{SAMPLING}), closed loop: {res['completed']} complete, tokens in "
          f"[0, {cfg.vocab}): {done}", flush=True)
    if paging:
        why = ("0: JAX's paged prefill chunk (gqa_prefill_chunk, "
               "mla_prefill_chunk) computes its attention with einsums, "
               "outside any Pallas kernel, and the port does the same")
    else:
        why = (f"{layers['flash_fwd']} attention and {layers['ssd_scan']} "
               f"SSM layers x ({len(trace)} admissions + {len(lengths)} "
               f"warm-up admissions, one per prompt length {lengths})")
    print(f"engine {key}: launches over the run {counts} (want {want}: "
          f"{why}); alone in a fresh engine the same stream {same}",
          flush=True)
    print(f"engine {key}: tok_s {res['tok_s']} decode_tok_s "
          f"{res['decode_tok_s']} ttft_s p50 {res['ttft_s']['p50']:.4f} p95 "
          f"{res['ttft_s']['p95']:.4f} tpot_ms p50 {tp['p50']:.4f} p90 "
          f"{tp['p90']:.4f} slot_utilization {res['slot_utilization']} "
          f"compile_s {res['compile_s']} elapsed_s {res['elapsed_s']} "
          f"peak_mem_gib {peak_gib:.3f}", flush=True)
    if cfg.mla and paging:
        pool_bytes = sum(
            t.numel() * t.element_size() for stack in model.init_paged_cache(
                engine.n_blocks, engine.block_len, engine.cache_dtype,
                "meta").values() for t in stack.values())
        mc = cfg.mla
        per_token = (mc.kv_lora + mc.head_dim_rope) * cfg.n_layers * 2
        kv_token = (2 * cfg.n_heads * mc.head_dim_v * cfg.n_layers * 2)
        print(f"engine {key}: latent cache {pool_bytes} bytes ("
              f"{engine.n_blocks} pages + the scratch block of "
              f"{engine.block_len} tokens, {per_token} bytes a token over "
              f"{cfg.n_layers} layers in bf16; expanded K/V of 2 x "
              f"{cfg.n_heads} heads x {mc.head_dim_v} would take "
              f"{kv_token} bytes a token)", flush=True)
    del engine, solo, res
    return bool(done and counts == want and all(same.values()))


def _flash_without_last_kstep(flash_attention):
    """``flash_attention`` with the last 16 head dims left out of Q·Kᵀ (the
    bf16 kernel's last k-step dropped: dims 48-63 at dh 64, 64-79 at dh 80,
    112-127 at dh 128, 144-159 at dh 160): a control that a bound on the
    kernel's logits has to reject."""
    def attention(q, k, v, **kw):
        q = q.clone()
        q[..., q.shape[-1] - 16:] = 0
        return flash_attention(q, k, v, **kw)

    return attention


def _rerouted(a, b) -> tuple:
    """(token-layer pairs whose top-k expert sets differ between two runs'
    recorded routes, pairs in all)."""
    n = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
            for x, y in zip(a, b))
    return n, sum(x.shape[0] for x in a)


def check_logits(label, seed, cfg, params, tok, checks, extra=None) -> bool:
    """One prompt's prefill logits through the kernels against a plain
    path, for each of ``checks`` (dtype, what is plain, bound, whether the
    control must fail it, why): the attention (the blockwise online softmax,
    which keeps f32 probabilities as ``flash_fwd`` does), the attention and
    the SSD scan (``ssd_chunked``), or the MoE layers (``moe_dense`` in
    place of the main path, the attention through the kernel on both
    sides).  Beside each: the plain path's own spread (the attention that
    rounds its probabilities to the activations' dtype against the
    blockwise one, or ``ssd_chunked`` at chunk 64 against the model's 128),
    a control, ``flash_fwd`` with its last k-step dropped, which must fail
    the bound where the check says so, and for a MoE model the token-layer
    pairs whose top-k expert set differs between the two paths.  ``extra``
    goes into every prefill's batch beside the tokens (frames or patch
    embeddings)."""
    import functools

    import torch

    from repro_torch.kernels.flash import ops as flash_ops

    control = _flash_without_last_kstep(flash_ops.flash_attention)
    prefill = functools.partial(_prefill_logits, extra=extra)
    floors: dict = {}
    ok = True
    for dname, plain, tol, control_fails, why in checks:
        dtype = getattr(torch, dname)
        ssd = "plain" if "SSD" in plain else "kernel"
        moe = "dense" if plain == "MoE" else "main"
        rk, rp = [], []
        lk = prefill(cfg, params, tok, dtype, routes=rk)
        lp = prefill(cfg, params, tok, dtype,
                             "kernel" if moe == "dense" else "blockwise", ssd,
                             moe=moe, routes=rp)
        if ssd == "plain":
            lo = prefill(cfg, params, tok, dtype, "blockwise", ssd, 64)
            floors[(dname, ssd)] = (float((lo - lp).abs().max()),
                                    "plain chunk 64 vs 128")
        elif (dname, ssd) not in floors:
            lb = lp if moe == "main" else prefill(
                cfg, params, tok, dtype, "blockwise", ssd)
            lo = prefill(cfg, params, tok, dtype, "full", ssd)
            floors[(dname, ssd)] = (
                float((lo - lb).abs().max()),
                "plain attention with its probabilities rounded to the "
                "activations' dtype vs blockwise")
        floor, floor_what = floors[(dname, ssd)]
        lc = prefill(cfg, params, tok, dtype, control)
        torch.cuda.synchronize()
        err = float((lk - lp).abs().max())
        ctl = float((lc - lp).abs().max())
        good = (bool(torch.isfinite(lk).all()) and err <= tol
                and (ctl > tol or not control_fails))
        routed = ""
        if rk:
            n, total = _rerouted(rk, rp)
            routed = (f"; token-layer pairs routed to another expert set "
                      f"{n} of {total}")
        print(f"{label}: prefill logits of one {tok.shape[1]}-token "
              f"prompt (seed {seed}, {dname}), kernel path vs plain {plain}: "
              f"max abs diff {err:.6g}, max |logit| "
              f"{float(lp.abs().max()):.4f}, same argmax "
              f"{int(lk.argmax(-1)) == int(lp.argmax(-1))}{routed}; "
              f"{floor_what} (the floor) {floor:.6g}; control, flash_fwd "
              f"with its last k-step dropped, {ctl:.6g}; tol {tol}, kernel "
              f"within{' and control outside' if control_fails else ''}: "
              f"{'ok' if good else 'FAILED'} ({why})", flush=True)
        ok &= good
    return ok


# ---------------------------------------------------------------------------
# the encoder-decoder and the VLM patch prefix
# ---------------------------------------------------------------------------
# Whisper-tiny (arXiv:2212.04356) at every width and depth of its config
# (49.6 M params); LLaVA-NeXT-34B's language backbone at every width, its
# 60 layers cut to 20 for serving (12,074,646,528 params, 45.0 GiB in f32:
# the 60 layers' 128 GiB would not fit one card) and to 2 for training
# (2,033,224,704 params; params, gradients and AdamW moments take ~30
# GiB).  Serving: ``serve_benchmark`` (one prefill on zero frames or zero
# patch embeddings, then ``gen - 1`` greedy ticks); Whisper's 416 + 32 =
# 448 is its decoder's real context.  Training: ``make_train_step`` on a
# batch that carries seeded frames or patch embeddings (0.02 * N(0, 1)),
# ``steps`` steps on the same batch at the slice's ``lr``, so its loss
# falls.  ``logits`` are
# ``check_logits``' rows; ``train_tols`` the (loss, gradient) bounds of
# one step through the kernel against the plain path.
MM_SLICES = {
    "whisper": {"arch": "whisper_tiny", "with": {"use_flash_kernel": True},
                "batch": 8, "prompt": 416, "gen": 32,
                "train": {"batch": 8, "seq": 416, "steps": 3, "lr": 1e-3,
                          "with": {}},
                "logits": [
                    ("bfloat16", "attention", 0.02, True,
                     "bf16 activations through 4 decoder layers (the "
                     "encoder and the cross attention are plain on both "
                     "sides): kernel and blockwise loop sum the same f32 "
                     "products in other orders and round the output once "
                     "to bf16. On an H100 with this seed the kernel reads "
                     "0.0088 and the two plain attentions differ by 0.0098 "
                     "(the floor) at logits of size ~1.6; the bound is "
                     "about twice the larger, and the control reads 0.055"),
                    ("float32", "attention", 5e-6, True,
                     "f32 activations: only f32 sum orders differ. Kernel "
                     "7.2e-7, floor 8.3e-7, control 0.048 on an H100; the "
                     "bound is about six times the larger")],
                "train_tols": {
                    "tols": {"bfloat16": (1e-4, 0.03),
                             "float32": (1e-5, 5e-5)},
                    "zero_leaves": ("/bk",),
                    "why": {
                        "bfloat16": (
                            "bf16 activations and gradients, as Qwen's row "
                            "of TRAIN_TOL_WHY. On an H100 with these seeds "
                            "the kernel's |dloss| 5.1e-5 and worst leaf "
                            "0.0148 (self_attn/wk), the floor's 2.0e-5 and "
                            "0.0115; each bound about twice the larger. The "
                            "key biases (bk) take gradient 0 in exact "
                            "arithmetic and are held against the tree's "
                            "largest gradient (grad_diff)"),
                        "float32": (
                            "f32 sum orders only: kernel worst leaf 3.4e-6, "
                            "floor 4.8e-6, |dloss| 0 on an H100; the "
                            "gradient bound about ten times the larger, "
                            "the loss bound Qwen's")}}},
    "llava": {"arch": "llava_next_34b",
              "with": {"use_flash_kernel": True, "n_layers": 20},
              "batch": 4, "prompt": 448, "gen": 32,
              # a 7168-wide model takes a smaller step than the reduced
              # quickstart's lr 1e-3: on an H100 at 1e-3 the third step
              # overshoots (losses 12.48, 5.67, 13.48), at 1e-4 the second
              # saturates the head on the one batch (12.48, 1.38, 0.0)
              "train": {"batch": 2, "seq": 448, "steps": 3, "lr": 1e-5,
                        "with": {"n_layers": 2}},
              "logits": [
                  ("bfloat16", "attention", 0.3, True,
                   "bf16 activations through 20 layers behind 576 patch "
                   "rows: kernel and blockwise loop sum the same f32 "
                   "products in other orders and round the output once to "
                   "bf16; each difference grows through the later layers. "
                   "On an H100 with this seed the kernel reads 0.126 and "
                   "the floor 0.137 at logits of size ~7; the bound is "
                   "about twice the larger, and the control reads 3.34"),
                  ("float32", "attention", 2e-4, True,
                   "f32 activations: only f32 sum orders differ. Kernel "
                   "3.6e-5, floor 4.3e-5, control 3.38 on an H100; the "
                   "bound is about five times the larger")],
              "train_tols": {
                  "tols": {"bfloat16": (1e-3, 0.035),
                           "float32": (1e-5, 7e-5)},
                  "why": {
                      "bfloat16": (
                          "bf16 activations and gradients, as Qwen's row "
                          "of TRAIN_TOL_WHY, at depth 2 behind 576 patch "
                          "rows. On an H100 with these seeds the kernel's "
                          "|dloss| 4.3e-4 and worst leaf 0.0163 "
                          "(attn/wk), the floor's 4.5e-4 and 0.0165; each "
                          "bound about twice the larger"),
                      "float32": (
                          "f32 sum orders only: kernel worst leaf 6.5e-6, "
                          "floor 6.0e-6, |dloss| 0 on an H100; the "
                          "gradient bound about ten times the larger, the "
                          "loss bound Qwen's")}}},
}
# the decode check teacher-forces the shim's first MM_DECODE_REQUESTS
# requests along their generated tokens, at the shim's own cache length
# and positions, in f32, against ``apply`` (JAX's bound)
MM_DECODE_REQUESTS, MM_DECODE_TOL = 2, 5e-4


def mm_extra(cfg, B, device, seed=None):
    """The modality inputs of a batch of ``B``: Whisper's ``frames``, a
    VLM's ``patch_embeds``; zeros (the serve shim's) without ``seed``, else
    0.02 * N(0, 1) from ``seed``."""
    import torch

    def make(shape):
        if seed is None:
            return torch.zeros(shape, device=device)
        g = torch.Generator(device=device).manual_seed(seed)
        return 0.02 * torch.randn(shape, generator=g, device=device)

    if cfg.arch_type == "audio":
        return {"frames": make((B, cfg.encoder_frames, cfg.d_model))}
    return {"patch_embeds": make((B, cfg.n_patches, cfg.d_model))}


def mm_decode_check(key, cfg, params, spec, res) -> bool:
    """The shim's first requests teacher-forced along their generated
    tokens through ``prefill`` and ``decode_step`` at the shim's cache
    length ``n_patches + P + G`` and positions ``n_patches + P + i``, in
    f32, against ``apply`` on the same inputs (for the VLM, the card's
    proof that the port keeps the prompt that JAX's shim drops)."""
    import numpy as np
    import torch

    n, P, G = cfg.n_patches, spec["prompt"], spec["gen"]
    R = MM_DECODE_REQUESTS
    prompts = np.random.default_rng(1).integers(
        3, cfg.vocab, size=(spec["batch"], P), dtype=np.int32)[:R]
    tok = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
    gen = torch.as_tensor(res["generated_ids"][:R], dtype=torch.int64,
                          device="cuda")
    extra = mm_extra(cfg, R, "cuda")
    model, stack = _patched(cfg, torch.float32)
    with stack, torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tok, **extra},
                                      max_len=n + P + G,
                                      cache_dtype=torch.float32)
        outs = [logits.float()]
        for j in range(G - 1):
            logits, cache = model.decode_step(
                params, cache, gen[:, j],
                torch.full((R,), n + P + j, dtype=torch.int64, device="cuda"))
            outs.append(logits.float())
        dec = torch.stack(outs, 1)
        del cache
        full, _ = model.apply(params, {"tokens": torch.cat(
            [tok, gen[:, :G - 1]], 1), **extra})
        want = full[:, n + P - 1:].float()
    torch.cuda.synchronize()
    err = float((dec - want).abs().max())
    same = bool((dec.argmax(-1) == want.argmax(-1)).all())
    good = bool(torch.isfinite(dec).all()) and err <= MM_DECODE_TOL
    print(f"slice {key}: decode (f32) of {R} requests teacher-forced along "
          f"the shim's tokens, cache {n + P + G} rows, positions {n + P}.."
          f"{n + P + G - 2}, vs apply: max abs diff {err:.6g}, max |logit| "
          f"{float(want.abs().max()):.4f}, same argmax {same}; tol "
          f"{MM_DECODE_TOL} (JAX's, tests/test_decode_consistency.py): "
          f"{'ok' if good else 'FAILED'}", flush=True)
    return good


def phase_mm_serve(key: str, results: dict, card: str,
                   profile_dir: str = "") -> bool:
    """``serve_benchmark`` on the slice through ``flash_fwd`` (one prefill:
    the decoder's layers launch it once each), its tokens, the prefill
    logits through the kernel against the plain attention with a control
    (``check_logits``), and the decode check."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_benchmark
    from repro_torch.models import build_model
    from repro_torch.serve.engine import load_params
    from repro_torch.tree import tree_leaves

    spec = MM_SLICES[key]
    B, P, G = spec["batch"], spec["prompt"], spec["gen"]
    cfg = get_config(spec["arch"]).with_(**spec["with"])
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = load_params(model, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(int(t.numel()) for t in tree_leaves(params))
    print(f"slice {key}: {cfg.name} full width ({cfg.n_layers} decoder "
          f"layers, {cfg.n_encoder_layers} encoder layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of "
          f"{cfg.head_dim_}, vocab {cfg.vocab}, {cfg.n_patches} patches), "
          f"{n_params} params, seeded init {time.perf_counter() - t0:.2f}s",
          flush=True)
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    res = serve_benchmark(model, batch=B, prompt_len=P, gen=G, seed=0,
                          params=params, device="cuda", log=_quiet)
    wall = time.perf_counter() - t0
    counts = {name: c.launches for name, c in counters.items()}
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {"flash_fwd": cfg.n_layers, "ssd_scan": 0}
    ok = counts == want
    print(f"slice {key}: launches over serve_benchmark {counts} (want "
          f"{want}: {cfg.n_layers} decoder layers x 1 prefill)", flush=True)
    add_launches(results, counts)
    ids = res["generated_ids"]
    tokens_ok = (len(ids) == B and all(
        len(r) == G and all(0 <= t < cfg.vocab for t in r) for r in ids))
    ok &= tokens_ok
    print(f"slice {key}: {len(ids)} requests, each {G} tokens in [0, "
          f"{cfg.vocab}): {tokens_ok}; prefill of {B} x ({cfg.n_patches} + "
          f"{P}) rows{' + 1500 frames' if cfg.arch_type == 'audio' else ''} "
          f"{res['prefill_s']}s (prefill_tok_s {res['prefill_tok_s']}, B x P "
          f"as JAX counts), decode {res['decode_steps']} ticks "
          f"{res['decode_s']}s (decode_tok_s {res['decode_tok_s']}, "
          f"{1e3 * res['decode_s'] / max(res['decode_steps'], 1):.3f} ms a "
          f"tick), call {wall:.3f}s, peak_mem_gib {peak_gib:.3f}; {card}",
          flush=True)
    prompt = np.random.default_rng(1).integers(
        3, cfg.vocab, size=(1, P), dtype=np.int32)
    tok = torch.as_tensor(prompt, dtype=torch.int64, device="cuda")
    label = f"slice {key}" + (f" ({cfg.n_patches} patch rows + prompt)"
                              if cfg.n_patches else " (1500 frames)")
    ok &= check_logits(label, 1, cfg, params, tok, spec["logits"],
                       extra=mm_extra(cfg, 1, "cuda", seed=1))
    ok &= mm_decode_check(key, cfg, params, spec, res)
    if profile_dir:
        profile_mm(key, model, params, spec, profile_dir)
    del params, res
    _free()
    return bool(ok)


def profile_mm(key, model, params, spec, out_dir: str) -> None:
    """The shim's two calls at the slice's shape under ``torch.profiler``:
    its prefill of the whole batch and one decode tick."""
    import torch

    from repro_torch.train.steps import make_serve_step

    os.makedirs(out_dir, exist_ok=True)
    cfg = model.cfg
    B, P, G = spec["batch"], spec["prompt"], spec["gen"]
    max_len = cfg.n_patches + P + G
    tok = torch.randint(3, cfg.vocab, (B, P), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(2))
    batch = {"tokens": tok, **mm_extra(cfg, B, "cuda")}
    profile_call(f"{key}_prefill",
                 lambda: model.prefill(params, batch, max_len=max_len),
                 out_dir)
    logits, cache = model.prefill(params, batch, max_len=max_len)
    step = make_serve_step(model)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    pos = torch.full((B,), cfg.n_patches + P, dtype=torch.int64,
                     device="cuda")
    profile_call(f"{key}_decode_tick",
                 lambda: step(params, cache, nxt, pos), out_dir)


def phase_mm_train(key: str, results: dict, card: str,
                   profile_dir: str = "") -> bool:
    """``make_train_step`` with AdamW (the quickstart's weight decay and
    clip, the slice's ``lr``) on one
    batch that carries seeded frames or patch embeddings, ``steps`` times:
    losses finite and falling, ``flash_fwd`` launched by every decoder
    layer in the forward and the remat recompute of each step; then one
    step's loss and gradients through the kernel against the plain path
    (``compare_train_step``)."""
    import math
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import tree_leaves

    spec = MM_SLICES[key]
    tr = spec["train"]
    B, S, steps = tr["batch"], tr["seq"], tr["steps"]
    cfg = get_config(spec["arch"]).with_(**{**spec["with"], **tr["with"]})
    model = build_model(cfg)
    toks = np.random.default_rng(3).integers(3, cfg.vocab, size=(B, S),
                                             dtype=np.int64)
    batch = {"tokens": torch.as_tensor(toks, device="cuda"),
             "labels": torch.as_tensor(np.roll(toks, -1, axis=1),
                                       device="cuda"),
             **mm_extra(cfg, B, "cuda", seed=4)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    opt = AdamW(lr=tr["lr"], weight_decay=0.1, grad_clip=1.0)
    params = model.init(gen)
    n_params = sum(int(t.numel()) for t in tree_leaves(params))
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    step = make_train_step(model, opt)
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    losses, step_ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    counts = {name: c.launches for name, c in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {"flash_fwd": cfg.n_layers * 2 * steps, "ssd_scan": 0}
    rows = cfg.n_patches + S
    med = statistics.median(step_ms[1:])
    ok = (counts == want and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0])
    print(f"train {key}: {cfg.name} full width, {cfg.n_layers} decoder "
          f"layers, {n_params} params, batch {B} x ({cfg.n_patches} + {S}) "
          f"rows{' + 1500 frames' if cfg.arch_type == 'audio' else ''}, "
          f"remat {cfg.remat}, {steps} steps on one batch: loss per step "
          f"{json.dumps([round(x, 5) for x in losses])}, final < first "
          f"{losses[-1] < losses[0]}", flush=True)
    print(f"train {key}: launches {counts} (want {want}: {cfg.n_layers} "
          f"layers x 2 (forward and remat recompute) x {steps} steps); "
          f"ms/step {json.dumps([round(x, 3) for x in step_ms])}, median of "
          f"steps 2-{steps} {med:.3f} ms, {B * rows / (med / 1e3):.1f} "
          f"rows/s, peak_mem_gib {peak_gib:.3f}; {card}", flush=True)
    add_launches(results, counts)
    if profile_dir:
        del state["opt"]
        _free()
        profile_train_step(key, cfg, state["params"], batch, profile_dir)
    del state, params
    _free()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    ok &= compare_train_step(key, cfg, params, batch,
                             spec=spec["train_tols"])
    del params, batch
    _free()
    return bool(ok)


# ---------------------------------------------------------------------------
# post-training and DeepSeek-V3 under sharding plans (ROADMAP A8b's third
# part), each run beside the same run with no mesh on a (1, 1) NCCL mesh
# ---------------------------------------------------------------------------
A8B_SFT_STEPS, A8B_DPO_STEPS, A8B_DSV3_STEPS = 3, 2, 2
# (a)-(c)'s Qwen at 12 of its 24 layers since PR 30, for the script's time
A8B_POST_LAYERS = 12
# on-policy pairs: a smaller draw than the posttrain phase's (the sampler
# and the engine are the same code with and without the plan)
A8B_ONPOLICY = {"n_prompts": 4, "prompt_len": 64, "gen_tokens": 32,
                "temperature": 0.9, "n_slots": 4, "seed": 0}
# DeepSeek-V3's shim at DSV3_TRAIN_LAYERS: batch SLICE_BATCH, this prompt
A8B_DSV3_PROMPT = 256
A8B_DECODE = {"batch": 8, "cache": 1024, "timed": 3}
A8B_DRYRUN_SHAPES = ("train_4k", "decode_32k")
# the full-width DeepSeek-V3-671B dryruns, each a CLI child on the host
A8B_DRYRUN_SETS = ["arch.variant_key=deepseek_v3_671b",
                   "arch.config.scan_block_size=1",
                   "plan.variant_key=fsdp_tp_ep"]


def _plan_sets(plan: str) -> list:
    """The document sets that put a gym under ``plan`` on a ``local``
    ``(1, 1)`` mesh."""
    return ["mesh={component_key: mesh_provider, variant_key: local, "
            "config: {dp: 1, tp: 1}}",
            "gym.config.mesh_provider={instance_key: mesh}",
            f"gym.config.sharding_plan={{component_key: sharding_plan, "
            f"variant_key: {plan}}}"]


def _a8b_drive(doc, results):
    """One run-API call on the card with every launch counter set to 0 just
    before it: (result, final state, launches, peak GiB, ms/step, wall s,
    logs)."""
    import gc

    import torch

    from repro_torch.run import api

    logs = []
    gc.collect()
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with _RunCapture() as cap:
        res = api.execute_doc(doc, device="cuda", write_result=True,
                              log=logs.append)
    torch.cuda.synchronize()
    counts = {n: c.launches for n, c in counters.items()}
    add_launches(results, counts)
    return (res, cap.out["state"], counts,
            torch.cuda.max_memory_allocated() / 2**30,
            _step_ms(res["history"]), time.perf_counter() - t0, logs, cap.gym)


def _host(tree):
    """A param tree's full tensors on the host (a DTensor gathered)."""
    from repro_torch.models.base import is_dtensor

    return {k: (v.full_tensor() if is_dtensor(v) else v).detach().cpu()
            for k, v in _flat(tree)}


def _same(a: dict, b: dict) -> tuple:
    """(bit-equal, max |d|) of two trees of the same leaves."""
    bit = _trees_equal(a, b)
    return bit, 0.0 if bit else _max_diff(a, b)


def _ms(ms) -> str:
    import statistics

    med = statistics.median(ms) if ms else float("nan")
    return f"ms/step {json.dumps([round(x, 3) for x in ms])} (median {med:.3f})"


def _a8b_post_qwen(data_dir: str, results: dict, card: str) -> bool:
    """(a) ``sft`` under ``fsdp_tp``, (c) its adapters across layouts and
    its merged export, (b) ``dpo`` under ``fsdp`` on static and on-policy
    pairs: full-width Qwen1.5-0.5B through ``flash_fwd`` (8 x 1024,
    ``remat: full``), LoRA rank 8 on a fresh init, each run beside the run
    with no mesh."""
    import math

    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as MESH
    from repro_torch.models import build_model
    from repro_torch.posttrain import dpo as DPO
    from repro_torch.posttrain import lora as LO
    from repro_torch.sharding import plans as PL

    tag = f"[{card}]"
    base_sets = ["arch.config.reduced=false", f"variables.seq_len={TRAIN_SEQ}",
                 f"loader.config.global_batch={TRAIN_BATCH}",
                 *TRAIN_SLICES["qwen"]["sets"], "gym.config.log_every=1",
                 "gym.config.prefetch=0",
                 f"arch.config.n_layers={A8B_POST_LAYERS}"]
    layers = A8B_POST_LAYERS

    def doc_for(kind, name, settings, dataset, plan, *sets):
        doc = train_doc(data_dir, "a8b_qwen", *base_sets, *sets,
                        *(_plan_sets(plan) if plan else ()))
        doc["dataset"] = {"component_key": "dataset", "variant_key": dataset[0],
                          "config": {"seq_len": "${seq_len}",
                                     "vocab": "${vocab}", **dataset[1]}}
        doc["run"] = {"kind": kind, "name": name,
                      "output_dir": os.path.join(data_dir, name),
                      kind: {"lora": dict(POST_LORA), **settings}}
        return doc

    ok = True
    # (a) sft: 3 steps with no mesh, then under fsdp_tp
    sft_data = ("sft_synthetic", POST_SFT_DATA)
    runs = {}
    for plan in (None, "fsdp_tp"):
        name = f"a8b_sft_{plan or 'nomesh'}"
        res, state, counts, peak, ms, wall, logs, gym = _a8b_drive(doc_for(
            "sft", name, {"steps": A8B_SFT_STEPS, "export_merged": True},
            sft_data, plan), results)
        layout = True
        if plan:
            sh = dict(_flat(gym._state_sh["params"]))
            layout = all(isinstance(v, DTensor) and list(v.placements)
                         == list(sh[k].placements)
                         for k, v in _flat(state["params"]))
        runs[plan] = dict(res=res, params=_host(state["params"]),
                          counts=counts, peak=peak, ms=ms, wall=wall,
                          layout=layout, warnings=getattr(
                              gym, "shard_warnings", []))
        del state, gym
        _free()
    b, m = runs[None], runs["fsdp_tp"]
    init = LO.LoRAModel(build_model(get_config("qwen1p5_0p5b").with_(
        n_layers=layers)), LO.LoRAConfig(**POST_LORA))
    p0 = _host(init.init(torch.Generator(device="cuda").manual_seed(0)))
    base_bit = _trees_equal(
        *({k: v for k, v in t.items() if not LO.is_adapter_path(k)}
          for t in (m["params"], p0)))
    bit, dmax = _same(m["params"], b["params"])
    bl, ml = ([h["loss"] for h in r["res"]["history"]] for r in (b, m))
    want = {"flash_fwd": 2 * layers * A8B_SFT_STEPS, "ssd_scan": 0}
    a_ok = (bit and base_bit and bl == ml and m["layout"]
            and m["counts"] == b["counts"] == want
            and all(map(math.isfinite, ml)))
    print(f"a8b_post (a) qwen sft under fsdp_tp on a (1, 1) mesh: {layers} "
          f"layers, LoRA rank "
          f"{POST_LORA['rank']}, {A8B_SFT_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}; losses {json.dumps([round(x, 5) for x in ml])} vs "
          f"no mesh {json.dumps([round(x, 5) for x in bl])} bit-equal "
          f"{bl == ml}; params (adapters and base) bit-equal {bit} (max |d| "
          f"{dmax:.3g}, tol {MESH_TOL[0]}); {len(p0)} leaves, the frozen base "
          f"== its init {base_bit}; every param leaf a DTensor with the "
          f"plan's placements {m['layout']}; launches {m['counts']} (want "
          f"{want}: {2 * layers} a step); {_ms(m['ms'])} vs no mesh "
          f"{_ms(b['ms'])}; "
          f"peak {m['peak']:.3f} vs {b['peak']:.3f} GiB; shard warnings "
          f"{len(m['warnings'])} {tag}: {'ok' if a_ok else 'FAILED'}",
          flush=True)
    ok &= a_ok

    # (c) the adapter checkpoint written under fsdp_tp, with no mesh and
    # under ddp; the merged export under the plan against no mesh's
    adir = os.path.dirname(m["res"]["adapter_ckpt"])
    lm = init
    fresh = lm.init(torch.Generator(device="cuda").manual_seed(0))
    got = _host(LO.load_adapter(fresh, adir))
    nomesh_ok, _ = _same(got, m["params"])
    mesh = MESH.make_local_mesh(1, 1, device_type="cuda")
    ddp = PL.make_plan("ddp")
    sh, _ = PL.param_shardings(ddp, mesh, fresh, lm.param_axes())
    dgot = LO.load_adapter(PL.distribute(fresh, sh), adir, shardings=sh)
    shd = dict(_flat(sh))
    ddp_layout = all(isinstance(v, DTensor) and list(v.placements)
                     == list(shd[k].placements)
                     for k, v in _flat(dgot) if LO.is_adapter_path(k))
    ddp_ok, _ = _same(_host(dgot), m["params"])
    del fresh, dgot, got
    ea, eb = (np.load(r["res"]["merged_export"]) for r in (m, b))
    export_ok = sorted(ea.files) == sorted(eb.files) and all(
        np.array_equal(ea[k], eb[k]) for k in ea.files)
    n_export = len(ea.files)
    del ea, eb
    c_ok = nomesh_ok and ddp_ok and ddp_layout and export_ok
    print(f"a8b_post (c) adapters across layouts: the fsdp_tp run's adapter "
          f"checkpoint {adir} restored with no mesh == {nomesh_ok}, through "
          f"load_adapter(shardings=) under ddp == {ddp_ok} (the plan's "
          f"placements {ddp_layout}); export_merged under fsdp_tp (rank 0 "
          f"writes, each leaf gathered) == the no-mesh export, {n_export} "
          f"arrays: {export_ok} {tag}: {'ok' if c_ok else 'FAILED'}",
          flush=True)
    ok &= c_ok
    del runs, b, m, p0, init, lm
    _free()

    # (b) dpo under fsdp: static pairs, then on-policy pairs
    dpo_data = ("preference_synthetic", POST_DPO_DATA)
    per_dpo = 2 * layers * 2 + 2 * layers
    rows = {}
    for plan in (None, "fsdp"):
        res, state, counts, peak, ms, wall, _, _ = _a8b_drive(doc_for(
            "dpo", f"a8b_dpo_{plan or 'nomesh'}",
            {"steps": A8B_DPO_STEPS, "beta": 0.1}, dpo_data, plan,
            f"loader.config.global_batch={POST_DPO_BATCH}", *POST_DPO_OPT),
            results)
        rows[plan] = (res, _host(state["params"]), counts, peak, ms)
        del state
        _free()
    (br, bp, bc, bpk, bms), (mr, mp, mc, mpk, mms) = rows[None], rows["fsdp"]
    hist = [(h["loss"], h["margin"]) for h in mr["history"]]
    first = hist[0][0] if hist else math.nan
    bit, dmax = _same(mp, bp)
    want = {"flash_fwd": per_dpo * A8B_DPO_STEPS, "ssd_scan": 0}
    b_ok = (hist == [(h["loss"], h["margin"]) for h in br["history"]]
            and bit and abs(first - math.log(2)) <= 1e-6
            and mc == bc == want)
    print(f"a8b_post (b) qwen dpo under fsdp: {A8B_DPO_STEPS} steps of "
          f"{POST_DPO_BATCH} static pairs of {TRAIN_SEQ} tokens; (loss, "
          f"margin) {json.dumps([[round(x, 6) for x in r] for r in hist])} "
          f"== no mesh {hist == [(h['loss'], h['margin']) for h in br['history']]}"
          f", first loss {first!r} (log 2 within 1e-6); params bit-equal "
          f"{bit} (max |d| {dmax:.3g}); launches {mc} (want {want}: "
          f"{per_dpo} a step); {_ms(mms)} vs no mesh {_ms(bms)}; peak {mpk:.3f} vs "
          f"{bpk:.3f} GiB {tag}: {'ok' if b_ok else 'FAILED'}", flush=True)
    ok &= b_ok
    del rows, bp, mp
    _free()
    flash = _counters()["flash_fwd"]
    drawn = {}
    real = DPO.sample_onpolicy_pairs

    def recorded(*a, **kw):
        before = flash.launches
        pairs = real(*a, **kw)
        drawn[key] = (pairs, flash.launches - before)
        return pairs

    for key in (None, "fsdp"):
        with mock.patch.object(DPO, "sample_onpolicy_pairs", recorded):
            res, state, *_ = _a8b_drive(doc_for(
                "dpo", f"a8b_dpo_onpolicy_{key or 'nomesh'}",
                {"steps": 1, "beta": 0.1, "onpolicy": dict(A8B_ONPOLICY)},
                dpo_data, key, *POST_DPO_OPT), results)
        drawn[key] = drawn[key] + (res["history"][0]["loss"],)
        del state
        _free()
    (pb, nb, lb), (pm, nm, lm_) = drawn[None], drawn["fsdp"]
    same_pairs = len(pb) == len(pm) == A8B_ONPOLICY["n_prompts"] and all(
        np.array_equal(x, y) for p, q in zip(pb, pm) for x, y in zip(p, q))
    o_ok = same_pairs and nb == nm == 0 and lb == lm_
    print(f"a8b_post (b) on-policy: {A8B_ONPOLICY['n_prompts']} prompts x 2 "
          f"samples of {A8B_ONPOLICY['prompt_len']} + "
          f"{A8B_ONPOLICY['gen_tokens']} tokens (the merged params gathered, "
          f"an engine with no mesh): pairs under fsdp == no mesh's "
          f"{same_pairs}, flash_fwd while sampling {nm} and {nb}; the step's "
          f"loss {lm_!r} == {lb!r} {tag}: {'ok' if o_ok else 'FAILED'}",
          flush=True)
    ok &= o_ok
    _free()
    return bool(ok)


def _a8b_engine(mesh, results: dict, card: str) -> bool:
    """(d) the engine over the LoRA model under ``fsdp_tp`` beside the
    engine over ``merge(params)`` with no mesh: full-width Qwen at
    ``ENGINE_QWEN_LAYERS``, paged, 8 requests of the Engines cell's
    traffic (``SERVE_MESH_ENGINE_TRACE``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.posttrain import lora as LO
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.workload import shared_prefix_trace
    from repro_torch.sharding import plans as PL
    from repro_torch.tree import tree_map

    cfg = get_config("qwen1p5_0p5b").with_(use_flash_kernel=True,
                                           n_layers=ENGINE_QWEN_LAYERS)
    lm = LO.LoRAModel(build_model(cfg), LO.LoRAConfig(**POST_LORA))
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    params[LO.ADAPTER_KEY] = tree_map(
        lambda t: t + 0.02 * torch.randn(t.shape, generator=gen,
                                         device="cuda"),
        params[LO.ADAPTER_KEY])
    with torch.no_grad():
        merged = lm.merge(params)
    t = SERVE_MESH_ENGINE_TRACE
    rows = {}
    for label, model, p, kw in (
            ("no mesh", lm.base, merged, {}),
            ("fsdp_tp", lm, params,
             {"mesh": mesh, "plan": PL.make_plan("fsdp_tp")})):
        trace = shared_prefix_trace(
            t["n_requests"], cfg.vocab, prefix_len=t["prefix_len"],
            n_prefixes=t["n_prefixes"], seed=0, prompt_lens=t["prompt_lens"],
            gen_tokens=t["gen_tokens"], max_len=ENGINE_QWEN["max_len"],
            **SAMPLING)
        for r in trace[::4]:
            r.temperature = 0.0
        engine = ServeEngine(model, p, **ENGINE_QWEN, **kw)
        counters = _counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        res = engine.run(trace, realtime=False)
        torch.cuda.synchronize()
        counts = {n: c.launches for n, c in counters.items()}
        add_launches(results, counts)
        rows[label] = (res, counts, torch.cuda.max_memory_allocated() / 2**30)
        del engine
        _free()
    (b, bc, bp), (m, mc, mp) = rows["no mesh"], rows["fsdp_tp"]
    streams = [r["gen_ids"] for r in m["requests"]]
    same = streams == [r["gen_ids"] for r in b["requests"]]
    ok = (same and m["completed"] == t["n_requests"]
          and m["prefill_cache_hit_rate"] == b["prefill_cache_hit_rate"] > 0
          and mc == bc == {n: 0 for n in _counters()})
    print(f"a8b_post (d) the engine over the LoRA model (rank "
          f"{POST_LORA['rank']}, b perturbed) under fsdp_tp: Qwen at "
          f"{ENGINE_QWEN_LAYERS} of 24 layers, paged, {t['n_requests']} "
          f"requests of the Engines cell's traffic, {t['gen_tokens'][0]} "
          f"tokens, every fourth greedy; {m['tok_s']} tok/s, decode "
          f"{m['decode_tok_s']} tok/s, tpot p50 {m['tpot_ms']['p50']:.3f} ms, "
          f"hit rate {m['prefill_cache_hit_rate']}, peak {mp:.3f} GiB; the "
          f"engine over merge(params) with no mesh: {b['tok_s']} tok/s, "
          f"decode {b['decode_tok_s']} tok/s, tpot p50 "
          f"{b['tpot_ms']['p50']:.3f} ms, hit rate "
          f"{b['prefill_cache_hit_rate']}, peak {bp:.3f} GiB; streams equal "
          f"{same}; launches {mc} [{card}]: {'ok' if ok else 'FAILED'}",
          flush=True)
    del params, merged, lm
    _free()
    return bool(ok)


def _a8b_dsv3(data_dir: str, mesh, results: dict, card: str) -> bool:
    """(e) full-width DeepSeek-V3 at ``DSV3_TRAIN_LAYERS`` (the dense MLA
    layers) with the MTP head: 2 gym steps under ``fsdp_tp`` beside the
    no-mesh run, then its shim under ``fsdp_tp`` with the expanded and the
    absorbed decode beside the shim with no mesh."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import load_params

    spec = {"steps": A8B_DSV3_STEPS, "sets": TRAIN_SLICES["dsv3"]["sets"]}
    runs = {}
    for plan in (None, "fsdp_tp"):
        gym, out, counts, peak, med, ms = _mesh_run(data_dir, "a8b_dsv3",
                                                    spec, plan)
        add_launches(results, counts)
        hist = out["history"]
        runs[plan] = ([{k: h[k] for k in ("ce", "mtp", "router_lb")}
                       for h in hist], _host(out["state"]["params"]), counts,
                      peak, ms, gym.model.cfg)
        del gym, out
        _free()
    (bh, bp, bc, bpk, bms, cfg), (mh, mp, mc, mpk, mms, _) = \
        runs[None], runs["fsdp_tp"]
    bit, dmax = _same(mp, bp)
    zero = {n: 0 for n in _counters()}
    ok = (mh == bh and bit and mc == bc == zero
          and all(math.isfinite(h["mtp"]) and h["mtp"] > 0 for h in mh))
    print(f"a8b_post (e) dsv3 train: {cfg.name} full width, "
          f"{cfg.n_layers} MLA layers + the MTP head, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, {A8B_DSV3_STEPS} gym steps under fsdp_tp on a (1, 1) "
          f"mesh: (ce, mtp, router_lb) {json.dumps(mh)} == no mesh "
          f"{mh == bh}; final params bit-equal {bit} (max |d| {dmax:.3g}); "
          f"launches {mc} (want {zero}: MLA is einsums); {_ms(mms)} vs no "
          f"mesh {_ms(bms)}; peak {mpk:.3f} vs {bpk:.3f} GiB [{card}]: "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    del runs, bp, mp
    _free()
    shim = {"plan": "fsdp_tp", "prompt": A8B_DSV3_PROMPT}
    params = None
    for absorb in (False, True):
        c = get_config("deepseek_v3_671b").with_(n_layers=DSV3_TRAIN_LAYERS,
                                                 mla_absorb=absorb)
        model = build_model(c)
        if params is None:     # the absorbed decode reads the same params
            params = load_params(model, seed=0, device="cuda")
        b, bc, bpk, bw = _shim_run(model, params, shim)
        m, mc, mpk, mw = _shim_run(model, params, shim, mesh)
        add_launches(results, bc)
        add_launches(results, mc)
        same = m["generated_ids"] == b["generated_ids"]
        s_ok = same and mc == bc == zero
        print(f"a8b_post (e) dsv3 shim, {'absorbed' if absorb else 'expanded'}"
              f" decode, {c.n_layers} layers, {SLICE_BATCH} x "
              f"{A8B_DSV3_PROMPT} x {SLICE_GEN} under fsdp_tp: "
              f"{_shim_line(m, mc, mpk, mw)}; no mesh: "
              f"{_shim_line(b, bc, bpk, bw)}; streams equal {same} "
              f"[{card}]: {'ok' if s_ok else 'FAILED'}", flush=True)
        ok &= s_ok
        del model
        _free()
    del params
    _free()
    return bool(ok)


def _a8b_dsv3_decode(results: dict, card: str) -> bool:
    """(e) one absorbed DeepSeek-V3 decode step at ``DSV3_TRAIN_LAYERS``
    (``A8B_DECODE``'s slots and cache) under ``fsdp_tp`` beside its
    dryrun (:func:`_decode_vs_dryrun`)."""
    from repro_torch.configs import get_config

    cfg = get_config("deepseek_v3_671b").with_(n_layers=DSV3_TRAIN_LAYERS,
                                               mla_absorb=True)
    return _decode_vs_dryrun("a8b_post (e) dsv3 absorbed decode step", cfg,
                             "fsdp_tp", results, card)


def _decode_vs_dryrun(label: str, cfg, plan_name: str, results: dict,
                      card: str) -> bool:
    """One decode step of ``cfg`` (``A8B_DECODE``'s slots and cache) under
    ``plan_name`` on a ``(1, 1)`` mesh under the dryrun's counter, beside
    its dryrun on a fake world of one: FLOPs, bytes, collectives and
    argument bytes equal, no kernel launched (a decode step has none)."""
    import torch

    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch.hlo_analysis import CostCounter
    from repro_torch.models import build_model
    from repro_torch.sharding import plans as PL

    d = A8B_DECODE
    shape = InputShape("card", d["cache"], d["batch"], "decode")
    plan = PL.make_plan(plan_name)
    dry = DR.compile_run(cfg, shape, MESH.LocalMesh(1, 1), plan)
    try:
        mesh = MESH.make_local_mesh(1, 1, device_type="cuda")
        setup = DR.build_step(build_model(cfg), shape, mesh, plan,
                              device="cuda")
        counters = _counters()
        for c in counters.values():
            c.launches = 0
        with CostCounter(arguments=setup.args) as counter:
            out = setup.fn(*setup.args)
            torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        add_launches(results, launches)
        ana, mem = counter.analyze(), counter.memory(setup.args, out)
        ms = []
        for _ in range(d["timed"]):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
            setup.fn(*setup.args)
            t1.record()
            torch.cuda.synchronize()
            ms.append(t0.elapsed_time(t1))
        tok = out[0]
        ok = (ana["flops"] == dry["hlo_flops_per_dev"]
              and ana["bytes"] == dry["hlo_bytes_per_dev"]
              and ana["collective_counts"] == dry["collective_counts"]
              and mem["mem_argument_size_in_bytes"]
              == dry["mem_argument_size_in_bytes"]
              and tok.shape == (d["batch"],) and 0 <= int(tok.min())
              and int(tok.max()) < cfg.vocab
              and all(n == 0 for n in launches.values()))
        roofline = max(dry["compute_term_s"], dry["memory_term_s"],
                       dry["collective_term_s"])
        print(f"{label}, {cfg.n_layers} layers, batch {d['batch']} x cache "
              f"{d['cache']} under {plan_name}: flops/device card "
              f"{ana['flops']!r} vs dryrun {dry['hlo_flops_per_dev']!r}; "
              f"bytes/device card {ana['bytes']!r} vs dryrun "
              f"{dry['hlo_bytes_per_dev']!r}; collectives card "
              f"{ana['collective_counts']} vs dryrun "
              f"{dry['collective_counts']}; arguments card "
              f"{mem['mem_argument_size_in_bytes']} B vs dryrun "
              f"{dry['mem_argument_size_in_bytes']} B; launches {launches};"
              f" ms/step {json.dumps([round(x, 3) for x in ms])} vs "
              f"max(terms) {roofline * 1e3:.4f} ms (dominant "
              f"{dry['dominant_term']}) [{card}]: "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        del setup, out
    finally:
        MESH.shutdown()
        _free()
    return bool(ok)


def _a8b_dryrun_start(out_dir: str) -> dict:
    """(f) the full-width DeepSeek-V3-671B dryruns of ``A8B_DRYRUN_SHAPES``
    under ``fsdp_tp_ep`` on the production mesh's 256 fake ranks: each
    ``dryrun.yaml`` with ``A8B_DRYRUN_SETS`` through the CLI in a child on
    the host, started here while the card runs the rest of the phase."""
    cfgs = os.path.join(ROOT, "examples", "configs")
    procs = {}
    for shape in A8B_DRYRUN_SHAPES:
        cwd = os.path.join(out_dir, f"dsv3_{shape}")
        os.makedirs(cwd)
        argv = ["dryrun", "--config", os.path.join(cfgs, "dryrun.yaml"),
                "--json", os.path.join(cwd, "result.json")]
        for s in A8B_DRYRUN_SETS + [f"shape.variant_key={shape}"]:
            argv += ["--set", s]
        procs[shape] = (time.perf_counter(), _dryrun_cli(argv, cwd), cwd)
    return procs


def _a8b_dryrun_check(procs: dict, card: str) -> bool:
    """(f)'s checks once its children end: the plan, no sharding warning,
    the collectives counted, ``model_flops_global`` == 6·N·D of the active
    params, and each child's word that it never initialised CUDA."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.telemetry.accounting import model_flops

    ok = True
    for shape, (t0, proc, cwd) in procs.items():
        text, _ = proc.communicate(timeout=900)
        wall = time.perf_counter() - t0
        res = {}
        path = os.path.join(cwd, "result.json")
        if os.path.exists(path):
            with open(path) as f:
                res = json.load(f)
        clean = "cuda_initialized=False" in text
        want = model_flops(get_config("deepseek_v3_671b"), SHAPES[shape])[0]
        d_ok = (proc.returncode == 0 and clean and res.get("chips") == 256
                and res.get("model_flops_global") == want
                and res.get("plan", "").startswith("fsdp_tp_ep(")
                and res.get("sharding_warnings") == []
                and res.get("collective_counts", {}).get("all-gather", 0) > 0)
        line = (f"a8b_post (f) dsv3 671B dryrun {shape}: exit "
                f"{proc.returncode}, {wall:.1f} s wall; card untouched "
                f"{clean}")
        if res.get("chips"):
            line += (f"; on {res['mesh']} ({res['plan']}), warnings "
                     f"{res['sharding_warnings']}; {_terms(res)}; "
                     f"collectives {res['collective_counts']}; arguments "
                     f"{res['mem_argument_size_in_bytes']} B/device; "
                     f"n_params {res['n_params']}, active "
                     f"{res['n_params_active']}; model_flops_global "
                     f"{res['model_flops_global']} == 6·N·D {want}: "
                     f"{res['model_flops_global'] == want}")
        print(f"{line} [{card}]: {'ok' if d_ok else 'FAILED'}", flush=True)
        if not d_ok:
            print(f"a8b_post (f) {shape} child's output, its end: "
                  f"{text[-3000:]}", flush=True)
        ok &= d_ok
    return bool(ok)


def phase_a8b_post(data_dir: str, results: dict, card: str) -> bool:
    """Post-training and DeepSeek-V3 under sharding plans on the card (the
    third part of ROADMAP A8b): (f)'s dryrun children start first, on the
    host, and run beside the rest; on a one-rank NCCL group's ``(1, 1)``
    mesh (a) LoRA ``sft``
    under ``fsdp_tp``, (c) its adapters across layouts and merged export,
    (b) ``dpo`` under ``fsdp`` (static and on-policy pairs), (d) the engine
    over the LoRA model under ``fsdp_tp``, (e) DeepSeek-V3 (MLA and MTP)
    training and shims under ``fsdp_tp`` and one absorbed decode step
    against its dryrun; each run beside the same run with no mesh, bit
    equality required (``MESH_TOL``).  The group is destroyed at the end
    of the phase."""
    from repro_torch.launch import mesh as MESH

    t0 = time.perf_counter()
    out_dir = os.path.join(data_dir, "a8b_post")
    os.makedirs(out_dir)
    dry = _a8b_dryrun_start(out_dir)
    ok = True

    def lap(what):
        print(f"a8b_post: {what} done at {time.perf_counter() - t0:.1f}s",
              flush=True)

    try:
        ok &= _a8b_post_qwen(data_dir, results, card)
        lap("(a)-(c)")
        mesh = MESH.make_local_mesh(1, 1, device_type="cuda")
        ok &= _a8b_engine(mesh, results, card)
        lap("(d)")
        ok &= _a8b_dsv3(data_dir, mesh, results, card)
        lap("(e) train and shims")
        MESH.shutdown()
        ok &= _a8b_dsv3_decode(results, card)
        lap("(e) decode step")
        ok &= _a8b_dryrun_check(dry, card)
        lap("(f)")
    finally:
        # no child outlives the phase, whatever the checks did
        for _, proc, _ in dry.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        MESH.shutdown()
        _free()
    return bool(ok)


# the a8b_rest phase (the rest of ROADMAP A8b): the Zamba2 hybrid, Whisper
# and LLaVA under sharding plans on a (1, 1) NCCL mesh.  Zamba2 full width
# at A8B_ZAMBA_GROUPS of its 9 groups (5 Mamba2 layers, then one use of the
# shared block), for the phase's 100 s
A8B_ZAMBA_GROUPS = 3
A8B_ZAMBA_STEPS = 2
A8B_ZAMBA_ENGINE = {"n_requests": 4, "prompt": 256, "gen": 32}
A8B_LLAVA_LAYERS = 8
A8B_LLAVA_TRAIN_LAYERS = 2


def _zamba2_cfg():
    from repro_torch.configs import get_config

    cfg = get_config("zamba2_2p7b")
    return cfg.with_(use_flash_kernel=True,
                     n_layers=A8B_ZAMBA_GROUPS * cfg.attn_every)


def _a8b_zamba2_train(data_dir: str, results: dict, card: str) -> bool:
    """(a) full-width Zamba2 at ``A8B_ZAMBA_GROUPS`` groups, ``remat:
    full``, 8 x 1024, ``A8B_ZAMBA_STEPS`` gym steps under ``fsdp_tp``
    beside the no-mesh run: losses and final params bit-equal, ``flash_fwd``
    uses x 2 x steps and ``ssd_scan`` Mamba2 layers x 2 x steps in each;
    then the ``fsdp_tp`` checkpoint restored under ``ddp`` and with no
    mesh (``_mesh_elastic``)."""
    cfg = _zamba2_cfg()
    spec = {"steps": A8B_ZAMBA_STEPS,
            "sets": ["arch.variant_key=zamba2_2p7b",
                     "arch.config.use_flash_kernel=true",
                     f"arch.config.n_layers={cfg.n_layers}"]}
    uses = A8B_ZAMBA_GROUPS
    mamba = uses * (cfg.attn_every - 1)
    want = {"flash_fwd": uses * 2 * spec["steps"],
            "ssd_scan": mamba * 2 * spec["steps"]}
    runs = {}
    for plan in (None, "fsdp_tp"):
        gym, out, counts, peak, med, ms = _mesh_run(data_dir, "a8b_zamba2",
                                                    spec, plan)
        add_launches(results, counts)
        runs[plan] = ([h["loss"] for h in out["history"]],
                      _host(out["state"]["params"]), counts, peak, ms)
        if plan is None:
            del gym, out
            _free()
    (bl, bp, bc, bpk, bms), (ml, mp, mc, mpk, mms) = \
        runs[None], runs["fsdp_tp"]
    bit, dmax = _same(mp, bp)
    tok_s = [TRAIN_BATCH * TRAIN_SEQ / (x / 1e3) for x in mms]
    ok = ml == bl and bit and mc == bc == want
    print(f"a8b_rest (a) zamba2 train: {cfg.name} full width, "
          f"{cfg.n_layers} of 54 layers ({mamba} Mamba2 + {uses} uses of "
          f"the shared block), {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{spec['steps']} gym steps under fsdp_tp on a (1, 1) mesh: "
          f"losses {json.dumps(ml)} == no mesh {ml == bl}; final params "
          f"bit-equal {bit} (max |d| {dmax:.3g}); launches {mc} (want "
          f"{want}); {_ms(mms)}, tok/s {json.dumps([round(x) for x in tok_s])}"
          f" vs no mesh {_ms(bms)}; peak {mpk:.3f} vs {bpk:.3f} GiB [{card}]: "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    ok &= _mesh_elastic(data_dir, gym, out["state"], "a8b_zamba2_ckpt",
                        "params/shared_attn/attn/wq")
    del gym, out, runs, bp, mp
    _free()
    return bool(ok)


def _a8b_zamba2_engine(mesh, results: dict, card: str) -> bool:
    """(b) the Zamba2 engine (dense pool, greedy) at (a)'s depth under
    ``fsdp_tp`` beside the no-mesh engine: ``A8B_ZAMBA_ENGINE``'s requests,
    streams ``==``, both kernels in every admission (the engine's warm-up
    admission among them)."""
    import numpy as np
    import torch

    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine, load_params
    from repro_torch.serve.workload import static_trace
    from repro_torch.sharding import plans as PL

    cfg = _zamba2_cfg()
    e = A8B_ZAMBA_ENGINE
    model = build_model(cfg)
    params = load_params(model, seed=0, device="cuda")
    prompts = np.random.default_rng(5).integers(
        3, cfg.vocab, size=(e["n_requests"], e["prompt"]), dtype=np.int32)
    uses = A8B_ZAMBA_GROUPS
    admissions = e["n_requests"] + 1
    want = {"flash_fwd": uses * admissions,
            "ssd_scan": uses * (cfg.attn_every - 1) * admissions}
    rows = {}
    for label, kw in (("no mesh", {}),
                      ("fsdp_tp", {"mesh": mesh,
                                   "plan": PL.make_plan("fsdp_tp")})):
        engine = ServeEngine(model, params, n_slots=e["n_requests"],
                             max_len=e["prompt"] + e["gen"], greedy=True,
                             block_len=0, **kw)
        counters = _counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        res = engine.run(static_trace(prompts, e["gen"]), realtime=False)
        torch.cuda.synchronize()
        counts = {n: c.launches for n, c in counters.items()}
        add_launches(results, counts)
        rows[label] = (res, counts, torch.cuda.max_memory_allocated() / 2**30)
        del engine
        _free()
    (b, bc, bp), (m, mc, mp) = rows["no mesh"], rows["fsdp_tp"]
    same = ([r["gen_ids"] for r in m["requests"]]
            == [r["gen_ids"] for r in b["requests"]])
    ok = same and m["completed"] == e["n_requests"] and mc == bc == want
    print(f"a8b_rest (b) zamba2 engine, {cfg.n_layers} layers, dense pool, "
          f"{e['n_requests']} greedy requests of {e['prompt']} + "
          f"{e['gen']} tokens under fsdp_tp: {m['tok_s']} tok/s, decode "
          f"{m['decode_tok_s']} tok/s, tpot p50 {m['tpot_ms']['p50']:.3f} "
          f"ms, peak {mp:.3f} GiB; no mesh: {b['tok_s']} tok/s, decode "
          f"{b['decode_tok_s']} tok/s, tpot p50 {b['tpot_ms']['p50']:.3f} "
          f"ms, peak {bp:.3f} GiB; streams equal {same}; launches {mc} "
          f"(want {want}: {admissions} admissions) [{card}]: "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    del params, model
    _free()
    return bool(ok)


def _a8b_mm_shim(key: str, n_layers: int, mesh, results: dict,
                 card: str) -> bool:
    """The ``mm`` slice's shim (``serve_benchmark``: zero frames or
    patches, the slice's batch x prompt x gen) under ``fsdp_tp`` beside
    the shim with no mesh: streams ``==``, ``flash_fwd`` once a decoder
    layer in each prefill."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_benchmark
    from repro_torch.models import build_model
    from repro_torch.serve.engine import load_params
    from repro_torch.sharding import plans as PL

    spec = MM_SLICES[key]
    cfg = get_config(spec["arch"]).with_(**{**spec["with"],
                                            "n_layers": n_layers})
    model = build_model(cfg)
    params = load_params(model, seed=0, device="cuda")
    rows = {}
    for label, kw in (("no mesh", {}),
                      ("fsdp_tp", {"mesh": mesh,
                                   "plan": PL.make_plan("fsdp_tp")})):
        counters = _counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        res = serve_benchmark(model, batch=spec["batch"],
                              prompt_len=spec["prompt"], gen=spec["gen"],
                              seed=0, params=params, device="cuda",
                              log=_quiet, **kw)
        torch.cuda.synchronize()
        counts = {n: c.launches for n, c in counters.items()}
        add_launches(results, counts)
        rows[label] = (res, counts, torch.cuda.max_memory_allocated() / 2**30,
                       time.perf_counter() - t0)
    (b, bc, bpk, bw), (m, mc, mpk, mw) = rows["no mesh"], rows["fsdp_tp"]
    want = {"flash_fwd": cfg.n_layers, "ssd_scan": 0}
    same = m["generated_ids"] == b["generated_ids"]
    ok = same and mc == bc == want

    def tpot(r):
        return 1e3 * r["decode_s"] / max(r["decode_steps"], 1)

    print(f"a8b_rest ({'c' if key == 'whisper' else 'd'}) {key} shim: "
          f"{cfg.name} full width, {cfg.n_layers} decoder layers, "
          f"{spec['batch']} x ({cfg.n_patches} + {spec['prompt']}) x "
          f"{spec['gen']} under fsdp_tp: {_shim_line(m, mc, mpk, mw)}, tpot "
          f"{tpot(m):.3f} ms; no mesh: {_shim_line(b, bc, bpk, bw)}, tpot "
          f"{tpot(b):.3f} ms; streams equal {same} (want launches {want}) "
          f"[{card}]: {'ok' if ok else 'FAILED'}", flush=True)
    del params, model
    _free()
    return bool(ok)


def _a8b_mm_train(key: str, n_layers: int, plan_name: str, mesh,
                  results: dict, card: str) -> bool:
    """One ``make_train_step`` step of the ``mm`` slice's training batch
    (seeded frames or patches) under ``plan_name`` beside the step with
    no mesh: loss and params bit-equal, ``flash_fwd`` twice a decoder
    layer (forward and remat recompute)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.sharding import plans as PL
    from repro_torch.train import steps as ST

    spec = MM_SLICES[key]
    tr = spec["train"]
    B, S = tr["batch"], tr["seq"]
    cfg = get_config(spec["arch"]).with_(**{**spec["with"], **tr["with"],
                                            "n_layers": n_layers})
    model = build_model(cfg)
    toks = np.random.default_rng(3).integers(3, cfg.vocab, size=(B, S),
                                             dtype=np.int64)
    rows = {}
    for label in ("no mesh", plan_name):
        batch = {"tokens": torch.as_tensor(toks, device="cuda"),
                 "labels": torch.as_tensor(np.roll(toks, -1, axis=1),
                                           device="cuda"),
                 **mm_extra(cfg, B, "cuda", seed=4)}
        opt = AdamW(lr=tr["lr"], weight_decay=0.1, grad_clip=1.0)
        state = ST.init_train_state(
            model, opt, torch.Generator(device="cuda").manual_seed(0))
        ctx = None
        if label != "no mesh":
            plan = PL.make_plan(plan_name)
            sh, _ = PL.train_state_shardings(plan, mesh, model, opt)
            state = PL.distribute(state, sh)
            batch = PL.distribute(batch, PL.batch_shardings(plan, mesh,
                                                            batch))
            ctx = PL.mesh_context(plan, mesh)
        step = ST.make_train_step(model, opt, ctx)
        counters = _counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        counts = {n: c.launches for n, c in counters.items()}
        add_launches(results, counts)
        rows[label] = (loss, _host(state["params"]), counts,
                       torch.cuda.max_memory_allocated() / 2**30,
                       1e3 * (time.perf_counter() - t0))
        del state, opt, step, batch
        _free()
    (bl, bp, bc, bpk, bms), (ml, mp, mc, mpk, mms) = \
        rows["no mesh"], rows[plan_name]
    bit, dmax = _same(mp, bp)
    want = {"flash_fwd": 2 * cfg.n_layers, "ssd_scan": 0}
    ok = ml == bl and bit and mc == bc == want
    print(f"a8b_rest ({'c' if key == 'whisper' else 'd'}) {key} train step:"
          f" {cfg.n_layers} decoder layers, {B} x ({cfg.n_patches} + {S}) "
          f"under {plan_name}: loss {ml!r} == no mesh {ml == bl}; params "
          f"bit-equal {bit} (max |d| {dmax:.3g}); launches {mc} (want "
          f"{want}); {mms:.1f} ms (the first step) vs {bms:.1f}; peak "
          f"{mpk:.3f} vs {bpk:.3f} GiB [{card}]: {'ok' if ok else 'FAILED'}",
          flush=True)
    return bool(ok)


def phase_a8b_rest(data_dir: str, results: dict, card: str) -> bool:
    """The Zamba2 hybrid, Whisper and LLaVA under sharding plans on the
    card (the rest of ROADMAP A8b), on a one-rank NCCL group's ``(1, 1)``
    mesh, each run beside the same run with no mesh, bit equality
    required (``MESH_TOL``): (a) Zamba2 training under ``fsdp_tp`` and its
    checkpoint across layouts, (b) the Zamba2 engine under ``fsdp_tp``,
    (c) Whisper-tiny's shim under ``fsdp_tp`` and a train step under
    ``fsdp``, (d) LLaVA-NeXT-34B's shim under ``fsdp_tp`` and a train
    step at depth 2, (e) one Zamba2 decode step under ``ddp`` against its
    dryrun.  The group is destroyed at the end of the phase."""
    from repro_torch.launch import mesh as MESH

    t0 = time.perf_counter()
    ok = True

    def lap(what):
        print(f"a8b_rest: {what} done at {time.perf_counter() - t0:.1f}s",
              flush=True)

    try:
        ok &= _a8b_zamba2_train(data_dir, results, card)
        lap("(a)")
        mesh = MESH.make_local_mesh(1, 1, device_type="cuda")
        ok &= _a8b_zamba2_engine(mesh, results, card)
        lap("(b)")
        ok &= _a8b_mm_shim("whisper", 4, mesh, results, card)
        ok &= _a8b_mm_train("whisper", 4, "fsdp", mesh, results, card)
        lap("(c)")
        ok &= _a8b_mm_shim("llava", A8B_LLAVA_LAYERS, mesh, results, card)
        ok &= _a8b_mm_train("llava", A8B_LLAVA_TRAIN_LAYERS, "fsdp_tp", mesh,
                            results, card)
        lap("(d)")
        MESH.shutdown()
        ok &= _decode_vs_dryrun("a8b_rest (e) zamba2 decode step",
                                _zamba2_cfg(), "ddp", results, card)
        lap("(e)")
    finally:
        MESH.shutdown()
        _free()
    return bool(ok)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="", metavar="DIR",
                    help="after each serving slice, profile one admission "
                         "and one decode tick, and after each training slice "
                         "one step; tables and traces go to DIR")
    ap.add_argument("--only", default="", metavar="PHASES",
                    help="comma-separated phases to run after the build: "
                         "kernels, slices, mm, train, bench, ckpt, resil, "
                         "posttrain, mesh, pp, serve_mesh, a8b_post, "
                         "a8b_rest, sweep, "
                         "dryrun, engine "
                         "(default: "
                         "all); a partial run prints no result line")
    args = ap.parse_args()
    only = {p for p in args.only.split(",") if p}

    def want(phase: str) -> bool:
        return not only or phase in only

    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    info = build.build_all()
    print(f"build: {len(info)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    for name, i in info.items():
        print(f"build: {name} nvcc {i['seconds']:.2f}s", flush=True)
        for line in str(i["log"]).splitlines():
            if "Compiling entry function" in line:
                # the kernel (with its template arguments) whose counts
                # follow
                print(f"build:   entry {demangle(line.split(chr(39))[1])}",
                      flush=True)
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"build:   {line.strip()}", flush=True)

    results: dict = {}
    ok = _phases(args, want, results, card)
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f}s, the "
          f"kernels' build included", flush=True)
    if not ok:
        return 1
    if only:
        print(f"chip_smoke: phases {sorted(only)} ok; a partial run prints "
              f"no result line", flush=True)
        return 0
    return _result_lines(results, card, torch)


def _phases(args, want, results: dict, card: str) -> bool:
    """Every phase ``want`` accepts, in order; True when all are ok."""
    ok = True

    def run(label: str, *checks) -> None:
        """One phase: every check runs (a failure does not skip the next),
        then the phase's verdict and wall on one line."""
        nonlocal ok
        t0 = time.perf_counter()
        good = True
        for check in checks:
            good &= bool(check())
        print(f"phase {label}: {'ok' if good else 'FAILED'} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        ok &= good

    if want("kernels"):
        run("kernels", lambda: phase_kernels(results),
            lambda: phase_ssd(results))
    for key in SLICES if want("slices") else ():
        run(f"slice {key}", lambda: phase_slice(key, results, args.profile))
    for key in MM_SLICES if want("mm") else ():
        run(f"mm {key}",
            lambda: phase_mm_serve(key, results, card, args.profile),
            lambda: phase_mm_train(key, results, card, args.profile))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as data_dir:
        if want("train"):
            run("train quickstart", lambda: phase_train_quickstart(data_dir))
        for key in TRAIN_SLICES if want("train") else ():
            run(f"train {key}", lambda: phase_train_full(
                key, data_dir, results, card, args.profile))
        if want("bench"):
            run("bench", lambda: phase_bench(data_dir, results, card))
        if want("ckpt"):
            run("ckpt qwen", lambda: phase_ckpt_quickstart(data_dir),
                lambda: phase_ckpt_qwen(data_dir, results, card))
        if want("resil"):
            run("resil qwen", lambda: phase_resil_qwen(data_dir, results,
                                                       card))
        if want("posttrain"):
            run("posttrain qwen",
                lambda: phase_posttrain_qwen(data_dir, results, card))
        if want("mesh"):
            run("mesh", lambda: phase_mesh(data_dir, results, card))
        if want("pp"):
            run("pp", lambda: phase_pp(data_dir, results, card))
        if want("serve_mesh"):
            run("serve_mesh", lambda: phase_serve_mesh(results, card))
        if want("a8b_post"):
            run("a8b_post", lambda: phase_a8b_post(data_dir, results, card))
        if want("a8b_rest"):
            run("a8b_rest", lambda: phase_a8b_rest(data_dir, results, card))
        if want("sweep"):
            run("sweep", lambda: phase_sweep(data_dir, results, card))
        if want("dryrun"):
            run("dryrun", lambda: phase_dryrun(data_dir, results, card))
        if want("engine"):
            run("engine quickstart", lambda: phase_engine_quickstart(data_dir))
    if want("engine"):
        run("engine qwen", lambda: phase_engine_qwen(results, args.profile))
    for key in ENGINE_SLICES if want("engine") else ():
        run(f"engine {key}", lambda: phase_engine_model(key, results))
    return ok


def _result_lines(results: dict, card: str, torch) -> int:
    """The ``kernels`` line, the card's line and the result line."""
    kernels = []
    for name, cases, src, replaces in (
            ("flash_fwd", "flash_cases",
             "src/repro_torch/kernels/flash/csrc/flash_fwd.cu",
             "src/repro/kernels/flash/kernel.py:67"),
            ("ssd_scan", "ssd_cases",
             "src/repro_torch/kernels/ssd/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd/kernel.py:60")):
        row = next(r for r in results[cases] if r["case"].startswith("slice"))
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": results["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
