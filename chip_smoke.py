#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (with the card's ``nvidia-smi`` name
and power limit beside its numbers); any failure ends the script with a
non-zero exit code and no ``ok`` line. On the card every fixed-shape entry
point of the engines runs from a CUDA graph captured at its first call
(``repro_torch/serving/graphs.py``): the fused decode per k, the reference
decode, the bucketed prefill per bucket, the classifier engine per batch
bucket; exact-length batch-1 prefills run eagerly. The kernel wrappers'
launch counts include graph replays.

1. device  — asserts CUDA; prints the card's name and power limit as
             ``nvidia-smi --query-gpu=name,power.limit`` reports them.
2. build   — compiles every kernel (``src/repro_torch/kernels/csrc/*.cu``)
             with nvcc for sm_90a, one process per source, in parallel,
             and prints ptxas's registers, spills and shared memory for
             each kernel entry.
3. kernels — holds each kernel against its plain PyTorch version on the
             card at the serving paths' shapes, the attention kernels also
             at qwen3-32b's (H 64, KV 8, hd 128), olmo-1b's (B 4, H 16
             = KV 16, hd 128, S and C 200-208), qwen2-moe-a2.7b's (H 16 =
             KV 16, hd 128: decode at B 8, C 512, flash at B 1, S 16 and
             200), jamba-v0.1's (H 32, KV 8, hd 128 at B 1: decode at
             C 204, flash at S 200), seamless-m4t's (H 16 = KV 16, hd 64:
             flash full at B 4, S 500, and Sq 32 over Sk 500; decode at
             B 4, C 500, all valid), internvl2's (flash causal at B 4,
             S 456) and h2o-danube's hd 80 (H 32, KV 8: flash at window
             4,096, B 1, S 4,200; decode at B 1 over the full 4,096-slot
             ring and at B 8, C 512) (top2gap bit-exact with
             planted ties, also at the classifier's B 64, V 2 and at the
             new vocabs, B 4 x 256,206, B 4 x 151,655, B 1 x 32,000; bf16
             attention within 2e-2 of the f32 plain version and each
             element within the kernel's own bf16 roundings of it
             (``_bf16_tol``), the new shapes also rejecting the plain
             version with 64 keys dropped or Sk's pad keys unmasked; f32
             attention at qwen3-32b's, danube's (decode also over the
             4,096 ring) and seamless's cross heads within 1e-5; the selective
             scan within 2e-4, f32 throughout) and
             times kernel, plain version and the PyTorch library call that
             computes the same function where one exists (a yardstick the
             port never calls), with CUDA events, against the least time
             the card needs for the same bytes and operations (every row
             prints both counts; for the scan the operation count is its
             exponentials). top2gap is timed at B 8 (V 151,936, 65,024
             and 4,096, the last nearly all fixed cost) and at B 1,
             V 151,936 (reference mode and the teacher-forced checks) and
             V 65,536 (jamba);
             flash at S 256 and at S 64, the most common prefill bucket;
             the scan at S 200 and S 64. Then the flash-attention backward
             (no TPU counterpart) at each training phase's attention
             shape: f32 within BWD_F32_TOL of the plain backward, bf16
             each element within its own roundings of it (the output's
             and P's and dS's as bf16 operands; D = dO . o read from the
             bf16 o, as the kernel reads it),
             rejecting the plain version with the full form's pad keys
             unmasked (seamless) or the window's edge one key late
             (danube); reading the log-sum-exp the forward writes (held
             against the plain one); two calls bit-equal; timed beside
             the backward of SDPA. Then the
             selective scan's backward (no TPU counterpart) at the
             training shape (B 4, S 512, Di 8192, N 16, x bf16) and six
             more: every gradient within MAMBA_BWD_TOL of its largest
             entry in the plain reverse recurrence (a bf16 dx also within
             its rounding), two calls bit-equal, the decay a step early
             and h0's term dropped rejected; timed with the forward
             kernel at the training shape. Then the SSM decode step's
             two kernels (no TPU counterpart: the jnp chain), conv and
             recurrence, at falcon-mamba-7b's width (Di 8192, N 16, bf16)
             at B 32 and B 1, and checked also at N 4 and 8 and in f32
             over an f32 and a narrow bf16 pool: the conv and SSM states
             the plain chain's bits, xc and out within two bf16 units in
             the last place (``_step_err``); timed each and as a pair
             against the plain chain.
4. serve   — the main path: a two-stage cascade of full-width qwen2-0.5b
             models (random bf16 weights from seeds 0 and 1) served by the
             fused ``TokenEngine`` (8 KV slots of 512 tokens, spec_k 4):
             16 requests, prompts of 16-200 tokens, 32 new tokens each.
             The stage-a threshold is set from a calibration pass so that
             requests both resolve at a and escalate to b. The launch
             counters are zeroed just before the measured run and read
             just after; each must equal what the run's step counts imply.
             Served tokens are then checked against a teacher-forced
             ``forward`` pass, and a short reference-mode run of stage a
             (batch-1 prefills, one decode call per step) must reduce
             every prefill and step through the top2gap kernel and serve
             the fused run's tokens. Each stage's ``compile_counts``
             must be the shapes it served (bucketed prefill graphs = the
             buckets prefilled <= the bucket grid, fused graphs = the k
             values run). A torch.profiler window over fused decode
             steps, then one over a repeat of the 8-prompt prefill, with
             the host's CUDA API calls (``cudaGraphLaunch``,
             ``cudaLaunchKernel``) per step. Then ``graphs_vs_eager``: a
             fresh engine's bucketed prefill and fused decode (k 1 and
             4), and in reference mode its decode, each replayed at least
             twice on new inputs against a direct eager call of the same
             ``models/model.py`` function on a cloned copy of the state:
             tokens, gaps, certainties and the state after, bit for bit.
             A ``path_summary`` line ends the phase: served step and
             prefill ms beside device ms, host launch calls and device
             kernels per step, graphs, capture seconds, peak memory,
             tokens/s.
5. serve_ssm — the SSM path, after the qwen2 params are freed: a
             two-stage cascade of full-width falcon-mamba-7b (64 Mamba-1
             layers, d_inner 8192, d_state 16, vocab 65,024; random bf16
             weights from seeds 0 and 1) through the same engine and
             traffic. Every prefill is an exact-length batch-1 call whose
             scan runs in the mamba_scan kernel (64 launches per prefill),
             every decode step runs the SSM step's two kernels once a
             layer, top2gap reduces every step at V 65,024, and no attention
             kernel runs; the launch counters are checked as above, served
             tokens against a teacher-forced ``forward``, and a profiler
             window, ``graphs_vs_eager`` (fused decode only: the prefills
             are eager) and ``path_summary`` end the phase. Prefill time
             per prompt length and the peak device memory are printed.
             Then one ``prefill`` of stage a's weights at B 1, S 4,096
             (``repro_torch/profiling/prefill_peak.py`` ``measure``): its
             peak allocation above the memory in use before it must lie
             under the bound from the shapes (the cache twice, one SSM
             layer's activations as 8 in_proj outputs, 256 MiB of
             slack), well under the 8.6 GB that 64 layers' projections
             would add if each layer's cache kept its projection alive.
6. serve_qwen3 — after the SSM params are freed, the heterogeneous
             cascade the serve CLI's ``--workload qwen`` names: full-width
             qwen2-0.5b at stage a, full-width qwen3-32b at stage b (64
             layers, d 5120, 64 heads over 8 KV heads at hd 128, qk-norm,
             untied head; 65.5 GB of bf16 weights; random, seeds 0 and
             1), the same engine and traffic. Launches per stage: decode
             attention = layers x decode steps, flash = layers x prefill
             calls, summed over the stages; top2gap once per step and
             prefill; no scan. Stage b's served tokens against a bf16
             teacher-forced ``forward`` where the gap exceeds
             QWEN3_BF16_MARGIN, a profiler window over stage b's fused
             steps, ``graphs_vs_eager`` and ``path_summary`` on stage b,
             peak memory (allocated under QWEN3_PEAK_LIMIT), then the 0.1
             check in f32 on a depth-cut copy of stage b (its first
             QWEN3_F32_LAYERS layers, full width, 22 GB).
7. serve_moe — after the qwen3-32b params are freed, the MoE cascade:
             full-width qwen2-0.5b at stage a, full-width qwen2-moe-a2.7b
             at stage b (24 layers, 60 routed experts padded to 64, top-4
             by sigmoid, 4 gated shared experts; 30.3 GB of bf16; seeds 0
             and 1), the same engine and traffic. Stage b prefills at
             exact length, batch 1, eagerly; every fused step reads all
             64 experts (the reference's dispatch). Capacity routing makes
             a call's output depend on the tokens it holds, so stage b's
             decode is not held against a teacher-forced ``forward``
             (printed only); instead (a) its prefills against ``forward``
             over the same prompt at batch 1 (logits within
             MOE_PREFILL_TOL, the same experts for every token), (b)
             ``graphs_vs_eager`` (every fused replay and every
             exact-length prefill bit-equal to a direct eager call), (c)
             bf16 against an f32 copy of its first MOE_F32_LAYERS layers
             (argmax agreement and the tokens whose expert sets differ,
             layer by layer, printed; at the first MoE layer a set may
             differ only where the f32 router gap is below
             MOE_ROUTE_NEAR). Launches as serve_qwen3;
             a profiler window, ``path_summary``, one MoE layer timed
             alone at T 8 and 200, peak memory under MOE_PEAK_LIMIT.
8. forward_olmo — full-width olmo-1b (GQA group 1 at hd 128, the
             non-parametric LayerNorm) in bf16: a prefill and 8 teacher-
             forced decode steps against ``forward`` (max logit error
             within FORWARD_LOGIT_TOL, argmax equal where the gap exceeds
             FORWARD_MARGIN), launches counted; as phases 10-12.
9. forward_jamba — jamba-v0.1 at full width with JAMBA_LAYERS (16) of
             its 32 layers (~52 GB of bf16; all 32 need 104 GB), batch 1:
             the one configuration whose forward runs all four kernels (14
             Mamba-1 layers, 2 attention layers at a GQA group of 4, MoE
             in every other layer). A 200-token prefill and JAMBA_STEPS
             decode steps, launches counted from ``block_pattern`` (the
             SSM step's two kernels once a Mamba layer a step); the
             prefill held against ``forward`` as in serve_moe (a), the
             steps against a teacher-forced forward printed only; peak
             memory under JAMBA_PEAK_LIMIT.
10. forward_seamless — seamless-m4t-large-v2 at full width (24 encoder
             and 24 decoder layers, d 1024, 16 = 16 KV heads at hd 64,
             GeGLU, LayerNorm with bias, tied head, vocab 256,206; 3.55 GB
             of bf16), B 4: random source frames (4, 500, 1024), a
             32-token decoder prompt, 16 teacher-forced decode steps, each
             served position's logits against ``forward`` within
             FORWARD_LOGIT_TOL. The encoder runs the flash kernel's full
             form, cross attention the full form over the 500 source keys
             at forward and prefill and the decode kernel (every key
             valid) in each step; launches counted per formula; the
             model's FFN held to the tanh GELU.
11. forward_internvl — internvl2-1b at full width (24 layers, d 896, 14
             heads over 2 KV at hd 64, vocab 151,655), B 4: 256 random
             prefix embeddings (4, 256, 1024) before a 200-token prompt (a
             causal prefill over 456 positions), 8 teacher-forced steps
             against ``forward``.
12. forward_danube — h2o-danube-1.8b at full width (24 layers, d 2560, 32
             heads over 8 KV at hd 80, window 4,096, untied head), B 1: a
             4,200-token prompt past the window (the prefill cache cut and
             rolled into the 4,096-slot ring), 8 decode steps on the ring
             against ``forward`` over 4,208 tokens. Phases 8 and 10-12
             print the prefill's and each step's host and device ms, peak
             memory, the step's weight-read bound and the H100 cost
             model's step.
13-17. train_qwen2, train_olmo, train_danube, train_internvl,
             train_seamless — the training path (``make_train_step``:
             ``train_loss`` with remat, ``backward()`` through the flash
             kernels forward and backward, AdamW with f32 moments in
             place) at full width and depth in bf16, random weights from
             seed 0, on one repeated ``SyntheticDataset`` batch
             (TRAIN_SHAPES: qwen2-0.5b B 8 x 512, olmo-1b B 4 x 512,
             h2o-danube B 1 x 4,200 past its window, internvl2 B 4 x (256
             prefix rows + 200 tokens), seamless B 4 x 128 over 500 source
             frames). First one f32 step cut to TRAIN_CUT layers (batch 1,
             the same positions) on the card and on the CPU: every
             gradient leaf within TRAIN_GRAD_TOL of the CPU's (a gradient
             the card dropped would miss by its whole size). Then
             TRAIN_WARM steps and TRAIN_STEPS timed ones: the loss must
             fall; launches (zeroed just before, read just after) flash
             forward = attention layers x steps x 2 (the recompute),
             backward = attention layers x steps. Prints the step's wall
             and device ms against 6 and 8 x params x tokens at the bf16
             peak, and the peak memory (weights, gradients, m and v: 12 B
             a parameter, 6-22 GB).
18-20. train_falcon_mamba, train_moe, train_jamba — the same at full
             width with the depth cut to fit the card (TRAIN_LAYERS:
             falcon-mamba-7b 40 of 64 layers, qwen2-moe-a2.7b 6 of 24,
             jamba-v0.1 its first 3 of 32; 4.0-4.7 B parameters), B 4 x
             512: the scan kernels forward, recomputed and backward in
             every Mamba layer, the MoE dispatch and expert products under
             autograd. f32 checks at 2 layers (falcon-mamba; A_log's, D's
             and dt_proj's readings apart) and 1 (qwen2-moe; its routes
             equal the CPU's, the smallest router margin printed, a
             differing route named a near-tie under ROUTE_TIE); none for
             jamba. Launches per step: each forward kernel 2 x its layers,
             each backward kernel 1 x; the MoE models' bound over their
             active parameters, the all-expert one beside it; device time
             by kind with the scan backward and the expert products apart.
21. train_resume — in a process of its own (CUBLAS_WORKSPACE_CONFIG set,
             ``torch.use_deterministic_algorithms(True)``): qwen2-0.5b at
             the train_qwen2 shape, RESUME_AT steps, a ``CheckpointManager``
             save into a temporary directory (deleted after), RESUME_K
             more; the checkpoint restored into a zeroed template must be
             bit-equal to the saved state, and RESUME_K steps from it
             bit-equal to the uninterrupted run (an op without a
             deterministic implementation would be named and the run held
             within RESUME_TOL instead); then the same for falcon-mamba-7b
             cut to 2 layers (``train_resume_ssm``).
22. cost_model — the H100 analytic cost model (``repro_torch.profiling``)
             beside the profiler windows' device ms per decode step for
             the four token models (and the time to read every weight a
             step reads: for the MoE all 64 experts, where the model
             prices the active ones) and qwen3-32b's prefill (host wall,
             and device ms from the trace window's profiled repeat); the
             ``--workload qwen`` plan and DES through the serve CLI's own
             functions (qwen3-32b must place on one card).
23. serve_tiny — the paper's one-shot classifier lifecycle through
             ``repro_torch.launch.serve``'s own functions: the tiny family
             (five transformers, d 16-96) trains on the card, every member
             is profiled through the ``EngineBackend`` that serves it, the
             gear planner plans for 2 logical devices sharing the card, and
             the threaded ``CascadeServer`` serves an azure-like trace at
             60 qps (``--real --devices 2 --trace-seconds 8 --qps-max 60
             --slo latency:0.3``). The launch counters are zeroed just
             before that run and read just after: top2gap must launch once
             per executed batch, every arrival must be done or still
             queued, at least 95 % done, and every done request must obey
             cascade semantics against the certainties the kernel gave it.
             Before it, every bucket graph of every engine (captured by the
             warm-up of profiling) is replayed against a direct eager
             ``apply_tiny``, bit for bit; after it, the engines must hold
             one graph per bucket and no more. The same plan and trace on
             the discrete-event simulator, a profiled repeat (device busy
             and idle share) and a real run at the reference's default
             2000 qps (numbers only) follow, and ``serve_tiny_fidelity``
             puts real p95 beside the simulator's at both loads.
24. serve_baselines — the paper's baselines (``serving/baselines.py``)
             over the family and profiles of phase 23 (not trained
             again). ``serve_baselines_grid``: the paper's Fig. 7 on the
             simulator, the fewest logical devices (1-8, binary search)
             with which CascadeServe's plan, DynBa's grid and MS+'s grid
             serve a 4 s diurnal trace peaking at 8,000 qps at two
             accuracy targets (the two best models' accuracy less 0.005)
             times two p95 targets (0.5 and 2 ms), CascadeServe's saving
             factor, and Cocktail+'s time-averaged active devices on 8.
             Then DynBa (the most accurate model) and MS+ through
             ``build_plan`` on the threaded ``CascadeServer`` with the
             policy's selector, at 60 and 2,000 qps as in phase 23, each
             beside the simulator's run of the same policy and trace, and
             a ``serve_baselines`` line with CascadeServe's runs of phase
             20. Checks: at 60 qps at least 95 % done, every request
             served within its gear's cascade, top2gap launched once per
             executed batch in every run, and Cocktail+'s ``build_plan``
             refusing its ensemble gears.
25. serve_tenants — the reference CLI's two-tenant example
             (``interactive:latency:0.3:600:2,batch:latency:1.0:600:1``)
             planned by ``plan_multi_tenant`` for the 2 logical devices,
             both tenants' azure-like traces superposed and served by the
             threaded ``MultiTenantServer`` over the card's
             ``EngineBackend`` behind an ``AdmissionController`` (0.75
             utilisation cap, as the CLI) with ``Telemetry`` on, beside
             ``ServingSimulator.run_multi_tenant``. Checks: per tenant
             offered = done + shed, cascade semantics, span conservation
             (none open), ``dump_metrics``'s three files written, top2gap
             launched once per executed batch.
26-28. dist_serve, dist_moe, dist_train — the distributed layer
             (``repro_torch.distributed``, ``launch/mesh``, ``launch/steps``)
             on one card: one NCCL process group of one rank, meshes of
             size 1 (after train_resume), so no collective is called and
             each process's blocks are the whole tensors. dist_serve:
             qwen2-0.5b at full width
             and depth through ``launch/steps`` on a (1, 1) mesh with
             ``flash_decode``, DTensor params, B 8 x 64-token prompts and
             16 greedy steps: tokens and gaps bit-equal to the mesh-less
             calls (or the differing op named). dist_moe: qwen2-moe-a2.7b
             at full depth, bf16, one ``forward`` with every MoE layer
             through ``apply_moe_ep``, logits bit-equal to
             ``apply_moe_local``'s. dist_train: ``launch/train.py --mesh
             1x1x1 --compress-pod-grads`` on qwen2-0.5b (B 8 x 512, 2 warm
             and 5 timed steps; the loss falls; step device ms and peak
             memory beside train_qwen2's), and its first step's own int8
             exchange within half a quantisation step (at world 1 a
             quantisation check).
             Launch counters around each run, as each path's formula.
             The kernel phase also holds the decode kernel's log-sum-exp
             form (qwen2's and qwen3's shapes, the default output
             bit-equal, an empty row 0 and -inf), the n-shard flash-decode
             (n 2, 4, 8 over qwen2's cache, empty shards included; one
             shard's rescale dropped rejected) and the flash forward and
             backward with ``q_offset`` (qwen2's training shape in 4 query
             chunks: outputs and dq bit-equal to the unchunked slices, an
             offset one late rejected).
29. dryrun — the dry-run (``repro_torch.launch.dryrun.run_cell``): seven
             production-mesh cells (olmo-1b decode_32k on (16, 16) and
             (2, 16, 16), falcon-mamba-7b long_500k, llama4-maverick
             train_4k, internvl2-1b train_4k (a vocab of 151,655 that
             does not tile the 16-wide model axis: its logits in padded
             blocks), falcon-mamba-7b prefill_32k (each layer's conv
             tail copied out of its projection) and h2o-danube-1.8b
             train_4k (32 query heads tile the model axis, 8 kv heads do
             not: the query-heads layout, each process 2 query heads
             over the kv head they read, forward, remat and backward) on
             (16, 16); each must
             peak under 80 GB a card) traced on fake tensors over a fake
             256- or 512-rank process group, once with ``--device cuda``
             (fake CUDA tensors: every kernel wrapper charged as its
             kernel, nothing launched) and once with ``--device cpu``,
             each in a process of its own (the fake group and the dist
             phases' NCCL group cannot share one), the two at once. Each
             cell's FLOPs, bytes, collective bytes by kind, peak memory
             and kernel calls must be equal on both devices, and the
             kernel calls as the path's formula; each cell's trace
             seconds are printed. Each child resets the launch counts
             before its cells and reports them after; both must be 0,
             and the card's child's counts are the path's launches.

The last lines are the kernel table (JSON), the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cascade import Cascade  # noqa: E402
from repro_torch.core.certainty import StreamingCertainty  # noqa: E402
from repro_torch.core.gears import Gear  # noqa: E402
from repro_torch.core.scheduling import (ContinuousBatcher,  # noqa: E402
                                         SchedulerCore)
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.decode_attention import \
    decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd)
from repro_torch.kernels.mamba_scan import (mamba_scan,  # noqa: E402
                                            mamba_scan_bwd)
from repro_torch.kernels.mamba_step import (  # noqa: E402
    mamba_conv_step, mamba_ssm_step)
from repro_torch.kernels.top2gap import top2gap  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.profiling.flash_bwd_ab import rounding_scale  # noqa: E402
# inputs are cycled through more than the L2 cache
from repro_torch.profiling.hw import L2_BYTES  # noqa: E402
from repro_torch.profiling import prefill_peak  # noqa: E402
from repro_torch.serving.token_engine import (SlotEngine,  # noqa: E402
                                              TokenEngine, TokenRequest,
                                              greedy_generate)
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training import (AdamWConfig, SyntheticDataset,  # noqa: E402
                                  TrainStepConfig, adamw_update,
                                  init_opt_state, make_train_step)
from repro_torch.training.train_step import as_batch  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
# exponentials: the special-function units return 16 results per clock per
# SM on compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput), 132 SMs at the H100 SXM's 1,980 MHz boost clock
SFU_PER_S = 132 * 16 * 1.98e9
SCAN_TOL = 2e-4           # f32 scan kernel vs the f32 plain version
# the decode-step kernels' xc and out against the plain chain: a sum over
# K or N in another order moves one rounding by an ulp, which the next
# product and rounding can carry to two; rarely (the share below)
MAMBA_STEP_ULPS = 2
MAMBA_STEP_F32_TOL = 1e-5
MAMBA_STEP_DIFFER = 1e-3
SSM_BF16_MARGIN = 0.5     # bf16 teacher-forced margin on the SSM path
F32_GAP_TOL = 1e-3        # f32 decode vs forward gaps (summation order)
ATTN_TOL = 2e-2           # bf16 kernel vs the f32 plain version
F32_ATTN_TOL = 1e-5       # f32 kernel vs the f32 plain version (cuda tests)
LSE_TOL = 1e-4            # the decode kernel's f32 LSE vs the plain version
# ... and each bf16 element within _bf16_tol of it: the kernel's own bf16
# roundings, at most 2^-8 relative each; P's rounding (flash only) is held
# to P_ROUND_SIGMAS times its scale
P_ROUND_SIGMAS = 6

ARCH = "qwen2-0.5b"
SSM_ARCH = "falcon-mamba-7b"
QWEN3_ARCH = "qwen3-32b"      # stage b of the heterogeneous cascade
OLMO_ARCH = "olmo-1b"
QWEN3_BF16_MARGIN = 0.5       # bf16 teacher-forced margin, 64 layers
QWEN3_BF16_CHECKED = 8        # stage-b requests held at that margin
QWEN3_F32_LAYERS = 8          # depth of the f32 copy of qwen3-32b (22 GB)
QWEN3_PEAK_LIMIT = 79e9       # bytes allocated at most in that phase
OLMO_BATCH, OLMO_STEPS = 4, 8
MOE_ARCH = "qwen2-moe-a2.7b"  # stage b of the MoE cascade (30.3 GB bf16)
MOE_PEAK_LIMIT = 40e9         # bytes allocated at most while serving it
# an MoE stage's prefill against forward over the same prompt at batch 1:
# the same layers on the same tokens (one routing call, so the same
# capacity and drops); only the LM head's product differs in shape (one
# row against S), so the bf16 logits differ by at most a rounding step or
# two of the largest logit: 2^-4 is two steps below 8
MOE_PREFILL_TOL = 0.0625
MOE_PREFILL_CHECKED = 8       # prompts held so
MOE_F32_LAYERS = 8            # depth of the bf16 / f32 routing check
# bf16 against f32 at the first MoE layer: the two router inputs differ
# only by bf16 rounding through one attention layer (router logits of std
# ~0.9 at qwen2-moe's widths), so a token's expert set may differ only
# where its f32 k-th and (k+1)-th router logits lie closer than this
MOE_ROUTE_NEAR = 0.05
JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_LAYERS = 16             # 2 of its 4 block periods: ~52 GB of bf16
JAMBA_STEPS = 4               # decode steps after its 200-token prefill
JAMBA_PEAK_LIMIT = 60e9       # bytes allocated at most in forward_jamba
# the encoder-decoder, the vision prefix and hd 80 (forward_seamless,
# forward_internvl, forward_danube): B, decoder or text prompt, decode steps
SEAMLESS_ARCH = "seamless-m4t-large-v2"
SEAMLESS_B, SEAMLESS_SRC, SEAMLESS_PROMPT, SEAMLESS_STEPS = 4, 500, 32, 16
INTERNVL_ARCH = "internvl2-1b"
INTERNVL_B, INTERNVL_TEXT, INTERNVL_STEPS = 4, 200, 8
DANUBE_ARCH = "h2o-danube-1.8b"
DANUBE_B, DANUBE_PROMPT, DANUBE_STEPS = 1, 4200, 8   # past its 4,096 window
# bf16 prefill / decode logits against forward over the same inputs
# (forward_olmo and the three above): logits of std ~0.6-1.0 after 16-24
# layers of bf16 GEMM outputs (48 with seamless's encoder) whose shapes
# differ between the paths; the largest of 0.2-4 M differences
FORWARD_LOGIT_TOL = 0.25
FORWARD_MARGIN = 0.1          # argmax held equal where forward's gap exceeds
FORWARD_PEAK_LIMIT = 20e9     # bytes allocated at most in each such phase
# training (kernel_flash_bwd, the train_* phases, train_resume): each
# model's batch, positions per row (internvl2: 256 prefix + 200 text;
# seamless: 128 decoder positions over 500 source frames)
TRAIN_SHAPES = {ARCH: (8, 512), OLMO_ARCH: (4, 512), DANUBE_ARCH: (1, 4200),
                INTERNVL_ARCH: (4, 456), SEAMLESS_ARCH: (4, 128),
                SSM_ARCH: (4, 512), MOE_ARCH: (4, 512), JAMBA_ARCH: (4, 512)}
# the SSM, MoE and hybrid models train at full width with their depth cut
# to fit the card at 12 B a parameter (bf16 params and gradients, f32 m and
# v) beside the activations: 40 of falcon-mamba-7b's 64 layers (4.74 B
# parameters, 56.9 GB), 6 of qwen2-moe's 24 (4.05 B, 60 experts padded to
# 64), jamba-v0.1's first 3 of 32 (4.02 B: Mamba + dense FFN, Mamba +
# 16-expert MoE, Mamba + dense FFN; its first attention layer is its 5th)
TRAIN_LAYERS = {SSM_ARCH: 40, MOE_ARCH: 6, JAMBA_ARCH: 3}
# layers of the f32 gradient check where not TRAIN_CUT: qwen2-moe at one
# (1.19 B f32 parameters, about 5 GB on each side); none for jamba (two
# layers hold 3.74 B f32 parameters on the host; its Mamba layers have
# falcon-mamba's shapes, and qwen2-moe's check covers the MoE backward)
TRAIN_CHECK_LAYERS = {MOE_ARCH: 1, JAMBA_ARCH: 0}
# the router guard of the MoE gradient check: a token whose k-th and
# (k+1)-th f32 router logits lie closer than this on the CPU is a near-tie
ROUTE_TIE = 1e-4
TRAIN_SRC = 500
TRAIN_WARM, TRAIN_STEPS = 2, 8  # steps before the timed ones, timed steps
TRAIN_LR = 1e-3                 # AdamW, warmup 2, over a repeated batch
TRAIN_CUT = 2                   # layers of the f32 gradient check
# the depth-cut f32 step on the card against the same step on the CPU:
# every gradient leaf within this share of its largest CPU entry (both
# packages' f32 products in other summation orders, and the logits'
# gradient rounded to bf16 in both, where a rounding may land a step
# apart); a gradient the card dropped would miss by its whole size
TRAIN_GRAD_TOL = 1e-3
BWD_F32_TOL = 1e-4              # f32 backward kernel, relative to the max
# the flash forward's log-sum-exp output against the plain version's (the
# same f32 sums in another order; a row's value is a few units)
FLASH_LSE_TOL = 1e-5
# the selective scan's backward against its plain reverse recurrence, each
# gradient relative to its largest entry: f32 sums in other orders (dA and
# dD over B x S terms, dB and dC over Di), and the kernel's ex2.approx
# decays (2^-22 relative each), which the carry g compounds over the
# ~1 / (dt |a|) steps it remembers (about 20 at dt 0.05, |a| 1)
MAMBA_BWD_TOL = 1e-5
N_SLOTS, MAX_LEN, SPEC_K = 8, 512, 4
N_REQ, MAX_NEW, PROMPT_LO, PROMPT_HI = 16, 32, 16, 200
MIN_TOKENS, EARLY_MARGIN = 4, 0.5
# the one-shot classifier path: the verify recipe's healthy setting
TINY_DEVICES, TINY_TRACE_S, TINY_QPS, TINY_SLO = 2, 8, 60.0, "latency:0.3"
TINY_QPS_STRESS = 2000.0      # the reference's default --qps-max
TINY_BATCH = 64               # top2gap row timed at the classifier shape
# the paper's Fig. 7 cost grid on the DES over the card's tiny profiles:
# a diurnal trace whose peak the flat sub-ms batch runtimes of one card
# serve; the p95 targets make queueing, not throughput, the cost
GRID_MAX_DEV, GRID_PEAK, GRID_TRACE_S, GRID_RANGES = 8, 8000.0, 4, 4
GRID_P95 = (0.5e-3, 2e-3)     # seconds
GRID_ACC_MARGIN = 0.005       # targets: the two best models' accuracy less
# the reference CLI's own two-tenant example (repro/launch/serve.py)
TENANTS = "interactive:latency:0.3:600:2,batch:latency:1.0:600:1"


CARD = ""   # the nvidia-smi name and power limit, set by phase_device
Q_OFFSET: dict = {}   # the flash q_offset rows (forward, backward)
TRAIN_ROWS: dict = {}   # each train phase's line, by phase


def emit(obj) -> None:
    """One JSON line; a phase's line carries the card it was measured on."""
    if "phase" in obj and CARD:
        obj = {**obj, "card": CARD}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def device_ms(fns, reps: int = 7, per_window: int = 16) -> float:
    """Median device milliseconds of one call. Each window queues
    ``per_window`` calls (cycling over ``fns``, one per input copy, so the
    inputs come from device memory, not L2) behind a device-side sleep, so
    the host has queued every launch before the first one starts and the
    two CUDA events bracket device time only."""
    for f in fns[:2]:
        f()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(per_window):
            fns[i % len(fns)]()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / per_window)
    return statistics.median(out)


def copies(nbytes_per_call: int) -> int:
    """Input copies to cycle so a window's inputs exceed the L2 cache."""
    return max(2, min(128, math.ceil(2 * L2_BYTES / max(nbytes_per_call,
                                                          1))))


def bound(nbytes: float, flops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1-2: device and build
# ---------------------------------------------------------------------------

def phase_device() -> str:
    check(torch.cuda.is_available(), "a CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(len(smi) >= 1, "nvidia-smi lists a card")
    global CARD
    CARD = smi[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi[0],
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi[0]


def _ptxas_report(log: str) -> list:
    """Registers, spill bytes and static shared memory of each kernel
    entry in one library's ``nvcc -Xptxas -v`` output."""
    rows, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = {"kernel": m.group(1)}
            rows.append(entry)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            entry["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entry["static_smem"] = int(m.group(1)) if m else 0
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            timeout=60, check=True).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r["kernel"] = n
    except (OSError, subprocess.SubprocessError):
        pass   # keep the mangled names
    return rows


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = build.build_all()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_flags": " ".join(build.NVCC_FLAGS),
          "libraries": sorted(p.name for p in libs.values())})
    for stem, path in sorted(libs.items()):
        emit({"phase": "ptxas", "source": f"csrc/{stem}.cu",
              "kernels": _ptxas_report(path.with_suffix(".log").read_text())})


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version, timed
# ---------------------------------------------------------------------------

def _gen(seed: int) -> torch.Generator:
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _time_top2gap(x) -> dict:
    b, v = x.shape
    n = copies(x.numel() * 4)
    xs = [x.clone() for _ in range(n)]
    kms = device_ms([lambda t=t: top2gap(t) for t in xs])
    pms = device_ms([lambda t=t: ref.top2gap_ref(t) for t in xs])
    lms = device_ms([lambda t=t: torch.topk(t, 2, dim=-1) for t in xs])
    nbytes, flops = b * v * 4 + b * 8, 2 * b * v
    bms, by = bound(nbytes, flops, FP32_FLOP_PER_S)
    return dict(shape=f"B={b} V={v} f32", ms=kms, plain_ms=pms,
                library_ms=lms, library="torch.topk(k=2)", bound_ms=bms,
                bound_by=by, bound_bytes=nbytes, bound_flops=flops)


def kernel_top2gap(dev) -> dict:
    """At the qwen2 vocab (151,936, the row's headline shape at B 8, and
    at B 1, where reference mode and the teacher-forced checks reduce),
    the falcon-mamba vocab (65,024), jamba's (65,536) at B 1, a
    4,096-wide row, whose time is almost all the kernel's fixed cost
    (launch, cluster barrier, one round trip to device memory), and the
    vocabs of seamless-m4t (256,206 at B 4), internvl2 (151,655 at B 4;
    both odd widths, so every odd row starts off a 16-byte boundary) and
    h2o-danube (32,000 at B 1)."""
    worst = 0.0
    timed = {}
    for b, v in ((1, 151936), (8, 151936), (8, 65024), (1, 65536),
                 (8, 4096), (SEAMLESS_B, 256206), (INTERNVL_B, 151655),
                 (DANUBE_B, 32000)):
        x = torch.randn(b, v, generator=_gen(b), device=dev) * 3.0
        # planted exact top-1 ties far apart (other threads, other warps):
        # row 0 two-way, and at B > 1 the last row three-way
        top = float(x.max()) + 1.0
        x[0, 17] = x[0, v - 5] = top
        if b > 1:
            x[b - 1, min(40000, v // 2)] = x[b - 1, 3] = \
                x[b - 1, v - 1935] = top + 1.0
        rgap, ridx = ref.top2gap_ref(x)
        gap, idx = top2gap(x)
        torch.cuda.synchronize()
        check(torch.equal(idx, ridx), f"top2gap index equal (B={b})")
        check(torch.equal(gap, rgap), f"top2gap gap bit-equal (B={b})")
        check(int(idx[0]) == 17 and float(gap[0]) == 0.0,
              "top2gap two-way tie -> gap 0, lowest index")
        if b > 1:
            check(int(idx[b - 1]) == 3 and float(gap[b - 1]) == 0.0,
                  "top2gap three-way tie -> gap 0, lowest index")
        err = float((gap - rgap).abs().max())
        worst = max(worst, err)
        timed[b, v] = dict(_time_top2gap(x), max_abs_err=err)
    # the classifier path's shape: (B, 2) f32 scores, ties in row 0 and
    # in the last row
    x = torch.randn(TINY_BATCH, 2, generator=_gen(2), device=dev)
    x[0, 1] = x[0, 0]
    x[TINY_BATCH - 1, 0] = x[TINY_BATCH - 1, 1]
    rgap, ridx = ref.top2gap_ref(x)
    gap, idx = top2gap(x)
    torch.cuda.synchronize()
    check(torch.equal(idx, ridx) and torch.equal(gap, rgap),
          f"top2gap bit-equal at B={TINY_BATCH}, V=2")
    check(int(idx[0]) == 0 and float(gap[0]) == 0.0,
          "top2gap V=2 tie -> gap 0, index 0")
    timed[TINY_BATCH, 2] = dict(_time_top2gap(x), max_abs_err=0.0)
    row = dict(name="top2gap", **timed[8, 151936],
               at_v65024=timed[8, 65024], at_b1=timed[1, 151936],
               at_b1_v65536=timed[1, 65536], at_v4096=timed[8, 4096],
               at_b64_v2=timed[TINY_BATCH, 2],
               at_seamless=timed[SEAMLESS_B, 256206],
               at_internvl=timed[INTERNVL_B, 151655],
               at_danube=timed[DANUBE_B, 32000])
    row["max_abs_err"] = worst
    return row


def _bf16_tol(rout, nu=None):
    """The elementwise limit of a bf16 attention kernel against the f32
    plain version on the same bf16-valued inputs. Both kernels compute in
    f32 and round their output to bf16: at most 2^-8 of ``rout``. The
    flash kernel also rounds P to bf16 before P.V (the row sums stay f32):
    each weight w_j by at most 2^-8 of itself, which moves an output by
    sum_j w_j d_j v_j, of standard deviation at most 2^-8 / sqrt(3) times
    ``nu`` = sqrt(sum_j w_j^2 v_j^2). P_ROUND_SIGMAS x 2^-8 x nu is over
    ten of those, and bounds the sum outright for up to 36 visible keys
    (sum_j w_j |v_j| <= sqrt(n) nu). F32_ATTN_TOL covers f32 summation
    order and the fast exponentials. The decode kernel rounds only its
    output, so its readings come close to 1 (a value just above a power
    of two rounded by half a step) and never past it."""
    t = rout.abs() if nu is None else rout.abs() + P_ROUND_SIGMAS * nu
    return t * 2.0 ** -8 + F32_ATTN_TOL


def _held(out, rout, tol, what: str) -> float:
    """max |out - rout| / tol, checked to be at most 1."""
    r = float(((out.float() - rout).abs() / tol).max())
    check(r <= 1.0, f"{what} within the bf16 rounding limit ({r} of it)")
    return r


def _traps_rejected(rout, tol, traps: dict, what: str) -> dict:
    """The check's power at this shape: each trap is the plain version
    with one kernel bug built in, rounded to bf16 as the kernel's output
    is, and must lie outside ``tol``, so a kernel with that bug fails the
    check. Returns {trap: max |trap - rout| / tol}."""
    out = {}
    for name, tr in traps.items():
        out[name] = float(((tr.bfloat16().float() - rout).abs() / tol)
                          .max())
        check(out[name] > 1.0, f"{what}: a kernel with {name} fails the "
                               f"check ({out[name]} of the limit)")
    return out


def _flash_nu(q, k, v, causal, window):
    """sqrt(sum_j w_j^2 v_j^2) per output element, f32, from the plain
    version's softmax weights w (the scale of P's bf16 rounding)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    scores = torch.einsum("bqkgd,bskd->bkgqs",
                          q.float().reshape(b, sq, kv, h // kv, d),
                          k.float()) / math.sqrt(d)
    if causal:
        i = torch.arange(sq, device=q.device)
        keep = i[None, :] <= i[:, None]
        if window:
            keep &= i[None, :] > i[:, None] - window
        scores.masked_fill_(~keep, -math.inf)
    w = torch.softmax(scores, dim=-1)
    del scores
    nu = torch.einsum("bkgqs,bskd->bqkgd", w.square_(), v.float().square())
    return nu.sqrt_().reshape(b, sq, h, d)


def _time_decode(dev, b, h, kv, d, c, vl, seed, traps=False) -> dict:
    """One-query GQA attention over a (B, C, KV, hd) bf16 cache view with
    ragged valid lengths ``vl``: held against the f32 plain version
    (within ATTN_TOL and, element by element, within ``_bf16_tol``) and
    timed beside it and SDPA. With ``traps`` (every row valid past 64) the
    check must also reject the plain version with the first 64 keys of
    every row dropped."""
    g = _gen(seed)

    def make():
        q = torch.randn(b, h, d, generator=g, device=dev).bfloat16()
        # layer 1 of a (reps, B, C, KV, hd) pool, as the model passes it
        kp = torch.randn(2, b, c, kv, d, generator=g, device=dev).bfloat16()
        vp = torch.randn(2, b, c, kv, d, generator=g, device=dev).bfloat16()
        return q, kp[1], vp[1]

    q, k, v = make()
    out = decode_attention(q, k, v, vl)
    rout = ref.decode_attention_ref(q.float(), k.float(), v.float(), vl)
    torch.cuda.synchronize()
    err = float((out.float() - rout).abs().max())
    what = f"decode_attention B={b} H={h} KV={kv} hd={d} C={c}"
    check(err <= ATTN_TOL, f"{what} within {ATTN_TOL} ({err})")
    tol = _bf16_tol(rout)
    row = dict(err_over_tol=_held(out, rout, tol, what))
    if traps:
        check(int(vl.min()) > 64, f"{what}: every row valid past 64")
        row["traps_over_tol"] = _traps_rejected(rout, tol, {
            "the first 64 keys dropped": ref.decode_attention_ref(
                q.float(), k[:, 64:].float(), v[:, 64:].float(), vl - 64)},
            what)
    n_valid = int(vl.sum())
    nbytes = (2 * b * h * d * 2 + 2 * n_valid * kv * d * 2 + b * 4)
    sets = [make() for _ in range(copies(nbytes))]
    mask = (torch.arange(c, device=dev)[None, :] < vl[:, None])[:, None,
                                                                None, :]
    kms = device_ms([lambda s=s: decode_attention(s[0], s[1], s[2], vl)
                     for s in sets])
    pms = device_ms([lambda s=s: ref.decode_attention_ref(s[0], s[1], s[2],
                                                          vl)
                     for s in sets])
    lms = device_ms([lambda s=s: F.scaled_dot_product_attention(
        s[0][:, :, None], s[1].transpose(1, 2), s[2].transpose(1, 2),
        attn_mask=mask, enable_gqa=True) for s in sets])
    flops = 4 * h * d * n_valid
    bms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    return dict(max_abs_err=err, **row,
                shape=f"B={b} H={h} KV={kv} hd={d} C={c} bf16 "
                      f"valid_len={vl.tolist()}",
                ms=kms, plain_ms=pms, library_ms=lms,
                library="F.scaled_dot_product_attention(enable_gqa)",
                bound_ms=bms, bound_by=by, bound_bytes=nbytes,
                bound_flops=flops)


def _check_decode_f32(dev, b, h, kv, d, c, vl, seed) -> float:
    """The f32 kernel (f32 q over an f32 cache, as ``greedy_generate``
    runs it, and over the engine's bf16 slot pool) against the f32 plain
    version within F32_ATTN_TOL. Returns the larger error."""
    g = _gen(seed)
    q = torch.randn(b, h, d, generator=g, device=dev)
    k = torch.randn(b, c, kv, d, generator=g, device=dev)
    v = torch.randn(b, c, kv, d, generator=g, device=dev)
    worst = 0.0
    for kk, vv in ((k, v), (k.bfloat16(), v.bfloat16())):
        out = decode_attention(q, kk, vv, vl)
        rout = ref.decode_attention_ref(q, kk.float(), vv.float(), vl)
        torch.cuda.synchronize()
        err = float((out - rout).abs().max())
        check(err <= F32_ATTN_TOL,
              f"f32 decode_attention (cache {kk.dtype}) B={b} H={h} KV={kv} "
              f"hd={d} C={c} within {F32_ATTN_TOL} ({err})")
        worst = max(worst, err)
    return worst


def _time_decode_lse(dev, b, h, kv, d, c, vl, seed) -> dict:
    """The decode kernel's log-sum-exp form at one shape (bf16 cache, valid
    lengths ``vl``, an empty row included): its output bit-equal to a call
    without the LSE, held to ``_bf16_tol`` of the f32 plain version, and
    its (B, H) f32 LSE within LSE_TOL of the plain version's (-inf exactly
    where a row has no valid key). Timed beside the plain version (with
    its LSE) and SDPA; the bound adds the LSE's bytes to the decode's."""
    g = _gen(seed)

    def make():
        return (torch.randn(b, h, d, generator=g, device=dev).bfloat16(),
                torch.randn(b, c, kv, d, generator=g, device=dev).bfloat16(),
                torch.randn(b, c, kv, d, generator=g, device=dev).bfloat16())

    q, k, v = make()
    out, lse = decode_attention(q, k, v, vl, return_lse=True)
    plain = decode_attention(q, k, v, vl)
    rout, rlse = ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                          vl, return_lse=True)
    torch.cuda.synchronize()
    what = f"decode_attention LSE form B={b} H={h} KV={kv} hd={d} C={c}"
    check(torch.equal(out, plain), f"{what}: output bit-equal to a call "
                                   f"without the LSE")
    ratio = _held(out, rout, _bf16_tol(rout), what)
    empty = rlse == -math.inf
    check(bool(torch.equal(lse == -math.inf, empty)),
          f"{what}: LSE -inf exactly on the rows with no valid key")
    check(bool((out[vl == 0] == 0).all()), f"{what}: empty rows give 0")
    lse_err = float((lse[~empty] - rlse[~empty]).abs().max())
    check(lse_err <= LSE_TOL, f"{what}: LSE within {LSE_TOL} ({lse_err})")
    n_valid = int(vl.sum())
    nbytes = 2 * b * h * d * 2 + 2 * n_valid * kv * d * 2 + b * 4 + b * h * 4
    sets = [make() for _ in range(copies(nbytes))]
    mask = (torch.arange(c, device=dev)[None, :] < vl[:, None])[:, None,
                                                                None, :]
    kms = device_ms([lambda t=t: decode_attention(*t, vl, return_lse=True)
                     for t in sets])
    pms = device_ms([lambda t=t: ref.decode_attention_ref(
        *t, vl, return_lse=True) for t in sets])
    lms = device_ms([lambda t=t: F.scaled_dot_product_attention(
        t[0][:, :, None], t[1].transpose(1, 2), t[2].transpose(1, 2),
        attn_mask=mask, enable_gqa=True) for t in sets])
    bms, by = bound(nbytes, 4 * h * d * n_valid, BF16_FLOP_PER_S)
    return dict(shape=f"B={b} H={h} KV={kv} hd={d} C={c} bf16 LSE form "
                      f"valid_len={vl.tolist()}",
                max_abs_err=float((out.float() - rout).abs().max()),
                err_over_tol=ratio, lse_max_abs_err=lse_err, ms=kms,
                plain_ms=pms, library_ms=lms,
                library="F.scaled_dot_product_attention(enable_gqa)",
                bound_ms=bms, bound_by=by, bound_bytes=nbytes,
                bound_flops=4 * h * d * n_valid)


def _time_decode_shards(dev, n, b, h, kv, d, c, ci, seed) -> dict:
    """The sharded flash-decode run as n cache shards in turn on one card:
    each chunk of C / n slots through ``_flash_decode_shard`` (its slot
    write and the decode kernel's LSE form over its valid slots; chunks
    past a row's position are empty), the partials merged by
    ``_combine_partials`` over a leading shard dim. Held to ``_bf16_tol``
    of the f32 plain version of one write + decode, and within twice it of
    the unsplit kernel; a combine with one shard's rescale dropped must
    fail the limit. Timed (the n launches and the combine) beside the
    unsplit kernel, the plain version and SDPA over the same cache."""
    from repro_torch.models import attention as attn_lib
    g = _gen(seed)
    q = torch.randn(b, h, d, generator=g, device=dev).bfloat16()
    kn, vn = (torch.randn(b, kv, d, generator=g, device=dev).bfloat16()
              for _ in range(2))
    kc, vc = (torch.randn(b, c, kv, d, generator=g, device=dev).bfloat16()
              for _ in range(2))
    rows = torch.arange(b, device=dev)
    k1, v1 = kc.clone(), vc.clone()
    k1[rows, ci], v1[rows, ci] = kn, vn
    rout = ref.decode_attention_ref(q.float(), k1.float(), v1.float(),
                                    ci + 1)
    unsplit = decode_attention(q, k1, v1, ci + 1)
    chunk = c // n

    def sharded():
        outs, lses = [], []
        for r in range(n):
            o, l_ = attn_lib._flash_decode_shard(
                q, kn, vn, kc[:, r * chunk:(r + 1) * chunk],
                vc[:, r * chunk:(r + 1) * chunk], ci, r * chunk)
            outs.append(o)
            lses.append(l_)
        outs, lses = torch.stack(outs), torch.stack(lses)
        return outs, lses, attn_lib._combine_partials(
            outs, lses, lambda t: t.amax(0), lambda t: t.sum(0)).to(q.dtype)

    outs, lses, out = sharded()
    torch.cuda.synchronize()
    what = f"flash-decode over {n} shards B={b} H={h} KV={kv} hd={d} C={c}"
    check(torch.equal(kc, k1) and torch.equal(vc, v1),
          f"{what}: each row's slot written in its own shard")
    check(bool(torch.isfinite(out).all()), f"{what}: finite (empty shards)")
    tol = _bf16_tol(rout)
    ratio = _held(out, rout, tol, what)
    vs_unsplit = float(((out.float() - unsplit.float()).abs() / tol).max())
    check(vs_unsplit <= 2.0, f"{what}: within twice the limit of the "
                             f"unsplit kernel ({vs_unsplit})")
    w = torch.exp(lses - lses.amax(0))
    worst = int(torch.argmin(torch.where(torch.isinf(lses), 2.0, w)
                             .amin((1, 2))))
    w[worst] = torch.where(torch.isinf(lses[worst]), 0.0, 1.0)
    trap = (outs * w[..., None]).sum(0) / w.sum(0)[..., None]
    traps = _traps_rejected(rout, tol, {
        f"shard {worst}'s rescale dropped": trap}, what)
    empty = int((lses == -math.inf).any(-1).sum())
    n_valid = int((ci + 1).sum())
    nbytes = 2 * b * h * d * 2 + 2 * n_valid * kv * d * 2 + b * 4
    kms = device_ms([lambda: sharded()])
    ums = device_ms([lambda: decode_attention(q, kc, vc, ci + 1)])
    pms = device_ms([lambda: ref.decode_attention_ref(q, kc, vc, ci + 1)])
    mask = (torch.arange(c, device=dev)[None, :] <= ci[:, None])[:, None,
                                                                 None, :]
    lms = device_ms([lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)])
    bms, by = bound(nbytes, 4 * h * d * n_valid, BF16_FLOP_PER_S)
    return dict(shape=f"{n} shards of B={b} H={h} KV={kv} hd={d} C={c} "
                      f"bf16, positions {ci.tolist()}",
                max_abs_err=float((out.float() - rout).abs().max()),
                err_over_tol=ratio, vs_unsplit_over_tol=vs_unsplit,
                traps_over_tol=traps, empty_shard_rows=empty, ms=kms,
                unsplit_ms=ums, plain_ms=pms, library_ms=lms,
                library="F.scaled_dot_product_attention(enable_gqa)",
                bound_ms=bms, bound_by=by, bound_bytes=nbytes,
                bound_flops=4 * h * d * n_valid)


def kernel_decode(dev) -> dict:
    """At qwen2-0.5b's shape (H 14, KV 2, hd 64; the row's shape) and at
    qwen3-32b's (H 64, KV 8, hd 128: a group of 8, the kernel's most), B 8,
    C 512, ragged valid lengths; at olmo-1b's decode steps (B 4, H 16 = KV
    16, a group of 1, hd 128, C 208, valid 201-208); at qwen2-moe-a2.7b's
    (B 8, H 16 = KV 16, hd 128, C 512, the same valid lengths) and at
    jamba-v0.1's (B 1, H 32, KV 8: a group of 4, hd 128, C 204, its last
    decode step's 204 valid); seamless-m4t's cross attention in a decode
    step (B 4, H 16 = KV 16, hd 64, C 500, every row valid to 500: one
    query over the encoder's keys); h2o-danube's hd 80 (H 32, KV 8) over
    its full 4,096-slot ring at B 1 and at B 8, C 512, qwen2's valid
    lengths. The cross and ring rows must also reject a kernel that drops
    64 keys. Then in f32 (f32 q over f32 and over bf16 caches) at
    qwen3-32b's heads (the f32 depth-cut check's decode), at danube's
    heads at B 8, C 512 and over the full ring, and at seamless's cross
    shape."""
    vl = torch.tensor([1, 2, 100, 256, 300, 511, 512, 512],
                      dtype=torch.int32, device=dev)
    qwen2 = _time_decode(dev, N_SLOTS, 14, 2, 64, MAX_LEN, vl, seed=7)
    qwen3 = _time_decode(dev, N_SLOTS, 64, 8, 128, MAX_LEN, vl, seed=8)
    olmo_c = PROMPT_HI + OLMO_STEPS
    olmo_vl = torch.tensor([PROMPT_HI + 1, PROMPT_HI + 4, PROMPT_HI + 6,
                            olmo_c], dtype=torch.int32, device=dev)
    olmo = _time_decode(dev, OLMO_BATCH, 16, 16, 128, olmo_c, olmo_vl,
                        seed=9)
    moe = _time_decode(dev, N_SLOTS, 16, 16, 128, MAX_LEN, vl, seed=14)
    jamba_c = PROMPT_HI + JAMBA_STEPS
    jamba = _time_decode(dev, 1, 32, 8, 128, jamba_c,
                         torch.tensor([jamba_c], dtype=torch.int32,
                                      device=dev), seed=15)
    cross_vl = torch.full((SEAMLESS_B,), SEAMLESS_SRC, dtype=torch.int32,
                          device=dev)
    seamless = _time_decode(dev, SEAMLESS_B, 16, 16, 64, SEAMLESS_SRC,
                            cross_vl, seed=16, traps=True)
    ring = get_config(DANUBE_ARCH).sliding_window
    ring_vl = torch.tensor([ring], dtype=torch.int32, device=dev)
    danube = _time_decode(dev, 1, 32, 8, 80, ring, ring_vl, seed=17,
                          traps=True)
    danube_b8 = _time_decode(dev, N_SLOTS, 32, 8, 80, MAX_LEN, vl, seed=18)
    f32 = max(_check_decode_f32(dev, N_SLOTS, 64, 8, 128, MAX_LEN, vl,
                                seed=10),
              _check_decode_f32(dev, N_SLOTS, 32, 8, 80, MAX_LEN, vl,
                                seed=19),
              _check_decode_f32(dev, 1, 32, 8, 80, ring, ring_vl, seed=26),
              _check_decode_f32(dev, SEAMLESS_B, 16, 16, 64, SEAMLESS_SRC,
                                cross_vl, seed=27))
    lse_vl = torch.cat([vl[:-1], torch.zeros(1, dtype=torch.int32,
                                             device=dev)])
    lse = _time_decode_lse(dev, N_SLOTS, 14, 2, 64, MAX_LEN, lse_vl, seed=70)
    lse_qwen3 = _time_decode_lse(dev, N_SLOTS, 64, 8, 128, MAX_LEN, lse_vl,
                                 seed=71)
    shards = {n: _time_decode_shards(dev, n, N_SLOTS, 14, 2, 64, MAX_LEN,
                                     vl - 1, seed=72 + n) for n in (2, 4, 8)}
    rows = (qwen2, qwen3, olmo, moe, jamba, seamless, danube, danube_b8,
            lse, lse_qwen3, *shards.values())
    row = dict(name="decode_attention", **qwen2, at_qwen3=qwen3,
               at_olmo=olmo, at_moe=moe, at_jamba=jamba,
               at_seamless=seamless, at_danube=danube,
               at_danube_b8=danube_b8, at_lse=lse, at_lse_qwen3=lse_qwen3,
               **{f"at_shards_n{n}": r for n, r in shards.items()},
               f32_max_abs_err=f32)
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    row["err_over_tol"] = max(r["err_over_tol"] for r in rows)
    return row


def _time_flash(dev, b, sq, sk, h, kv, d, causal, window, seed,
                traps=False) -> dict:
    """bf16 flash attention at one shape (full over Sk keys, causal, or
    windowed), held against the f32 plain version (within ATTN_TOL and,
    element by element, within ``_bf16_tol``; causal, a right-padded
    prompt's rows bit-identical to an unpadded call) and timed beside it
    and SDPA (a boolean mask for the window). With ``traps`` the check
    must also reject the plain version with the oldest 64 visible keys
    dropped (the full form: keys 0-63; causal: the window, or the causal
    span, 64 shorter) and, in the full form, with the zero-filled keys
    that pad Sk to a whole 64-key tile left unmasked."""
    g = _gen(seed)

    def make():
        return (torch.randn(b, sq, h, d, generator=g, device=dev).bfloat16(),
                torch.randn(b, sk, kv, d, generator=g, device=dev)
                .bfloat16(),
                torch.randn(b, sk, kv, d, generator=g, device=dev)
                .bfloat16())

    q, k, v = make()
    out = flash_attention(q, k, v, causal=causal, window=window)
    qf, kf, vf = q.float(), k.float(), v.float()
    rout = ref.flash_attention_ref(qf, kf, vf, causal=causal, window=window)
    torch.cuda.synchronize()
    err = float((out.float() - rout).abs().max())
    form = ("full" if not causal else
            f"window {window}" if window else "causal")
    what = f"flash_attention B={b} Sq={sq} Sk={sk} H={h} KV={kv} hd={d} " \
           f"{form}"
    check(err <= ATTN_TOL, f"{what} within {ATTN_TOL} ({err})")
    tol = _bf16_tol(rout, _flash_nu(qf, kf, vf, causal, window))
    row = dict(err_over_tol=_held(out, rout, tol, what))
    if traps and causal:
        row["traps_over_tol"] = _traps_rejected(rout, tol, {
            "the oldest 64 keys dropped": ref.flash_attention_ref(
                qf, kf, vf, window=(window or sq) - 64)}, what)
    elif traps:
        pad = torch.zeros(b, -sk % 64, kv, d, device=dev)
        row["traps_over_tol"] = _traps_rejected(rout, tol, {
            "the first 64 keys dropped": ref.flash_attention_ref(
                qf, kf[:, 64:], vf[:, 64:], causal=False),
            "the tile's pad keys unmasked": ref.flash_attention_ref(
                qf, torch.cat([kf, pad], 1), torch.cat([vf, pad], 1),
                causal=False)}, what)
    del rout, tol, qf, kf, vf
    if causal:
        # a ragged prompt right-padded into the bucket: its real rows are
        # bit-identical to an unpadded call
        n = max(sq - 23, 1)
        part = flash_attention(q[:, :n].contiguous(), k[:, :n].contiguous(),
                               v[:, :n].contiguous(), window=window)
        check(torch.equal(part, out[:, :n]),
              f"flash_attention right padding invisible (S={sq}, n={n})")
    nbytes = 2 * (2 * b * sq * h * d + 2 * b * sk * kv * d)
    sets = [make() for _ in range(copies(nbytes))]
    kms = device_ms([lambda t=t: flash_attention(
        *t, causal=causal, window=window) for t in sets])
    pms = device_ms([lambda t=t: ref.flash_attention_ref(
        *t, causal=causal, window=window) for t in sets], reps=3,
        per_window=4)
    if causal and window:
        i = torch.arange(sq, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        sdpa = dict(attn_mask=mask)
        pairs = int(mask.sum())
    else:
        sdpa = dict(is_causal=causal)
        pairs = sq * (sq + 1) // 2 if causal else sq * sk
    lms = device_ms([lambda t=t: F.scaled_dot_product_attention(
        t[0].transpose(1, 2), t[1].transpose(1, 2), t[2].transpose(1, 2),
        enable_gqa=True, **sdpa) for t in sets])
    flops = 4 * d * b * h * pairs
    bms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    return dict(shape=f"B={b} Sq={sq} Sk={sk} H={h} KV={kv} hd={d} {form} "
                      f"bf16", max_abs_err=err, **row, ms=kms, plain_ms=pms,
                library_ms=lms,
                library=f"F.scaled_dot_product_attention({form}, "
                        f"enable_gqa)",
                bound_ms=bms, bound_by=by, bound_bytes=nbytes,
                bound_flops=flops)


def _time_flash_q_offset(dev) -> tuple:
    """The flash forward and backward with ``q_offset`` at qwen2-0.5b's
    training shape (B 8, S 512, H 14 over KV 2, hd 64, causal, bf16) in 4
    query chunks of 128, each over the keys up to its end, as the
    sequence-parallel attention runs them: each chunk's output and dq
    bit-equal to the slices of the unchunked kernels' (the same key tiles
    in the same order), the output also within ``_bf16_tol`` of the f32
    plain version; the chunks' dk and dv summed within the bf16 roundings
    (2^-8 of each chunk's and of the whole's magnitudes) plus BWD_F32_TOL
    of the unchunked backward's; the plain version with the offset one
    position late must fail the forward's limit. The last chunk is timed
    (forward, then backward) beside its plain version and SDPA with the
    chunk's causal mask. Returns (forward row, backward row)."""
    b, s, h, kv, d, n = 8, 512, 14, 2, 64, 4
    c = s // n
    g = _gen(80)
    q = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(b, s, kv, d, generator=g, device=dev).bfloat16()
            for _ in range(2))
    do = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
    whole, lse_w = flash_attention(q, k, v, return_lse=True)
    dq_w, dk_w, dv_w = flash_attention_bwd(q, k, v, whole, do, lse=lse_w)
    qf, kf, vf = q.float(), k.float(), v.float()
    rout = ref.flash_attention_ref(qf, kf, vf)
    tol = _bf16_tol(rout, _flash_nu(qf, kf, vf, True, 0))
    what = f"flash_attention q_offset chunks B={b} S={s} H={h} KV={kv} hd={d}"
    dk_s, dv_s = torch.zeros_like(kf), torch.zeros_like(vf)
    dk_a, dv_a = torch.zeros_like(kf), torch.zeros_like(vf)
    ratio = err = 0.0
    chunks = []
    for r in range(n):
        end = (r + 1) * c
        qc, doc = q[:, r * c:end].contiguous(), do[:, r * c:end].contiguous()
        part, lse = flash_attention(qc, k[:, :end], v[:, :end],
                                    q_offset=r * c, return_lse=True)
        dq, dk, dv = flash_attention_bwd(qc, k[:, :end], v[:, :end], part,
                                         doc, q_offset=r * c, lse=lse)
        torch.cuda.synchronize()
        check(torch.equal(part, whole[:, r * c:end]),
              f"{what}: chunk {r}'s output bit-equal to the slice")
        check(torch.equal(dq, dq_w[:, r * c:end]),
              f"{what}: chunk {r}'s dq bit-equal to the slice")
        ratio = max(ratio, _held(part, rout[:, r * c:end],
                                 tol[:, r * c:end], what))
        err = max(err, float((part.float() - rout[:, r * c:end]).abs()
                             .max()))
        dk_s[:, :end] += dk.float()
        dv_s[:, :end] += dv.float()
        dk_a[:, :end] += dk.float().abs()
        dv_a[:, :end] += dv.float().abs()
        chunks.append((qc, doc, part, lse))
    bwd_ratio = bwd_err = 0.0
    for got, want, mag in ((dk_s, dk_w, dk_a), (dv_s, dv_w, dv_a)):
        lim = (mag + want.float().abs()) * 2.0 ** -8 \
            + BWD_F32_TOL * float(want.float().abs().max())
        bwd_err = max(bwd_err, float((got - want.float()).abs().max()))
        bwd_ratio = max(bwd_ratio, float(((got - want.float()).abs() / lim)
                                         .max()))
    check(bwd_ratio <= 1.0, f"{what}: dk, dv summed over the chunks within "
                            f"the bf16 roundings ({bwd_ratio})")
    end = 2 * c
    traps = _traps_rejected(rout[:, c:end], tol[:, c:end], {
        "the offset one position late": ref.flash_attention_ref(
            qf[:, c:end], kf[:, :end + 1], vf[:, :end + 1],
            q_offset=c + 1)}, what)
    del rout, tol, qf, kf, vf, dk_s, dv_s, dk_a, dv_a
    qc, doc, part, lse = chunks[-1]
    mask = (torch.arange(s, device=dev)[None, :]
            <= torch.arange(s - c, s, device=dev)[:, None])
    pairs = int(mask.sum())
    nbytes = 2 * (2 * b * c * h * d + 2 * b * s * kv * d)
    fms = device_ms([lambda: flash_attention(qc, k, v, q_offset=s - c)])
    fpms = device_ms([lambda: ref.flash_attention_ref(qc, k, v,
                                                      q_offset=s - c)],
                     reps=3, per_window=4)
    flms = device_ms([lambda: F.scaled_dot_product_attention(
        qc.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)])
    bms, by = bound(nbytes, 4 * d * b * h * pairs, BF16_FLOP_PER_S)
    shape = f"chunk 4 of 4: B={b} Sq={c} Sk={s} q_offset={s - c} H={h} " \
            f"KV={kv} hd={d} causal bf16"
    # the chunks' outputs against the f32 plain version (the unchunked
    # kernel's are the same bits); the chunks' summed dk, dv against the
    # unchunked kernel's
    fwd = dict(shape=shape, max_abs_err=err, err_over_tol=ratio,
               traps_over_tol=traps, ms=fms, plain_ms=fpms, library_ms=flms,
               library="F.scaled_dot_product_attention(chunk mask, "
                       "enable_gqa)", bound_ms=bms, bound_by=by,
               bound_bytes=nbytes, bound_flops=4 * d * b * h * pairs)
    bbytes = 2 * (3 * b * c * h * d + 2 * b * s * kv * d) \
        + 2 * (b * c * h * d + 2 * b * s * kv * d)
    kms = device_ms([lambda: flash_attention_bwd(qc, k, v, part, doc,
                                                 q_offset=s - c, lse=lse)])
    pms = device_ms([lambda: ref.flash_attention_bwd_ref(
        qc, k, v, part, doc, q_offset=s - c)], reps=3, per_window=2)
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (qc, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                             enable_gqa=True)
    lms = device_ms([lambda: torch.autograd.grad(
        lib_out, (qs, ks, vs), doc.transpose(1, 2), retain_graph=True)])
    bbms, bby = bound(bbytes, 10 * d * b * h * pairs, BF16_FLOP_PER_S)
    bwd = dict(shape=shape, max_abs_err=bwd_err, err_over_tol=bwd_ratio,
               ms=kms,
               plain_ms=pms, library_ms=lms,
               library="backward of F.scaled_dot_product_attention(chunk "
                       "mask, enable_gqa)", bound_ms=bbms, bound_by=bby,
               bound_bytes=bbytes, bound_flops=10 * d * b * h * pairs)
    return fwd, bwd


def kernel_flash(dev) -> dict:
    """Causal bf16: qwen2-0.5b's heads (H 14, KV 2, hd 64) at B 8, S 256
    (the row's shape) and at S 64, the most common prefill bucket;
    qwen3-32b's (H 64, KV 8, hd 128) at B 8, S 256; olmo-1b's (H 16 = KV
    16, hd 128) at B 4 and its forward's S 208 and prefill's S 200;
    qwen2-moe-a2.7b's exact-length batch-1 prefills (H 16 = KV 16, hd
    128) at the longest prompt (S 200) and a short one (S 16); jamba-v0.1's
    (H 32, KV 8, hd 128) at B 1, S 200. Then the forms of the
    encoder-decoder, vision-prefix and hd-80 paths:
    seamless-m4t's encoder (full, B 4, S 500, H 16 = KV 16, hd 64) and
    cross attention at prefill (full, Sq 32 over Sk 500), internvl2's
    prefill (causal, B 4, S 456 = 256 prefix + 200 text, H 14, KV 2) and
    h2o-danube's (window 4,096, B 1, S 4,200, H 32, KV 8, hd 80), each of
    these four also rejecting a kernel that drops 64 visible keys or, in
    the full form, leaves Sk's pad keys unmasked. Then f32
    at qwen3-32b's heads, as the f32 depth-cut check runs it: its
    engine's B 4 x 256 bucket and the batch-1 forward of the first
    request (204 tokens); and at danube's hd 80, windowed."""
    olmo_s = PROMPT_HI + OLMO_STEPS
    timed = {(b, s, h): _time_flash(dev, b, s, s, h, kv, d, True, 0,
                                    seed=30 + i)
             for i, (b, s, h, kv, d) in enumerate((
                 (N_SLOTS, 64, 14, 2, 64), (N_SLOTS, 256, 14, 2, 64),
                 (N_SLOTS, 256, 64, 8, 128),
                 (OLMO_BATCH, olmo_s, 16, 16, 128),
                 (OLMO_BATCH, PROMPT_HI, 16, 16, 128),
                 (1, PROMPT_HI, 16, 16, 128), (1, PROMPT_LO, 16, 16, 128),
                 (1, PROMPT_HI, 32, 8, 128)))}
    g = _gen(11)
    f32 = 0.0
    for b, s in ((4, 256), (1, 204)):
        q = torch.randn(b, s, 64, 128, generator=g, device=dev)
        k = torch.randn(b, s, 8, 128, generator=g, device=dev)
        v = torch.randn(b, s, 8, 128, generator=g, device=dev)
        out = flash_attention(q, k, v)
        rout = ref.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = float((out - rout).abs().max())
        check(err <= F32_ATTN_TOL, f"f32 flash_attention B={b} S={s} H=64 "
                                   f"KV=8 hd=128 within {F32_ATTN_TOL} "
                                   f"({err})")
        f32 = max(f32, err)
    q = torch.randn(1, 300, 32, 80, generator=g, device=dev)
    k = torch.randn(1, 300, 8, 80, generator=g, device=dev)
    v = torch.randn(1, 300, 8, 80, generator=g, device=dev)
    out = flash_attention(q, k, v, window=100)
    rout = ref.flash_attention_ref(q, k, v, window=100)
    torch.cuda.synchronize()
    err = float((out - rout).abs().max())
    check(err <= F32_ATTN_TOL, f"f32 flash_attention hd=80 window 100 "
                               f"within {F32_ATTN_TOL} ({err})")
    f32 = max(f32, err)
    seamless = _time_flash(dev, SEAMLESS_B, SEAMLESS_SRC, SEAMLESS_SRC, 16,
                           16, 64, False, 0, seed=20, traps=True)
    cross = _time_flash(dev, SEAMLESS_B, SEAMLESS_PROMPT, SEAMLESS_SRC, 16,
                        16, 64, False, 0, seed=21, traps=True)
    n_vlm = get_config(INTERNVL_ARCH).frontend.num_prefix_embeddings \
        + INTERNVL_TEXT
    internvl = _time_flash(dev, INTERNVL_B, n_vlm, n_vlm, 14, 2, 64, True, 0,
                           seed=22, traps=True)
    danube = _time_flash(dev, DANUBE_B, DANUBE_PROMPT, DANUBE_PROMPT, 32, 8,
                         80, True, get_config(DANUBE_ARCH).sliding_window,
                         seed=23, traps=True)
    rows = (*timed.values(), seamless, cross, internvl, danube)
    Q_OFFSET["fwd"], Q_OFFSET["bwd"] = _time_flash_q_offset(dev)
    row = dict(name="flash_attention", **timed[N_SLOTS, 256, 14],
               at_q_offset=Q_OFFSET["fwd"],
               at_s64=timed[N_SLOTS, 64, 14],
               at_qwen3=timed[N_SLOTS, 256, 64],
               at_olmo=timed[OLMO_BATCH, olmo_s, 16],
               at_olmo_s200=timed[OLMO_BATCH, PROMPT_HI, 16],
               at_moe=timed[1, PROMPT_HI, 16],
               at_moe_s16=timed[1, PROMPT_LO, 16],
               at_jamba=timed[1, PROMPT_HI, 32],
               at_seamless=seamless, at_seamless_cross=cross,
               at_internvl=internvl, at_danube=danube,
               f32_max_abs_err=f32)
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    row["err_over_tol"] = max(r["err_over_tol"] for r in rows)
    return row


def kernel_mamba(dev) -> dict:
    """The selective scan at the SSM prefill's shapes (falcon-mamba-7b:
    Di 8192, N 16, x bf16): B 1 at the longest prompt (the row's shape)
    and at S 64, the short end of the prefills, then B 2 at an odd length
    from a nonzero state; y, h_last and the chunk states (the training
    path's output) against the plain scan, and y and h_last the same bits
    with and without the states."""
    di, n = 8192, 16
    g = _gen(13)

    def make(b, s, with_h0=False):
        dt = F.softplus(torch.randn(b, s, di, generator=g, device=dev)
                        * 0.5 - 3.0)
        a = -torch.exp(torch.rand(di, n, generator=g, device=dev) * 1.1)
        bm = torch.randn(b, s, n, generator=g, device=dev)
        cm = torch.randn(b, s, n, generator=g, device=dev)
        d = torch.ones(di, device=dev)
        x = torch.randn(b, s, di, generator=g, device=dev).bfloat16()
        h0 = (torch.randn(b, di, n, generator=g, device=dev)
              if with_h0 else None)
        return dt, a, bm, cm, d, x, h0

    worst = 0.0
    for b, s, with_h0 in ((1, PROMPT_HI, False), (1, 64, False),
                          (2, 33, True)):
        ins = make(b, s, with_h0)
        ry, rh, rst = ref.mamba_scan_ref(*ins, return_states=True)
        y, h = mamba_scan(*ins)
        ys, hs, st = mamba_scan(*ins, return_states=True)
        torch.cuda.synchronize()
        err = max(float((y - ry).abs().max()), float((h - rh).abs().max()),
                  float((st - rst).abs().max()))
        check(err <= SCAN_TOL, f"mamba_scan B={b} S={s} y, h_last and the "
                               f"chunk states within {SCAN_TOL} ({err})")
        check(_same_bits(y, ys) and _same_bits(h, hs),
              f"mamba_scan B={b} S={s}: y and h_last the same bits with "
              f"and without the states")
        worst = max(worst, err)
    timed = {}
    for b, s in ((1, PROMPT_HI), (1, 64)):
        nbytes = (b * s * di * (4 + 2 + 4) + 2 * b * s * n * 4 + di * n * 4
                  + di * 4 + b * di * n * 4)
        sets = [make(b, s) for _ in range(copies(nbytes))]
        kms = device_ms([lambda t=t: mamba_scan(*t) for t in sets])
        pms = device_ms([lambda t=t: ref.mamba_scan_ref(*t) for t in sets],
                        reps=3, per_window=2)
        # per state and step: dt*a, exp, the fused update (2), B and C
        # products, the N-sum: 6 f32 flops and one exponential; the
        # exponentials are the operation count that binds
        exps = b * s * di * n
        bms, by = _scan_bound(nbytes, exps, 6)
        timed[s] = dict(shape=f"B={b} S={s} Di={di} N={n} x bf16, f32 "
                              f"state",
                        ms=kms, plain_ms=pms, library_ms=None,
                        library=None, bound_ms=bms, bound_by=by,
                        bound_bytes=nbytes, bound_flops=exps)
    return dict(name="mamba_scan", max_abs_err=worst, **timed[PROMPT_HI],
                at_s64=timed[64])


def _step_inputs(dev, g, b, di, n, dtype, pool=None):
    """One Mamba-1 decode step's kernel inputs at falcon-mamba-7b's
    scales (d_conv 4, dt_rank 256): x_new and z as the halves of one
    in_proj output, B and C as column views of one x_proj output, the conv
    pool in ``pool`` (default: ``dtype``) and an f32 state."""
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale
    xz = r(b, 1, 2 * di).to(dtype)
    dbc = r(b, 1, 256 + 2 * n).to(dtype)
    conv = (xz[..., :di], r(b, 3, di).to(pool or dtype),
            r(4, di, scale=0.5).to(dtype), r(di, scale=0.1).to(dtype))
    ssm = (r(b, 1, di).to(dtype), torch.rand(di, generator=g, device=dev)
           * 2.0 - 4.0, torch.rand(di, n, generator=g, device=dev) * 1.1,
           dbc[..., 256:256 + n], dbc[..., 256 + n:], r(di),
           r(b, 1, di).to(dtype), xz[..., di:], r(b, di, n))
    return conv, ssm


def _step_err(got, want) -> float:
    """The largest |got - want| over its limit: in bf16 MAMBA_STEP_ULPS
    units in the last place of ``want`` (at least 2^-17: the f32 sums'
    own error near a cancellation), in f32 MAMBA_STEP_F32_TOL absolute
    plus relative."""
    w, d = want.float(), (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
        return float((d / (MAMBA_STEP_ULPS * ulp.clamp_min(2.0 ** -17)))
                     .max())
    return float((d / (MAMBA_STEP_F32_TOL * (1.0 + w.abs()))).max())


def _step_check(conv, ssm, what: str) -> dict:
    """Both decode-step kernels against their plain versions on clones of
    the same card inputs: the conv state and the SSM state bit-equal (the
    same roundings op for op), xc and out within their limits
    (``_step_err``: the sums over K and N follow another order than
    cuBLAS's, then pass two or three roundings), at most
    MAMBA_STEP_DIFFER of their elements not bit-equal in bf16."""
    pool, rpool = conv[1], conv[1].clone()
    before = (mamba_conv_step.launches, mamba_ssm_step.launches)
    xc = mamba_conv_step(*conv)
    rxc = ref.mamba_conv_step_ref(conv[0], rpool, conv[2], conv[3])
    h, rh = ssm[8], ssm[8].clone()
    out = mamba_ssm_step(*ssm[:6], xc, ssm[7], h)
    rout = ref.mamba_ssm_step_ref(*ssm[:6], xc, ssm[7], rh)
    torch.cuda.synchronize()
    check((mamba_conv_step.launches, mamba_ssm_step.launches)
          == (before[0] + 1, before[1] + 1), f"{what}: one launch each")
    row = {"xc_over_tol": _step_err(xc, rxc),
           "out_over_tol": _step_err(out, rout),
           "xc_differ": float((xc != rxc).float().mean()),
           "out_differ": float((out != rout).float().mean()),
           "conv_state_equal": torch.equal(pool, rpool),
           "ssm_state_equal": torch.equal(h, rh),
           "ssm_state_max_abs_err": float((h - rh).abs().max())}
    check(row["conv_state_equal"] and row["ssm_state_equal"],
          f"{what}: conv and SSM states bit-equal to the plain version's "
          f"({row})")
    # in f32 every sum's last bit may differ; in bf16 few survive rounding
    check(max(row["xc_over_tol"], row["out_over_tol"]) <= 1.0
          and (out.dtype != torch.bfloat16 or max(
              row["xc_differ"], row["out_differ"]) <= MAMBA_STEP_DIFFER),
          f"{what}: xc and out within their limits, in bf16 at most "
          f"{MAMBA_STEP_DIFFER} of them not bit-equal ({row})")
    return row


def kernel_mamba_step(dev) -> list:
    """The Mamba-1 decode step's two kernels (no TPU counterpart: the JAX
    model's jnp chain, which ``ref`` keeps as their plain versions) at
    falcon-mamba-7b's width (Di 8192, N 16, bf16): B 32 (the benchmark's
    slots) is each row's shape, B 1 (jamba's forward) its ``at_b1``; held
    against the plain versions there and at N 4 and 8, f32 activations
    over an f32 and a narrow bf16 pool (``_step_check``). Timed with the
    plain chain (one row's ``plain_ms``) and the pair (``at_pair_*``:
    both kernels against the whole plain step, x_proj and dt_proj left
    out of both). Returns the two rows."""
    g = _gen(17)
    di = 8192
    checks = {}
    for b, n, dtype, pool in ((32, 16, torch.bfloat16, None),
                              (1, 16, torch.bfloat16, None),
                              (3, 4, torch.bfloat16, None),
                              (5, 8, torch.bfloat16, None),
                              (4, 16, torch.float32, None),
                              (4, 8, torch.float32, torch.bfloat16)):
        what = (f"mamba_step B={b} N={n} {str(dtype)[6:]}"
                + (f" pool {str(pool)[6:]}" if pool else ""))
        checks[what] = _step_check(*_step_inputs(dev, g, b, di, n, dtype,
                                                 pool), what)
    rows = {"mamba_ssm_step": {}, "mamba_conv_step": {}}
    for b in (32, 1):
        n, es = 16, 2
        ssm_bytes = (2 * b * di * n * 4 + di * n * 4 + 3 * di * 4
                     + 4 * b * di * es + 2 * b * n * es)
        conv_bytes = 2 * b * di * 3 * es + 2 * b * di * es + 5 * di * es
        sets = [_step_inputs(dev, g, b, di, n, torch.bfloat16)
                for _ in range(copies(ssm_bytes + conv_bytes))]
        xcs = [mamba_conv_step(*c) for c, _ in sets]
        conv_ms = device_ms([lambda c=c: mamba_conv_step(*c)
                             for c, _ in sets])
        ssm_ms = device_ms([lambda s=s, x=x: mamba_ssm_step(*s[:6], x, s[7],
                                                            s[8])
                            for (_, s), x in zip(sets, xcs)])
        pair_ms = device_ms([lambda c=c, s=s: mamba_ssm_step(
            *s[:6], mamba_conv_step(*c), s[7], s[8]) for c, s in sets])
        conv_pms = device_ms([lambda c=c: ref.mamba_conv_step_ref(*c)
                              for c, _ in sets])
        ssm_pms = device_ms([lambda s=s, x=x: ref.mamba_ssm_step_ref(
            *s[:6], x, s[7], s[8]) for (_, s), x in zip(sets, xcs)])
        pair_pms = device_ms([lambda c=c, s=s: ref.mamba_ssm_step_ref(
            *s[:6], ref.mamba_conv_step_ref(*c), s[7], s[8])
            for c, s in sets])
        # two exponentials a state (A and the decay) and softplus's two
        # a channel; the state's read and write bind
        sb = _scan_bound(ssm_bytes, b * di * (2 * n + 2), 8)
        cb = bound(conv_bytes, 2.0 * b * 4 * di, FP32_FLOP_PER_S)
        pb = bound(ssm_bytes + conv_bytes, 0.0, FP32_FLOP_PER_S)
        shape = f"B={b} Di={di} N={n} bf16, f32 state, d_conv 4"
        for name, ms, pms, (bms, by), nb in (
                ("mamba_ssm_step", ssm_ms, ssm_pms, sb, ssm_bytes),
                ("mamba_conv_step", conv_ms, conv_pms, cb, conv_bytes)):
            rows[name][b] = dict(shape=shape, ms=ms, plain_ms=pms,
                                 library_ms=None, library=None, bound_ms=bms,
                                 bound_by=by, bound_bytes=nb,
                                 hbm_share=bms / ms)
        rows["mamba_ssm_step"][b]["pair"] = dict(
            shape=shape + ", conv and SSM kernels", ms=pair_ms,
            plain_ms=pair_pms, bound_ms=pb[0], bound_by=pb[1])
    out = []
    for name, by_b in rows.items():
        row = dict(name=name, checks=checks, max_abs_err=max(
                       c["ssm_state_max_abs_err"] for c in checks.values()),
                   err_over_tol=max(max(c["xc_over_tol"], c["out_over_tol"])
                                    for c in checks.values()),
                   **by_b[32], at_b1=by_b[1])
        if name == "mamba_ssm_step":
            row["at_pair_b32"] = row.pop("pair")
            row["at_pair_b1"] = row["at_b1"].pop("pair")
        out.append(row)
    return out


def _bwd_plain(q, k, v, o, do, causal, window):
    """The plain backward in f32 with D_i = dO_i . o_i read from the ``o``
    given, as the kernel reads it."""
    return ref.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, o, do)),
                                       causal=causal, window=window)


def _time_flash_bwd(dev, name, b, sq, sk, h, kv, d, causal, window, seed,
                    traps=()) -> dict:
    """The backward kernel at one training shape. f32: dq, dk, dv within
    BWD_F32_TOL of each gradient's largest entry in the plain backward.
    bf16 (o the f32 plain output rounded to bf16, as a forward kernel
    hands it over): each element within the kernel's own roundings of
    ``_bwd_plain`` on the same inputs, as ``_bf16_tol`` holds the forward:
    its f32 result rounded once to bf16 (2^-8 of the value), P and dS
    rounded to bf16 operands (P_ROUND_SIGMAS x 2^-8 x the root-sum-square
    of the terms each rounding moves, ``rounding_scale``), plus
    BWD_F32_TOL of the largest entry; the ``traps`` (``"pad"``: the full
    form's pad keys to a whole 64-key tile left unmasked; ``"window"``:
    the window's lower edge one key late) must fall outside that limit.
    The bf16 backward reads the log-sum-exp that the forward kernel
    writes on the same q and k (held within FLASH_LSE_TOL of the plain
    version's, the forward's output bit-equal to a launch without it),
    and two calls give the same bits.
    Timed (bf16) beside the plain backward
    and the backward of SDPA on the same tensors (a yardstick; the port
    never calls it) against the least time the card needs: q, k, v, o, dO
    read and dq, dk, dv written once, or 10 hd flops per visible
    query-key pair and head (the five score-sized products: Q.K^T again,
    dO.V^T, dS.K, dS^T.Q and P^T.dO; about 2.5x the forward's) at the
    bf16 peak."""
    g = _gen(seed)
    form = ("full" if not causal else
            f"window {window}" if window else "causal")
    what = f"flash_attention_bwd {name} B={b} Sq={sq} Sk={sk} H={h} " \
           f"KV={kv} hd={d} {form}"

    def make(dtype):
        q = torch.randn(b, sq, h, d, generator=g, device=dev)
        k = torch.randn(b, sk, kv, d, generator=g, device=dev)
        v = torch.randn(b, sk, kv, d, generator=g, device=dev)
        do = torch.randn(b, sq, h, d, generator=g, device=dev)
        q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
        o = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                    causal=causal, window=window)
        # dense, as the forward kernel hands it over (the plain version's
        # einsum may leave it permuted, which the wrapper would copy)
        return q, k, v, o.to(dtype).contiguous(), do

    ins = make(torch.float32)
    got = flash_attention_bwd(*ins, causal=causal, window=window)
    want = _bwd_plain(*ins, causal, window)
    torch.cuda.synchronize()
    f32 = max(float((x - r).abs().max() / r.abs().max())
              for x, r in zip(got, want))
    check(f32 <= BWD_F32_TOL, f"f32 {what} within {BWD_F32_TOL} ({f32})")
    del ins, got, want
    ins = make(torch.bfloat16)
    out, lse = flash_attention(*ins[:3], causal=causal, window=window,
                               return_lse=True)
    lse_err = float((lse - ref.flash_attention_lse_ref(
        *ins[:2], causal=causal, window=window)).abs().max())
    check(lse_err <= FLASH_LSE_TOL, f"{what}: the forward's LSE within "
                                    f"{FLASH_LSE_TOL} ({lse_err})")
    check(torch.equal(out, flash_attention(*ins[:3], causal=causal,
                                           window=window)),
          f"{what}: the forward's output bit-equal with and without the "
          f"LSE")
    del out
    got = flash_attention_bwd(*ins, causal=causal, window=window, lse=lse)
    again = flash_attention_bwd(*ins, causal=causal, window=window, lse=lse)
    want = _bwd_plain(*ins, causal, window)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"{what}: two calls bit-equal")
    del again
    err = max(float((x.float() - r).abs().max()) for x, r in zip(got, want))
    rel = max(float((x.float() - r).abs().max() / r.abs().max())
              for x, r in zip(got, want))
    tols = [(r.abs() + P_ROUND_SIGMAS * nu) * 2.0 ** -8
            + BWD_F32_TOL * r.abs().max()
            for r, nu in zip(want, rounding_scale(*ins, causal, window))]
    ratio = max(float(((x.float() - r).abs() / t).max())
                for x, r, t in zip(got, want, tols))
    check(ratio <= 1.0, f"{what} within the bf16 rounding limit ({ratio} "
                        f"of it)")
    row = dict(err_over_tol=ratio, max_rel_err=rel, f32_max_rel_err=f32,
               lse_max_abs_err=lse_err, bit_equal_repeat=True)
    if traps:
        q, k, v, o, do = ins
        bad = {}
        if "pad" in traps:
            pad = torch.zeros(b, -sk % 64, kv, d, device=dev,
                              dtype=k.dtype)
            tq, tk, tv = _bwd_plain(q, torch.cat([k, pad], 1),
                                    torch.cat([v, pad], 1), o, do, False, 0)
            bad["the tile's pad keys unmasked"] = (tq, tk[:, :sk],
                                                   tv[:, :sk])
        if "window" in traps:
            bad["the window's edge one key late"] = _bwd_plain(
                q, k, v, o, do, True, window + 1)
        row["traps_over_tol"] = {}
        for trap, outs in bad.items():
            r = max(float(((x.bfloat16().float() - w).abs() / t).max())
                    for x, w, t in zip(outs, want, tols))
            row["traps_over_tol"][trap] = r
            check(r > 1.0, f"{what}: a kernel with {trap} fails the check "
                           f"({r} of the limit)")
        del bad
    del got, want, tols
    nbytes = 2 * (3 * b * sq * h * d + 2 * b * sk * kv * d) \
        + 2 * (b * sq * h * d + 2 * b * sk * kv * d)
    sets = [ins] + [make(torch.bfloat16)
                    for _ in range(copies(nbytes) - 1)]
    lses = [lse] + [ref.flash_attention_lse_ref(
        *t[:2], causal=causal, window=window) for t in sets[1:]]
    kms = device_ms([lambda t=t, l=l: flash_attention_bwd(
        *t, causal=causal, window=window, lse=l)
        for t, l in zip(sets, lses)])
    pms = device_ms([lambda t=t: ref.flash_attention_bwd_ref(
        *t, causal=causal, window=window) for t in sets[:2]], reps=3,
        per_window=2)
    if causal:
        i = torch.arange(sq, device=dev)
        mask = i[None, :] <= i[:, None]
        if window:
            mask &= i[None, :] > i[:, None] - window
        pairs = int(mask.sum())
        sdpa = dict(attn_mask=mask) if window else dict(is_causal=True)
    else:
        pairs = sq * sk
        sdpa = {}
    lib = []
    for q, k, v, _, do in sets[:2]:
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True,
                                             **sdpa)
        lib.append((out, (qs, ks, vs), do.transpose(1, 2)))
    lms = device_ms([lambda t=t: torch.autograd.grad(
        t[0], t[1], t[2], retain_graph=True) for t in lib])
    del lib, sets, lses
    flops = 10 * d * b * h * pairs
    bms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    return dict(shape=f"{name}: B={b} Sq={sq} Sk={sk} H={h} KV={kv} hd={d} "
                      f"{form} bf16", max_abs_err=err, **row, ms=kms,
                plain_ms=pms, library_ms=lms,
                library=f"backward of F.scaled_dot_product_attention("
                        f"{form}, enable_gqa)",
                bound_ms=bms, bound_by=by, bound_bytes=nbytes,
                bound_flops=flops)


def kernel_flash_bwd(dev) -> dict:
    """The flash-attention backward at each training phase's attention
    shape: qwen2-0.5b (B 8, S 512, H 14 over KV 2, hd 64, causal; the
    row's shape), olmo-1b (B 4, S 512, H 16 = KV 16, hd 128), h2o-danube
    (B 1, S 4,200, H 32 over KV 8, hd 80, window 4,096; the window's edge
    trap), internvl2 (B 4, S 456, causal), seamless's encoder (full, B 4,
    S 500, H 16 = KV 16, hd 64) and cross attention (full, Sq 128 over
    Sk 500), both with the pad-key trap, and its decoder's self-attention
    (causal, B 4, S 128) (``_time_flash_bwd``)."""
    cfg = get_config(DANUBE_ARCH)
    rows = {
        "qwen2": _time_flash_bwd(dev, "qwen2-0.5b", 8, 512, 512, 14, 2, 64,
                                 True, 0, seed=40),
        "olmo": _time_flash_bwd(dev, "olmo-1b", 4, 512, 512, 16, 16, 128,
                                True, 0, seed=41),
        "danube": _time_flash_bwd(dev, "h2o-danube-1.8b", 1, 4200, 4200, 32,
                                  8, 80, True, cfg.sliding_window, seed=42,
                                  traps=("window",)),
        "internvl": _time_flash_bwd(dev, "internvl2-1b", 4, 456, 456, 14, 2,
                                    64, True, 0, seed=43),
        "seamless": _time_flash_bwd(dev, "seamless encoder", 4, TRAIN_SRC,
                                    TRAIN_SRC, 16, 16, 64, False, 0,
                                    seed=44, traps=("pad",)),
        "seamless_cross": _time_flash_bwd(dev, "seamless cross", 4, 128,
                                          TRAIN_SRC, 16, 16, 64, False, 0,
                                          seed=45, traps=("pad",)),
        "seamless_decoder": _time_flash_bwd(dev, "seamless decoder", 4, 128,
                                            128, 16, 16, 64, True, 0,
                                            seed=46),
    }
    row = dict(name="flash_attention_bwd", **rows["qwen2"],
               **{f"at_{k}": r for k, r in rows.items() if k != "qwen2"},
               at_q_offset=Q_OFFSET["bwd"])
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    row["err_over_tol"] = max(r["err_over_tol"] for r in rows.values())
    for key in ("max_rel_err", "f32_max_rel_err"):
        row[key] = max(r[key] for r in rows.values())
    return row


def _scan_inputs(dev, g, b, s, di, n, x_dtype, with_h0=False,
                 with_dh=False):
    """Selective-scan operands as the SSM layer makes them (dt a softplus
    around 0.05, a = -exp(U(0, 1.1))), a cotangent dy, and dh_last."""
    dt = F.softplus(torch.randn(b, s, di, generator=g, device=dev) * 0.5
                    - 3.0)
    a = -torch.exp(torch.rand(di, n, generator=g, device=dev) * 1.1)
    bm = torch.randn(b, s, n, generator=g, device=dev)
    cm = torch.randn(b, s, n, generator=g, device=dev)
    d = torch.randn(di, generator=g, device=dev)
    x = torch.randn(b, s, di, generator=g, device=dev).to(x_dtype)
    h0 = torch.randn(b, di, n, generator=g, device=dev) if with_h0 else None
    dy = torch.randn(b, s, di, generator=g, device=dev)
    dh = torch.randn(b, di, n, generator=g, device=dev) if with_dh else None
    return (dt, a, bm, cm, d, x, h0, dy, dh)


def _scan_bwd_trap(dt, a, bm, cm, d, x, h0, dy, dh, trap: str):
    """``ref.mamba_scan_bwd_ref`` with one kernel bug built in: ``"decay"``
    carries g_{t+1} into step t with step t's own decay e_t, not e_{t+1};
    ``"h0"`` drops the initial state's term (the states start from zero);
    ``"late"`` starts each chunk after the first from the forward's state
    of the chunk before it (the states read a chunk late). Returns its
    (ddt, da, db, dc, dd, dx)."""
    if trap == "h0":
        return ref.mamba_scan_bwd_ref(dt, a, bm, cm, d, x, None, dy, dh)[:6]
    if trap == "late":
        states = ref.mamba_scan_ref(dt, a, bm, cm, d, x, h0,
                                    return_states=True)[2]
        late = torch.cat([states[:, :1], states[:, :-1]], dim=1)
        return ref.mamba_scan_bwd_ref(dt, a, bm, cm, d, x, h0, dy, dh,
                                      late)[:6]
    xf = x.float()
    h = h0.clone()
    hs = [h]
    for t in range(x.shape[1]):
        h = (torch.exp(dt[:, t, :, None] * a) * h
             + (dt[:, t] * xf[:, t])[..., None] * bm[:, t, None, :])
        hs.append(h)
    carry = torch.zeros_like(h) if dh is None else dh.clone()
    ddt, dx = torch.empty_like(dt), torch.empty_like(dt)
    db, dc = torch.empty_like(bm), torch.empty_like(cm)
    da = torch.zeros_like(a)
    for t in reversed(range(x.shape[1])):
        e = torch.exp(dt[:, t, :, None] * a)
        g = dy[:, t, :, None] * cm[:, t, None, :] + carry
        dc[:, t] = torch.einsum("bin,bi->bn", hs[t + 1], dy[:, t])
        db[:, t] = torch.einsum("bin,bi->bn", g, dt[:, t] * xf[:, t])
        dx[:, t] = (dt[:, t] * torch.einsum("bin,bn->bi", g, bm[:, t])
                    + d * dy[:, t])
        ddt[:, t] = (g * (a * e * hs[t] + bm[:, t, None, :]
                          * xf[:, t, :, None])).sum(-1)
        da += (g * dt[:, t, :, None] * e * hs[t]).sum(0)
        # the bug: g_t reaches step t - 1 through e_{t-1}, not e_t
        carry = torch.exp(dt[:, max(t - 1, 0), :, None] * a) * g
    return ddt, da, db, dc, (dy * xf).sum((0, 1)), dx.to(x.dtype)


_SCAN_GRADS = ("ddt", "da", "db", "dc", "dd", "dx", "dh0")


def _scan_bwd_limits(want, x_dtype):
    """Each gradient's elementwise limit against the plain backward in f32
    on the same (bf16-valued) inputs: MAMBA_BWD_TOL of its largest entry
    (f32 in another order, and the kernel's fast exponentials), and for a
    bf16 dx also 2^-8 of the value (the kernel's f32 dx rounded once to
    bf16)."""
    out = []
    for name, w in zip(_SCAN_GRADS, want):
        if w is None:
            out.append(None)
            continue
        t = MAMBA_BWD_TOL * float(w.float().abs().max()) + torch.zeros_like(
            w, dtype=torch.float32)
        if name == "dx" and x_dtype == torch.bfloat16:
            t = t + w.float().abs() * 2.0 ** -8
        out.append(t)
    return out


def _over(got, want, tols) -> dict:
    """{gradient: max |got - want| / limit}."""
    return {name: float(((gt.float() - w.float()).abs() / t).max())
            for name, gt, w, t in zip(_SCAN_GRADS, got, want, tols)
            if w is not None and gt is not None}


def _scan_bound(nbytes: float, exps: float, f32_ops: int):
    """(ms, "bytes" or "operations"): the scan's least time on the card,
    ``nbytes`` at the memory rate against ``exps`` exponentials at the
    special-function units' rate or ``f32_ops`` f32 operations each at
    the f32 rate, whichever takes longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(f32_ops * exps / FP32_FLOP_PER_S, exps / SFU_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_mamba_bwd(dev) -> dict:
    """The selective scan's backward (no TPU counterpart) against the
    plain reverse recurrence (``ref.mamba_scan_bwd_ref``) at the training
    shape of falcon-mamba-7b and jamba (B 4, S 512, Di 8192, N 16, x bf16,
    no initial state: the row's shape), B 1 at S 200, S 1, S 77 (a tail
    chunk of 13 steps) over Di 1000 (a tail of 8 channels), N 4 and N 8
    at Di 256, and f32 with h0 and dh_last at B 2, S 512, Di 8192, each
    from the chunk states of a forward launch (``return_states``, whose y
    and h_last must be the same bits as without them): every gradient
    within ``_scan_bwd_limits``; the kernel twice on the same inputs,
    bit-equal; at the f32 shape the plain version with the decay a step
    early, with h0's term dropped and with the states a chunk late must
    fail those limits. Timed (CUDA events, inputs cycled past L2, median
    of 7) beside the plain version against the least time the card needs:
    the backward alone (its states from an untimed forward): dt, x, dy,
    B, C, a, D, h0, dh_last and the states read and every gradient
    written once, or B S Di N exponentials (each decay once) at the
    special-function units' rate; no PyTorch call computes the function.
    At the training shape also the forward without the states
    (``at_forward``), with them (``at_forward_states``: they are written
    too) and the pair that training runs, the forward with states then
    the backward (``at_pair``, bound: the two bounds added)."""
    di, n = 8192, 16
    g = _gen(17)
    shapes = {
        "train": (4, 512, di, n, torch.bfloat16, False, False),
        "s200": (1, PROMPT_HI, di, n, torch.bfloat16, False, False),
        "s1": (2, 1, 256, n, torch.float32, True, True),
        "tail": (2, 77, 1000, n, torch.float32, True, False),
        "n4": (2, 100, 256, 4, torch.float32, True, True),
        "n8": (2, 100, 256, 8, torch.bfloat16, False, True),
        "f32_h0": (2, 512, di, n, torch.float32, True, True),
    }
    rows = {}
    for key, (b, s, w, nn, xd, with_h0, with_dh) in shapes.items():
        ins = _scan_inputs(dev, g, b, s, w, nn, xd, with_h0, with_dh)
        y, h_last, states = mamba_scan(*ins[:7], return_states=True)
        y0, h0_last = mamba_scan(*ins[:7])
        check(_same_bits(y, y0) and _same_bits(h_last, h0_last),
              f"mamba_scan B={b} S={s} Di={w} N={nn}: y and h_last the "
              f"same bits with and without the states")
        del y, h_last, y0, h0_last
        got = mamba_scan_bwd(*ins, states=states)
        again = mamba_scan_bwd(*ins, states=states)
        # in f32 throughout: a bf16 dx is held against the unrounded value
        want = ref.mamba_scan_bwd_ref(*ins[:5], ins[5].float(), *ins[6:])
        torch.cuda.synchronize()
        tols = _scan_bwd_limits(want, xd)
        over = _over(got, want, tols)
        same = all((x is None and y is None) or _same_bits(x, y)
                   for x, y in zip(got, again))
        what = f"mamba_scan_bwd {key} B={b} S={s} Di={w} N={nn} x {xd}"
        check(max(over.values()) <= 1.0, f"{what} within its limits "
                                         f"({over})")
        check(same, f"{what}: two calls bit-equal")
        row = dict(shape=f"B={b} S={s} Di={w} N={nn} x "
                         f"{str(xd).split('.')[-1]}"
                         + (", h0" if with_h0 else "")
                         + (", dh_last" if with_dh else ""),
                   err_over_tol=max(over.values()), over_by_grad=over,
                   max_abs_err=max(float((gt.float() - wt.float()).abs()
                                         .max())
                                   for gt, wt in zip(got, want)
                                   if wt is not None),
                   max_rel_err=max(float((gt.float() - wt.float()).abs()
                                         .max() / wt.float().abs().max())
                                   for gt, wt in zip(got, want)
                                   if wt is not None),
                   bit_equal_twice=same)
        if key == "f32_h0":
            row["traps_over_tol"] = {}
            for trap, what_trap in (("decay", "the decay a step early"),
                                    ("h0", "h0's term dropped"),
                                    ("late", "the states a chunk late")):
                bad = _scan_bwd_trap(*ins, trap)
                r = max(_over(bad, want[:6], tols[:6]).values())
                row["traps_over_tol"][what_trap] = r
                check(r > 1.0, f"{what}: a kernel with {what_trap} fails "
                               f"the check ({r} of the limit)")
                del bad
        del got, again, want, tols
        if key in ("train", "s200"):
            x_b = ins[5].element_size()
            st_b = states.numel() * 4
            nbytes = (b * s * w * (4 + x_b + 4 + 4 + x_b)
                      + 4 * b * s * nn * 4 + 2 * w * nn * 4 + 2 * w * 4
                      + st_b)
            exps = b * s * w * nn
            sets = [ins] + [_scan_inputs(dev, g, b, s, w, nn, xd)
                            for _ in range(copies(nbytes) - 1)]
            fwd_states = [states] + [mamba_scan(*t[:7],
                                                return_states=True)[2]
                                     for t in sets[1:]]
            kms = device_ms([lambda t=t, st=st: mamba_scan_bwd(
                *t, states=st) for t, st in zip(sets, fwd_states)])
            pms = device_ms([lambda t=t: ref.mamba_scan_bwd_ref(*t)
                             for t in sets[:2]], reps=3, per_window=2)
            bms, by = _scan_bound(nbytes, exps, 10)
            row.update(ms=kms, plain_ms=pms, library_ms=None, library=None,
                       bound_ms=bms, bound_by=by, bound_bytes=nbytes,
                       bound_flops=exps)
            if key == "train":
                # the forward kernel at the same shape, without and with
                # the states, and the pair
                fbytes = (b * s * w * (4 + x_b + 4) + 2 * b * s * nn * 4
                          + w * nn * 4 + w * 4 + b * w * nn * 4)
                fb, fby = _scan_bound(fbytes, exps, 6)
                sb, sby = _scan_bound(fbytes + st_b, exps, 6)
                fpms = device_ms([lambda t=t: ref.mamba_scan_ref(*t[:7])
                                  for t in sets[:2]], reps=3, per_window=2)
                row["at_forward"] = dict(
                    shape=row["shape"], ms=device_ms(
                        [lambda t=t: mamba_scan(*t[:7]) for t in sets]),
                    plain_ms=fpms, library_ms=None, bound_ms=fb,
                    bound_by=fby, bound_bytes=fbytes, bound_flops=exps)
                row["at_forward_states"] = dict(
                    shape=row["shape"] + ", states written", ms=device_ms(
                        [lambda t=t: mamba_scan(*t[:7], return_states=True)
                         for t in sets]),
                    plain_ms=device_ms(
                        [lambda t=t: ref.mamba_scan_ref(
                            *t[:7], return_states=True) for t in sets[:2]],
                        reps=3, per_window=2),
                    library_ms=None, bound_ms=sb, bound_by=sby,
                    bound_bytes=fbytes + st_b, bound_flops=exps)

                def pair(t):
                    st = mamba_scan(*t[:7], return_states=True)[2]
                    return mamba_scan_bwd(*t, states=st)

                def plain_pair(t):
                    st = ref.mamba_scan_ref(*t[:7], return_states=True)[2]
                    return ref.mamba_scan_bwd_ref(*t, states=st)
                row["at_pair"] = dict(
                    shape=row["shape"] + ", the forward with states then "
                                         "the backward",
                    ms=device_ms([lambda t=t: pair(t) for t in sets]),
                    plain_ms=device_ms([lambda t=t: plain_pair(t)
                                        for t in sets[:2]], reps=3,
                                       per_window=2),
                    library_ms=None, bound_ms=sb + bms,
                    bound_by=f"{sby} + {by}",
                    bound_bytes=fbytes + st_b + nbytes,
                    bound_flops=2 * exps)
            del sets, fwd_states
        del states
        rows[key] = row
        del ins
    out = dict(name="mamba_scan_bwd", **rows["train"],
               **{f"at_{k}": r for k, r in rows.items() if k != "train"})
    for key in ("err_over_tol", "max_abs_err", "max_rel_err"):
        out[key] = max(r[key] for r in rows.values())
    return out


def phase_kernels(dev) -> dict:
    out = {}
    for fn in (kernel_top2gap, kernel_decode, kernel_flash, kernel_mamba,
               kernel_flash_bwd, kernel_mamba_bwd, kernel_mamba_step):
        rows = fn(dev)
        for row in rows if isinstance(rows, list) else [rows]:
            emit({"phase": "kernel", **row})
            out[row["name"]] = row
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def _requests(cfg):
    rng = np.random.default_rng(0)
    return [TokenRequest(i, rng.integers(
        0, cfg.vocab_size, int(rng.integers(PROMPT_LO, PROMPT_HI + 1)))
        .astype(np.int32), MAX_NEW) for i in range(N_REQ)]


def _gear(models, thresholds):
    return Gear(cascade=Cascade(tuple(models), tuple(thresholds)),
                min_queue_lens={m: 1 for m in models},
                load_fractions={m: {i: 1.0} for i, m in enumerate(models)})


def _predicted_escalations(streams, thr) -> int:
    """Replays the batcher's boundary rule over stage-a gap streams."""
    gear = _gear(["a", "b"], [thr])
    cb = ContinuousBatcher(SchedulerCore([]), N_SLOTS,
                           min_tokens=MIN_TOKENS, early_margin=EARLY_MARGIN)
    n = 0
    for gaps in streams:
        cert = StreamingCertainty()
        cert.update(gaps[0])
        _, hop = cb.stream_trace_hop(0, cert, gaps[1:], 1, MAX_NEW, gear)
        n += int(getattr(hop, "next_stage", None) is not None)
    return n


def _timed(eng: SlotEngine, log: dict) -> None:
    """Wraps a SlotEngine's prefill and decode calls with wall timers
    (each call already ends in a device-to-host copy). A bucketed prefill
    is logged by its (batch x length) bucket, an exact-length one by its
    prompt length; calls that replayed a graph are logged again under
    ``*_replayed`` (the others are a key's first call: its eager warm-up
    and capture, or an exact-length eager prefill)."""
    decode = eng.decode_fused
    if model_lib.bucketed_prefill_supported(eng.cfg):
        prefill = eng.prefill_batch

        def prefill_t(prompts):
            torch.cuda.synchronize()
            replays = eng.graphs.replays
            t0 = time.perf_counter()
            res = prefill(prompts)
            dt = (time.perf_counter() - t0) * 1e3
            bb = eng._batch_bucket(len(prompts))
            lb = eng._len_bucket(max(len(p) for p in prompts))
            log["prefill"].setdefault(f"{bb}x{lb}", []).append(dt)
            if eng.graphs.replays > replays:
                log["prefill_replayed"].setdefault(f"{bb}x{lb}",
                                                   []).append(dt)
            return res
        eng.prefill_batch = prefill_t
    else:
        prefill_one = eng.prefill_into_slot

        def prefill_one_t(prompt):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = prefill_one(prompt)
            dt = (time.perf_counter() - t0) * 1e3
            log["prefill"].setdefault(f"1x{len(prompt)}", []).append(dt)
            return res
        eng.prefill_into_slot = prefill_one_t

    def decode_t(k=1, mode="ewma", beta=0.35):
        torch.cuda.synchronize()
        replays = eng.graphs.replays
        t0 = time.perf_counter()
        res = decode(k, mode=mode, beta=beta)
        dt = (time.perf_counter() - t0) * 1e3 / k
        log["step_ms"].append(dt)
        if eng.graphs.replays > replays:
            log["step_ms_replayed"].append(dt)
        log["ks"].add(k)
        return res

    eng.decode_fused = decode_t


def _ms_medians(log: dict) -> dict:
    def by_shape(d):
        return {k: statistics.median(v) for k, v in sorted(
            d.items(), key=lambda kv: [int(x) for x in kv[0].split("x")])}
    return {"step_ms_median": statistics.median(log["step_ms"])
            if log["step_ms"] else None,
            "step_ms_median_replayed":
                statistics.median(log["step_ms_replayed"])
                if log["step_ms_replayed"] else None,
            "prefill_ms_median": by_shape(log["prefill"]),
            "prefill_ms_median_replayed": by_shape(log["prefill_replayed"])}


def serve_cascade(dev, arch: str, phase: str, arch_b: str = ""):
    """The main path: a two-stage cascade of full-width models (random
    bf16 weights, seeds 0 and 1), ``arch`` at stage a and ``arch_b`` (or
    ``arch`` again) at stage b, served by the fused TokenEngine. A
    calibration pass of stage a alone sets the threshold so that requests
    both resolve at a and escalate to b; the launch counters are zeroed
    just before the measured run and read just after. Returns (summary,
    params by stage, configs by stage, requests, calibration results,
    served results)."""
    cfgs = {"a": get_config(arch), "b": get_config(arch_b or arch)}
    params = {m: model_lib.init_params(cfgs[m], seed=s, device=dev)
              for m, s in (("a", 0), ("b", 1))}
    param_bytes = {m: sum(t.numel() * t.element_size()
                          for t in _leaves(params[m])) for m in params}
    reqs = _requests(cfgs["a"])

    # calibration: stage a alone; its gap streams set the threshold
    cal = TokenEngine([SlotEngine("a", params["a"], cfgs["a"], N_SLOTS,
                                  MAX_LEN, device=dev)], _gear(["a"], []),
                      min_tokens=MIN_TOKENS, early_margin=EARLY_MARGIN,
                      spec_k=SPEC_K).serve(reqs)
    streams = [cal[r.rid].gaps for r in reqs]
    finals = []
    for gaps in streams:
        c = StreamingCertainty()
        for gp in gaps:
            c.update(gp)
        finals.append(c.value)
    s = np.sort(finals)
    cands = [0.5 * (s[i] + s[i + 1]) for i in range(len(s) - 1)]
    thr = min(cands, key=lambda t: abs(
        _predicted_escalations(streams, t) - N_REQ / 2))

    stages = [SlotEngine(m, params[m], cfgs[m], N_SLOTS, MAX_LEN,
                         device=dev) for m in ("a", "b")]
    logs = {m: {"prefill": {}, "prefill_replayed": {}, "step_ms": [],
                "step_ms_replayed": [], "ks": set()} for m in ("a", "b")}
    for e in stages:
        _timed(e, logs[e.name])
    te = TokenEngine(stages, _gear(["a", "b"], [thr]),
                     min_tokens=MIN_TOKENS, early_margin=EARLY_MARGIN,
                     mode="fused", spec_k=SPEC_K)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = te.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()

    st = te.stats()
    res = [out[r.rid] for r in reqs]
    n_a = sum(r.resolver == 0 for r in res)
    n_b = sum(r.resolver == 1 for r in res)
    tokens_out = sum(len(r.tokens) for r in res)
    # one arch at both stages: its steps, prefills and bound pooled at the
    # top level; two archs: per stage only (``by_stage``)
    pooled = {}
    if cfgs["a"].name == cfgs["b"].name:
        both = {key: logs["a"][key] + logs["b"][key]
                for key in ("step_ms", "step_ms_replayed")}
        for key in ("prefill", "prefill_replayed"):
            both[key] = {}
            for log in logs.values():
                for k, v in log[key].items():
                    both[key].setdefault(k, []).extend(v)
        pooled = {**_ms_medians(both),
                  "param_bytes_per_stage": param_bytes["a"],
                  "weight_read_bound_step_ms": param_bytes["a"]
                  / HBM_BYTES_PER_S * 1e3}
    summary = {
        "phase": phase, "arch": arch, "stages": 2,
        "n_slots": N_SLOTS, "max_len": MAX_LEN, "spec_k": SPEC_K,
        "requests": N_REQ, "max_new": MAX_NEW, "threshold": thr,
        "resolved_at_a": n_a, "escalated_to_b": n_b,
        "wall_s": wall, "tokens_out": tokens_out,
        "tokens_per_s": tokens_out / wall,
        "decode_steps": st["decode_steps"],
        "decode_calls": st["decode_calls"],
        "prefill_calls": st["prefill_calls"],
        "prefill_prompts": st["prefill_prompts"],
        "prefill_shapes": {k: [list(x) for x in v]
                           for k, v in st["prefill_shapes"].items()},
        "spec_discarded": st["spec_discarded"],
        **pooled,
        "by_stage": {e.name: {
            "arch": cfgs[e.name].name, "layers": cfgs[e.name].num_layers,
            "decode_steps": e.stats.decode_steps,
            "decode_calls": e.stats.decode_calls,
            "prefill_calls": e.stats.prefill_calls,
            **_ms_medians(logs[e.name]),
            "param_bytes": param_bytes[e.name],
            "weight_read_bound_step_ms": param_bytes[e.name]
            / HBM_BYTES_PER_S * 1e3,
            "fused_k": sorted(logs[e.name]["ks"]),
            "compile_counts": e.compile_counts(),
            "graphs": e.graphs.captured,
            "graph_replays": e.graphs.replays,
            "capture_seconds": e.graphs.capture_seconds} for e in stages},
        "launches": launches,
    }
    emit(summary)
    _check_compile_counts(stages, logs)

    check(launches["top2gap"] == st["decode_steps"] + st["prefill_calls"]
          and launches["top2gap"] > 0,
          f"top2gap launches {launches['top2gap']} == decode steps + "
          f"prefill calls")
    for r in res:
        check(r.resolver in (0, 1) and r.done_step >= 0, "request completes")
        check(len(r.tokens) == MAX_NEW, "request streams max_new tokens")
        check(all(0 <= t < cfgs["a"].vocab_size for t in r.tokens),
              "tokens range")
        check(all(np.isfinite(g) and g >= 0 for gs in r.stage_gaps.values()
                  for g in gs), "gaps finite and >= 0")
    check(n_a >= 1 and n_b >= 1, f"both outcomes: {n_a} at a, {n_b} at b")
    return summary, params, cfgs, reqs, cal, out


def _check_compile_counts(stages, logs) -> None:
    """Each stage's graphs are the shapes it served and no more, within
    the bucket grid: one bucketed prefill graph per (batch, length) bucket
    it prefilled (or, on the exact-length path, one count per distinct
    prompt length and no graph), one fused decode graph per k it ran, no
    reference decode; every counted key but the eager prefills is a
    captured graph."""
    for e in stages:
        cc = e.compile_counts()
        shapes = e.stats.prefill_shapes
        grid = len(e.len_buckets) * len(e.batch_buckets)
        if model_lib.bucketed_prefill_supported(e.cfg):
            check(cc["bucketed_prefill"] == len(shapes) <= grid
                  and cc["reference_prefill"] == 0,
                  f"{e.name}: bucketed prefill graphs {cc} == served "
                  f"buckets {sorted(shapes)} <= grid {grid}")
        else:
            check(cc["bucketed_prefill"] == 0 and cc["reference_prefill"]
                  == len({n for _, n in shapes}),
                  f"{e.name}: exact-length prefills {cc} == distinct "
                  f"lengths of {sorted(shapes)}")
        ks = logs[e.name]["ks"]
        check(cc["fused_decode"] == len(ks) <= SPEC_K
              and cc["reference_decode"] == 0,
              f"{e.name}: fused decode graphs {cc} == the k values run "
              f"{sorted(ks)}")
        check(e.graphs.captured == cc["total"] - cc["reference_prefill"],
              f"{e.name}: every counted key is a captured graph")


def _check_attention_launches(summary: dict) -> None:
    """Each attention kernel launches once per layer of every decode step
    (decode) or prefill call (flash) of each stage; no scan runs."""
    launches, by = summary["launches"], summary["by_stage"].values()
    expect = {
        "decode_attention": sum(s["layers"] * s["decode_steps"] for s in by),
        "flash_attention": sum(s["layers"] * s["prefill_calls"] for s in by),
    }
    for name, n in expect.items():
        check(launches[name] == n and n > 0,
              f"{name} launches {launches[name]} == {n} > 0")
    check(launches["mamba_scan"] == 0 and launches["mamba_conv_step"] == 0
          and launches["mamba_ssm_step"] == 0,
          "no scan or SSM step on the attention path")


def phase_serve(dev) -> dict:
    torch.cuda.reset_peak_memory_stats()
    summary, params, cfgs, reqs, cal, out = serve_cascade(dev, ARCH,
                                                          "serve")
    cfg = cfgs["a"]
    _teacher_forced_check(params, cfgs, reqs, out, "serve")
    _check_attention_launches(summary)
    phase_reference(dev, params["a"], cfg, reqs, cal)
    summary["trace"] = phase_trace(dev, params, cfg, reqs, "trace")
    graphs = phase_graphs(dev, params["a"], cfg, "serve")
    phase_graphs(dev, params["a"], cfg, "serve_reference", reference=True)
    _path_summary("serve", summary, summary["trace"], graphs)
    return summary


def phase_serve_ssm(dev) -> dict:
    """falcon-mamba-7b through the same engine and traffic: exact-length
    batch-1 prefills whose scans run in the mamba_scan kernel, single-step
    recurrent decode, top2gap at V 65,024, and no attention kernel."""
    torch.cuda.reset_peak_memory_stats()
    summary, params, cfgs, reqs, _, out = serve_cascade(dev, SSM_ARCH,
                                                        "serve_ssm")
    cfg = cfgs["a"]
    launches, layers = summary["launches"], cfg.num_layers
    n = layers * summary["prefill_calls"]
    check(launches["mamba_scan"] == n and n > 0,
          f"mamba_scan launches {launches['mamba_scan']} == {n} > 0")
    # every decode step runs each step kernel once a layer, graph replays
    # included
    steps = sum(s["layers"] * s["decode_steps"]
                for s in summary["by_stage"].values())
    for name in ("mamba_conv_step", "mamba_ssm_step"):
        check(launches[name] == steps and steps > 0,
              f"{name} launches {launches[name]} == {steps} > 0")
    check(launches["decode_attention"] == 0
          and launches["flash_attention"] == 0,
          "no attention kernel on the SSM path")
    check(summary["prefill_calls"] == summary["prefill_prompts"]
          and all(b == 1 for shapes in summary["prefill_shapes"].values()
                  for b, _ in shapes),
          "every SSM prefill is an exact-length batch-1 call")
    # bf16 rounding over 64 layers moves a top-2 gap by up to a few tenths
    # between the decode and the forward path (logits of std 1.3 here), so
    # in bf16 the tokens must agree where the gap exceeds SSM_BF16_MARGIN;
    # the 0.1 check is held in f32 below, where only summation order
    # differs
    _teacher_forced_check(params, cfgs, reqs, out, "serve_ssm",
                          enforce_at=SSM_BF16_MARGIN)
    summary["trace"] = phase_trace(dev, params, cfg, reqs, "trace_ssm")
    graphs = phase_graphs(dev, params["a"], cfg, "serve_ssm")
    _path_summary("serve_ssm", summary, summary["trace"], graphs)
    summary["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    emit({"phase": "memory_ssm",
          "max_memory_allocated_bytes": summary["max_memory_allocated_bytes"],
          "param_bytes_two_stages": 2 * summary["param_bytes_per_stage"]})
    peak = prefill_peak.measure(params["a"], cfg)
    emit({"phase": "ssm_prefill_peak", **peak})
    check(peak["logits_finite"], "ssm_prefill_peak: finite logits")
    check(peak["peak_bytes"] <= peak["bound_bytes"],
          f"ssm_prefill_peak: {peak['peak_bytes']} bytes above the memory "
          f"in use before the prefill <= bound {peak['bound_bytes']}")
    phase_teacher_forced_f32(dev, _widen(params["a"]), cfg, reqs,
                             "serve_ssm")
    return summary


def phase_serve_qwen3(dev) -> dict:
    """The heterogeneous token cascade: full-width qwen2-0.5b at stage a,
    full-width qwen3-32b (64 layers, d 5120, 64 heads over 8 KV heads at
    hd 128, qk-norm, an untied head; 65.5 GB of bf16 weights) at stage b,
    one 151,936-token vocabulary, through the same engine and traffic.
    Checks the per-stage launch formulas, holds stage b's served tokens
    against a bf16 teacher-forced ``forward`` at QWEN3_BF16_MARGIN, traces
    stage b's fused decode steps, then holds the 0.1 check in f32 on a
    depth-cut copy of stage b (its first QWEN3_F32_LAYERS layers, full
    width)."""
    torch.cuda.reset_peak_memory_stats()
    summary, params, cfgs, reqs, _, out = serve_cascade(
        dev, ARCH, "serve_qwen3", arch_b=QWEN3_ARCH)
    _check_attention_launches(summary)
    at_b = [r for r in reqs if out[r.rid].resolver == 1]
    # bf16 rounding over 64 layers moves a top-2 gap between the decode
    # and the forward path; the tokens must agree where forward's gap
    # exceeds QWEN3_BF16_MARGIN (the largest gap difference is printed),
    # on up to QWEN3_BF16_CHECKED of the requests stage b resolved
    _teacher_forced_check(params, cfgs, at_b, out, "serve_qwen3",
                          n_check=QWEN3_BF16_CHECKED,
                          enforce_at=QWEN3_BF16_MARGIN)
    summary["trace"] = phase_trace(dev, params, cfgs["b"], reqs,
                                   "trace_qwen3", stage="b")
    graphs = phase_graphs(dev, params["b"], cfgs["b"], "serve_qwen3",
                          stage="b")
    _path_summary("serve_qwen3", summary, summary["trace"], graphs)
    summary["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    emit({"phase": "memory_qwen3",
          "max_memory_allocated_bytes": summary["max_memory_allocated_bytes"],
          "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
          "limit_bytes": QWEN3_PEAK_LIMIT,
          "param_bytes_by_stage": {m: v["param_bytes"] for m, v in
                                   summary["by_stage"].items()}})
    check(summary["max_memory_allocated_bytes"] < QWEN3_PEAK_LIMIT,
          f"qwen3-32b phase peak memory under {QWEN3_PEAK_LIMIT} bytes")
    cut = dataclasses.replace(cfgs["b"], num_layers=QWEN3_F32_LAYERS)
    p32 = _depth_cut_f32(params.pop("b"), QWEN3_F32_LAYERS)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase_teacher_forced_f32(dev, p32, cut, reqs, "serve_qwen3")
    return summary


@contextlib.contextmanager
def _routes():
    """(expert indices (T, k), each token's gap between its k-th and
    (k+1)-th router logit (T,)) of every MoE routing call made inside, in
    call order (eager calls only: a graph replay runs no Python)."""
    rec = []
    route = moe_lib._route

    def recording(p, m, x2d):
        out = route(p, m, x2d)
        logits = x2d.float() @ p["router"]
        top = torch.topk(logits[:, :m.num_experts], m.top_k + 1,
                         dim=-1).values
        rec.append((out[1], top[:, -2] - top[:, -1]))
        return out
    moe_lib._route = recording
    try:
        yield rec
    finally:
        moe_lib._route = route


def _set_differs(x, y):
    """(T,) whether each token's top-k expert set differs."""
    return (x.sort(-1).values != y.sort(-1).values).any(-1)


def _route_diffs(a, b):
    """(tokens whose top-k expert set differs, tokens routed) between two
    runs' routing records, call by call."""
    check(len(a) == len(b) > 0
          and all(x[0].shape == y[0].shape for x, y in zip(a, b)),
          "the two runs route the same calls")
    diff = sum(int(_set_differs(x[0], y[0]).sum()) for x, y in zip(a, b))
    return diff, sum(x[0].shape[0] for x in a)


def _prefill_vs_forward(params, cfg, prompts, of: str) -> dict:
    """Each prompt's batch-1 ``prefill`` (an MoE stage's exact-length
    prefill) against ``forward`` over the same prompt: one routing call of
    the same tokens per layer in both, so the same capacity and drops.
    Last-position logits within MOE_PREFILL_TOL, the same experts chosen
    for every token in every layer, argmax equal where forward's top-2 gap
    exceeds twice the tolerance."""
    worst, checked, agreed, diff, routed = 0.0, 0, 0, 0, 0
    for p in prompts:
        toks = {"tokens": p[None]}
        with _routes() as rp:
            last, _ = model_lib.prefill(params, cfg, toks, cache_len=MAX_LEN)
        with _routes() as rf:
            full, _ = model_lib.forward(params, cfg, toks)
        ref = full[:, -1].contiguous()
        worst = max(worst, float((last - ref).abs().max()))
        fgap, fidx = top2gap(ref)
        _, pidx = top2gap(last)
        clear = bool(fgap[0] > 2 * MOE_PREFILL_TOL)
        checked += clear
        agreed += clear and bool(fidx[0] == pidx[0])
        d, n = _route_diffs(rp, rf)
        diff, routed = diff + d, routed + n
    row = {"phase": "prefill_vs_forward", "of": of, "arch": cfg.name,
           "prompts": len(prompts),
           "prompt_lens": [int(p.size) for p in prompts],
           "max_logit_err": worst, "tol": MOE_PREFILL_TOL,
           "argmax_checked": checked, "argmax_agreed": agreed,
           "route_diffs": diff, "routed_tokens": routed}
    emit(row)
    check(worst <= MOE_PREFILL_TOL,
          f"{of}: prefill logits within {MOE_PREFILL_TOL} of forward's "
          f"({worst})")
    check(diff == 0, f"{of}: prefill and forward route every token to the "
                     f"same experts ({diff} of {routed} differ)")
    check(agreed == checked, f"{of}: prefill argmax equals forward's where "
                             f"the gap is clear ({agreed}/{checked})")
    return row


def _first_reps(tree, n: int):
    """Views of the first ``n`` repetitions of a rep-stacked tree."""
    if isinstance(tree, dict):
        return {k: _first_reps(v, n) for k, v in tree.items()}
    return tree[:n]


def _moe_bf16_vs_f32(params, cfg, reqs, out) -> dict:
    """The bf16 MoE model cut to its first MOE_F32_LAYERS layers against
    a float32 copy of the same cut (the same weights, widened), ``forward``
    over the same sequences (the first 4 requests' prompts and served
    tokens, batch 1): argmax agreement where the f32 top-2 gap exceeds
    0.1, 0.25, 0.5 and 1, and how many tokens' top-k expert sets differ
    between the two, layer by layer. Neither is held to a limit: with
    random weights a token whose routing flips at a near-tie changes by
    the whole output of an expert, moves other tokens past or within an
    expert's capacity, and reaches every later position through
    attention, so the two runs part more with every layer. What is held:
    at the first MoE layer, whose router inputs differ by bf16 rounding
    alone, every token whose expert set differs has an f32 gap between
    its k-th and (k+1)-th router logit below MOE_ROUTE_NEAR."""
    n = MOE_F32_LAYERS // len(model_lib.block_pattern(cfg))
    cut_cfg = dataclasses.replace(cfg, num_layers=MOE_F32_LAYERS)
    cut = {"embed": params["embed"], "final_norm": params["final_norm"],
           "blocks": [_first_reps(b, n) for b in params["blocks"]]}
    p32 = _widen(cut)
    margins = (0.1, 0.25, 0.5, 1.0)
    checked = dict.fromkeys(margins, 0)
    agreed = dict.fromkeys(margins, 0)
    worst, diff, routed = 0.0, 0, 0
    by_layer = [0] * MOE_F32_LAYERS
    first_gaps = []     # f32 router gaps of the first layer's flipped tokens
    for r in reqs[:4]:
        seq = {"tokens": np.concatenate([r.prompt, np.asarray(
            out[r.rid].tokens[:-1], np.int32)])[None]}
        with _routes() as rb:
            lb, _ = model_lib.forward(cut, cut_cfg, seq)
        with _routes() as rf:
            lf, _ = model_lib.forward(p32, cut_cfg, seq)
        worst = max(worst, float((lb - lf).abs().max()))
        fgap, fidx = top2gap(lf[0].contiguous())
        _, bidx = top2gap(lb[0].contiguous())
        for m in margins:
            clear = fgap > m
            checked[m] += int(clear.sum())
            agreed[m] += int((fidx[clear] == bidx[clear]).sum())
        d, k = _route_diffs(rb, rf)
        diff, routed = diff + d, routed + k
        for i, (x, y) in enumerate(zip(rb, rf)):
            by_layer[i] += int(_set_differs(x[0], y[0]).sum())
        flipped = _set_differs(rb[0][0], rf[0][0])
        first_gaps += rf[0][1][flipped].tolist()
    row = {"phase": "moe_bf16_vs_f32", "arch": cfg.name,
           "layers": MOE_F32_LAYERS, "requests": [r.rid for r in reqs[:4]],
           "positions_checked": {str(m): checked[m] for m in margins},
           "agreed": {str(m): agreed[m] for m in margins},
           "max_logit_diff": worst, "route_diffs": diff,
           "route_diffs_by_layer": by_layer, "routed_tokens": routed,
           "first_layer_flip_max_f32_gap": max(first_gaps, default=None),
           "route_near": MOE_ROUTE_NEAR,
           "not_enforced": "argmax and later layers' routing: a flip at a "
                           "near-tie changes a token by a whole expert's "
                           "output and moves others past capacity, and "
                           "attention carries it to every later position",
           "param_bytes_f32": sum(t.numel() * t.element_size()
                                  for t in _leaves(p32))}
    emit(row)
    check(all(g < MOE_ROUTE_NEAR for g in first_gaps),
          f"bf16 and f32 choose other experts at the first MoE layer only "
          f"where the f32 router gap is below {MOE_ROUTE_NEAR} "
          f"({max(first_gaps, default=None)})")
    return row


def _moe_layer_time(dev, params, cfg) -> dict:
    """Device ms of one MoE layer (``apply_moe_local`` in bf16, the aux
    loss skipped as prefill and decode skip it) at the fused decode's T
    (N_SLOTS tokens) and the longest prefill's (PROMPT_HI), each call on
    the next layer's weights so that they come from device memory, against
    the least time for the bytes every call must read (all E_pad experts'
    weights, the shared expert, the router) and its products."""
    blk = next(b["moe"] for b in params["blocks"] if "moe" in b)
    m = cfg.moe
    layers = [model_lib._rep(blk, r) for r in range(model_lib.num_reps(cfg))]
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(layers[0]))
    e_pad = blk["router"].shape[-1]
    d, fe = cfg.d_model, m.expert_d_ff
    shared = m.num_shared_experts * (m.shared_d_ff or m.expert_d_ff)
    rows = {}
    for t in (N_SLOTS, PROMPT_HI):
        x = torch.randn(t, d, generator=_gen(20 + t), device=dev).bfloat16()
        ms = device_ms([lambda p=p: moe_lib.apply_moe_local(
            p, cfg, x, with_aux=False) for p in layers])
        cap = moe_lib._capacity(t, m.top_k, m.num_experts, 1.25)
        flops = 6 * e_pad * cap * d * fe + 6 * t * d * shared \
            + 2 * t * d * (e_pad + 1)
        nbytes = wbytes + 2 * t * d * 2
        bms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
        rows[str(t)] = dict(tokens=t, capacity=cap, ms=ms, bound_ms=bms,
                            bound_by=by, bound_bytes=nbytes,
                            bound_flops=flops)
    row = {"phase": "moe_layer", "arch": cfg.name, "experts_padded": e_pad,
           "top_k": m.top_k, "by_tokens": rows,
           "moe_layers": len(layers),
           "decode_step_moe_ms": rows[str(N_SLOTS)]["ms"] * len(layers),
           "decode_step_moe_bound_ms":
               rows[str(N_SLOTS)]["bound_ms"] * len(layers)}
    emit(row)
    return row


def phase_serve_moe(dev) -> dict:
    """The MoE token cascade: full-width qwen2-0.5b at stage a, full-width
    qwen2-moe-a2.7b at stage b (24 layers, d 2048, 16 = 16 KV heads at hd
    128, 60 routed experts padded to 64, top-4 by the sigmoid of the
    router logits, 4 shared experts gated per token; 30.3 GB of bf16;
    seeds 0 and 1), one 151,936-token vocabulary, through the same engine
    and traffic. Stage b prefills at exact length, batch 1, eagerly; each
    fused step routes the 8 slots' tokens together and, as the reference's
    dispatch does, runs every padded expert over its capacity slots, so it
    reads all 64 experts of every layer. Launches per stage as in
    serve_qwen3. Capacity routing makes a call's output depend on the
    tokens it holds, so stage b is held three ways instead of against a
    teacher-forced ``forward`` (printed only): (a) its prefills against
    ``forward`` over the same prompt at batch 1, (b) ``graphs_vs_eager``
    (every fused replay and every exact-length prefill bit-equal to a
    direct eager call), (c) bf16 against a float32 copy of its first
    MOE_F32_LAYERS layers. Also a profiler window over its fused steps, a
    ``path_summary``, one MoE layer timed alone, and peak memory under
    MOE_PEAK_LIMIT."""
    torch.cuda.reset_peak_memory_stats()
    summary, params, cfgs, reqs, _, out = serve_cascade(
        dev, ARCH, "serve_moe", arch_b=MOE_ARCH)
    cfg = cfgs["b"]
    _check_attention_launches(summary)
    check(summary["by_stage"]["b"]["prefill_calls"] > 0
          and all(b == 1 for b, _ in summary["prefill_shapes"]["b"]),
          "every MoE-stage prefill is an exact-length batch-1 call")
    at_b = [r for r in reqs if out[r.rid].resolver == 1]
    _teacher_forced_check(
        params, cfgs, at_b, out, "serve_moe", enforce_at=QWEN3_BF16_MARGIN,
        not_enforced="capacity routing: a decode step routes the 8 slots' "
                     "tokens together and the forward one sequence's, so "
                     "capacities and drops differ between the two paths")
    _prefill_vs_forward(params["b"], cfg,
                        [r.prompt for r in reqs[:MOE_PREFILL_CHECKED]],
                        "serve_moe")
    summary["trace"] = phase_trace(dev, params, cfg, reqs, "trace_moe",
                                   stage="b")
    graphs = phase_graphs(dev, params["b"], cfg, "serve_moe", stage="b")
    _path_summary("serve_moe", summary, summary["trace"], graphs)
    summary["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    emit({"phase": "memory_moe",
          "max_memory_allocated_bytes": summary["max_memory_allocated_bytes"],
          "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
          "limit_bytes": MOE_PEAK_LIMIT,
          "param_bytes_by_stage": {m: v["param_bytes"] for m, v in
                                   summary["by_stage"].items()}})
    check(summary["max_memory_allocated_bytes"] < MOE_PEAK_LIMIT,
          f"MoE phase peak memory under {MOE_PEAK_LIMIT} bytes")
    summary["moe_layer"] = _moe_layer_time(dev, params["b"], cfg)
    del params["a"]
    gc.collect()
    torch.cuda.empty_cache()
    summary["bf16_vs_f32"] = _moe_bf16_vs_f32(params["b"], cfg, reqs, out)
    return summary


def phase_forward_jamba(dev) -> dict:
    """jamba-v0.1 at full width with JAMBA_LAYERS of its 32 layers (2 of
    its 4 8-layer periods: 14 Mamba-1 layers at d_inner 8192, d_state 16;
    2 attention layers, 32 heads over 8 KV heads at hd 128; MoE with 16
    experts, top-2 by softmax, in every other layer; vocab 65,536; about
    52 GB of bf16 from seed 0; the whole model, 104 GB, does not fit one
    card), batch 1: the one configuration whose forward runs all four
    kernels. A PROMPT_HI-token prompt is prefilled, then JAMBA_STEPS
    decode steps are fed the next tokens. Launch counters are zeroed just
    before and read just after: the scan once per SSM layer and flash once
    per attention layer of the prefill, decode attention once per
    attention layer of each step (layer kinds from ``block_pattern``),
    top2gap once for the prefill's logits and once for the steps'. Then
    the prefill is held against ``forward`` over the same prompt (one
    routing call of the same tokens, so the same capacity and drops); the
    steps against a teacher-forced ``forward`` are printed only (a step
    routes its one token alone). Peak memory under JAMBA_PEAK_LIMIT.
    Returns the launch counts."""
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(JAMBA_ARCH), num_layers=JAMBA_LAYERS)
    params = model_lib.init_params(cfg, seed=0, device=dev)
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    pattern = model_lib.block_pattern(cfg)
    reps = model_lib.num_reps(cfg)
    n_attn = reps * sum(sp.mixer == "attn" for sp in pattern)
    n_ssm = cfg.num_layers - n_attn
    s, n = PROMPT_HI, JAMBA_STEPS
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, s + n)).astype(np.int32)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    last, cache = model_lib.prefill(params, cfg, {"tokens": toks[:, :s]},
                                    cache_len=s + n)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    step_ms, steps = [], []
    for i in range(n):
        t0 = time.perf_counter()
        logits, cache = model_lib.decode_step(
            params, cfg, toks[:, s + i:s + i + 1], cache, s + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(logits)
    top2gap(last)
    _, sidx = top2gap(torch.cat(steps))
    torch.cuda.synchronize()
    launches = K.launch_counts()
    expect = {"mamba_scan": n_ssm, "flash_attention": n_attn,
              "decode_attention": n_attn * n, "top2gap": 2,
              "mamba_conv_step": n_ssm * n, "mamba_ssm_step": n_ssm * n}
    for name, want in expect.items():
        check(launches[name] == want and want > 0,
              f"forward_jamba {name} launches {launches[name]} == {want}")
    _prefill_vs_forward(params, cfg, [toks[0, :s]], "forward_jamba")
    full, aux = model_lib.forward(params, cfg, {"tokens": toks})
    ref = full[0, s:s + n].contiguous()
    fgap, fidx = top2gap(ref)
    clear = fgap > 0.1
    row = {"phase": "forward_jamba", "arch": cfg.name,
           "layers": cfg.num_layers, "attention_layers": n_attn,
           "ssm_layers": n_ssm,
           "moe_layers": reps * sum(sp.ffn == "moe" for sp in pattern),
           "batch": 1, "prompt_len": s, "decode_steps": n,
           "param_bytes": param_bytes,
           "weight_read_bound_step_ms": param_bytes / HBM_BYTES_PER_S * 1e3,
           "prefill_ms": prefill_ms, "step_ms": step_ms,
           "finite": bool(torch.isfinite(full).all()
                          and torch.isfinite(last).all()
                          and torch.isfinite(torch.cat(steps)).all()),
           "aux_loss": float(aux),
           "decode_vs_forward": {
               "max_logit_diff": float((torch.cat(steps) - ref)
                                       .abs().max()),
               "positions_checked": int(clear.sum()),
               "agreed": int((fidx[clear] == sidx[clear]).sum()),
               "not_enforced": "capacity routing: a decode step routes "
                               "its one token alone, the forward all "
                               "of them together"},
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "limit_bytes": JAMBA_PEAK_LIMIT, "launches": launches}
    emit(row)
    check(row["finite"], "jamba logits finite")
    check(row["max_memory_allocated_bytes"] < JAMBA_PEAK_LIMIT,
          f"forward_jamba peak memory under {JAMBA_PEAK_LIMIT} bytes")
    return launches


def _decode_read_bytes(params, cfg, cache) -> int:
    """Bytes a decode step must read at least: the decoder's blocks and
    final norm, the LM head (the tied embedding, or the untied head: an
    untied embedding table is only gathered), and an enc-dec cache's
    cross K/V; not the encoder, nor the frontend projection."""
    head = params["embed"]["embedding" if cfg.tie_embeddings else "lm_head"]
    trees = (params["blocks"], params["final_norm"], head,
             cache.get("cross", []))
    return sum(t.numel() * t.element_size() for tree in trees
               for t in _leaves(tree))


def _forward_phase(dev, phase: str, cfg, extra: dict, b: int, s: int,
                   n: int, expect: dict, extra_row: dict) -> dict:
    """One model at full width in bf16 (seed 0), no engine, the way a
    user drives ``models/model.py``: ``forward`` over prompt and n more
    tokens (with ``extra``: source frames or prefix embeddings), a
    ``prefill`` of the prompt, n teacher-forced ``decode_step`` calls, and
    both argmax reductions through top2gap. Launch counters are zeroed
    just before and read just after and must equal ``expect``. Every
    served position's logits (the prefill's last and each step's) against
    ``forward``'s at the same position within FORWARD_LOGIT_TOL, and the
    top2gap kernel's argmax of the two equal wherever forward's top-2 gap
    exceeds FORWARD_MARGIN (at least one such position). Prints the
    prefill's and each step's host ms and the span between CUDA events
    around it, then, after the counts are read, one
    more step and one more prefill inside torch.profiler windows for
    their device-busy ms and kernels (the step's idle share against the
    unprofiled host median); peak memory, the step's weight-read bound
    and the H100 cost model's step for the same batch and context.
    Returns the launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.profiling import cost_model as CM

    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init_params(cfg, seed=0, device=dev)
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    pre = (cfg.frontend.num_prefix_embeddings
           if "prefix_embeddings" in extra else 0)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + n)).astype(np.int32)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    full, _ = model_lib.forward(params, cfg, {"tokens": toks, **extra})

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)

    (last, cache), prefill_ms, prefill_dev_ms = timed(
        lambda: model_lib.prefill(params, cfg, {"tokens": toks[:, :s],
                                                **extra},
                                  cache_len=pre + s + n + 1))
    steps, step_ms, step_dev_ms = [last], [], []
    for i in range(n):
        (logits, cache), ms, dms = timed(
            lambda i=i: model_lib.decode_step(
                params, cfg, toks[:, s + i:s + i + 1], cache, pre + s + i))
        steps.append(logits)
        step_ms.append(ms)
        step_dev_ms.append(dms)
    served = torch.stack(steps, 1)                      # (B, n + 1, V)
    ref_tail = full[:, pre + s - 1:pre + s + n]         # same positions
    fgap, fidx = top2gap(ref_tail.reshape(-1, cfg.vocab_size).contiguous())
    _, sidx = top2gap(served.reshape(-1, cfg.vocab_size).contiguous())
    torch.cuda.synchronize()
    launches = K.launch_counts()
    err = float((served - ref_tail).abs().max())
    clear = fgap > FORWARD_MARGIN
    agreed = int((fidx[clear] == sidx[clear]).sum())
    read = _decode_read_bytes(params, cfg, cache)
    context = pre + s + n
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        model_lib.decode_step(params, cfg, toks[:, -1:], cache, context)
        torch.cuda.synchronize()
    step_kernels = _device_kernels(prof, 1)
    step_busy = sum(k[0] for k in step_kernels)
    del cache
    with profile(activities=acts) as prof:
        model_lib.prefill(params, cfg, {"tokens": toks[:, :s], **extra},
                          cache_len=context + 1)
        torch.cuda.synchronize()
    prefill_busy = sum(k[0] for k in _device_kernels(prof, 1))
    row = {"phase": phase, "arch": cfg.name, "batch": b,
           "prefix_len": pre, "prompt_len": s, "decode_steps": n,
           "param_bytes": param_bytes, "step_read_bytes": read,
           "weight_read_bound_step_ms": read / HBM_BYTES_PER_S * 1e3,
           "prefill_ms": prefill_ms, "prefill_event_ms": prefill_dev_ms,
           "prefill_device_busy_ms": prefill_busy,
           "step_ms": step_ms, "step_event_ms": step_dev_ms,
           "step_ms_median": statistics.median(step_ms),
           "step_device_busy_ms": step_busy,
           "step_kernels": sum(k[1] for k in step_kernels),
           "step_idle_share": 1.0 - step_busy / statistics.median(step_ms),
           "step_top": [{"ms": t, "launches": c, "kernel": name[:90]}
                        for t, c, name in step_kernels[:8]],
           "analytic_step_ms": CM.analytic_runtime(cfg, b, context,
                                                   "decode", 1) * 1e3,
           "logit_std": float(ref_tail.float().std()),
           "max_logit_err": err, "tol": FORWARD_LOGIT_TOL,
           "margin": FORWARD_MARGIN, "positions_checked": int(clear.sum()),
           "agreed": agreed,
           "finite": bool(torch.isfinite(full).all()
                          and torch.isfinite(served).all()),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "limit_bytes": FORWARD_PEAK_LIMIT, "launches": launches,
           "expected_launches": expect, **extra_row}
    row["measured_device_over_analytic"] = step_busy \
        / row["analytic_step_ms"]
    emit(row)
    check(row["finite"], f"{phase} logits finite")
    check(err <= FORWARD_LOGIT_TOL,
          f"{phase} prefill/decode logits within {FORWARD_LOGIT_TOL} of "
          f"forward ({err})")
    check(int(clear.sum()) > 0 and agreed == int(clear.sum()),
          f"{phase} argmax agrees where forward's gap > {FORWARD_MARGIN} "
          f"({agreed}/{int(clear.sum())})")
    for name, want in expect.items():
        check(launches[name] == want,
              f"{phase} {name} launches {launches[name]} == {want}")
    check(row["max_memory_allocated_bytes"] < FORWARD_PEAK_LIMIT,
          f"{phase} peak memory under {FORWARD_PEAK_LIMIT} bytes")
    return launches


def phase_forward_olmo(dev) -> dict:
    """Full-width olmo-1b (16 layers, d 2048, 16 heads over 16 KV heads
    at hd 128: a GQA group of 1; the non-parametric LayerNorm) in bf16:
    OLMO_BATCH prompts of PROMPT_HI tokens prefilled, then OLMO_STEPS
    teacher-forced decode steps (``_forward_phase``). Launches: flash once
    per layer of the forward and of the prefill, decode attention once per
    layer of each step, top2gap 2."""
    cfg = get_config(OLMO_ARCH)
    n = OLMO_STEPS
    expect = {"flash_attention": 2 * cfg.num_layers,
              "decode_attention": cfg.num_layers * n, "top2gap": 2,
              "mamba_scan": 0}
    return _forward_phase(dev, "forward_olmo", cfg, {}, OLMO_BATCH,
                          PROMPT_HI, n, expect, {})


def phase_forward_seamless(dev) -> dict:
    """seamless-m4t-large-v2 at full width (24 encoder and 24 decoder
    layers, d 1024, 16 = 16 KV heads at hd 64, GeGLU with the tanh GELU,
    LayerNorm with bias, tied head, vocab 256,206; about 1.77 B
    parameters) in bf16: SEAMLESS_B rows of random source frames (B, 500,
    1024) bf16 (10 s of audio at the w2v-BERT frontend's 20 ms frames),
    a SEAMLESS_PROMPT-token decoder prompt, SEAMLESS_STEPS teacher-forced
    steps (``_forward_phase``). Launches: flash 24 encoder (full form) +
    24 decoder self (causal) + 24 cross (full form over the 500 source
    keys) in each of ``forward`` and ``prefill``; decode attention 24 self
    + 24 cross (every key valid) per step; top2gap 2. Also holds the
    model's FFN (``common.apply_ffn`` with seamless's activation) to the
    tanh GELU the reference uses (``jax.nn.gelu``'s default), away from
    the erf form."""
    cfg = get_config(SEAMLESS_ARCH)
    g = _gen(24)
    frames = torch.randn(SEAMLESS_B, SEAMLESS_SRC,
                         cfg.frontend.frontend_dim, generator=g,
                         device=dev).bfloat16()
    # the FFN on [h, 1] with w_gate picking h, w_up the constant 1 and
    # w_down the identity is its activation of h, exactly in f32
    h = torch.randn(64, 64, generator=g, device=dev) * 3.0
    eye, zeros = torch.eye(64, device=dev), torch.zeros(64, 64, device=dev)
    one = torch.ones(1, 64, device=dev)
    ffn = {"w_gate": torch.cat([eye, torch.zeros_like(one)]),
           "w_up": torch.cat([zeros, one]), "w_down": eye}
    act = common.apply_ffn(ffn, torch.cat([h, one.T], 1), cfg.activation)
    tanh_form = 0.5 * h * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                            * (h + 0.044715 * h ** 3)))
    gelu_err = float((act - tanh_form).abs().max())
    erf_gap = float((act - 0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0))))
                    .abs().max())
    check(gelu_err <= 1e-5 < erf_gap,
          f"seamless's FFN applies the tanh GELU ({gelu_err}; the erf form "
          f"is {erf_gap} away)")
    layers, enc = cfg.num_layers, cfg.encdec.num_encoder_layers
    n = SEAMLESS_STEPS
    expect = {"flash_attention": 2 * (enc + 2 * layers),
              "decode_attention": 2 * layers * n, "top2gap": 2,
              "mamba_scan": 0}
    return _forward_phase(dev, "forward_seamless", cfg,
                          {"source_frames": frames}, SEAMLESS_B,
                          SEAMLESS_PROMPT, n, expect,
                          {"source_len": SEAMLESS_SRC,
                           "encoder_layers": enc,
                           "gelu_tanh_max_err": gelu_err,
                           "gelu_erf_gap": erf_gap})


def phase_forward_internvl(dev) -> dict:
    """internvl2-1b at full width (24 layers, d 896, 14 heads over 2 KV at
    hd 64, QKV bias, tied head, vocab 151,655; about 0.49 B parameters) in
    bf16: INTERNVL_B rows of 256 random prefix embeddings (B, 256, 1024)
    bf16 (the stub InternViT's patch rows, projected by ``frontend_proj``)
    before an INTERNVL_TEXT-token prompt, so the prefill is causal over
    456 positions, then INTERNVL_STEPS teacher-forced steps from position
    456 (``_forward_phase``). Launches: flash 24 in each of ``forward``
    and ``prefill``, decode attention 24 per step, top2gap 2."""
    cfg = get_config(INTERNVL_ARCH)
    prefix = torch.randn(INTERNVL_B, cfg.frontend.num_prefix_embeddings,
                         cfg.frontend.frontend_dim, generator=_gen(25),
                         device=dev).bfloat16()
    n = INTERNVL_STEPS
    expect = {"flash_attention": 2 * cfg.num_layers,
              "decode_attention": cfg.num_layers * n, "top2gap": 2,
              "mamba_scan": 0}
    return _forward_phase(dev, "forward_internvl", cfg,
                          {"prefix_embeddings": prefix}, INTERNVL_B,
                          INTERNVL_TEXT, n, expect, {})


def phase_forward_danube(dev) -> dict:
    """h2o-danube-1.8b at full width (24 layers, d 2560, 32 heads over 8
    KV at hd 80, window 4,096, untied head, vocab 32,000; about 1.83 B
    parameters) in bf16, batch 1: a DANUBE_PROMPT-token prompt, past the
    window, so the prefill's cache is cut to the last 4,096 positions and
    rolled into the ring, then DANUBE_STEPS decode steps on the full ring
    against ``forward`` over 4,208 tokens (``_forward_phase``). Launches:
    flash 24 in each of ``forward`` and ``prefill`` (windowed, hd 80),
    decode attention 24 per step (hd 80), top2gap 2."""
    cfg = get_config(DANUBE_ARCH)
    check(cfg.head_dim == 80 and DANUBE_PROMPT > cfg.sliding_window,
          "danube runs at hd 80 past its window")
    n = DANUBE_STEPS
    expect = {"flash_attention": 2 * cfg.num_layers,
              "decode_attention": cfg.num_layers * n, "top2gap": 2,
              "mamba_scan": 0}
    return _forward_phase(dev, "forward_danube", cfg, {}, DANUBE_B,
                          DANUBE_PROMPT, n, expect,
                          {"window": cfg.sliding_window,
                           "ring_slots": model_lib.attn.kv_cache_len(
                               cfg, DANUBE_PROMPT + n)})


# ---------------------------------------------------------------------------
# training: five attention models at full width and depth, the SSM, MoE and
# hybrid models at full width under a depth cut, and resumed runs
# ---------------------------------------------------------------------------

def _train_batch(cfg, b: int, s: int, seed: int) -> dict:
    """One ``SyntheticDataset`` batch (numpy) of ``s`` positions per row
    (a vision prefix counts toward them); an encoder-decoder's source
    frames are TRAIN_SRC rows drawn from the same seed (the dataset would
    give it min(max_source_len, s))."""
    batch = SyntheticDataset(cfg, b, s, seed=seed).next_batch()
    if cfg.is_encoder_decoder:
        batch["source_frames"] = np.random.default_rng(seed) \
            .standard_normal((b, TRAIN_SRC, cfg.frontend.frontend_dim)) \
            .astype(np.float32)
    return batch


def _attention_layers(cfg) -> int:
    """Flash calls in one forward: every attention layer; an
    encoder-decoder's encoder and decoder self attention and its cross
    attention."""
    n = sum(1 for i in range(cfg.num_layers) if cfg.layer_is_attention(i))
    if cfg.is_encoder_decoder:
        n = cfg.encdec.num_encoder_layers + 2 * cfg.num_layers
    return n


def _depth_cut(cfg, n: int):
    cut = cfg.scaled(num_layers=n)
    if cfg.is_encoder_decoder:
        cut = cut.scaled(encdec=dataclasses.replace(
            cfg.encdec, num_encoder_layers=n))
    return cut


def _ssm_layers(cfg) -> int:
    """Selective scans in one forward: every Mamba layer."""
    return sum(spec.mixer == "ssm" for spec in model_lib.block_pattern(cfg)) \
        * model_lib.num_reps(cfg)


def _train_launches(cfg, steps: int) -> dict:
    """The kernels one train step with remat launches, times ``steps``:
    each forward kernel twice per layer (the forward and its recompute in
    the backward pass) and each backward kernel once; no serving kernel."""
    n_attn, n_ssm = _attention_layers(cfg), _ssm_layers(cfg)
    return {"flash_attention": 2 * n_attn * steps,
            "flash_attention_bwd": n_attn * steps,
            "mamba_scan": 2 * n_ssm * steps, "mamba_scan_bwd": n_ssm * steps,
            "decode_attention": 0, "top2gap": 0}


def _grad_check_f32(dev, cfg, s: int, layers: int = TRAIN_CUT) -> dict:
    """One f32 train step's gradients at full width, cut to ``layers``
    layers (encoder too), batch 1 at the phase's positions, on the card
    (the flash and scan kernels forward and backward) and on the CPU (the
    plain versions under autograd): every leaf within TRAIN_GRAD_TOL of its
    largest CPU entry, the loss within 1e-5. The attention projections'
    and the SSM's A_log, D and dt_proj worst readings are printed apart: a
    kernel output without a gradient would leave them with none from it.
    An MoE model's routes must be the same on both sides, call by call;
    the smallest top-k router margin of the CPU run is printed, and a
    route that differs where that margin is under ROUTE_TIE is named as a
    near-tie."""
    cut = _depth_cut(cfg, layers)
    p_cpu = model_lib.init_params(cut, seed=1, dtype=torch.float32,
                                  device="cpu")
    batch = _train_batch(cut, 1, s, seed=3)
    out, routes = [], []
    for p in (p_cpu, tree_lib.tree_map(lambda t: t.detach().to(dev),
                                       p_cpu)):
        pairs, _ = tree_lib.flatten_with_path(p)
        for _, t in pairs:
            t.requires_grad_(True)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with _routes() as rec:
            loss, _ = model_lib.train_loss(p, cut, batch, remat=True)
            loss.backward()
        if p is not p_cpu:
            torch.cuda.synchronize()
        routes.append([(i.cpu(), m.detach().cpu()) for i, m in rec])
        out.append((float(loss.detach()), [(path, t.grad.cpu())
                                            for path, t in pairs],
                    K.launch_counts(), time.perf_counter() - t0))
        del pairs, loss, rec
    del p_cpu
    worst = 0.0
    named = {"attn_proj_grad_rel_err": ("wq", "wk", "wv"),
             "A_log_grad_rel_err": ("A_log",), "D_grad_rel_err": ("D",),
             "dt_proj_grad_rel_err": ("dt_proj_w", "dt_proj_b")}
    apart = {k: 0.0 for k in named}
    for (path, g), (_, r) in zip(out[1][1], out[0][1]):
        rel = float((g - r).abs().max() / max(float(r.abs().max()), 1e-30))
        worst = max(worst, rel)
        for key, leaves in named.items():
            if path[-1] in leaves:
                apart[key] = max(apart[key], rel)
    want = _train_launches(cut, 1)
    row = {"layers": layers, "positions": s, "loss_cpu": out[0][0],
           "loss_card": out[1][0], "worst_grad_rel_err": worst, **apart,
           "tol": TRAIN_GRAD_TOL, "launches": out[1][2],
           "cpu_s": out[0][3], "card_s": out[1][3]}
    if cut.moe is not None:
        margins = torch.cat([m for _, m in routes[0]])
        diff, routed = _route_diffs(routes[0], routes[1])
        near = torch.cat([ma[_set_differs(ia, ib)]
                          for (ia, ma), (ib, _) in zip(*routes)])
        row.update(min_router_margin_cpu=float(margins.min()),
                   route_diffs=diff, tokens_routed=routed,
                   route_tie=ROUTE_TIE)
        check(diff == 0, f"{cfg.name} f32 depth-cut routes on the card "
              f"equal the CPU's: {diff} of {routed} tokens differ"
              + (f", at router margins down to {float(near.min())}: a "
                 f"near-tie (under {ROUTE_TIE})"
                 if diff and float(near.min()) < ROUTE_TIE else ""))
    check(abs(out[1][0] - out[0][0]) <= 1e-5 * abs(out[0][0]),
          f"{cfg.name} f32 depth-cut loss on the card {out[1][0]} == the "
          f"CPU's {out[0][0]}")
    check(worst <= TRAIN_GRAD_TOL,
          f"{cfg.name} f32 depth-cut gradients on the card within "
          f"{TRAIN_GRAD_TOL} of the CPU's ({worst})")
    check(all(out[1][2][k] == n for k, n in want.items()),
          f"{cfg.name} f32 depth-cut step ran the kernels forward, "
          f"recomputed and backward ({out[1][2]} == {want})")
    return row


def _op_device_ms(prof, op: str) -> float:
    """Device ms of the kernels that calls of ``op`` launched in a
    torch.profiler window (0 where the profiler links none to it)."""
    total = 0.0
    for e in prof.key_averages():
        if e.key == op:
            t_us = getattr(e, "device_time_total", None)
            if t_us is None:
                t_us = e.cuda_time_total
            total += t_us / 1e3
    return total


def _train_phase(dev, phase: str, arch: str) -> dict:
    """One model trained at full width and depth in bf16 through the
    port's train step (``make_train_step``: ``train_loss`` with remat,
    ``backward()``, AdamW with f32 moments in place; random weights from
    seed 0) on one repeated ``SyntheticDataset`` batch at TRAIN_SHAPES:
    TRAIN_WARM steps, then TRAIN_STEPS timed ones (host wall around a
    synchronised step, and CUDA events), after ``_grad_check_f32`` (at
    TRAIN_CHECK_LAYERS, by default TRAIN_CUT). A model in TRAIN_LAYERS
    trains at that depth cut. The loss must fall and stay finite; launch
    counters, zeroed just before the timed steps and read just after, must
    be ``_train_launches``: each forward kernel layers x steps x 2 (the
    remat recompute), each backward kernel layers x steps, nothing else.
    Prints the step's median wall and device ms against 6 x params x
    tokens (8 x with remat) at the bf16 peak (an encoder's params count
    over the source positions, the rest over the decoder's; an MoE
    model's active params, with the all-expert figure beside), one
    profiled step's device time by kind (the scan's and flash's forward
    and backward kernels, the expert products (``aten::bmm``), the other
    GEMMs, the rest), one more step's loss-and-backward and AdamW halves
    between CUDA events, and the peak memory beside the 12 B a parameter
    of params, gradients and moments. Returns the launch counts."""
    full = get_config(arch)
    cfg = _depth_cut(full, TRAIN_LAYERS[arch]) if arch in TRAIN_LAYERS \
        else full
    b, s = TRAIN_SHAPES[arch]
    check_layers = TRAIN_CHECK_LAYERS.get(arch, TRAIN_CUT)
    gcheck = (_grad_check_f32(dev, full, s, check_layers) if check_layers
              else None)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init_params(cfg, seed=0, device=dev)
    enc = sum(t.numel() for key in ("encoder", "frontend_proj")
              if cfg.is_encoder_decoder and key in params
              for t in tree_lib.leaves(params[key]))
    n_params = sum(t.numel() for t in tree_lib.leaves(params))
    # the routed experts' weights: a token reaches top_k of E_pad of them
    experts = sum(t.numel() for blk in params["blocks"] if "moe" in blk
                  for key in ("w_gate", "w_up", "w_down")
                  for t in [blk["moe"][key]])
    active = n_params - experts + (
        experts * cfg.moe.top_k // moe_lib.padded_num_experts(cfg.moe)
        if experts else 0)
    positions = b * s
    src = b * TRAIN_SRC if cfg.is_encoder_decoder else 0
    pt = (active - enc) * positions + enc * src
    pt_all = (n_params - enc) * positions + enc * src
    opt = init_opt_state(params)
    opt_cfg = AdamWConfig(learning_rate=TRAIN_LR, warmup_steps=2,
                          decay_steps=100)
    step = make_train_step(cfg, opt_cfg, TrainStepConfig(remat=True))
    batch = as_batch(_train_batch(cfg, b, s, seed=0), dev)
    losses = []
    for _ in range(TRAIN_WARM):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    wall, event = [], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        params, opt, m = step(params, opt, batch)
        end.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        event.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    launches = K.launch_counts()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
    kernels = _device_kernels(prof, 1)
    busy = sum(k[0] for k in kernels)
    by_kind = {"flash_bwd": 0.0, "flash_fwd": 0.0, "scan_bwd": 0.0,
               "scan_fwd": 0.0, "expert_gemm": 0.0, "gemm": 0.0,
               "other": 0.0}
    for ms, _, name in kernels:
        kind = ("flash_bwd" if "flash_bwd" in name else
                "flash_fwd" if "flash" in name else
                "scan_bwd" if "mamba_scan_bwd" in name else
                "scan_fwd" if "mamba_scan" in name else
                "gemm" if re.search(r"gemm|xmma|nvjet|cutlass", name)
                else "other")
        by_kind[kind] += ms
    if experts:
        by_kind["expert_gemm"] = min(_op_device_ms(prof, "aten::bmm"),
                                     by_kind["gemm"])
        by_kind["gemm"] -= by_kind["expert_gemm"]
    del prof
    # the step's two halves on their own, between CUDA events: the loss and
    # its backward pass, then the AdamW update
    leaves = tree_lib.leaves(params)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    marks[0].record()
    loss, _ = model_lib.train_loss(params, cfg, batch, remat=True)
    loss.backward()
    marks[1].record()
    adamw_update(params, [p.grad for p in leaves], opt, opt_cfg)
    marks[2].record()
    torch.cuda.synchronize()
    for p in leaves:
        p.grad = None
    halves = {"loss_and_backward_event_ms": marks[0].elapsed_time(marks[1]),
              "adamw_event_ms": marks[1].elapsed_time(marks[2])}
    del loss, leaves
    expect = _train_launches(cfg, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(wall)
    row = {"phase": phase, "arch": cfg.name, "batch": b, "positions": s,
           "layers": cfg.num_layers, "full_layers": full.num_layers,
           "source_frames": TRAIN_SRC if cfg.is_encoder_decoder else 0,
           "params": n_params, "encoder_params": enc,
           "active_params": active,
           "param_state_bytes": 12 * n_params,
           "grad_check_f32": gcheck or "left out (TRAIN_CHECK_LAYERS)",
           "losses": losses,
           "grad_norm_last": float(m["grad_norm"]),
           "step_ms": wall, "step_event_ms": event,
           "step_ms_median": step_ms,
           "step_event_ms_median": statistics.median(event),
           "bound_6pt_ms": 6 * pt / BF16_FLOP_PER_S * 1e3,
           "bound_8pt_remat_ms": 8 * pt / BF16_FLOP_PER_S * 1e3,
           "bound_8pt_remat_all_experts_ms":
               8 * pt_all / BF16_FLOP_PER_S * 1e3,
           "tokens_per_s": (positions + src) / step_ms * 1e3,
           "max_memory_allocated_bytes": peak,
           "peak_over_param_state": peak / (12 * n_params),
           "launches": launches,
           "expected_launches": expect,
           "profiled_step_device_busy_ms": busy, **halves,
           "profiled_step_kernels": sum(k[1] for k in kernels),
           "device_busy_ms_by_kind": by_kind,
           "idle_share": 1.0 - busy / statistics.median(event),
           "top_kernels": [{"ms": t, "launches": c, "kernel": name[:90]}
                           for t, c, name in kernels[:8]]}
    row["mfu_6pt"] = row["bound_6pt_ms"] / row["step_event_ms_median"]
    TRAIN_ROWS[phase] = row
    emit(row)
    check(all(math.isfinite(x) for x in losses), f"{phase} losses finite")
    check(losses[-1] < losses[0], f"{phase} loss falls ({losses[0]} -> "
                                  f"{losses[-1]})")
    for name, want in expect.items():
        check(launches[name] == want,
              f"{phase} {name} launches {launches[name]} == {want}")
    del params, opt, batch, step, m
    return launches


def phase_train_qwen2(dev) -> dict:
    """qwen2-0.5b (24 layers, d 896, 14 heads over 2 KV at hd 64, tied
    head, vocab 151,936; 0.49 B parameters, about 6 GB of weights,
    gradients and moments), B 8 x 512 positions."""
    return _train_phase(dev, "train_qwen2", ARCH)


def phase_train_olmo(dev) -> dict:
    """olmo-1b (16 layers, d 2048, 16 = 16 KV heads at hd 128, the
    non-parametric LayerNorm; 1.18 B parameters, about 14 GB), B 4 x
    512."""
    return _train_phase(dev, "train_olmo", OLMO_ARCH)


def phase_train_danube(dev) -> dict:
    """h2o-danube-1.8b (24 layers, d 2560, 32 heads over 8 KV at hd 80,
    window 4,096; 1.83 B parameters, about 22 GB), B 1 x 4,200 positions,
    past the window."""
    return _train_phase(dev, "train_danube", DANUBE_ARCH)


def phase_train_internvl(dev) -> dict:
    """internvl2-1b (24 layers, d 896, 14 heads over 2 KV at hd 64;
    0.49 B parameters, about 6 GB), B 4 x (256 prefix embeddings + 200
    text tokens): the prefix positions carry no label."""
    return _train_phase(dev, "train_internvl", INTERNVL_ARCH)


def phase_train_seamless(dev) -> dict:
    """seamless-m4t-large-v2 (24 encoder and 24 decoder layers, d 1024,
    16 = 16 KV heads at hd 64, vocab 256,206; 1.77 B parameters, about
    21 GB), B 4 x 128 decoder positions over 500 source frames: the
    encoder's full flash form, the decoder's causal one and the cross
    attention's full form over 500 keys, each forward and backward."""
    return _train_phase(dev, "train_seamless", SEAMLESS_ARCH)


def phase_train_falcon_mamba(dev) -> dict:
    """falcon-mamba-7b at full width (d 4096, d_inner 8192, d_state 16,
    vocab 65,024) cut to 40 of its 64 layers (4.74 B parameters, 56.9 GB
    of weights, gradients and moments), B 4 x 512: every layer's scan
    through the mamba_scan kernel forward and recomputed and
    mamba_scan_bwd backward. Its f32 check runs 2 layers."""
    return _train_phase(dev, "train_falcon_mamba", SSM_ARCH)


def phase_train_moe(dev) -> dict:
    """qwen2-moe-a2.7b at full width (d 2048, 16 = 16 KV heads at hd 128,
    60 routed experts padded to 64, top-4 by softmax, 4 gated shared
    experts, vocab 151,936) cut to 6 of its 24 layers (4.05 B parameters),
    B 4 x 512: the flash kernels forward and backward, and the sorted
    dispatch's gathers and batched expert products under autograd. Its f32
    check runs 1 layer with the router guard."""
    return _train_phase(dev, "train_moe", MOE_ARCH)


def phase_train_jamba(dev) -> dict:
    """jamba-v0.1 at full width (d 4096, d_inner 8192, 16 experts of
    d_ff 14,336, top-2) cut to its first 3 layers (4.02 B parameters):
    Mamba + dense FFN, Mamba + MoE, Mamba + dense FFN; no attention layer
    (the first is its 5th). B 4 x 512; no f32 check (TRAIN_CHECK_LAYERS)."""
    return _train_phase(dev, "train_jamba", JAMBA_ARCH)


RESUME_AT, RESUME_K = 2, 2      # steps before the checkpoint, and after
# Where an op of the path is named nondeterministic, the resumed run is held
# within RESUME_TOL of the uninterrupted one, every leaf, instead of bit for
# bit: a gradient that differs moves an element's AdamW step by at most
# 2 x the learning rate (the bias-corrected step m/sqrt(v) lies within
# [-1, 1] where 1 - b1 <= sqrt(1 - b2), as at 0.9 and 0.95), and each step
# rounds a bf16 param once more (2^-7 at the norms' 1.0, the largest
# params); the moments move far less than the params.
RESUME_TOL = RESUME_K * (2 * TRAIN_LR + 2.0 ** -7)
# the resumed runs: qwen2-0.5b whole, falcon-mamba-7b at full width cut to
# 2 layers (0.74 B parameters, a 7.4 GB checkpoint: it saves about as fast
# as qwen2's 4.9 GB); the phase's name and the depth cut
RESUMED = {ARCH: ("train_resume", None), SSM_ARCH: ("train_resume_ssm", 2)}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = a.view(ints[a.element_size()]), b.view(ints[b.element_size()])
    return torch.equal(a, b)


def _train_resume_child(arch: str) -> dict:
    """Save, restore and resume ``arch`` at full width (its train phase's
    shape, at RESUMED's depth cut, RESUME_AT + RESUME_K distinct batches)
    under
    ``torch.use_deterministic_algorithms(True)``: RESUME_AT steps, a
    ``CheckpointManager`` save into a temporary directory (deleted after),
    RESUME_K more steps; then the checkpoint restored into a zeroed
    template and the same RESUME_K steps from it. Runs in a process of its
    own, started with CUBLAS_WORKSPACE_CONFIG set, as deterministic cuBLAS
    needs. Where an op of the path has no deterministic implementation it
    is named, the mode is relaxed to a warning, and the two runs are held
    within RESUME_TOL instead."""
    import tempfile
    dev = resolve_device("cuda")
    phase, layers = RESUMED[arch]
    cfg = get_config(arch)
    if layers:
        cfg = _depth_cut(cfg, layers)
    b, s = TRAIN_SHAPES[arch]
    ds = SyntheticDataset(cfg, b, s, seed=5)
    batches = [as_batch(ds.next_batch(), dev)
               for _ in range(RESUME_AT + RESUME_K)]
    step = make_train_step(cfg, AdamWConfig(learning_rate=TRAIN_LR,
                                            warmup_steps=2, decay_steps=100),
                           TrainStepConfig(remat=True))
    nondeterministic = None
    torch.use_deterministic_algorithms(True)

    def run(params, opt, lo, hi):
        nonlocal nondeterministic
        for i in range(lo, hi):
            try:
                params, opt, _ = step(params, opt, batches[i])
            except RuntimeError as e:
                if "deterministic" not in str(e) or nondeterministic:
                    raise
                nondeterministic = str(e).splitlines()[0][:300]
                torch.use_deterministic_algorithms(True, warn_only=True)
                params, opt, _ = step(params, opt, batches[i])
        return params, opt

    params = model_lib.init_params(cfg, seed=0, device=dev)
    opt = init_opt_state(params)
    params, opt = run(params, opt, 0, RESUME_AT)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        mgr = CheckpointManager(tmp)
        t0 = time.perf_counter()
        mgr.save(RESUME_AT, (params, opt), extra={"arch": cfg.name})
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(tmp) for f in fs)
        saved = tree_lib.tree_map(lambda t: t.detach().clone(),
                                  (params, opt))
        straight = run(params, opt, RESUME_AT, RESUME_AT + RESUME_K)
        template = tree_lib.tree_map(torch.zeros_like, saved)
        t0 = time.perf_counter()
        restored, meta = mgr.restore(template)
        restore_s = time.perf_counter() - t0
        del template
    restored_equal = meta["step"] == RESUME_AT and all(
        _same_bits(a.detach(), r) for a, r in zip(
            tree_lib.leaves(saved), tree_lib.leaves(restored)))
    del saved
    resumed = run(*restored, RESUME_AT, RESUME_AT + RESUME_K)
    pairs = [(a.detach(), r.detach()) for a, r in zip(
        tree_lib.leaves(straight), tree_lib.leaves(resumed))]
    resumed_equal = all(_same_bits(a, r) for a, r in pairs)
    max_diff = max(float((a.float() - r.float()).abs().max())
                   for a, r in pairs)
    return {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
            "batch": b, "positions": s, "steps_before": RESUME_AT,
            "steps_after": RESUME_K, "checkpoint_bytes": ckpt_bytes,
            "save_s": save_s, "restore_s": restore_s,
            "restored_bit_equal": restored_equal,
            "resumed_bit_equal": resumed_equal,
            "resumed_max_abs_diff": max_diff,
            "resume_tol": RESUME_TOL,
            "leaves": len(pairs),
            "nondeterministic_op": nondeterministic,
            "deterministic_algorithms":
                torch.are_deterministic_algorithms_enabled()}


def phase_train_resume(arch: str) -> None:
    """``_train_resume_child(arch)`` in a process of its own (this script
    with ``--train-resume-child ARCH``), which must print its row last and
    exit 0:
    the restored state bit-equal to the saved one, and the resumed run
    bit-equal to the uninterrupted one (or, where an op was named
    nondeterministic, every leaf within RESUME_TOL of it: no difference is
    allowed without a name)."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--train-resume-child", arch], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines,
          f"train_resume child exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    row = json.loads(lines[-1])
    emit(row)
    check(row["restored_bit_equal"], f"{arch}: the restored state is "
                                     f"bit-equal to the saved one")
    if row["nondeterministic_op"] is None:
        check(row["resumed_bit_equal"], f"{arch}: the resumed run is "
              f"bit-equal to "
              f"the uninterrupted one (max diff "
              f"{row['resumed_max_abs_diff']})")
    else:
        check(row["resumed_max_abs_diff"] <= RESUME_TOL,
              f"{arch}: the resumed run is within {RESUME_TOL} of the "
              f"uninterrupted "
              f"one, as {row['nondeterministic_op']!r} is nondeterministic "
              f"(max diff {row['resumed_max_abs_diff']})")


def _depth_cut_f32(params, n_layers: int):
    """The first ``n_layers`` repetitions of a dense model's params in
    float32, built leaf by leaf while the full-depth bf16 leaves are
    dropped, so the bf16 model and its f32 cut never coexist whole."""
    out = {}
    for key in list(params):
        tree = params.pop(key)
        if key == "blocks":
            out[key] = [{k: _cut_leaves(v, n_layers) for k, v in blk.items()}
                        for blk in tree]
        else:
            out[key] = _widen(tree)
        del tree
    return out


def _cut_leaves(tree, n):
    if isinstance(tree, dict):
        return {k: _cut_leaves(tree.pop(k), n) for k in list(tree)}
    return tree[:n].float()


def phase_teacher_forced_f32(dev, p32, cfg, reqs, of: str,
                             n_req: int = 4) -> None:
    """One float32 stage at full width (``cfg`` may be cut in depth)
    serves the first requests through the fused engine; the served tokens
    must agree with an f32 teacher-forced ``forward`` wherever its top-2
    gap exceeds 0.1. The engine's slot pool rounds a joiner's cache (the
    SSM's conv tail, attention's K/V) to bf16 as the JAX engine's does, so
    the gaps are held tight on ``greedy_generate``, whose cache stays f32:
    its decode gaps within F32_GAP_TOL of the forward's."""
    kernel = "mamba_scan" if cfg.ssm is not None else "flash_attention"
    te = TokenEngine([SlotEngine("a", p32, cfg, N_SLOTS, MAX_LEN,
                                 device=dev)], _gear(["a"], []),
                     min_tokens=MIN_TOKENS, early_margin=EARLY_MARGIN,
                     spec_k=SPEC_K)
    sub = reqs[:n_req]
    before = K.launch_counts()[kernel]
    out = te.serve(sub)
    check(K.launch_counts()[kernel] - before
          == cfg.num_layers * te.stats()["prefill_calls"],
          f"the f32 prefills run {kernel} in every layer")
    _teacher_forced_check({"a": p32}, {"a": cfg}, sub, out, f"{of}_f32")
    r = reqs[0]
    toks, gaps = greedy_generate(p32, cfg, r.prompt, MAX_NEW)
    seq = np.concatenate([r.prompt, toks[:-1]])[None]
    logits, _ = model_lib.forward(p32, cfg, {"tokens": seq})
    fgap, fidx = top2gap(logits[0, r.prompt.size - 1:].contiguous())
    diff = float(np.abs(fgap.cpu().numpy() - gaps).max())
    clear = fgap.cpu().numpy() > 0.1
    emit({"phase": "greedy_f32", "of": of, "layers": cfg.num_layers,
          "tokens": len(toks), "max_gap_diff": diff,
          "positions_checked": int(clear.sum()),
          "agreed": int((fidx.cpu().numpy()[clear] == toks[clear]).sum())})
    check(diff <= F32_GAP_TOL,
          f"f32 decode and forward gaps within {F32_GAP_TOL} ({diff})")
    check(np.array_equal(fidx.cpu().numpy()[clear], toks[clear]),
          "f32 greedy tokens agree with the forward where the gap > 0.1")


def _widen(tree):
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_widen(v) for v in tree]
    return tree.float()


def phase_reference(dev, params, cfg, reqs, fused, n_req: int = 4,
                    max_new: int = 8) -> None:
    """Stage a in reference mode (batch-1 prefills, one decode call per
    step): every prefill's and every step's argmax and gap come from the
    top2gap kernel, and the tokens match the fused calibration run's up to
    the first position either gap puts inside bf16 noise."""
    margin = 0.1
    te = TokenEngine([SlotEngine("a", params, cfg, N_SLOTS, MAX_LEN,
                                 device=dev)], _gear(["a"], []),
                     min_tokens=MIN_TOKENS, early_margin=EARLY_MARGIN,
                     mode="reference")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    out = te.serve([TokenRequest(r.rid, r.prompt, max_new)
                    for r in reqs[:n_req]])
    torch.cuda.synchronize()
    launches = K.launch_counts()
    st = te.stats()
    compared = 0
    for r in reqs[:n_req]:
        ref, fus = out[r.rid], fused[r.rid]
        check(len(ref.tokens) == max_new, "reference request completes")
        for t_r, t_f, g_r, g_f in zip(ref.tokens, fus.tokens, ref.gaps,
                                      fus.gaps):
            if min(g_r, g_f) <= margin:
                break
            check(t_r == t_f, f"reference token {t_r} == fused {t_f}")
            compared += 1
    emit({"phase": "reference", "requests": n_req, "max_new": max_new,
          "prefill_calls": st["prefill_calls"],
          "decode_calls": st["decode_calls"], "launches": launches,
          "tokens_compared": compared, "margin": margin})
    layers = cfg.num_layers
    check(launches["top2gap"] == st["prefill_prompts"] + st["decode_calls"],
          "reference mode reduces every prefill and step with top2gap")
    check(launches["decode_attention"] == layers * st["decode_steps"],
          "reference decode runs the decode kernel in every layer")
    check(launches["flash_attention"] == layers * st["prefill_calls"],
          "reference prefill runs the flash kernel in every layer")
    check(compared > 0, "reference tokens compared with the fused run")


# ---------------------------------------------------------------------------
# graph replays against direct eager calls
# ---------------------------------------------------------------------------

def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _equal(a, b) -> bool:
    """Nested dicts and lists of tensors, bit for bit and dtype for
    dtype."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def _prefill_vs_eager(eng: SlotEngine, prompts) -> bool:
    """One join through the engine's bucketed prefill against
    ``prefill_bucketed`` and the top2gap reduction called eagerly on the
    same padded batch: first tokens and gaps, and the joiners' pool lanes
    against the eager cache rows, bit for bit. Returns whether the call
    replayed a graph."""
    n = len(prompts)
    bb = eng._batch_bucket(n)
    lb = eng._len_bucket(max(p.size for p in prompts))
    arr = np.zeros((bb, lb), np.int32)
    lens = np.ones((bb,), np.int32)
    for i, p in enumerate(prompts):
        arr[i, :p.size] = p
        lens[i] = p.size
    logits, cache1 = model_lib.prefill_bucketed(eng.params, eng.cfg, arr,
                                                lens, cache_len=eng.max_len)
    gap, idx = top2gap(logits)
    replays = eng.graphs.replays
    slots, toks, gaps = eng.prefill_batch(prompts)
    rows = torch.as_tensor(slots, device=eng.device)
    check(np.array_equal(toks, idx[:n].cpu().numpy())
          and np.array_equal(gaps, gap[:n].cpu().numpy()),
          f"bucketed prefill {bb}x{lb}: tokens and gaps equal the eager "
          f"call's")
    check(all(torch.equal(leaf[:, rows], new[name][:, :n])
              for pool, new in zip(eng.cache["blocks"], cache1["blocks"])
              for name, leaf in pool.items()),
          f"bucketed prefill {bb}x{lb}: pool lanes equal the eager cache")
    return eng.graphs.replays == replays + 1


def _exact_prefill_vs_eager(eng: SlotEngine, prompts) -> int:
    """One join of exact-length batch-1 prefills (the SSM and MoE path,
    run eagerly) against ``prefill`` and the top2gap reduction called
    directly on each prompt: first tokens and gaps, and each joiner's pool
    lane against the direct call's cache, bit for bit. Returns the
    prefills compared."""
    eager = []
    for p in prompts:
        logits, cache1 = model_lib.prefill(eng.params, eng.cfg,
                                           {"tokens": p[None]},
                                           cache_len=eng.max_len)
        gap, idx = top2gap(logits)
        eager.append((int(idx[0]), float(gap[0]), cache1))
    slots, toks, gaps = eng.prefill_batch(prompts)
    for slot, tok, g, (etok, egap, cache1) in zip(slots, toks, gaps, eager):
        check(int(tok) == etok and float(g) == egap,
              f"exact-length prefill (S {len(prompts[0])}...): token and "
              f"gap equal the direct call's")
        check(all(torch.equal(leaf[:, slot], new[name][:, 0].to(leaf.dtype))
                  for pool, new in zip(eng.cache["blocks"], cache1["blocks"])
                  for name, leaf in pool.items()),
              "exact-length prefill: the pool lane equals the direct "
              "call's cache")
    return len(prompts)


def _fused_vs_eager(eng: SlotEngine, k: int) -> bool:
    """k fused steps through the engine against ``decode_fused_steps``
    called eagerly on a clone of the engine's state (pool, tokens,
    positions, active mask, fold): token, gap and certainty traces and the
    state after the call, bit for bit. Returns whether it replayed."""
    active = torch.from_numpy(eng.active).to(eng.device)
    tt, gt, ct, tok, cache, pos, fold = model_lib.decode_fused_steps(
        eng.params, eng.cfg, eng.dev_tok.clone(), _clone(eng.cache),
        eng.dev_pos.clone(), active, _clone(eng._fold), k=k)
    replays = eng.graphs.replays
    out = eng.decode_fused(k)
    check(all(np.array_equal(got, want.cpu().numpy())
              for got, want in zip(out, (tt, gt, ct))),
          f"fused decode k={k}: token, gap and certainty traces equal the "
          f"eager call's")
    check(torch.equal(eng.dev_tok, tok) and torch.equal(eng.dev_pos, pos)
          and _equal(eng._fold, fold) and _equal(eng.cache, cache),
          f"fused decode k={k}: state equals the eager call's")
    return eng.graphs.replays == replays + 1


def _reference_vs_eager(eng: SlotEngine, nxt: dict):
    """One reference decode step through the engine against
    ``decode_step`` and the top2gap reduction called eagerly on a clone of
    the pool. Returns (whether it replayed, the engine's output)."""
    toks = np.zeros((eng.n_slots, 1), np.int32)
    for s, t in nxt.items():
        toks[s, 0] = t
    logits, cache = model_lib.decode_step(
        eng.params, eng.cfg, toks, _clone(eng.cache),
        torch.from_numpy(eng.pos).to(eng.device))
    gap, idx = top2gap(logits)
    idx, gap = idx.cpu().numpy(), gap.cpu().numpy()
    replays = eng.graphs.replays
    out = eng.decode(nxt)
    check(all(t == int(idx[s]) and g == float(gap[s])
              for s, (t, g) in out.items()) and _equal(eng.cache, cache),
          "reference decode: tokens, gaps and pool equal the eager call's")
    return eng.graphs.replays == replays + 1, out


def phase_graphs(dev, params, cfg, path: str, stage: str = "a",
                 reference: bool = False) -> dict:
    """A fresh engine's captured entry points replayed against direct
    eager calls of the same ``models/model.py`` functions on a cloned copy
    of the same state, bit for bit. Fused: three joins of two prompts of
    129-200 tokens (one (2, 256) bucket; the first join is the bucket's
    warm-up; on the SSM and MoE paths, exact-length eager prefills, each
    held against a direct ``prefill`` call), then three fused calls at
    k 1 and three at SPEC_K. Reference: three batch-1
    joins, then three decode steps. The first call of a key is its eager
    warm-up; every key is then replayed and compared at least twice, on
    new inputs each time (the slots fill and the positions advance), so
    the static inputs and the tensor maps baked into the flash kernel's
    launches carry new data."""
    rng = np.random.default_rng(5)
    eng = SlotEngine(stage, params, cfg, N_SLOTS, MAX_LEN, device=dev)

    def prompt():
        return rng.integers(0, cfg.vocab_size, int(rng.integers(
            129, PROMPT_HI + 1))).astype(np.int32)

    compared = {}
    if reference:
        nxt = {}
        for _ in range(3):
            slot, tok, _ = eng.prefill_into_slot(prompt())
            nxt[slot] = tok
        compared["reference_decode"] = 0
        for _ in range(3):
            replayed, out = _reference_vs_eager(eng, nxt)
            compared["reference_decode"] += replayed
            nxt = {s: t for s, (t, _) in out.items()}
    else:
        if model_lib.bucketed_prefill_supported(cfg):
            compared["bucketed_prefill"] = sum(
                _prefill_vs_eager(eng, [prompt(), prompt()])
                for _ in range(3))
        else:
            compared["exact_prefill"] = sum(
                _exact_prefill_vs_eager(eng, [prompt(), prompt()])
                for _ in range(3))
        for k in (1, SPEC_K):
            compared[f"fused_decode_k{k}"] = sum(
                _fused_vs_eager(eng, k) for _ in range(3))
    torch.cuda.synchronize()
    row = {"phase": "graphs_vs_eager", "path": path, "arch": cfg.name,
           "stage": stage, "replays_compared": compared,
           "compile_counts": eng.compile_counts(),
           "graphs": eng.graphs.captured, "replays": eng.graphs.replays,
           "capture_seconds": eng.graphs.capture_seconds}
    emit(row)
    check(all(n >= 2 for n in compared.values()),
          f"{path}: every captured entry point replayed and compared at "
          f"least twice ({compared})")
    return row


def _path_summary(path: str, summary: dict, trace: dict,
                  graphs: dict) -> None:
    """The per-path numbers of compiled steps on one line: served step and
    prefill ms (host wall, medians) of the traced stage beside the trace
    window's device ms and host launch calls per step, graphs and capture
    seconds over the serve run's engines, peak memory and tokens/s."""
    st = summary["by_stage"][trace["stage"]]
    emit({"phase": "path_summary", "path": path, "arch": trace["arch"],
          "stage": trace["stage"],
          "served_step_ms_median": st["step_ms_median"],
          "served_step_ms_median_replayed": st["step_ms_median_replayed"],
          "served_prefill_ms_median": st["prefill_ms_median"],
          "served_prefill_ms_median_replayed":
              st["prefill_ms_median_replayed"],
          "trace_wall_ms_per_step": trace["wall_ms_per_step"],
          "device_ms_per_step": trace["device_busy_ms_per_step"],
          "idle_share": trace["idle_share"],
          "host_launch_calls_per_step": trace["host_launch_calls_per_step"],
          "device_kernels_per_step": trace["kernel_launches_per_step"],
          "prefill_bucket": trace["prefill_bucket"],
          "prefill_wall_ms_profiled": trace["prefill_profiled"]["wall_ms"],
          "prefill_device_ms": trace["prefill_profiled"]["device_busy_ms"],
          "prefill_host_launch_calls":
              trace["prefill_profiled"]["host_launch_calls"],
          "graphs_served": {m: v["graphs"]
                            for m, v in summary["by_stage"].items()},
          "capture_seconds_served": {m: v["capture_seconds"]
                                     for m, v in summary["by_stage"].items()},
          "graphs_checked": graphs["graphs"],
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
          "tokens_per_s": summary["tokens_per_s"]})


def _device_kernels(prof, per: int) -> list:
    """(device ms, launches, name) of each kernel in a torch.profiler
    window, divided by ``per``, the longest first."""
    from torch.autograd import DeviceType
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t_us = getattr(e, "self_device_time_total", None)
        if t_us is None:
            t_us = e.self_cuda_time_total
        kernels.append((t_us / 1e3 / per, e.count / per, e.key))
    kernels.sort(reverse=True)
    return kernels


def _host_api(prof, per: int) -> dict:
    """Host calls into the CUDA runtime and driver in a torch.profiler
    window, by name, divided by ``per``: kernel and graph launches,
    copies, synchronisations."""
    from torch.autograd import DeviceType
    return {e.key: e.count / per for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.key.startswith("cu")}


def _launch_calls(api: dict) -> float:
    """Kernel and graph launches among the host's CUDA API calls."""
    return sum(n for name, n in api.items() if "Launch" in name)


def phase_trace(dev, params, cfg, reqs, phase: str, n_steps: int = 8,
                stage: str = "a") -> dict:
    """A torch.profiler window over fused decode steps of one stage with
    every slot resident: device-busy share of the step and the kernels
    that take the time, and the host's CUDA API calls per step (with
    graphs, one ``cudaGraphLaunch`` a step where eager PyTorch made one
    ``cudaLaunchKernel`` per kernel); measurement only, nothing is
    checked. The first step, outside the window, is the fused graph's
    warm-up and capture. The prefill that fills the slots (the bucket's
    warm-up and capture) is timed on the host clock; after the decode
    window the slots are released and the same prompts prefilled again
    inside a second profiler window (a replay), for the prefill's device
    time."""
    from torch.profiler import ProfilerActivity, profile

    eng = SlotEngine(stage, params[stage], cfg, N_SLOTS, MAX_LEN,
                     device=dev)
    prompts = [r.prompt for r in reqs[:N_SLOTS]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.prefill_batch(prompts)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    bucket = f"{len(prompts)}x{max(len(p) for p in prompts)}"
    if model_lib.bucketed_prefill_supported(cfg):
        bucket = (f"{eng._batch_bucket(len(prompts))}x"
                  f"{eng._len_bucket(max(len(p) for p in prompts))}")
    eng.decode_fused(1)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.decode_fused(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    kernels = _device_kernels(prof, n_steps)
    api = _host_api(prof, n_steps)
    busy = sum(k[0] for k in kernels)
    for slot in np.flatnonzero(eng.active):
        eng.release(int(slot))
    torch.cuda.synchronize()
    with profile(activities=acts) as pprof:
        t0 = time.perf_counter()
        eng.prefill_batch(prompts)
        torch.cuda.synchronize()
        pwall_ms = (time.perf_counter() - t0) * 1e3
    pkernels = _device_kernels(pprof, 1)
    papi = _host_api(pprof, 1)
    pbusy = sum(k[0] for k in pkernels)
    row = {"phase": phase, "arch": cfg.name, "stage": stage,
           "steps": n_steps,
           "batch": N_SLOTS, "prefill_bucket": bucket,
           "prefill_ms": prefill_ms,
           "wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": busy if kernels else None,
           "idle_share": 1.0 - busy / wall_ms if kernels else None,
           "kernel_launches_per_step": sum(k[1] for k in kernels),
           "host_launch_calls_per_step": _launch_calls(api),
           "host_cuda_api_per_step": api,
           "graphs": eng.graphs.captured,
           "capture_seconds": eng.graphs.capture_seconds,
           "compile_counts": eng.compile_counts(),
           "top": [{"ms_per_step": t, "launches_per_step": c,
                    "kernel": name[:90]} for t, c, name in kernels[:12]],
           "prefill_profiled": {
               "wall_ms": pwall_ms,
               "device_busy_ms": pbusy if pkernels else None,
               "idle_share": 1.0 - pbusy / pwall_ms if pkernels else None,
               "kernel_launches": sum(k[1] for k in pkernels),
               "host_launch_calls": _launch_calls(papi),
               "host_cuda_api": papi,
               "top": [{"ms": t, "launches": c, "kernel": name[:90]}
                       for t, c, name in pkernels[:12]]}}
    emit(row)
    return row


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _teacher_forced_check(params, cfgs, reqs, out, phase: str,
                          n_check: int = 4, enforce_at: float = 0.1,
                          not_enforced: str = "") -> dict:
    """Feeds prompt + served tokens of the first ``n_check`` requests
    through their resolving stage's ``forward`` (the flash attention or
    selective-scan kernel) and compares its greedy argmax with the tokens
    the decode loop served, at every position where forward's top-2 gap
    exceeds a margin: counted at 0.1, 0.25, 0.5, 1 and ``enforce_at``, and
    required to agree at ``enforce_at`` unless ``not_enforced`` gives the
    reason the comparison does not hold. Also reports the largest gap
    difference between the two paths."""
    margins = sorted({0.1, 0.25, 0.5, 1.0, enforce_at})
    checked = dict.fromkeys(margins, 0)
    agreed = dict.fromkeys(margins, 0)
    max_gap_diff = 0.0
    for r in reqs[:n_check]:
        res = out[r.rid]
        stage = "a" if res.resolver == 0 else "b"
        seq = np.concatenate([r.prompt, np.asarray(res.tokens[:-1],
                                                   np.int32)])[None]
        logits, _ = model_lib.forward(params[stage], cfgs[stage],
                                      {"tokens": seq})
        tail = logits[0, r.prompt.size - 1:]              # (tokens, V)
        gap, idx = top2gap(tail.contiguous())
        gap, idx = gap.cpu().numpy(), idx.cpu().numpy()
        served = np.asarray(res.tokens)
        sgaps = np.asarray(res.stage_gaps[res.resolver])
        max_gap_diff = max(max_gap_diff, float(np.abs(gap - sgaps).max()))
        for m in margins:
            clear = gap > m
            checked[m] += int(clear.sum())
            agreed[m] += int((idx[clear] == served[clear]).sum())
    agree = {"phase": "teacher_forced", "of": phase,
             "requests": [r.rid for r in reqs[:n_check]],
             "dtype": str(next(iter(params.values()))["embed"]["embedding"]
                          .dtype),
             "enforced_margin": None if not_enforced else enforce_at,
             "positions_checked": {str(m): checked[m] for m in margins},
             "agreed": {str(m): agreed[m] for m in margins},
             "max_gap_diff": max_gap_diff}
    if not_enforced:
        agree["not_enforced"] = not_enforced
    emit(agree)
    if not_enforced:
        return agree
    check(checked[enforce_at] > 0
          and agreed[enforce_at] == checked[enforce_at],
          f"teacher-forced argmax agrees where the gap exceeds "
          f"{enforce_at} ({agreed[enforce_at]}/{checked[enforce_at]})")
    return agree


def phase_cost_model(traces: dict, qwen3: dict, param_bytes: dict) -> None:
    """The analytic cost model on H100 constants (``repro_torch.profiling``)
    beside what the card measured: a decode step at B N_SLOTS, context
    MAX_LEN against the profiler windows' device ms per step (and host
    wall ms) and against the time to read every weight the step reads
    (``param_bytes`` by arch: all of them, the MoE's 64 experts too, where
    the model prices the active ones), qwen3-32b's prefill against the
    trace window's prefill of eight prompts (the B 8 x 256 bucket; host
    wall, and device ms from its profiled repeat);
    then the serve CLI's ``--workload qwen`` plan and DES through its own
    functions. Numbers only, except that qwen3-32b must place on one card
    and the DES must complete requests; the constants are not tuned to
    the measurements."""
    from repro_torch.core.plan_state import HardwareSpec
    from repro_torch.core.planner import optimize_gear_plan
    from repro_torch.launch import serve as S
    from repro_torch.profiling import cost_model as CM
    from repro_torch.profiling import hw

    rows = []
    for arch, tr in traces.items():
        cfg = get_config(arch)
        rows.append({
            "arch": arch, "kind": "decode", "batch": N_SLOTS,
            "context": MAX_LEN,
            "analytic_ms": CM.analytic_runtime(cfg, N_SLOTS, MAX_LEN,
                                               "decode", 1) * 1e3,
            "weight_read_bound_ms": cfg.active_param_count() * 2.0
            / hw.HBM_BW * 1e3,
            "all_weights_read_bound_ms": param_bytes[arch] / hw.HBM_BW * 1e3,
            "measured_device_ms": tr["device_busy_ms_per_step"],
            "measured_wall_ms": tr["wall_ms_per_step"],
            "launches_per_step": tr["kernel_launches_per_step"]})
    tr = traces[QWEN3_ARCH]
    b, length = (int(x) for x in tr["prefill_bucket"].split("x"))
    flops = CM.model_flops(get_config(QWEN3_ARCH), b * length, length,
                           "prefill")
    dev_ms = tr["prefill_profiled"]["device_busy_ms"]
    rows.append({
        "arch": QWEN3_ARCH, "kind": "prefill", "batch": b,
        "context": length,
        "analytic_ms": CM.analytic_runtime(get_config(QWEN3_ARCH), b,
                                           length, "prefill", 1) * 1e3,
        "analytic_flops": flops,
        "measured_device_ms": dev_ms,
        # the whole prefill's rate: its GEMMs run at least this fast
        "device_flop_share_of_peak": flops / (dev_ms * 1e-3)
        / hw.PEAK_FLOPS_BF16 if dev_ms else None,
        "measured_wall_ms": tr["prefill_ms"],
        "served_wall_ms_by_bucket": qwen3["by_stage"]["b"]
        ["prefill_ms_median"]})
    emit({"phase": "cost_model", "hw": {
        "PEAK_FLOPS_BF16": hw.PEAK_FLOPS_BF16, "HBM_BW": hw.HBM_BW,
        "HBM_BYTES": hw.HBM_BYTES, "ICI_BW": hw.ICI_BW}, "rows": rows})

    profiles = S.qwen_backend().profiles
    spec = HardwareSpec(num_devices=4, mem_per_device=hw.HBM_BYTES)
    report = optimize_gear_plan(profiles, spec, S.parse_slo("latency:0.3"),
                                qps_max=60.0, n_ranges=8)
    plan = report.plan
    res = S.serve_des(plan, profiles, S.make_trace("diurnal", 60, 60.0))
    emit({"phase": "cost_model_plan", "workload": "qwen",
          "slices": {n: p.devices_per_replica for n, p in profiles.items()},
          "runtime_ms_b1": {n: p.runtime(1) * 1e3
                            for n, p in profiles.items()},
          "seconds": report.wall_seconds,
          "ranges": [{"qps_to": plan.range_width * (r + 1),
                      "cascade": list(g.cascade.models),
                      "expected_accuracy": g.expected_accuracy,
                      "expected_p95_ms": g.expected_p95 * 1e3}
                     for r, g in enumerate(plan.gears)],
          "des": {"done": res.completed, "offered": res.offered,
                  "p95_ms": res.p95 * 1e3, "accuracy": res.accuracy,
                  "utilization": res.utilization,
                  "gear_switches": len(res.gear_switches)}})
    check(profiles[QWEN3_ARCH].devices_per_replica == 1,
          "qwen3-32b places on one modelled H100")
    check(res.completed > 0, "the qwen DES completes requests")


# ---------------------------------------------------------------------------
# phase 23: the one-shot classifier cascade (train, profile, plan, serve)
# ---------------------------------------------------------------------------

class _Recording:
    """The serve path's backend, with every ``execute`` recorded: how many
    batches ran, and each (request, model)'s certainty and prediction as
    the kernel gave them. Everything else is the backend's own."""

    def __init__(self, inner):
        self.inner = inner
        self.batches = 0
        self.seen = {}
        self.elapsed = {}
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def execute(self, model, sids, tokens=None):
        ex = self.inner.execute(model, sids, tokens=tokens)
        with self._lock:
            self.batches += 1
            self.elapsed.setdefault(model, []).append(ex.elapsed)
            for s, c, p in zip(sids, ex.certs, ex.preds):
                self.seen[s, model] = (float(c), int(p))
        return ex


def _cascade_violations(done, seen) -> list:
    """Requests that break cascade semantics: resolved at stage i exactly
    when the certainty the kernel gave it at stage i is at least the
    gear's threshold there (and below it at every earlier stage), the last
    stage always answering; the request carries that certainty and
    prediction."""
    bad = []
    for r in done:
        casc = r.gear.cascade
        ok = 0 <= r.resolver < len(casc.models)
        for i in range(r.resolver + 1 if ok else 0):
            c, p = seen.get((r.rid, casc.models[i]), (None, None))
            if c is None:
                ok = False
            elif i < r.resolver:
                ok = ok and c < casc.thresholds[i]
            else:
                ok = ok and (i == len(casc.thresholds)
                             or c >= casc.thresholds[i])
                ok = ok and r.cert == c and r.pred == p
        if not ok:
            bad.append(r.rid)
    return bad


def _real_run(S, plan, backend, trace, qps: float, phase: str,
              profile: bool = False, selector=None):
    """One threaded wall-clock run through ``serve.serve_real`` over a
    recording backend, under the plan's policy or a baseline's
    ``selector``; with ``profile``, under torch.profiler (device busy and
    idle share). Launch counters are zeroed just before and read just
    after. Returns (summary, completed requests, recording backend)."""
    from torch.profiler import ProfilerActivity

    from repro_torch.core.scheduling import DecisionTrace
    rec = _Recording(backend)
    tr = DecisionTrace()
    window = torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
        if profile else contextlib.nullcontext()
    with window as prof:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        server, done, labels, offered = S.serve_real(plan, rec, trace,
                                                     decision_trace=tr,
                                                     selector=selector)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
    out = {"phase": phase, "qps_max": qps, "trace_seconds": TINY_TRACE_S,
           "devices": TINY_DEVICES, "offered": offered, "done": len(done),
           "queued_at_end": sum(len(q) for q in server.queues),
           "gear_switches": len(server.gear_switches),
           "executed_batches": rec.batches, "fires": len(tr.fires),
           "launches": launches, "wall_s": wall,
           "batch_ms_median": {m: statistics.median(v) * 1e3
                               for m, v in sorted(rec.elapsed.items())},
           "batches_by_model": {m: len(v)
                                for m, v in sorted(rec.elapsed.items())},
           "plan_accuracy_served_gears": float(np.mean(
               [r.gear.expected_accuracy for r in done])) if done else None,
           **(S.summarize(done, labels) if done else {})}
    if profile:
        from torch.autograd import DeviceType
        kernels = []
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                t_us = getattr(e, "self_device_time_total", None)
                kernels.append((e.self_cuda_time_total if t_us is None
                                else t_us, e.count, e.key))
        kernels.sort(reverse=True)
        busy_s = sum(k[0] for k in kernels) / 1e6
        out.update(device_busy_s=busy_s,
                   kernels=sum(k[1] for k in kernels),
                   idle_share=1.0 - busy_s / wall,
                   top=[{"ms": t / 1e3, "launches": c, "kernel": name[:90]}
                        for t, c, name in kernels[:8]])
    return out, done, rec


def _des_run(S, plan, profiles, trace, qps: float) -> dict:
    """The same plan and trace on the discrete-event simulator."""
    res = S.serve_des(plan, profiles, trace)
    out = {"phase": "serve_tiny_des", "qps_max": qps, "done": res.completed,
           "offered": res.offered, "p95_ms": res.p95 * 1e3,
           "accuracy": res.accuracy, "utilization": res.utilization,
           "gear_switches": len(res.gear_switches)}
    emit(out)
    return out


def _tiny_graphs_vs_eager(backend, TY) -> dict:
    """Every bucket graph of every classifier engine replayed against a
    direct eager call of ``apply_tiny`` on the same padded batch, bit for
    bit, twice per bucket: a full batch and the smallest batch that the
    engine pads to that bucket. The graphs were captured by the engines'
    warm-up during profiling."""
    rng = np.random.default_rng(6)
    compared, graphs, capture_s = {}, {}, {}
    for cfg in TY.TINY_FAMILY:
        eng = backend.engines[cfg.name]
        before = eng.graphs.replays
        for lo, b in zip((0,) + eng.buckets, eng.buckets):
            for n in (b, lo + 1):
                tok = np.zeros((b, cfg.seq_len), np.int32)
                tok[:n] = rng.integers(0, cfg.vocab, (n, cfg.seq_len))
                with torch.no_grad():
                    want = TY.apply_tiny(cfg, eng.params, torch.from_numpy(
                        tok).to(eng.device))[:n]
                check(torch.equal(eng.infer(tok[:n]), want),
                      f"{cfg.name} bucket {b}, {n} rows: graph scores equal "
                      f"the eager call's")
        compared[cfg.name] = eng.graphs.replays - before
        graphs[cfg.name] = eng.graphs.captured
        capture_s[cfg.name] = eng.graphs.capture_seconds
    row = {"phase": "graphs_vs_eager", "path": "serve_tiny",
           "replays_compared": compared, "graphs": graphs,
           "capture_seconds": capture_s}
    emit(row)
    for cfg in TY.TINY_FAMILY:
        buckets = backend.engines[cfg.name].buckets
        check(compared[cfg.name] == 2 * len(buckets)
              and graphs[cfg.name] == len(buckets),
              f"{cfg.name}: one graph per bucket, each replayed")
    return row


def phase_serve_tiny(dev) -> dict:
    """The paper's Fig. 3 lifecycle on the card through
    ``repro_torch.launch.serve``'s own functions. Returns the launch
    counts of the checked 60-qps run."""
    from repro_torch.core.plan_state import HardwareSpec
    from repro_torch.core.planner import optimize_gear_plan
    from repro_torch.launch import serve as S
    from repro_torch.serving import tinymodels as TY

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained = TY.train_tiny_family(device=dev)
    torch.cuda.synchronize()
    params_by, scores_by, _, lab_va = trained
    emit({"phase": "serve_tiny_train",
          "seconds": time.perf_counter() - t0,
          "steps": {c.name: int(TY._FAMILY_STEPS[i])
                    for i, c in enumerate(TY.TINY_FAMILY)},
          "val_accuracy": {n: float((s.argmax(-1) == lab_va).mean())
                           for n, s in scores_by.items()}})
    check(all(np.isfinite(s).all() for s in scores_by.values()),
          "validation scores finite")

    t0 = time.perf_counter()
    backend = TY.make_engine_backend(*trained)
    profiles = backend.profiles
    emit({"phase": "serve_tiny_profile",
          "seconds": time.perf_counter() - t0,
          "runtime_ms": {n: dict(zip((int(b) for b in p.batch_sizes),
                                     (float(r) * 1e3
                                      for r in p.batch_runtimes)))
                         for n, p in profiles.items()},
          "mem_bytes": {n: p.mem_bytes for n, p in profiles.items()},
          "accuracy": {n: p.accuracy for n, p in profiles.items()}})
    check(all(np.all(p.batch_runtimes > 0) for p in profiles.values()),
          "profiled runtimes positive")
    graphs = _tiny_graphs_vs_eager(backend, TY)

    mem_name, mem = S.device_memory(dev)
    hw = HardwareSpec(num_devices=TINY_DEVICES,
                      mem_per_device=mem / TINY_DEVICES)
    slo = S.parse_slo(TINY_SLO)

    def plan_for(qps):
        report = optimize_gear_plan(profiles, hw, slo, qps_max=qps,
                                    n_ranges=8)
        emit({"phase": "serve_tiny_plan", "qps_max": qps,
              "seconds": report.wall_seconds, "memory": mem_name,
              "mem_per_device": hw.mem_per_device,
              "ranges": [{"qps_to": report.plan.range_width * (r + 1),
                          "cascade": list(g.cascade.models),
                          "thresholds": list(g.cascade.thresholds),
                          "min_queue_lens": g.min_queue_lens,
                          "expected_accuracy": g.expected_accuracy,
                          "expected_p95_ms": g.expected_p95 * 1e3}
                         for r, g in enumerate(report.plan.gears)]})
        return report.plan

    plan = plan_for(TINY_QPS)
    trace = S.make_trace("azure", TINY_TRACE_S, TINY_QPS)
    real, done, rec = _real_run(S, plan, backend, trace, TINY_QPS,
                                "serve_tiny_real")
    bad = _cascade_violations(done, rec.seen)
    rids = [r.rid for r in done]
    real["cascade_violations"] = len(bad)
    emit(real)
    n_top2gap = real["launches"]["top2gap"]
    check(len(set(rids)) == len(rids)
          and all(0 <= r < real["offered"] for r in rids)
          and real["done"] + real["queued_at_end"] == real["offered"],
          "every arrival is accounted for (done or still queued)")
    check(real["done"] >= 0.95 * real["offered"],
          f"at least 95 % done ({real['done']}/{real['offered']})")
    check(not bad, f"cascade semantics hold (violations: {bad[:10]})")
    check(n_top2gap == real["executed_batches"] == real["fires"] > 0,
          f"top2gap launches {n_top2gap} == executed batches "
          f"{real['executed_batches']}")
    check(all(v == 0 for k, v in real["launches"].items()
              if k != "top2gap"), "no other kernel on the classifier path")
    check(all(len(e.graphs) == e.graphs.captured == len(e.buckets)
              for e in backend.engines.values()),
          "the served batches used the warm-up's bucket graphs only")
    des = _des_run(S, plan, profiles, trace, TINY_QPS)

    profiled = _real_run(S, plan, backend, trace, TINY_QPS,
                         "serve_tiny_profiled", profile=True)[0]
    emit(profiled)

    plan_hi = plan_for(TINY_QPS_STRESS)
    trace_hi = S.make_trace("azure", TINY_TRACE_S, TINY_QPS_STRESS)
    real_hi = _real_run(S, plan_hi, backend, trace_hi, TINY_QPS_STRESS,
                        "serve_tiny_real")[0]
    emit(real_hi)
    des_hi = _des_run(S, plan_hi, profiles, trace_hi, TINY_QPS_STRESS)
    emit({"phase": "serve_tiny_fidelity",
          "by_qps": {str(q): {"real_p95_ms": r.get("p95_ms"),
                              "des_p95_ms": d["p95_ms"],
                              "real_over_des": r["p95_ms"] / d["p95_ms"]
                              if r.get("p95_ms") and d["p95_ms"] else None,
                              "real_done": r["done"], "des_done": d["done"],
                              "offered": r["offered"],
                              "batch_ms_median": r["batch_ms_median"]}
                     for q, r, d in ((TINY_QPS, real, des),
                                     (TINY_QPS_STRESS, real_hi, des_hi))},
          "device_idle_share_60qps": profiled.get("idle_share"),
          "graphs": graphs["graphs"],
          "capture_seconds": graphs["capture_seconds"]})
    return real["launches"], {
        "backend": backend, "profiles": profiles, "hw": hw,
        "cascadeserve": {TINY_QPS: (real, des),
                         TINY_QPS_STRESS: (real_hi, des_hi)}}


# ---------------------------------------------------------------------------
# phase 24: the paper's baselines (Fig. 7 on the DES, real runs on the card)
# ---------------------------------------------------------------------------

def _min_devices(check) -> "int | None":
    """The fewest devices in [1, GRID_MAX_DEV] that pass ``check``, by
    binary search (monotone in devices), as ``benchmarks/bench_cost_grid
    .py`` finds them."""
    lo, hi, best = 1, GRID_MAX_DEV, None
    while lo <= hi:
        mid = (lo + hi) // 2
        if check(mid):
            best, hi = mid, mid - 1
        else:
            lo = mid + 1
    return best


def _cost_grid(profiles, mem_per_device: float) -> dict:
    """The paper's Fig. 7 on the discrete-event simulator over the profiles
    measured on the card: at each (accuracy, p95) target, the fewest
    logical devices with which CascadeServe's plan, any point of DynBa's
    grid and any point of MS+'s grid serve a diurnal trace with 98 % of
    the arrivals done; CascadeServe's saving is the cheaper baseline's
    count over its own. Each (system, grid point, devices, p95 target) run
    is made once and read at both accuracy targets. Cocktail+ (ensembles,
    simulator only) at the looser p95 on the most devices: its
    time-averaged active devices."""
    from repro_torch.core.gears import SLO
    from repro_torch.core.plan_state import (HardwareSpec,
                                             InfeasiblePlanError)
    from repro_torch.core.planner import optimize_gear_plan
    from repro_torch.core.simulator import ServingSimulator
    from repro_torch.core.traces import diurnal_like_trace
    from repro_torch.serving.baselines import (CocktailPlusPolicy,
                                               DynBaPolicy, MSPlusPolicy)

    t0 = time.perf_counter()
    trace = diurnal_like_trace(seconds=GRID_TRACE_S, peak_qps=GRID_PEAK,
                               seed=1)
    accs = sorted(p.accuracy for p in profiles.values())
    acc_targets = [accs[-2] - GRID_ACC_MARGIN, accs[-1] - GRID_ACC_MARGIN]
    grids = {"cascadeserve": [None], "dynba": DynBaPolicy.grid(profiles),
             "msplus": MSPlusPolicy.grid(profiles)}
    runs = {}

    def hw(n):
        return HardwareSpec(num_devices=n, mem_per_device=mem_per_device)

    def run(system, i, n, p95):
        key = (system, i, n, p95)
        if key not in runs:
            slo = SLO(kind="latency", latency_p95=p95)
            if system == "cascadeserve":
                try:
                    plan = optimize_gear_plan(
                        profiles, hw(n), slo, qps_max=GRID_PEAK,
                        n_ranges=GRID_RANGES).plan
                except InfeasiblePlanError:
                    runs[key] = None
                else:
                    runs[key] = ServingSimulator(
                        profiles, plan.replicas, n).run_trace(plan, trace)
            else:
                gears, sel, reps, nd = grids[system][i].build(
                    profiles, hw(n), slo, GRID_PEAK)
                runs[key] = ServingSimulator(profiles, reps, nd).run_policy(
                    gears, sel, trace)
        return runs[key]

    def meets(r, acc, p95):
        return (r is not None and r.completed >= 0.98 * r.offered
                and r.p95 <= p95 and r.accuracy >= acc)

    cells = []
    for acc in acc_targets:
        for p95 in GRID_P95:
            n = {s: _min_devices(lambda k, s=s, g=g: any(
                meets(run(s, i, k, p95), acc, p95) for i in range(len(g))))
                for s, g in grids.items()}
            base = [n[s] for s in ("dynba", "msplus") if n[s]]
            cells.append({"accuracy": acc, "p95_ms": p95 * 1e3,
                          "devices": n,
                          "saving": min(base) / n["cascadeserve"]
                          if base and n["cascadeserve"] else None})
    slo = SLO(kind="latency", latency_p95=GRID_P95[-1])
    pol = CocktailPlusPolicy(forecast=trace)
    gears, sel, reps, nd = pol.build(profiles, hw(GRID_MAX_DEV), slo,
                                     GRID_PEAK)
    r = ServingSimulator(profiles, reps, nd).run_policy(gears, sel, trace)
    return {"phase": "serve_baselines_grid", "peak_qps": GRID_PEAK,
            "trace_seconds": GRID_TRACE_S, "arrivals": r.offered,
            "n_ranges": GRID_RANGES, "acc_targets": acc_targets,
            "p95_targets_ms": [x * 1e3 for x in GRID_P95],
            "model_accuracy": {m: p.accuracy for m, p in profiles.items()},
            "cells": cells,
            "cocktail_plus": {
                "p95_target_ms": GRID_P95[-1] * 1e3,
                "devices": GRID_MAX_DEV, "ensemble": list(
                    gears[0].cascade.models),
                "active_device_cost": CocktailPlusPolicy.active_device_cost(
                    r, gears),
                "done": r.completed, "offered": r.offered,
                "p95_ms": r.p95 * 1e3, "accuracy": r.accuracy},
            "des_runs": len(runs) + 1,
            "seconds": time.perf_counter() - t0}


def _baseline_real(S, name: str, policy, profiles, backend, hw,
                   qps: float) -> dict:
    """One baseline served on the card: ``build_plan`` gives the plan and
    the policy's selector, the threaded ``CascadeServer`` serves an
    azure-like trace with them (``serve.serve_real``), and the same
    policy and trace run on the discrete-event simulator."""
    from repro_torch.core.simulator import ServingSimulator
    slo = S.parse_slo(TINY_SLO)
    plan, selector = policy.build_plan(profiles, hw, slo, qps)
    trace = S.make_trace("azure", TINY_TRACE_S, qps)
    real, done, rec = _real_run(S, plan, backend, trace, qps,
                                "serve_baselines_real", selector=selector)
    gears, sel, reps, nd = policy.build(profiles, hw, slo, qps)
    des = ServingSimulator(profiles, reps, nd).run_policy(gears, sel, trace)
    real.update(policy=name, gears=[list(g.cascade.models) for g in gears],
                cascade_violations=len(_cascade_violations(done, rec.seen)),
                des_done=des.completed, des_offered=des.offered,
                des_p95_ms=des.p95 * 1e3, des_accuracy=des.accuracy,
                des_gear_switches=len(des.gear_switches))
    emit(real)
    return real


def phase_serve_baselines(tiny: dict) -> dict:
    """The paper's baselines on the card, over the tiny family trained and
    profiled by ``serve_tiny``: the DES cost grid, then DynBa (the most
    accurate model) and MS+ through ``build_plan`` on the threaded
    ``CascadeServer`` at 60 and 2,000 qps beside CascadeServe's runs.
    Returns the launch counts summed over the real runs."""
    from repro_torch.launch import serve as S
    from repro_torch.serving.baselines import (CocktailPlusPolicy,
                                               DynBaPolicy, MSPlusPolicy)
    profiles, backend, hw = tiny["profiles"], tiny["backend"], tiny["hw"]
    grid = _cost_grid(profiles, hw.mem_per_device)
    emit(grid)
    try:
        CocktailPlusPolicy().build_plan(profiles, hw,
                                        S.parse_slo(TINY_SLO), TINY_QPS)
    except NotImplementedError:
        pass
    else:
        check(False, "Cocktail+ build_plan refuses its ensemble gears")

    best = max(profiles, key=lambda m: profiles[m].accuracy)
    launches = {k: 0 for k in K.launch_counts()}
    summary = {}
    for qps in (TINY_QPS, TINY_QPS_STRESS):
        real, des = tiny["cascadeserve"][qps]
        row = {"cascadeserve": {
            "done": real["done"], "offered": real["offered"],
            "p50_ms": real.get("p50_ms"), "p95_ms": real.get("p95_ms"),
            "accuracy": real.get("accuracy"),
            "gear_switches": real["gear_switches"],
            "top2gap_launches": real["launches"]["top2gap"],
            "des_p95_ms": des["p95_ms"]}}
        for name, pol in (("dynba", DynBaPolicy(best)),
                          ("msplus", MSPlusPolicy())):
            r = _baseline_real(S, name, pol, profiles, backend, hw, qps)
            for k, v in r["launches"].items():
                launches[k] += v
            n_top2gap = r["launches"]["top2gap"]
            check(n_top2gap == r["executed_batches"] == r["fires"] > 0,
                  f"{name} at {qps} qps: top2gap launches {n_top2gap} == "
                  f"executed batches {r['executed_batches']}")
            check(r["cascade_violations"] == 0,
                  f"{name} at {qps} qps: every request served within its "
                  f"gear's cascade")
            if qps == TINY_QPS:
                check(r["done"] >= 0.95 * r["offered"],
                      f"{name}: at least 95 % done at {qps} qps "
                      f"({r['done']}/{r['offered']})")
            row[name] = {k: r.get(k) for k in (
                "done", "offered", "p50_ms", "p95_ms", "accuracy",
                "gear_switches", "des_p95_ms", "des_accuracy")}
            row[name]["top2gap_launches"] = n_top2gap
        summary[str(qps)] = row
    emit({"phase": "serve_baselines", "by_qps": summary,
          "cost_grid": [{"accuracy": c["accuracy"], "p95_ms": c["p95_ms"],
                         **c["devices"], "saving": c["saving"]}
                        for c in grid["cells"]],
          "cocktail_active_device_cost":
              grid["cocktail_plus"]["active_device_cost"]})
    return launches


# ---------------------------------------------------------------------------
# phase 25: two tenants on one shared fleet (MultiTenantServer)
# ---------------------------------------------------------------------------

def phase_serve_tenants(tiny: dict) -> dict:
    """The reference CLI's two-tenant example planned jointly with
    ``plan_multi_tenant`` over the card's tiny-family profiles, then both
    tenants' superposed azure-like traces served by the threaded
    ``MultiTenantServer`` over the card's ``EngineBackend``, behind an
    ``AdmissionController`` and with ``Telemetry`` on; the same plan and
    traces on ``ServingSimulator.run_multi_tenant``. Returns the launch
    counts of the served run."""
    import tempfile

    from repro_torch.core.admission import (AdmissionConfig,
                                            AdmissionController)
    from repro_torch.core.simulator import ServingSimulator
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.core.tenancy import plan_multi_tenant
    from repro_torch.launch import serve as S
    from repro_torch.serving.runtime import MultiTenantServer, Request
    from repro_torch.serving.tinymodels import synthetic_classification_data

    profiles, backend, hw = tiny["profiles"], tiny["backend"], tiny["hw"]
    specs = S.parse_tenants(TENANTS)
    report = plan_multi_tenant(profiles, hw, specs)
    mt = report.plan
    traces = {s.name: S.make_trace("azure", TINY_TRACE_S, s.qps_max)
              for s in specs}
    counts = {n: int(traces[n].sum()) + 8 for n in mt.names}
    toks, labels, _ = synthetic_classification_data(sum(counts.values()),
                                                    seed=7)
    reqs, base = {}, 0
    for n in mt.names:             # request ids unique across tenants
        reqs[n] = [Request(rid=base + k, tokens=toks[base + k], tenant=n)
                   for k in range(counts[n])]
        base += counts[n]

    telem = Telemetry()
    rec = _Recording(backend)
    server = MultiTenantServer(
        mt, backend=rec, telemetry=telem,
        admission=AdmissionController(
            mt, AdmissionConfig(utilization_cap=0.75),
            registry=telem.registry))
    S.prepare_engines(backend)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    done = server.run_trace(reqs, traces)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()

    sim = ServingSimulator(profiles, mt.replicas, hw.num_devices)
    des = sim.run_multi_tenant(mt, traces, admission=AdmissionController(
        mt, AdmissionConfig(utilization_cap=0.75)))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tenants.jsonl")
        S.dump_metrics(telem, path)
        files = {suffix: os.path.getsize(path + suffix)
                 for suffix in ("", ".prom", ".attr.json")}
    cons = telem.conservation()
    tenants = {}
    for n in mt.names:
        lat = np.array([r.latency for r in done[n]])
        d = des[n]
        tenants[n] = {
            "offered": server.offered_counts[n], "done": len(done[n]),
            "shed": server.shed_counts[n],
            "p50_ms": float(np.quantile(lat, .5) * 1e3) if len(lat)
            else None,
            "p95_ms": float(np.quantile(lat, .95) * 1e3) if len(lat)
            else None,
            "accuracy": float(np.mean([r.pred == labels[r.rid]
                                       for r in done[n]]))
            if done[n] else None,
            "gear_switches": len(server.gear_switches[n]),
            "cascade_violations": len(_cascade_violations(done[n],
                                                          rec.seen)),
            "top_gear": list(mt.plans[n].gears[-1].cascade.models),
            "des_done": d.result.completed, "des_offered": d.offered,
            "des_shed": d.shed, "des_p95_ms": d.p95 * 1e3,
            "des_accuracy": d.accuracy,
            "des_gear_switches": len(d.result.gear_switches)}
    emit({"phase": "serve_tenants", "tenants_spec": TENANTS,
          "devices": hw.num_devices, "trace_seconds": TINY_TRACE_S,
          "plan_seconds": report.wall_seconds, "wall_s": wall,
          "executed_batches": rec.batches,
          "queued_at_end": sum(len(q) for q in server.queues),
          "launches": launches, "conservation": cons,
          "metrics_files_bytes": files, "tenants": tenants})
    for n, r in tenants.items():
        check(r["offered"] == r["done"] + r["shed"],
              f"{n}: offered {r['offered']} == done {r['done']} + shed "
              f"{r['shed']}")
        check(r["cascade_violations"] == 0,
              f"{n}: every request served within its gear's cascade")
    check(cons["open"] == 0 and cons["opened"] == cons["completed"]
          + cons["shed"] + cons["revoked"],
          f"telemetry conservation holds ({cons})")
    check(all(v > 0 for v in files.values()),
          f"dump_metrics wrote its three files ({files})")
    check(launches["top2gap"] == rec.batches > 0,
          f"top2gap launches {launches['top2gap']} == executed batches "
          f"{rec.batches}")
    return launches


# ---------------------------------------------------------------------------
# phases 26-28: the distributed layer over NCCL at world size 1
# ---------------------------------------------------------------------------

DIST_PROMPT, DIST_STEPS = 64, 16     # dist_serve: B 8 prompts, greedy steps
DIST_MOE_SHAPE = (4, 128)            # dist_moe: B x S of one forward
DIST_TRAIN_STEPS, DIST_TRAIN_WARM = 7, 2


def _dist_start(dev) -> None:
    """One process group of one rank over NCCL on the card (a free local
    port), as the launchers' processes join theirs."""
    import socket
    import torch.distributed as dist
    if dist.is_initialized():
        return
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1, device_id=dev)


def _serve_greedy(params, cfg, prompts, ctx):
    """Prefill and DIST_STEPS greedy decode steps through ``launch/steps``
    under ``ctx`` (None: mesh-less). Returns (tokens (steps + 1, B), gaps
    (steps + 1, B), wall ms per decode step)."""
    from repro_torch.distributed.context import use_context
    from repro_torch.launch import steps
    prefill = steps.make_serve_prefill(cfg, DIST_PROMPT + DIST_STEPS)
    decode = steps.make_serve_decode(cfg)
    with use_context(ctx):
        pred, cert, cache = prefill(params, {"tokens": prompts})
        toks, gaps, ms = [pred], [cert], []
        for t in range(DIST_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred, cert, cache = decode(params, cache, pred[:, None],
                                       DIST_PROMPT + t)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            toks.append(pred)
            gaps.append(cert)
    return torch.stack(toks), torch.stack(gaps), ms


def phase_dist_serve(dev) -> dict:
    """qwen2-0.5b at full width and depth (random bf16 weights, seed 0)
    served through ``launch/steps`` on a (1, 1) ('data', 'model') mesh over
    NCCL with ``flash_decode``: params as DTensors placed by the serve
    rules, the model on their blocks (``local_params``: at world 1 the
    whole tensors, and no collective is called), the cache in the
    flash-decode layout, each decode layer through
    ``decode_attention_sharded`` (``_flash_decode_shard`` +
    ``_combine_partials``). B 8 prompts of DIST_PROMPT tokens, then
    DIST_STEPS greedy steps: tokens and gaps bit-equal to the mesh-less
    calls of the same steps on plain params (if not, the op that differs
    is named: the embedding, the prefill's logits or the first decode
    step's). Launch counters zeroed just before the mesh run and read just
    after: flash = layers, decode = layers x steps, top2gap = steps + 1."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import context_for_mesh, make_mesh
    _dist_start(dev)
    cfg = get_config(ARCH)
    params = model_lib.init_params(cfg, seed=0, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (N_SLOTS, DIST_PROMPT),
                            generator=_gen(90), device=dev)
    ctx = context_for_mesh(make_mesh((1, 1), ("data", "model"), "cuda"),
                           flash_decode=True)
    dparams = sh.param_shardings(params, ctx, mode="serve")
    plain = _serve_greedy(params, cfg, prompts, None)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    meshed = _serve_greedy(dparams, cfg, prompts, ctx)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    same = (torch.equal(plain[0], meshed[0]), torch.equal(plain[1],
                                                           meshed[1]))
    differs = None
    if not all(same):
        from repro_torch.distributed.context import use_context
        with use_context(ctx), torch.no_grad():
            emb = common.embed_tokens(sh.local_params(dparams)["embed"],
                                      prompts, cfg.vocab_size)
            lp, _ = model_lib.prefill(dparams, cfg, {"tokens": prompts})
        with torch.no_grad():
            lq, _ = model_lib.prefill(params, cfg, {"tokens": prompts})
        differs = ("the embedding" if not torch.equal(
            emb, params["embed"]["embedding"][prompts]) else
            "the prefill's logits" if not torch.equal(lp, lq)
            else "the first decode step's logits (flash-decode attention)")
    layers = cfg.num_layers
    emit({"phase": "dist_serve", "arch": cfg.name, "mesh": "(1, 1) nccl",
          "batch": N_SLOTS, "prompt": DIST_PROMPT, "steps": DIST_STEPS,
          "tokens_equal": same[0], "gaps_equal": same[1],
          "differs_at": differs,
          "decode_step_ms_median": statistics.median(meshed[2]),
          "meshless_decode_step_ms_median": statistics.median(plain[2]),
          "launches": launches})
    check(all(same), f"dist_serve tokens and gaps bit-equal to the "
                     f"mesh-less calls (first difference: {differs})")
    for name, want in (("flash_attention", layers),
                       ("decode_attention", layers * DIST_STEPS),
                       ("top2gap", DIST_STEPS + 1)):
        check(launches[name] == want,
              f"dist_serve {name} launches {launches[name]} == {want}")
    del params, dparams
    return launches


def phase_dist_moe(dev) -> dict:
    """qwen2-moe-a2.7b at full depth (24 layers, 60 experts padded to 64,
    bf16, seed 0), one ``forward`` of B x S random tokens with ``use_ep``
    on a (1, 1) mesh over NCCL, params as DTensors placed by the serve
    rules: every MoE layer through ``apply_moe_ep`` (at world 1 its
    capacity and dispatch are the local path's, and its collectives the
    identity: no NCCL call), logits bit-equal to the mesh-less
    ``forward`` (``apply_moe_local``). Launch counters around the mesh
    run: flash = layers."""
    from repro_torch.distributed.context import use_context
    from repro_torch.launch.mesh import context_for_mesh, make_mesh
    _dist_start(dev)
    cfg = get_config(MOE_ARCH)
    params = model_lib.init_params(cfg, seed=0, device=dev)
    b, s = DIST_MOE_SHAPE
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=_gen(91), device=dev)}
    ctx = context_for_mesh(make_mesh((1, 1), ("data", "model"), "cuda"))
    from repro_torch.distributed import sharding as sh
    dparams = sh.param_shardings(params, ctx, mode="serve")
    calls = []
    ep = moe_lib.apply_moe_ep

    def counted(*a, **kw):
        calls.append(1)
        return ep(*a, **kw)
    with torch.no_grad():
        local, _ = model_lib.forward(params, cfg, batch)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        moe_lib.apply_moe_ep = counted
        try:
            with use_context(ctx):
                t0 = time.perf_counter()
                meshed, _ = model_lib.forward(dparams, cfg, batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
        finally:
            moe_lib.apply_moe_ep = ep
    launches = K.launch_counts()
    same = torch.equal(local, meshed)
    emit({"phase": "dist_moe", "arch": cfg.name, "mesh": "(1, 1) nccl",
          "batch": b, "positions": s, "ep_layers": len(calls),
          "logits_equal": same,
          "max_abs_diff": float((local - meshed).abs().max()),
          "forward_ms": ms, "launches": launches})
    check(len(calls) == cfg.num_layers, f"dist_moe: every MoE layer "
                                        f"expert-parallel ({len(calls)})")
    check(same, "dist_moe logits bit-equal to apply_moe_local's forward")
    check(launches["flash_attention"] == cfg.num_layers,
          f"dist_moe flash launches {launches['flash_attention']}")
    del params, dparams, local, meshed
    return launches


def phase_dist_train(dev) -> dict:
    """qwen2-0.5b at full width through ``launch/train.py --mesh 1x1x1
    --compress-pod-grads`` (B 8 x 512, NCCL at world 1; params and ZeRO-1
    moments as DTensors): DIST_TRAIN_WARM warm and the rest timed steps
    (the launcher's device ms per step), the loss falling, the peak memory,
    both beside this run's ``train_qwen2`` row. Launch counters around the
    launcher's run: each kernel as ``_train_launches``. At world 1 no NCCL
    collective is called (every axis has one process). The first step's
    own exchange (``compressed_pod_allreduce``, read as it runs) is a
    quantisation check there: each leaf's f32 mean within half a
    quantisation step (scale / 2) of the gradient it was given, and its
    cast to the gradient's dtype within that plus half the dtype's
    rounding."""
    import contextlib
    import io
    from repro_torch.launch import train as train_launch
    from repro_torch.training import train_step as ts
    _dist_start(dev)
    cfg = get_config(ARCH)
    b, s = TRAIN_SHAPES[ARCH]
    worst = worst_cast = 0.0
    exchange = ts.compressed_pod_allreduce
    seen = []

    def checked(grads, pod_axis="pod", axes=None):
        nonlocal worst, worst_cast
        sent_all = exchange(grads, pod_axis, axes)
        if seen:
            return sent_all
        seen.append(len(grads))
        with torch.no_grad():
            for g, sent, a in zip(grads, sent_all, axes or [()] * len(grads)):
                q, scale = ts.quantize_int8(g, a)
                mean = ts.dequantize_mean(q[None], scale.reshape(1))
                # half a step, and the two f32 roundings of g / scale and
                # q x scale (2^-24 of |g| each)
                worst = max(worst, float(((mean - g.float()).abs()
                                          / (scale / 2 + 2.0 ** -23
                                             * g.float().abs())).max()))
                half_ulp = (sent.float().abs() * 2.0 ** -8 if g.dtype
                            == torch.bfloat16 else 0.0)
                worst_cast = max(worst_cast, float(
                    ((sent.float() - g.float()).abs()
                     / (scale / 2 + half_ulp + 2.0 ** -23 * g.float().abs()
                        + 1e-30)).max()))
        return sent_all

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    out = io.StringIO()
    ts.compressed_pod_allreduce = checked
    try:
        with contextlib.redirect_stdout(out):
            train_launch.main(["--arch", ARCH, "--steps",
                               str(DIST_TRAIN_STEPS), "--batch", str(b),
                               "--seq", str(s), "--log-every", "1",
                               "--mesh", "1x1x1", "--compress-pod-grads"])
    finally:
        ts.compressed_pod_allreduce = exchange
    torch.cuda.synchronize()
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    lines = [ln for ln in out.getvalue().splitlines() if "loss=" in ln]
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines]
    dev_ms = [float(ln.split("device ")[1].split("ms")[0]) for ln in lines]
    timed = dev_ms[DIST_TRAIN_WARM:]
    ref_row = TRAIN_ROWS.get("train_qwen2", {})
    expect = _train_launches(cfg, DIST_TRAIN_STEPS)
    emit({"phase": "dist_train", "arch": cfg.name,
          "mesh": "(1, 1, 1) pod x data x model, nccl",
          "compress_pod_grads": True, "batch": b, "positions": s,
          "losses": losses, "step_device_ms": dev_ms,
          "step_device_ms_median": statistics.median(timed),
          "max_memory_allocated_bytes": peak,
          "exchange_leaves_checked": seen[0] if seen else 0,
          "exchange_err_over_half_step": worst,
          "exchange_cast_err_over_limit": worst_cast,
          "train_qwen2_step_event_ms_median":
              ref_row.get("step_event_ms_median"),
          "train_qwen2_max_memory_allocated_bytes":
              ref_row.get("max_memory_allocated_bytes"),
          "launches": launches, "expected_launches": expect})
    check(len(losses) == DIST_TRAIN_STEPS, f"dist_train logged every step "
                                           f"({len(losses)})")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"dist_train loss falls ({losses[0]} -> {losses[-1]})")
    check(bool(seen), "dist_train's step ran the int8 exchange")
    check(worst <= 1.0, f"dist_train exchanged gradients within half a "
                        f"step ({worst})")
    check(worst_cast <= 1.0, f"dist_train exchanged gradients in their "
                             f"dtype within the limit ({worst_cast})")
    for name, want in expect.items():
        check(launches[name] == want,
              f"dist_train {name} launches {launches[name]} == {want}")
    return launches


# ---------------------------------------------------------------------------
# phase 29: the dry-run
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (("olmo-1b", "decode_32k", "single"),
                ("olmo-1b", "decode_32k", "multi"),
                ("falcon-mamba-7b", "long_500k", "single"),
                ("llama4-maverick-400b-a17b", "train_4k", "single"),
                ("internvl2-1b", "train_4k", "single"),
                ("falcon-mamba-7b", "prefill_32k", "single"),
                ("h2o-danube-1.8b", "train_4k", "single"))
DRYRUN_PEAK_LIMIT = 80e9      # bytes a card: the H100's 80 GB
# the row's fields that must not depend on the device the fakes stand for
DRYRUN_FIELDS = ("status", "chips", "hlo_flops", "hlo_bytes",
                 "collective_bytes", "collective_breakdown",
                 "collective_bytes_cross_node", "t_collective_by_domain",
                 "peak_memory_bytes", "memory_analysis", "kernel_calls",
                 "dominant", "roofline_fraction")


def _dryrun_child(device: str) -> dict:
    """The dry-run's rows of DRYRUN_CELLS with the fakes on ``device``,
    and the kernel launches counted while they were traced."""
    from repro_torch.launch.dryrun import run_cell
    K.reset_launch_counts()
    rows = [run_cell(arch, shape, mesh, device=device)
            for arch, shape, mesh in DRYRUN_CELLS]
    return {"rows": rows, "launches": K.launch_counts()}


def _dryrun_calls(arch: str, shape: str) -> dict:
    """The kernels a cell's step charges: a decode step one decode
    attention an attention layer, one conv and one SSM step an SSM layer
    and one top2gap; a train step (remat)
    the flash forward twice and its backward once an attention layer; a
    prefill one flash forward an attention layer, one scan an SSM layer
    and one top2gap."""
    cfg = get_config(arch)
    attn_layers = _attention_layers(cfg)
    ssm_layers = _ssm_layers(cfg)
    if shape == "train_4k":
        return {"flash_attention": 2 * attn_layers,
                "flash_attention_bwd": attn_layers}
    if shape == "prefill_32k":
        return {**({"flash_attention": attn_layers} if attn_layers else {}),
                **({"mamba_scan": ssm_layers} if ssm_layers else {}),
                "top2gap": 1}
    return {**({"decode_attention": attn_layers} if attn_layers else {}),
            **({"mamba_conv_step": ssm_layers, "mamba_ssm_step": ssm_layers}
               if ssm_layers else {}),
            "top2gap": 1}


def phase_dryrun() -> dict:
    """DRYRUN_CELLS traced twice, the fakes on the card and on the CPU,
    each in a child process of its own (``--dryrun-child DEVICE``), both
    at once; the rows must agree on DRYRUN_FIELDS, and neither child may
    launch a kernel. Returns the launches the card's child counted."""
    procs = {dev: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dryrun-child", dev],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for dev in ("cuda", "cpu")}
    rows = {}
    try:
        for dev, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            lines = out.strip().splitlines()
            check(proc.returncode == 0 and lines,
                  f"dryrun child ({dev}) exited {proc.returncode}: "
                  f"{err[-2000:]}")
            rows[dev] = json.loads(lines[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cells = []
    for (arch, shape, mesh), card, host in zip(
            DRYRUN_CELLS, rows["cuda"]["rows"], rows["cpu"]["rows"]):
        for row in (card, host):
            check(row["status"] == "ok", f"dryrun {arch} {shape} {mesh}: "
                  f"{row.get('error')} {row.get('traceback', '')[-1500:]}")
        differ = [f for f in DRYRUN_FIELDS if card[f] != host[f]]
        cells.append({"arch": arch, "shape": shape, "mesh": mesh,
                      "chips": card["chips"],
                      "flops_per_device": card["hlo_flops"],
                      "bytes_per_device": card["hlo_bytes"],
                      "collective_bytes_per_device":
                          card["collective_breakdown"],
                      "peak_memory_bytes": card["peak_memory_bytes"],
                      "collective_bytes_cross_node":
                          card["collective_bytes_cross_node"],
                      "t_collective": card["t_collective"],
                      "t_collective_by_domain":
                          card["t_collective_by_domain"],
                      "dominant": card["dominant"],
                      "roofline_fraction": card["roofline_fraction"],
                      "kernel_calls": card["kernel_calls"],
                      "trace_seconds_cuda": card["compile_seconds"],
                      "trace_seconds_cpu": host["compile_seconds"],
                      "fields_that_differ": differ})
    launches = {dev: rows[dev]["launches"] for dev in rows}
    emit({"phase": "dryrun", "fields_compared": list(DRYRUN_FIELDS),
          "launches": launches, "cells": cells})
    for dev, got in launches.items():
        check(not any(got.values()),
              f"dryrun ({dev}) launched no kernel: {got}")
    for cell in cells:
        what = f"dryrun {cell['arch']} {cell['shape']} {cell['mesh']}"
        check(not cell["fields_that_differ"], f"{what}: the cuda row equals "
              f"the cpu row ({cell['fields_that_differ']} differ)")
        want = _dryrun_calls(cell["arch"], cell["shape"])
        check(cell["kernel_calls"] == want,
              f"{what}: kernel calls {cell['kernel_calls']} == {want}")
        check(cell["peak_memory_bytes"] < DRYRUN_PEAK_LIMIT,
              f"{what}: peak {cell['peak_memory_bytes']} bytes a card "
              f"< {DRYRUN_PEAK_LIMIT:.0f}")
    return launches["cuda"]


# ---------------------------------------------------------------------------

def main() -> int:
    smi = phase_device()
    dev = resolve_device("cuda")   # strict fp32 matmuls (no TF32)
    phase_build()
    timed = phase_kernels(dev)
    paths, summaries = {}, {}
    for name, phase in (("serve", phase_serve),
                        ("serve_ssm", phase_serve_ssm),
                        ("serve_qwen3", phase_serve_qwen3),
                        ("serve_moe", phase_serve_moe)):
        summaries[name] = phase(dev)
        paths[name] = summaries[name]["launches"]
        gc.collect()             # this path's params and engines go first
        torch.cuda.empty_cache()
    paths["forward_olmo"] = phase_forward_olmo(dev)
    gc.collect()
    torch.cuda.empty_cache()
    paths["forward_jamba"] = phase_forward_jamba(dev)
    gc.collect()
    torch.cuda.empty_cache()
    for name, phase in (("forward_seamless", phase_forward_seamless),
                        ("forward_internvl", phase_forward_internvl),
                        ("forward_danube", phase_forward_danube),
                        ("train_qwen2", phase_train_qwen2),
                        ("train_olmo", phase_train_olmo),
                        ("train_danube", phase_train_danube),
                        ("train_internvl", phase_train_internvl),
                        ("train_seamless", phase_train_seamless),
                        ("train_falcon_mamba", phase_train_falcon_mamba),
                        ("train_moe", phase_train_moe),
                        ("train_jamba", phase_train_jamba)):
        paths[name] = phase(dev)
        gc.collect()
        torch.cuda.empty_cache()
    for arch in RESUMED:
        phase_train_resume(arch)
    # the launcher's run ends the process group, so dist_train goes last
    for name, phase in (("dist_serve", phase_dist_serve),
                        ("dist_moe", phase_dist_moe),
                        ("dist_train", phase_dist_train)):
        paths[name] = phase(dev)
        gc.collect()
        torch.cuda.empty_cache()
    phase_cost_model({s["trace"]["arch"]: s["trace"]
                      for s in summaries.values()}, summaries["serve_qwen3"],
                     {s["trace"]["arch"]: s["by_stage"][s["trace"]["stage"]]
                      ["param_bytes"] for s in summaries.values()})
    paths["serve_tiny"], tiny = phase_serve_tiny(dev)
    paths["serve_baselines"] = phase_serve_baselines(tiny)
    paths["serve_tenants"] = phase_serve_tenants(tiny)
    # the dry-run launches nothing (every wrapper is charged, not run):
    # its child counts that, and the phase requires 0
    paths["dryrun"] = phase_dryrun()
    sources = {
        "top2gap": ("src/repro_torch/kernels/csrc/top2gap.cu",
                    "src/repro/kernels/top2gap.py:79"),
        "decode_attention": ("src/repro_torch/kernels/csrc/"
                             "decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:81"),
        "flash_attention": ("src/repro_torch/kernels/csrc/"
                            "flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:93"),
        "mamba_scan": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                       "src/repro/kernels/mamba_scan.py:72"),
        "flash_attention_bwd": ("src/repro_torch/kernels/csrc/"
                                "flash_attention_bwd.cu", None),
        "mamba_scan_bwd": ("src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
                           None),
        "mamba_conv_step": ("src/repro_torch/kernels/csrc/mamba_step.cu",
                            None),
        "mamba_ssm_step": ("src/repro_torch/kernels/csrc/mamba_step.cu",
                           None),
    }
    notes = {"flash_attention_bwd": "no TPU kernel: stands in for XLA's "
                                    "derivative of the jnp sdpa / sdpa_gqa "
                                    "(src/repro/models/attention.py:76-89)",
             "mamba_scan_bwd": "no TPU kernel: stands in for XLA's "
                               "derivative of the jnp selective_scan "
                               "(src/repro/models/mamba.py:75)",
             "mamba_conv_step": "no TPU kernel: stands in for the jnp "
                                "decode step's conv (src/repro/models/"
                                "mamba.py mamba_decode)",
             "mamba_ssm_step": "no TPU kernel: stands in for the jnp "
                               "decode step's recurrence (src/repro/models/"
                               "mamba.py mamba_decode)"}
    rows = []
    for name, (src, replaces) in sources.items():
        t = timed[name]
        # launches: every main-path run together, and each on its own
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": sum(p[name] for p in paths.values()),
                     "launches_by_path": {k: p[name]
                                          for k, p in paths.items()},
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"],
                     **{key: t[key] for key in ("bound_bytes", "bound_flops",
                                                "err_over_tol",
                                                "max_rel_err",
                                                "f32_max_rel_err")
                        if key in t},
                     **({"note": notes[name]} if name in notes else {}),
                     **{at: {key: t[at][key] for key in (
                         "shape", "max_abs_err", "err_over_tol",
                         "traps_over_tol", "max_rel_err",
                         "f32_max_rel_err", "ms",
                         "plain_ms", "bound_ms", "bound_by", "library_ms")
                         if key in t[at]}
                        for at in t if at.startswith("at_")}})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if not __import__("torch").cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--train-resume-child"]:
        print(json.dumps(_train_resume_child(sys.argv[2])), flush=True)
        sys.exit(0)
    if sys.argv[1:2] == ["--dryrun-child"]:
        print(json.dumps(_dryrun_child(sys.argv[2])), flush=True)
        sys.exit(0)
    sys.exit(main())
