#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure ends the script with a
non-zero exit code and no ``ok`` line:

1. device  — asserts CUDA; prints the card's name and power limit as
             ``nvidia-smi --query-gpu=name,power.limit`` reports them.
2. build   — compiles every kernel (``src/repro_torch/kernels/csrc/*.cu``)
             with nvcc for sm_90a, one process per source, in parallel,
             and prints ptxas's registers, spills and shared memory for
             each kernel entry.
3. kernels — holds each kernel against its plain PyTorch version on the
             card at the serving paths' shapes (top2gap bit-exact with
             planted ties, also at the classifier's B 64, V 2; bf16
             attention within 2e-2 of the f32 plain
             version; the selective scan within 2e-4, f32 throughout) and
             times kernel, plain version and the PyTorch library call that
             computes the same function where one exists (a yardstick the
             port never calls), with CUDA events, against the least time
             the card needs for the same bytes and operations (every row
             prints both counts; for the scan the operation count is its
             exponentials). top2gap is timed at B 8 (V 151,936, 65,024
             and 4,096, the last nearly all fixed cost) and at B 1,
             V 151,936 (reference mode and the teacher-forced checks);
             flash at S 256 and at S 64, the most common prefill bucket;
             the scan at S 200 and S 64.
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
             the fused run's tokens. A torch.profiler window over fused
             decode steps ends the phase.
5. serve_ssm — the SSM path, after the qwen2 params are freed: a
             two-stage cascade of full-width falcon-mamba-7b (64 Mamba-1
             layers, d_inner 8192, d_state 16, vocab 65,024; random bf16
             weights from seeds 0 and 1) through the same engine and
             traffic. Every prefill is an exact-length batch-1 call whose
             scan runs in the mamba_scan kernel (64 launches per prefill),
             top2gap reduces every step at V 65,024, and no attention
             kernel runs; the launch counters are checked as above, served
             tokens against a teacher-forced ``forward``, and a profiler
             window ends the phase. Prefill time per prompt length and the
             peak device memory are printed.
6. serve_tiny — the paper's one-shot classifier lifecycle through
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
             The same plan and trace on the discrete-event simulator, a
             profiled repeat (device busy and idle share) and a real run at
             the reference's default 2000 qps (numbers only) follow.

The last lines are the kernel table (JSON), the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
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
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan  # noqa: E402
from repro_torch.kernels.top2gap import top2gap  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.serving.token_engine import (SlotEngine,  # noqa: E402
                                              TokenEngine, TokenRequest,
                                              greedy_generate)

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
# exponentials: the special-function units return 16 results per clock per
# SM on compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput), 132 SMs at the H100 SXM's 1,980 MHz boost clock
SFU_PER_S = 132 * 16 * 1.98e9
SCAN_TOL = 2e-4           # f32 scan kernel vs the f32 plain version
SSM_BF16_MARGIN = 0.5     # bf16 teacher-forced margin on the SSM path
F32_GAP_TOL = 1e-3        # f32 decode vs forward gaps (summation order)
ATTN_TOL = 2e-2           # bf16 kernel vs the f32 plain version
L2_BYTES = 50 * 2 ** 20   # inputs are cycled through more than this

ARCH = "qwen2-0.5b"
SSM_ARCH = "falcon-mamba-7b"
N_SLOTS, MAX_LEN, SPEC_K = 8, 512, 4
N_REQ, MAX_NEW, PROMPT_LO, PROMPT_HI = 16, 32, 16, 200
MIN_TOKENS, EARLY_MARGIN = 4, 0.5
# the one-shot classifier path: the verify recipe's healthy setting
TINY_DEVICES, TINY_TRACE_S, TINY_QPS, TINY_SLO = 2, 8, 60.0, "latency:0.3"
TINY_QPS_STRESS = 2000.0      # the reference's default --qps-max
TINY_BATCH = 64               # top2gap row timed at the classifier shape


def emit(obj) -> None:
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
    the falcon-mamba vocab (65,024), and a 4,096-wide row, whose time is
    almost all the kernel's fixed cost (launch, cluster barrier, one
    round trip to device memory)."""
    worst = 0.0
    timed = {}
    for b, v in ((1, 151936), (8, 151936), (8, 65024), (8, 4096)):
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
        worst = max(worst, float((gap - rgap).abs().max()))
        timed[b, v] = _time_top2gap(x)
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
    timed[TINY_BATCH, 2] = _time_top2gap(x)
    return dict(name="top2gap", max_abs_err=worst, **timed[8, 151936],
                at_v65024=timed[8, 65024], at_b1=timed[1, 151936],
                at_v4096=timed[8, 4096], at_b64_v2=timed[TINY_BATCH, 2])


def kernel_decode(dev) -> dict:
    b, h, kv, d, c = N_SLOTS, 14, 2, 64, MAX_LEN
    vl = torch.tensor([1, 2, 100, 256, 300, 511, 512, 512],
                      dtype=torch.int32, device=dev)
    g = _gen(7)

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
    check(err <= ATTN_TOL, f"decode_attention within {ATTN_TOL} ({err})")
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
    return dict(name="decode_attention", max_abs_err=err,
                shape=f"B={b} H={h} KV={kv} hd={d} C={c} bf16 "
                      f"valid_len={vl.tolist()}",
                ms=kms, plain_ms=pms, library_ms=lms,
                library="F.scaled_dot_product_attention(enable_gqa)",
                bound_ms=bms, bound_by=by, bound_bytes=nbytes,
                bound_flops=flops)


def kernel_flash(dev) -> dict:
    """Causal bf16 at B 8, H 14, KV 2, hd 64: the row's shape is S 256;
    S 64, the most common prefill bucket, is timed beside it."""
    b, h, kv, d = N_SLOTS, 14, 2, 64
    g = _gen(11)
    worst = 0.0
    timed = {}
    for s in (64, 256):
        def make(s=s):
            return (torch.randn(b, s, h, d, generator=g, device=dev)
                    .bfloat16(),
                    torch.randn(b, s, kv, d, generator=g, device=dev)
                    .bfloat16(),
                    torch.randn(b, s, kv, d, generator=g, device=dev)
                    .bfloat16())
        q, k, v = make()
        out = flash_attention(q, k, v)
        rout = ref.flash_attention_ref(q.float(), k.float(), v.float())
        # a ragged prompt right-padded into the bucket: its real rows are
        # bit-identical to an unpadded call
        n = s - 23
        part = flash_attention(q[:, :n].contiguous(), k[:, :n].contiguous(),
                               v[:, :n].contiguous())
        torch.cuda.synchronize()
        err = float((out.float() - rout).abs().max())
        check(err <= ATTN_TOL, f"flash_attention S={s} within {ATTN_TOL} "
                               f"({err})")
        check(torch.equal(part, out[:, :n]),
              f"flash_attention right padding invisible (S={s}, n={n})")
        worst = max(worst, err)
        nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kv * d)
        sets = [make() for _ in range(copies(nbytes))]
        kms = device_ms([lambda t=t: flash_attention(*t) for t in sets])
        pms = device_ms([lambda t=t: ref.flash_attention_ref(*t)
                         for t in sets])
        lms = device_ms([lambda t=t: F.scaled_dot_product_attention(
            t[0].transpose(1, 2), t[1].transpose(1, 2),
            t[2].transpose(1, 2), is_causal=True, enable_gqa=True)
            for t in sets])
        flops = 4 * d * b * h * s * (s + 1) // 2
        bms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
        timed[s] = dict(shape=f"B={b} S={s} H={h} KV={kv} hd={d} causal "
                              f"bf16", ms=kms, plain_ms=pms,
                        library_ms=lms,
                        library="F.scaled_dot_product_attention(causal, "
                                "enable_gqa)",
                        bound_ms=bms, bound_by=by, bound_bytes=nbytes,
                        bound_flops=flops)
    return dict(name="flash_attention", max_abs_err=worst, **timed[256],
                at_s64=timed[64])


def kernel_mamba(dev) -> dict:
    """The selective scan at the SSM prefill's shapes (falcon-mamba-7b:
    Di 8192, N 16, x bf16): B 1 at the longest prompt (the row's shape)
    and at S 64, the short end of the prefills, then B 2 at an odd length
    from a nonzero state; y and h_last against the plain scan."""
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
        ry, rh = ref.mamba_scan_ref(*ins)
        y, h = mamba_scan(*ins)
        torch.cuda.synchronize()
        err = max(float((y - ry).abs().max()), float((h - rh).abs().max()))
        check(err <= SCAN_TOL, f"mamba_scan B={b} S={s} y and h_last "
                               f"within {SCAN_TOL} ({err})")
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
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(6 * exps / FP32_FLOP_PER_S, exps / SFU_PER_S) * 1e3
        timed[s] = dict(shape=f"B={b} S={s} Di={di} N={n} x bf16, f32 "
                              f"state",
                        ms=kms, plain_ms=pms, library_ms=None,
                        library=None,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations",
                        bound_bytes=nbytes, bound_flops=exps,
                        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops)
    return dict(name="mamba_scan", max_abs_err=worst, **timed[PROMPT_HI],
                at_s64=timed[64])


def phase_kernels(dev) -> dict:
    out = {}
    for fn in (kernel_top2gap, kernel_decode, kernel_flash, kernel_mamba):
        row = fn(dev)
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
    prompt length."""
    decode = eng.decode_fused
    if model_lib.bucketed_prefill_supported(eng.cfg):
        prefill = eng.prefill_batch

        def prefill_t(prompts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = prefill(prompts)
            dt = (time.perf_counter() - t0) * 1e3
            bb = eng._batch_bucket(len(prompts))
            lb = eng._len_bucket(max(len(p) for p in prompts))
            log["prefill"].setdefault(f"{bb}x{lb}", []).append(dt)
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
        t0 = time.perf_counter()
        res = decode(k, mode=mode, beta=beta)
        log["step_ms"].append((time.perf_counter() - t0) * 1e3 / k)
        return res

    eng.decode_fused = decode_t


def serve_cascade(dev, arch: str, phase: str):
    """The main path for one architecture: a two-stage cascade of
    full-width ``arch`` models (random bf16 weights, seeds 0 and 1) served
    by the fused TokenEngine. A calibration pass of stage a alone sets the
    threshold so that requests both resolve at a and escalate to b; the
    launch counters are zeroed just before the measured run and read just
    after. Returns (summary, params, cfg, requests, calibration results,
    served results)."""
    cfg = get_config(arch)
    params = {m: model_lib.init_params(cfg, seed=s, device=dev)
              for m, s in (("a", 0), ("b", 1))}
    param_bytes = sum(t.numel() * t.element_size() for t in
                      _leaves(params["a"]))
    reqs = _requests(cfg)

    # calibration: stage a alone; its gap streams set the threshold
    cal = TokenEngine([SlotEngine("a", params["a"], cfg, N_SLOTS, MAX_LEN,
                                  device=dev)], _gear(["a"], []),
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

    stages = [SlotEngine(m, params[m], cfg, N_SLOTS, MAX_LEN, device=dev)
              for m in ("a", "b")]
    log = {"prefill": {}, "step_ms": []}
    for e in stages:
        _timed(e, log)
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
        "step_ms_median": statistics.median(log["step_ms"]),
        "prefill_ms_median": {k: statistics.median(v) for k, v in
                              sorted(log["prefill"].items(),
                                     key=lambda kv: [int(x) for x in
                                                     kv[0].split("x")])},
        "param_bytes_per_stage": param_bytes,
        "weight_read_bound_step_ms": param_bytes / HBM_BYTES_PER_S * 1e3,
        "launches": launches,
    }
    emit(summary)

    check(launches["top2gap"] == st["decode_steps"] + st["prefill_calls"]
          and launches["top2gap"] > 0,
          f"top2gap launches {launches['top2gap']} == decode steps + "
          f"prefill calls")
    for r in res:
        check(r.resolver in (0, 1) and r.done_step >= 0, "request completes")
        check(len(r.tokens) == MAX_NEW, "request streams max_new tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens), "tokens range")
        check(all(np.isfinite(g) and g >= 0 for gs in r.stage_gaps.values()
                  for g in gs), "gaps finite and >= 0")
    check(n_a >= 1 and n_b >= 1, f"both outcomes: {n_a} at a, {n_b} at b")
    return summary, params, cfg, reqs, cal, out


def phase_serve(dev) -> dict:
    summary, params, cfg, reqs, cal, out = serve_cascade(dev, ARCH, "serve")
    _teacher_forced_check(params, cfg, reqs, out, "serve")
    launches, layers = summary["launches"], cfg.num_layers
    expect = {
        "decode_attention": layers * summary["decode_steps"],
        "flash_attention": layers * summary["prefill_calls"],
    }
    for name, n in expect.items():
        check(launches[name] == n and n > 0,
              f"{name} launches {launches[name]} == {n} > 0")
    check(launches["mamba_scan"] == 0, "no scan on the attention path")
    phase_reference(dev, params["a"], cfg, reqs, cal)
    phase_trace(dev, params, cfg, reqs, "trace")
    return summary


def phase_serve_ssm(dev) -> dict:
    """falcon-mamba-7b through the same engine and traffic: exact-length
    batch-1 prefills whose scans run in the mamba_scan kernel, single-step
    recurrent decode, top2gap at V 65,024, and no attention kernel."""
    torch.cuda.reset_peak_memory_stats()
    summary, params, cfg, reqs, _, out = serve_cascade(dev, SSM_ARCH,
                                                       "serve_ssm")
    launches, layers = summary["launches"], cfg.num_layers
    n = layers * summary["prefill_calls"]
    check(launches["mamba_scan"] == n and n > 0,
          f"mamba_scan launches {launches['mamba_scan']} == {n} > 0")
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
    _teacher_forced_check(params, cfg, reqs, out, "serve_ssm",
                          enforce_at=SSM_BF16_MARGIN)
    phase_trace(dev, params, cfg, reqs, "trace_ssm")
    summary["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    emit({"phase": "memory_ssm",
          "max_memory_allocated_bytes": summary["max_memory_allocated_bytes"],
          "param_bytes_two_stages": 2 * summary["param_bytes_per_stage"]})
    phase_teacher_forced_f32(dev, params["a"], cfg, reqs)
    return summary


def phase_teacher_forced_f32(dev, params, cfg, reqs, n_req: int = 4) -> None:
    """Stage a in float32 at full width (its bf16 weights widened, 29 GB)
    serves the first requests through the fused engine; the served tokens
    must agree with an f32 teacher-forced ``forward`` wherever its top-2
    gap exceeds 0.1. The engine's slot pool rounds a joiner's conv tail to
    bf16 (as the JAX engine's does), so the gaps are held tight on
    ``greedy_generate``, whose cache stays f32: its decode gaps within
    F32_GAP_TOL of the forward's."""
    p32 = {"a": _widen(params)}
    te = TokenEngine([SlotEngine("a", p32["a"], cfg, N_SLOTS, MAX_LEN,
                                 device=dev)], _gear(["a"], []),
                     min_tokens=MIN_TOKENS, early_margin=EARLY_MARGIN,
                     spec_k=SPEC_K)
    sub = reqs[:n_req]
    before = K.launch_counts()["mamba_scan"]
    out = te.serve(sub)
    check(K.launch_counts()["mamba_scan"] - before
          == cfg.num_layers * te.stats()["prefill_calls"],
          "the f32 prefills run the scan kernel in every layer")
    _teacher_forced_check(p32, cfg, sub, out, "serve_ssm_f32")
    r = reqs[0]
    toks, gaps = greedy_generate(p32["a"], cfg, r.prompt, MAX_NEW)
    seq = np.concatenate([r.prompt, toks[:-1]])[None]
    logits, _ = model_lib.forward(p32["a"], cfg, {"tokens": seq})
    fgap, fidx = top2gap(logits[0, r.prompt.size - 1:].contiguous())
    diff = float(np.abs(fgap.cpu().numpy() - gaps).max())
    clear = fgap.cpu().numpy() > 0.1
    emit({"phase": "greedy_f32", "of": "serve_ssm", "tokens": len(toks),
          "max_gap_diff": diff, "positions_checked": int(clear.sum()),
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


def phase_trace(dev, params, cfg, reqs, phase: str,
                n_steps: int = 8) -> None:
    """A torch.profiler window over fused decode steps of stage a with
    every slot resident: device-busy share of the step and the kernels
    that take the time (measurement only; nothing is checked)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = SlotEngine("a", params["a"], cfg, N_SLOTS, MAX_LEN, device=dev)
    eng.prefill_batch([r.prompt for r in reqs[:N_SLOTS]])
    eng.decode_fused(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.decode_fused(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t_us = getattr(e, "self_device_time_total", None)
        if t_us is None:
            t_us = e.self_cuda_time_total
        kernels.append((t_us / 1e3 / n_steps, e.count / n_steps, e.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    emit({"phase": phase, "arch": cfg.name, "steps": n_steps,
          "batch": N_SLOTS,
          "wall_ms_per_step": wall_ms,
          "device_busy_ms_per_step": busy if kernels else None,
          "idle_share": 1.0 - busy / wall_ms if kernels else None,
          "kernel_launches_per_step": sum(k[1] for k in kernels),
          "top": [{"ms_per_step": t, "launches_per_step": c,
                   "kernel": name[:90]} for t, c, name in kernels[:12]]})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _teacher_forced_check(params, cfg, reqs, out, phase: str,
                          n_check: int = 4, enforce_at: float = 0.1
                          ) -> dict:
    """Feeds prompt + served tokens through ``forward`` (the flash
    attention or selective-scan kernel) and compares its greedy argmax
    with the tokens the decode loop served, at every position where
    forward's top-2 gap exceeds a margin: counted at 0.1 and at
    ``enforce_at``, and required to agree at ``enforce_at``. Also reports
    the largest gap difference between the two paths."""
    margins = sorted({0.1, enforce_at})
    checked = dict.fromkeys(margins, 0)
    agreed = dict.fromkeys(margins, 0)
    max_gap_diff = 0.0
    for r in reqs[:n_check]:
        res = out[r.rid]
        p = params["a" if res.resolver == 0 else "b"]
        seq = np.concatenate([r.prompt, np.asarray(res.tokens[:-1],
                                                   np.int32)])[None]
        logits, _ = model_lib.forward(p, cfg, {"tokens": seq})
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
             "dtype": str(params["a"]["embed"]["embedding"].dtype),
             "enforced_margin": enforce_at,
             "positions_checked": {str(m): checked[m] for m in margins},
             "agreed": {str(m): agreed[m] for m in margins},
             "max_gap_diff": max_gap_diff}
    emit(agree)
    check(checked[enforce_at] > 0
          and agreed[enforce_at] == checked[enforce_at],
          f"teacher-forced argmax agrees where the gap exceeds "
          f"{enforce_at} ({agreed[enforce_at]}/{checked[enforce_at]})")
    return agree



# ---------------------------------------------------------------------------
# phase 6: the one-shot classifier cascade (train, profile, plan, serve)
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
              profile: bool = False):
    """One threaded wall-clock run through ``serve.serve_real`` over a
    recording backend; with ``profile``, under torch.profiler (device busy
    and idle share). Launch counters are zeroed just before and read just
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
                                                     decision_trace=tr)
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
    _des_run(S, plan, profiles, trace, TINY_QPS)

    emit(_real_run(S, plan, backend, trace, TINY_QPS, "serve_tiny_profiled",
                   profile=True)[0])

    plan_hi = plan_for(TINY_QPS_STRESS)
    trace_hi = S.make_trace("azure", TINY_TRACE_S, TINY_QPS_STRESS)
    emit(_real_run(S, plan_hi, backend, trace_hi, TINY_QPS_STRESS,
                   "serve_tiny_real")[0])
    _des_run(S, plan_hi, profiles, trace_hi, TINY_QPS_STRESS)
    return real["launches"]


# ---------------------------------------------------------------------------

def main() -> int:
    smi = phase_device()
    dev = resolve_device("cuda")   # strict fp32 matmuls (no TF32)
    phase_build()
    timed = phase_kernels(dev)
    paths = {"serve": phase_serve(dev)["launches"]}
    gc.collect()                 # the qwen2 params and engines go first
    torch.cuda.empty_cache()
    paths["serve_ssm"] = phase_serve_ssm(dev)["launches"]
    gc.collect()                 # the falcon-mamba params and engines go
    torch.cuda.empty_cache()
    paths["serve_tiny"] = phase_serve_tiny(dev)
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
    }
    rows = []
    for name, (src, replaces) in sources.items():
        t = timed[name]
        # launches: both main-path runs together, and each on its own
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": sum(p[name] for p in paths.values()),
                     "launches_by_path": {k: p[name]
                                          for k, p in paths.items()},
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"],
                     **{key: t[key] for key in ("bound_bytes", "bound_flops")
                        if key in t}})
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
    sys.exit(main())
