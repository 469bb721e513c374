"""Training launcher (port of ``repro/launch/train.py``):

    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 20 \\
        --ckpt-dir CKPT --resume

Random bf16 params from seed 0 (``init_params``), AdamW with float32
moments, activation recomputation on (``--remat``), optional gradient
accumulation (``--microbatches``), ``SyntheticDataset`` batches drawn in
order, and crash-safe checkpoints (``--ckpt-dir``, every
``--ckpt-every`` steps; ``--resume`` picks up LATEST). Every
``--log-every`` steps it prints the reference's step line (loss, gradient
norm, host ms per step, tokens per second) and, on the card, the mean
device ms per step between CUDA events around each step.

``--device`` (default ``cuda``) selects where it trains: without a card it
raises, and the CPU runs only when asked (``--device cpu``, with
``--smoke`` for a same-family config the CPU can train). The reference's
``--mesh`` and ``--compress-pod-grads`` wait for the distributed port.
Unlike the reference, the batches are drawn in the training thread, not
by ``PrefetchingLoader``: the loader drops the batch it holds whenever its
queue stays full for 0.5 s, so the stream it yields depends on how long
the steps take (``training/data.py`` keeps it verbatim). Drawing a batch
costs a few milliseconds beside a full-width step. A resumed run first
draws and drops the batches of the steps it resumes after, so it trains
on the batches the uninterrupted run would have seen.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import model as model_lib
from repro_torch.training import (AdamWConfig, SyntheticDataset,
                                  TrainStepConfig, init_opt_state,
                                  make_train_step)
from repro_torch.training.train_step import as_batch


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"config: {cfg.name} ({'smoke' if args.smoke else 'FULL'}) "
          f"params≈{cfg.param_count() / 1e6:.1f}M")

    params = model_lib.init_params(cfg, seed=0, device=device)
    opt = init_opt_state(params)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if mgr is not None and args.resume and mgr.latest_step() is not None:
        (params, opt), meta = mgr.restore((params, opt))
        start_step = meta["step"]
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(
        cfg, AdamWConfig(learning_rate=args.lr, warmup_steps=10,
                         decay_steps=max(args.steps, 100)),
        TrainStepConfig(remat=args.remat,
                        num_microbatches=args.microbatches))
    ds = SyntheticDataset(cfg, batch=args.batch, seq_len=args.seq, seed=0)
    for _ in range(start_step):
        ds.next_batch()

    t0 = time.time()
    events = []
    for step in range(start_step, args.steps):
        batch = as_batch(ds.next_batch(), device)
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        params, opt, metrics = step_fn(params, opt, batch)
        if on_card:
            end.record()
            events.append((start, end))
        if (step + 1) % args.log_every == 0:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            dt = (time.time() - t0) / args.log_every
            tok_s = args.batch * args.seq / dt
            line = (f"step {step + 1:5d} loss={loss:.4f} gnorm={gn:.2f} "
                    f"{dt * 1e3:.0f}ms/step {tok_s:.0f} tok/s")
            if on_card:
                torch.cuda.synchronize()
                dms = sum(s.elapsed_time(e) for s, e in events) / len(events)
                line += f" device {dms:.1f}ms/step"
                events = []
            print(line, flush=True)
            t0 = time.time()
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, (params, opt), extra={"arch": cfg.name})
    print("done")


if __name__ == "__main__":
    main()
