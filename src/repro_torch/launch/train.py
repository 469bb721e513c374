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
``--smoke`` for a same-family config the CPU can train).

``--mesh dxm`` (e.g. 2x2, axes data x model) or ``pxdxm`` (e.g. 2x2x2,
pod x data x model) trains over one process per device under
``torchrun``, e.g. on the CPU over gloo::

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch \
        qwen2-0.5b --smoke --mesh 2x2x2 --compress-pod-grads --device cpu

and on cards over NCCL, each process on ``cuda:LOCAL_RANK``. As in the
reference, params are placed by the sharding rules (``sanitize_pspecs``:
an axis that does not divide a dim is dropped) and the moments also over
'pod' (ZeRO-1); ``--compress-pod-grads`` exchanges the gradients across
pods as int8. Every process draws the same global batch and trains on its
rows. Checkpoints keep the reference's on-disk format: every process
gathers the whole tensors, rank 0 writes, and a restore reads them on
every process and places them again. Only rank 0 prints.
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
import os
import socket
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.distributed import compat
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.context import use_context
from repro_torch.launch.mesh import context_for_mesh, make_mesh
from repro_torch.models import model as model_lib
from repro_torch.training import (AdamWConfig, SyntheticDataset,
                                  TrainStepConfig, init_opt_state,
                                  make_train_step, opt_state_pspecs)
from repro_torch.training.train_step import as_batch


def _start_mesh(spec: str, device: torch.device):
    """The mesh of ``--mesh`` over the job's processes (torchrun's
    environment): NCCL on the process's card, gloo on the CPU."""
    dims = tuple(int(x) for x in spec.split("x"))
    axes = ("pod", "data", "model")[-len(dims):]
    if not dist.is_initialized():
        # torchrun's environment, or one process alone on a free port
        init = None
        if "MASTER_ADDR" not in os.environ:
            with socket.socket() as s:
                s.bind(("localhost", 0))
                init = f"tcp://localhost:{s.getsockname()[1]}"
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            rank=int(os.environ.get("RANK", 0)),
            world_size=int(os.environ.get("WORLD_SIZE", 1)),
            init_method=init)
    return make_mesh(dims, axes, device.type)


def _place(params, opt, ctx):
    """Params by the rules and moments ZeRO-1 over 'pod', both sanitized,
    as DTensors (the step counter stays a plain tensor)."""
    mesh = ctx.mesh
    pspecs = sh.sanitize_pspecs(params, sh.param_pspecs(params, ctx, "train"),
                                mesh)
    zero1 = "pod" if "pod" in mesh.mesh_dim_names else None
    mspecs = sh.sanitize_pspecs(
        opt["m"], opt_state_pspecs(pspecs, zero1_axis=zero1)["m"], mesh)
    return (sh.distribute(params, pspecs, mesh),
            {"m": sh.distribute(opt["m"], mspecs, mesh),
             "v": sh.distribute(opt["v"], mspecs, mesh),
             "step": opt["step"]})


def _placed_like(tree, template):
    """Whole tensors placed as the template's DTensors are."""
    leaves, treedef = tree_lib.flatten(tree)
    like = tree_lib.leaves(template)
    return tree_lib.unflatten(treedef, [
        compat.distribute_tensor(t, w.device_mesh, w.placements)
        if isinstance(w, compat.DTensor) else t
        for t, w in zip(leaves, like)])


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
    ap.add_argument("--mesh", default="none",
                    help="none | dxm (e.g. 2x2) | pxdxm (e.g. 2x2x2), one "
                         "process per device under torchrun")
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ctx = None
    # a process group the caller started stays the caller's to end
    own_group = args.mesh != "none" and not dist.is_initialized()
    if args.mesh != "none":
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
            torch.cuda.set_device(device)
        ctx = context_for_mesh(_start_mesh(args.mesh, device))
    lead = ctx is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    on_card = device.type == "cuda"
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    say(f"config: {cfg.name} ({'smoke' if args.smoke else 'FULL'}) "
        f"params≈{cfg.param_count() / 1e6:.1f}M")

    params = model_lib.init_params(cfg, seed=0, device=device)
    opt = init_opt_state(params)
    if ctx is not None:
        params, opt = _place(params, opt, ctx)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if mgr is not None and args.resume and mgr.latest_step() is not None:
        (params, opt), meta = mgr.restore(template := (params, opt))
        if ctx is not None:
            params, opt = _placed_like((params, opt), template)
        start_step = meta["step"]
        say(f"resumed from step {start_step}")

    step_fn = make_train_step(
        cfg, AdamWConfig(learning_rate=args.lr, warmup_steps=10,
                         decay_steps=max(args.steps, 100)),
        TrainStepConfig(remat=args.remat,
                        num_microbatches=args.microbatches,
                        compress_pod_grads=args.compress_pod_grads))
    ds = SyntheticDataset(cfg, batch=args.batch, seq_len=args.seq, seed=0)
    for _ in range(start_step):
        ds.next_batch()

    with use_context(ctx):
        _train(args, cfg, step_fn, ds, params, opt, mgr, start_step, device,
               on_card, lead, say)
    say("done")
    if ctx is not None:
        dist.barrier()
    if own_group:
        dist.destroy_process_group()


def _train(args, cfg, step_fn, ds, params, opt, mgr, start_step, device,
           on_card, lead, say) -> None:
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
            say(line, flush=True)
            t0 = time.time()
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            whole = sh.gather_tree((params, opt))
            if lead:
                mgr.save(step + 1, whole, extra={"arch": cfg.name})
            if dist.is_initialized():
                dist.barrier()


if __name__ == "__main__":
    main()
