"""Multi-pod dry-run (port of ``repro/launch/dryrun.py``): trace every
(architecture x input shape) cell on the production meshes and write the
roofline rows (EXPERIMENTS.md §Dry-run/§Roofline).

The reference lowers and compiles each cell's step on 512 host devices
and reads the per-device HLO. The port runs one process per device, so a
cell is one process's step, traced: this process joins a ``fake`` process
group of the mesh's size (``distributed/compat.py``
``fake_process_group``: collectives communicate nothing), builds the
params, optimizer state, decode cache and batch under a
``FakeTensorMode`` (nothing is allocated), places them by the sharding
rules, and runs the step of ``launch/steps.py`` once under
``profiling/trace_cost.py``'s ``TraceCost``, which counts per-device
FLOPs, bytes, collective bytes by kind and peak memory, with every
kernel wrapper charged as its kernel. ``profiling/roofline.py`` turns the
counts into the reference's row, on the H100's constants.

Layouts, as the reference's: params by the rules (train mode: the
"fsdp" dims over 'data'), the optimizer's moments also over 'pod' on the
multi-pod mesh (ZeRO-1), the batch over every axis but 'model'. A decode
cell's cache is this process's block of the reference's layout: its
sequence chunk over the model axis (``seq_sharded``: whenever the kv
heads do not tile the model axis, for ``long_500k``, and under
``--flash-decode``), which the port computes on through the sharded
flash-decode; a sliding-window ring, which the flash-decode cannot shard,
is held whole; otherwise the cache's kv heads over the model axis. Params
are built whole as fakes and placed; the whole fakes are dropped before
the step is traced, and the peak counts each argument's local block
(``TraceCost.argument_bytes``) plus what the step creates.

The traced process is the mesh's last rank (the last coordinate on every
axis). Ranks differ in one place: under sequence-parallel causal
attention (the query heads do not tile the model axis) each model
coordinate takes one chunk of the queries over the keys up to the
chunk's end, and the last chunk sees every key, so the last rank is the
busiest device and its row bounds the step. The reference's SPMD program
is the same on every device.

The fake process group is global to a process, and a process that has
started another group cannot trace: run ``main`` in a process of its own.

Usage (``--device`` defaults to ``cuda``; the CPU traces the same step):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape decode_32k --mesh both --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --device cpu --out build/dryrun.json
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import (SHAPES, ShapeCell, cache_specs,
                                        input_specs, skip_reason)
from repro_torch.distributed import compat
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.context import use_context
from repro_torch.launch.mesh import context_for_mesh, make_mesh
from repro_torch.launch.steps import (make_serve_decode, make_serve_prefill,
                                      make_train)
from repro_torch.launch.train import _place
from repro_torch.models import model as model_lib
from repro_torch.profiling import hw as H100
from repro_torch.profiling.cost_model import model_bytes, model_flops
from repro_torch.profiling.roofline import (analyze_trace,
                                            t_collective_by_domain)
from repro_torch.profiling.trace_cost import TraceCost, tree_bytes
from repro_torch.training.optimizer import init_opt_state

__all__ = ["trace_cell", "run_cell", "fmt_row", "plan_check",
           "emit_serve_profiles", "production_shape", "main"]

_meshes: Dict[Tuple, compat.DeviceMesh] = {}


def production_shape(mesh_kind: str) -> Tuple[int, ...]:
    """A pod of ``hw.CHIPS_PER_POD`` (256) as (16, 16) ('data', 'model')
    or, multi-pod, (2, 16, 16) ('pod', 'data', 'model')."""
    side = math.isqrt(H100.CHIPS_PER_POD)
    return (2, side, side) if mesh_kind == "multi" else (side, side)


def _fake_mesh(dims: Tuple[int, ...], device_type: str
               ) -> compat.DeviceMesh:
    """A mesh of ``dims`` over a fake process group of ``prod(dims)``
    ranks, this process the last; the group is started anew when the size
    changes."""
    world = math.prod(dims)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("dryrun: this process has a real process "
                               "group; trace in a process of its own")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
            _meshes.clear()
            compat.forget_meshes()
    if not dist.is_initialized():
        compat.fake_process_group(world, rank=world - 1)
    key = (dims, device_type)
    if key not in _meshes:
        axes = ("pod", "data", "model")[-len(dims):]
        _meshes[key] = make_mesh(dims, axes, device_type)
    return _meshes[key]


def _local_block(tree: Any, specs: Any, mesh) -> Any:
    """This process's block of every tensor of ``tree`` placed by
    ``specs``."""
    return tree_lib.tree_map(lambda t: t.to_local(),
                             sh.distribute(tree, specs, mesh))


def _batch_bytes(batch: Dict[str, torch.Tensor], ctx) -> int:
    """The batch's bytes on this process: its rows where the global batch
    divides over the batch axes (the steps then slice them), else all."""
    n = compat.axis_size(ctx.batch_axes, ctx.mesh)
    return sum(t.numel() * t.element_size() // (
        n if t.dim() and t.shape[0] % n == 0 else 1) for t in batch.values())


def trace_cell(cfg: ModelConfig, shape: ShapeCell, dims: Sequence[int],
               device: Any = "cuda", flash_decode: bool = False
               ) -> Tuple[TraceCost, float, float]:
    """Trace one step of ``shape``'s kind for ``cfg`` on a fake mesh of
    ``dims`` as its last process (module docstring): (the ``TraceCost``
    that counted it, the seconds to build and place its arguments, the
    seconds to the end of the trace)."""
    t0 = time.time()
    dev = resolve_device(device)
    mesh = _fake_mesh(tuple(dims), dev.type)
    seq_sharded = False
    if shape.kind == "decode":
        # the reference's seq-sharded cache rule (dryrun.py:104-112)
        seq_sharded = (flash_decode or shape.name == "long_500k"
                       or cfg.num_kv_heads % mesh.shape[-1] != 0)
        # a sliding-window ring cannot be sharded by sequence
        seq_sharded = seq_sharded and cfg.sliding_window == 0
    ctx = context_for_mesh(mesh, flash_decode=flash_decode or seq_sharded)
    with FakeTensorMode(), use_context(ctx):
        params = model_lib.init_params(cfg, device=dev)
        batch = input_specs(cfg, shape, dev)
        if shape.kind == "train":
            state = _place(params, init_opt_state(params), ctx)
            args = state + (batch,)
            step = make_train(cfg)
        else:
            state = (sh.param_shardings(params, ctx, "serve"),)
            if shape.kind == "prefill":
                args = state + (batch,)
                step = make_serve_prefill(cfg)
            else:
                cache = cache_specs(cfg, shape, dev)
                specs = sh.sanitize_pspecs(cache, sh.cache_pspecs(
                    cache, ctx, "serve", seq_sharded=seq_sharded), mesh)
                state += (_local_block(cache, specs, mesh),)
                args = state + (batch["tokens"], batch["cache_index"])
                step = make_serve_decode(cfg)
        arg_bytes = tree_bytes(state) + _batch_bytes(batch, ctx)
        del params, state   # the whole fakes go; the blocks stay
        gc.collect()
        t_setup = time.time() - t0
        with TraceCost(argument_bytes=arg_bytes) as cost:
            step(*args)
        return cost, t_setup, time.time() - t0


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             flash_decode: bool = False,
             mesh_shape: Optional[Sequence[int]] = None,
             device: Any = "cuda") -> Dict:
    """Trace one cell and return its row: the reference's keys, plus
    ``kernel_calls`` (the kernels charged, with their calls),
    ``collective_bytes_cross_node`` and ``t_collective_by_domain``
    (``profiling/roofline.py``). A failing
    cell is a row with status ``error``. ``mesh_shape`` traces on a mesh
    of that shape (the trailing axis names of ('pod', 'data', 'model'))
    instead of the production one; the reference has no such argument."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    row: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind}
    if flash_decode:
        row["variant"] = "flash_decode"
    reason = skip_reason(cfg, shape)
    if reason:
        row["status"] = "skip"
        row["reason"] = reason
        return row
    dims = tuple(mesh_shape) if mesh_shape else production_shape(mesh_kind)
    try:
        cost, t_setup, t_trace = trace_cell(cfg, shape, dims, device,
                                            flash_decode)
        tokens = (shape.global_batch if shape.kind == "decode"
                  else shape.global_batch * shape.seq_len)
        mf = model_flops(cfg, tokens=tokens, context=shape.seq_len,
                         kind=shape.kind)
        mb = model_bytes(cfg, batch=shape.global_batch,
                         context=shape.seq_len, kind=shape.kind)
        rep = analyze_trace(cost, arch, shape_name, mesh_kind,
                            chips=math.prod(dims), model_flops_total=mf,
                            model_bytes_total=mb, compile_seconds=t_trace)
        row.update(rep.to_dict())
        row["status"] = "ok"
        row["lower_seconds"] = t_setup
        row["memory_analysis"] = {
            "argument_size_in_bytes": int(cost.argument_bytes),
            "temp_size_in_bytes": int(cost.peak_live)}
        row["kernel_calls"] = dict(sorted(cost.kernel_calls.items()))
        row["collective_bytes_cross_node"] = cost.collective_cross_node
        row["t_collective_by_domain"] = t_collective_by_domain(cost)
        if mesh_shape:
            row["mesh_shape"] = list(dims)
    except Exception as e:  # a failing cell is a bug in the system
        row["status"] = "error"
        row["error"] = f"{type(e).__name__}: {e}"
        row["traceback"] = traceback.format_exc()[-2000:]
    return row


def fmt_row(row: Dict) -> str:
    if row["status"] == "skip":
        return (f"{row['arch']:26s} {row['shape']:12s} {row['mesh']:6s} "
                f"SKIP ({row['reason'][:60]})")
    if row["status"] == "error":
        return (f"{row['arch']:26s} {row['shape']:12s} {row['mesh']:6s} "
                f"ERROR {row['error'][:80]}")
    return (f"{row['arch']:26s} {row['shape']:12s} {row['mesh']:6s} "
            f"flops/dev={row['hlo_flops']:.3e} bytes/dev={row['hlo_bytes']:.3e} "
            f"coll/dev={row['collective_bytes']:.3e} dom={row['dominant']:10s} "
            f"roofline={row['roofline_fraction']:.3f} "
            f"peak={row['peak_memory_bytes'] / 1e9:.2f}GB "
            f"trace={row['compile_seconds']:.1f}s")


def plan_check(archs, context: int, qps_max: float = 60.0,
               slo_spec: str = "latency:8.0") -> None:
    """Run the gear planner over the analytic serve profiles and print the
    per-submodule wall-time breakdown (``PlannerReport.submodule_seconds``)
    — the measurability hook for planner performance work (DESIGN.md §10):
    any regression in planner wall time shows up here per submodule, on
    artifacts the dry-run already produces."""
    from repro_torch.core.execution import CostModelBackend, profile_backend
    from repro_torch.core.gears import SLO
    from repro_torch.core.plan_state import HardwareSpec
    from repro_torch.core.planner import optimize_gear_plan
    from repro_torch.core.profiles import synthetic_family
    names = list(archs)
    synth = synthetic_family(names, base_acc=0.55, acc_gain=0.04, seed=11)
    backend = CostModelBackend({a: a for a in names}, context=context,
                               kind="decode",
                               validation={n: synth[n].validation
                                           for n in names})
    profiles = profile_backend(backend)
    # four 80 GB cards (the reference plans four 96 GB devices)
    hw = HardwareSpec(num_devices=4, mem_per_device=H100.HBM_BYTES)
    fits = {m: p for m, p in profiles.items()
            if p.mem_bytes <= hw.mem_per_device}
    dropped = sorted(set(profiles) - set(fits))
    if dropped:
        print(f"plan check: dropping {dropped} (replica exceeds device "
              f"memory {hw.mem_per_device / 1e9:.0f} GB)")
    profiles = fits
    kind, value = slo_spec.split(":")
    slo = SLO(kind="latency", latency_p95=float(value)) \
        if kind == "latency" else SLO(kind="accuracy",
                                      min_accuracy=float(value))
    report = optimize_gear_plan(profiles, hw, slo, qps_max=qps_max,
                                n_ranges=4)
    print(f"\nplan check: {report.submodule_calls} submodule calls, "
          f"{report.errors_resolved} errors resolved, "
          f"{report.wall_seconds:.2f}s wall, "
          f"{report.certify_rounds} certification restart(s)")
    for sub, secs in sorted(report.submodule_seconds.items()):
        print(f"  {sub:22s} {secs:7.3f}s")
    for memo, (hits, misses) in sorted(report.memo_stats.items()):
        total = hits + misses
        rate = hits / total if total else 0.0
        print(f"  {memo:22s} {hits}/{total} hits ({rate:.0%})")
    for r, g in enumerate(report.plan.gears):
        print(f"  range {r}: {' -> '.join(g.cascade.models)} "
              f"p95={g.expected_p95 * 1e3:.0f}ms")


def emit_serve_profiles(archs, context: int, out_path: str) -> None:
    """Write the analytic-roofline serve ModelProfiles for ``archs`` via the
    unified execution-backend entry point (``profile_backend`` over a
    ``CostModelBackend``) — the same artifacts the gear planner consumes, so
    dry-run cost extraction and serving planning cannot diverge."""
    from repro_torch.core.execution import CostModelBackend, profile_backend
    backend = CostModelBackend({a: a for a in archs}, context=context,
                               kind="decode")
    profiles = profile_backend(backend)
    rows = {name: p.to_dict() for name, p in profiles.items()}
    with open(out_path, "w") as f:
        json.dump(rows, f, indent=1)
    for name, p in profiles.items():
        print(f"{name:26s} slice={p.devices_per_replica:3d} "
              f"rt(1)={p.runtime(1) * 1e3:8.2f}ms "
              f"rt(128)={p.runtime(128) * 1e3:8.2f}ms")
    print(f"serve profiles written to {out_path}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--append", action="store_true",
                    help="merge into an existing --out file, skipping "
                         "already-recorded ok cells")
    ap.add_argument("--flash-decode", action="store_true",
                    help="sharded flash-decoding for decode cells "
                         "(EXPERIMENTS.md §Perf H2)")
    ap.add_argument("--serve-profiles-out", default="",
                    help="emit analytic serve ModelProfiles (CostModel"
                         "Backend) for the selected archs and exit")
    ap.add_argument("--serve-context", type=int, default=2048)
    ap.add_argument("--plan-check", action="store_true",
                    help="run the gear planner over the analytic serve "
                         "profiles and print the per-submodule wall-time "
                         "breakdown")
    ap.add_argument("--mesh-shape", default="",
                    help="trace on a mesh of this shape (e.g. 1x4: data x "
                         "model; 2x2x2: pod x data x model) instead of the "
                         "production one; the reference has no such flag")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the device the fake "
                         "tensors stand for")
    args = ap.parse_args(argv)

    if args.serve_profiles_out or args.plan_check:
        archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
        if args.serve_profiles_out:
            emit_serve_profiles(archs, args.serve_context,
                                args.serve_profiles_out)
        if args.plan_check:
            plan_check(archs, args.serve_context)
        return

    resolve_device(args.device)
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    mesh_shape = tuple(int(x) for x in args.mesh_shape.split("x")) \
        if args.mesh_shape else None

    done = {}
    if args.append and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for row in json.load(f):
                done[(row["arch"], row["shape"], row["mesh"])] = row

    rows = []
    t0 = time.time()
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                key = (arch, shape_name, mesh_kind)
                if key in done and done[key]["status"] in ("ok", "skip"):
                    rows.append(done[key])
                    print("CACHED " + fmt_row(done[key]), flush=True)
                    continue
                row = run_cell(arch, shape_name, mesh_kind,
                               flash_decode=args.flash_decode,
                               mesh_shape=mesh_shape, device=args.device)
                rows.append(row)
                print(fmt_row(row), flush=True)
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(rows, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skip" for r in rows)
    n_err = sum(r["status"] == "error" for r in rows)
    print(f"\n{n_ok} ok, {n_skip} documented skips, {n_err} errors "
          f"({time.time() - t0:.1f} s)")
    if dist.is_initialized():
        dist.destroy_process_group()
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
