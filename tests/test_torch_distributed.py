"""The port's distributed paths over CPU processes against the JAX
package's sharded paths.

Each test runs as separate processes, so nothing here imports jax or
starts a process group itself:

* one JAX process (8 host devices, ``XLA_FLAGS=
  --xla_force_host_platform_device_count=8``) computes the reference's
  sharded results for every phase and writes them, with its params, to an
  ``.npz`` (module fixture ``jax_ref``). Its meshes are built as
  ``jax.sharding.Mesh(devices.reshape(shape), names)``, whose axes are
  Auto: ``jax.make_mesh`` (as ``repro/launch/mesh.py`` calls it) gives
  Explicit axes on jax 0.9, where ``with_sharding_constraint`` refuses
  them;
* the port runs 8 processes over gloo (one ``FileStore`` rendezvous in
  ``tmp_path``, one intra-op thread each) on the same numpy-seeded inputs,
  with the JAX params carried over leaf by leaf, and rank 0 writes what it
  gathered.

Every spawn is joined with a hard time limit (``TIMEOUT``) and fails, not
hangs, when a process dies or runs over.

Phases and limits:

* (4, 2) ('data', 'model'): qwen2-moe smoke, expert-parallel MoE, random
  tokens: ``train_loss`` within 1e-5 of JAX's EP loss and within JAX's
  2e-2 of the local loss; every gradient leaf within 1e-4 of its largest
  JAX entry; the router-gap guard (1e-4) of ``tests/test_torch_moe.py``
  on every routing call of the port.
* (2, 4): qwen3 smoke, sharded flash-decode at cache_len 20 over two
  steps (``decode_step`` on sequence chunks of the cache): within 1e-5 of
  JAX's flash-decode logits and 1e-4 of JAX's dense decode; the serve
  steps (``launch/steps``) with DTensor params give JAX's greedy tokens.
  A 6-head qwen2 smoke (6 heads over a 4-way model axis: sequence
  parallel) ``forward`` at S 22 (padded to 4 chunks of 6) within 1e-5 of
  JAX's, and its gradients within 1e-4 of each leaf's largest.
* (2, 4), the tensor-parallel layers on DTensor params: olmo smoke
  (heads layout: one head and one kv head per model process, the cache
  kv-head sharded), falcon-mamba smoke (the mixer's channels split),
  seamless smoke (encoder, cross attention), and in the query-heads
  layout (4 query heads over 4, 2 kv heads: one query head per model
  process over the kv head it reads, the cache whole) h2o-danube smoke
  (window 64, so its decode writes a ring) and qwen3 smoke (qk-norm, whose
  scales' gradients are summed over the model axis): ``forward`` logits
  within 1e-5 of JAX's, ``train_loss`` gradients within 1e-4 of each
  leaf's largest, prefill and two decode steps within 1e-5 of JAX's; each
  process holds a quarter of every projection's columns or rows.
* (2, 4), a vocab of 510 that does not tile the 4-way model axis:
  qwen2 smoke (tied head) and falcon-mamba smoke (untied), each with
  ``vocab_size`` 510 in both packages, the JAX values under the mesh:
  ``forward`` logits within 1e-5 of JAX's, ``train_loss`` within 1e-5 and
  every gradient leaf (the replicated embedding and head included)
  within 1e-4 of its largest JAX entry, and the serve steps on DTensor
  params give JAX's greedy tokens past the guard. Each process's logits
  block is 128 wide (ceil(510 / 4), the last two columns of the last
  block padding), the per-device shape of the reference's constrained
  logits in the HLO XLA compiles for the mesh.
* (2, 2, 2) ('pod', 'data', 'model'): olmo smoke, f32 params, three
  ``compress_pod_grads`` + ZeRO-1 train steps placed as the launcher
  places them: the first loss within 1e-4 of JAX's, the later losses and
  the final params within 1e-3 (an int8 step can flip where the two
  packages' f32 gradients straddle a rounding boundary); each moment's
  local shape shows the pod split.
* The launcher under ``torchrun`` (8 gloo processes, ``--mesh 2x2x2
  --compress-pod-grads``): the loss falls, a resume from its checkpoint
  equals the uninterrupted run, and the checkpoint loads in the JAX
  ``CheckpointManager``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
TIMEOUT = 240            # seconds for each spawn, every process included
ROUTER_NEAR = 1e-4

EP_MESH = ((4, 2), ("data", "model"))
DEC_MESH = ((2, 4), ("data", "model"))
POD_MESH = ((2, 2, 2), ("pod", "data", "model"))
CACHE_LEN, PROMPT = 20, 12
TP_ARCHS = (("tpo", "olmo-1b", 5), ("tpm", "falcon-mamba-7b", 6),
            ("tps", "seamless-m4t-large-v2", 7),
            ("tpd", "h2o-danube-1.8b", 10), ("tpq", "qwen3-32b", 11))
S_SRC = 8
UV_ARCHS = (("uvq", "qwen2-0.5b", 8), ("uvm", "falcon-mamba-7b", 9))
UV_VOCAB = 510
SP_HEADS, SP_SEQ = 6, 22
TRAIN_STEPS = 3


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"), ROOT])
    env.update(extra)
    return env


def _run_all(cmds, env, cwd=ROOT):
    """Start every command, wait for all within TIMEOUT; on a failure or
    a timeout kill the rest and fail with their output."""
    procs = [subprocess.Popen(c, env=env, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
            if p.returncode != 0:
                raise AssertionError(f"process exited {p.returncode}:\n"
                                     f"{out[-4000:]}")
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a process ran over {TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


# ---------------------------------------------------------------------------
# inputs (numpy, seeded) shared by both packages
# ---------------------------------------------------------------------------

def _inputs():
    v = 512
    # a seed whose tokens keep every router choice 6e-4 clear of a tie
    ep = np.random.default_rng(38)
    rng = np.random.default_rng(23)
    return {
        "ep_tokens": ep.integers(0, v, (8, 16)).astype(np.int32),
        "ep_labels": ep.integers(0, v, (8, 16)).astype(np.int32),
        "dec_prompt": rng.integers(0, v, (4, PROMPT)).astype(np.int32),
        "dec_tokens": rng.integers(0, v, (2, 4, 1)).astype(np.int32),
        "sp_tokens": rng.integers(0, v, (4, SP_SEQ)).astype(np.int32),
        "sp_labels": rng.integers(0, v, (4, SP_SEQ)).astype(np.int32),
        "tr_tokens": rng.integers(0, v, (TRAIN_STEPS, 8, 16)).astype(np.int32),
        "tr_labels": rng.integers(0, v, (TRAIN_STEPS, 8, 16)).astype(np.int32),
    }


def _tp_batch(cfg):
    """tokens, labels (4, PROMPT) and the arch's source frames; decode
    tokens (2, 4, 1)."""
    rng = np.random.default_rng(31)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, PROMPT))
             .astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (4, PROMPT))
             .astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["source_frames"] = rng.standard_normal(
            (4, S_SRC, cfg.frontend.frontend_dim or cfg.d_model)) \
            .astype(np.float32)
    steps = rng.integers(0, cfg.vocab_size, (2, 4, 1)).astype(np.int32)
    return batch, steps


def _sp_config(get):
    import dataclasses
    return dataclasses.replace(get("qwen2-0.5b"), num_heads=SP_HEADS)


def _uv_config(get, arch):
    import dataclasses
    return dataclasses.replace(get(arch), vocab_size=UV_VOCAB)


TRAIN_OPT = dict(learning_rate=1e-3, warmup_steps=0, decay_steps=100)


# ---------------------------------------------------------------------------
# the JAX reference (its own process)
# ---------------------------------------------------------------------------

def _jax_main(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from repro.configs import get_smoke_config
    from repro.distributed import sharding as sh
    from repro.distributed.context import use_context
    from repro.launch.mesh import context_for_mesh
    from repro.models import model as JM
    from repro.training import (AdamWConfig, TrainStepConfig,
                                init_opt_state, make_train_step,
                                opt_state_pspecs)

    def mesh_of(spec):
        shape, names = spec
        return Mesh(np.array(jax.devices()).reshape(shape), names)

    inp = _inputs()
    out = {}

    def put_params(tag, params):
        for i, leaf in enumerate(jax.tree.leaves(params)):
            out[f"{tag}_param_{i}"] = np.asarray(leaf)

    def put_tree(tag, tree):
        for i, leaf in enumerate(jax.tree.leaves(tree)):
            out[f"{tag}_{i}"] = np.asarray(leaf, np.float32)

    # expert-parallel MoE on (4, 2)
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    params = JM.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    put_params("ep", params)
    batch = {"tokens": jnp.asarray(inp["ep_tokens"]),
             "labels": jnp.asarray(inp["ep_labels"])}

    def loss(p, b):
        return JM.train_loss(p, cfg, b)[0]
    out["ep_loss_local"] = np.asarray(jax.jit(loss)(params, batch))
    with use_context(context_for_mesh(mesh_of(EP_MESH))):
        val, grads = jax.jit(jax.value_and_grad(loss))(params, batch)
    out["ep_loss"] = np.asarray(val)
    put_tree("ep_grad", grads)

    # flash-decode on (2, 4)
    cfg = get_smoke_config("qwen3-32b")
    params = JM.init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    put_params("dec", params)
    _, cache = jax.jit(JM.prefill, static_argnums=(1, 3))(
        params, cfg, {"tokens": jnp.asarray(inp["dec_prompt"])}, CACHE_LEN)
    for tag, ctx in (("dense", None),
                     ("flash", context_for_mesh(mesh_of(DEC_MESH),
                                                flash_decode=True))):
        c = cache
        with use_context(ctx):
            # a fresh function per context: jit caches traces by function
            fn = jax.jit(lambda p, tok, c, i: JM.decode_step(p, cfg, tok, c,
                                                             i))
            for t in range(2):
                logits, c = fn(params, jnp.asarray(inp["dec_tokens"][t]), c,
                               jnp.asarray(PROMPT + t, jnp.int32))
                out[f"dec_{tag}_{t}"] = np.asarray(logits)

    # sequence-parallel forward and gradients on (2, 4), 6 heads
    cfg = _sp_config(get_smoke_config)
    params = JM.init_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    put_params("sp", params)
    batch = {"tokens": jnp.asarray(inp["sp_tokens"]),
             "labels": jnp.asarray(inp["sp_labels"])}
    with use_context(context_for_mesh(mesh_of(DEC_MESH))):
        logits = jax.jit(lambda p, b: JM.forward(p, cfg, b)[0])(params,
                                                                batch)
        grads = jax.jit(jax.grad(
            lambda p, b: JM.train_loss(p, cfg, b)[0]))(params, batch)
    out["sp_logits"] = np.asarray(logits)
    out["sp_logits_local"] = np.asarray(
        jax.jit(lambda p, b: JM.forward(p, cfg, b)[0])(params, batch))
    put_tree("sp_grad", grads)

    # the tensor-parallel layers' references (mesh-less)
    for tag, arch, key in TP_ARCHS:
        cfg = get_smoke_config(arch)
        params = JM.init_params(cfg, jax.random.PRNGKey(key),
                                dtype=jnp.float32)
        put_params(tag, params)
        batch, steps = _tp_batch(cfg)
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        out[f"{tag}_logits"] = np.asarray(jax.jit(
            lambda p, b: JM.forward(p, cfg, b)[0])(params, batch))
        put_tree(f"{tag}_grad", jax.jit(jax.grad(
            lambda p, b: JM.train_loss(p, cfg, b)[0]))(params, batch))
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        logits, cache = jax.jit(JM.prefill, static_argnums=(1, 3))(
            params, cfg, prompt, CACHE_LEN)
        out[f"{tag}_dec_p"] = np.asarray(logits)
        fn = jax.jit(lambda p, tok, c, i: JM.decode_step(p, cfg, tok, c, i))
        for t in range(2):
            logits, cache = fn(params, jnp.asarray(steps[t]), cache,
                               jnp.asarray(PROMPT + t, jnp.int32))
            out[f"{tag}_dec_{t}"] = np.asarray(logits)

    # a vocab that does not tile the model axis, on (2, 4)
    ctx = context_for_mesh(mesh_of(DEC_MESH))
    for tag, arch, key in UV_ARCHS:
        cfg = _uv_config(get_smoke_config, arch)
        params = JM.init_params(cfg, jax.random.PRNGKey(key),
                                dtype=jnp.float32)
        put_params(tag, params)
        batch, steps = _tp_batch(cfg)
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        with use_context(ctx):
            out[f"{tag}_logits"] = np.asarray(jax.jit(
                lambda p, b: JM.forward(p, cfg, b)[0])(params, batch))
            val, grads = jax.jit(jax.value_and_grad(
                lambda p, b: JM.train_loss(p, cfg, b)[0]))(params, batch)
            out[f"{tag}_loss"] = np.asarray(val)
            put_tree(f"{tag}_grad", grads)
            logits, cache = jax.jit(JM.prefill, static_argnums=(1, 3))(
                params, cfg, {"tokens": batch["tokens"]}, CACHE_LEN)
            out[f"{tag}_dec_p"] = np.asarray(logits)
            fn = jax.jit(lambda p, tok, c, i: JM.decode_step(p, cfg, tok, c,
                                                             i))
            for t in range(2):
                logits, cache = fn(params, jnp.asarray(steps[t]), cache,
                                   jnp.asarray(PROMPT + t, jnp.int32))
                out[f"{tag}_dec_{t}"] = np.asarray(logits)
    # the per-device shape of the reference's constrained logits: the
    # head alone at D 96 (no other f32[2, PROMPT, *] product of that width)
    import re
    from repro.models.common import lm_logits
    x = jnp.ones((4, PROMPT, 96), jnp.float32)
    w = jnp.ones((UV_VOCAB, 96), jnp.float32)
    with use_context(ctx):
        hlo = jax.jit(lambda x, w: sh.constrain(
            lm_logits({"embedding": w}, x, True), "batch", None, "vocab")
        ).lower(x, w).compile().as_text()
    out["uv_widths"] = np.array(sorted(
        {int(m) for m in re.findall(rf"f32\[2,{PROMPT},(\d+)\]", hlo)}))

    # compressed pod exchange + ZeRO-1 on (2, 2, 2), as the launcher places
    cfg = get_smoke_config("olmo-1b")
    params = JM.init_params(cfg, jax.random.PRNGKey(4), dtype=jnp.float32)
    put_params("tr", params)
    mesh = mesh_of(POD_MESH)
    ctx = context_for_mesh(mesh)
    opt = init_opt_state(params)
    pspecs = sh.sanitize_pspecs(params, sh.param_pspecs(params, ctx,
                                                        mode="train"), mesh)
    is_p = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa: E731
    params = jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(mesh, s), pspecs, is_leaf=is_p))
    ospecs = sh.sanitize_pspecs(opt, opt_state_pspecs(pspecs,
                                                      zero1_axis="pod"), mesh)
    opt = jax.device_put(opt, jax.tree.map(
        lambda s: NamedSharding(mesh, s), ospecs, is_leaf=is_p))
    step_fn = make_train_step(cfg, AdamWConfig(**TRAIN_OPT),
                              TrainStepConfig(compress_pod_grads=True))
    with use_context(ctx):
        jitted = jax.jit(step_fn)
        for t in range(TRAIN_STEPS):
            params, opt, metrics = jitted(params, opt, {
                "tokens": jnp.asarray(inp["tr_tokens"][t]),
                "labels": jnp.asarray(inp["tr_labels"][t])})
            out[f"tr_loss_{t}"] = np.asarray(metrics["loss"])
    put_tree("tr_final", params)
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port's processes
# ---------------------------------------------------------------------------

def _rank_main(phase, rank, store, ref_path, out_dir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, WORLD), rank=rank,
        world_size=WORLD)
    try:
        {"ep": _rank_ep, "dec": _rank_dec, "tp": _rank_tp,
         "uv": _rank_uv, "pod": _rank_pod}[phase](
            rank, np.load(ref_path), out_dir)
    finally:
        dist.barrier()
        dist.destroy_process_group()


def _port_params(ref, tag, cfg):
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.models import model as TM
    template = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    leaves, treedef = tree_lib.flatten(template)
    new = []
    for i, t in enumerate(leaves):
        a = ref[f"{tag}_param_{i}"]
        assert a.shape == tuple(t.shape), (tag, i, a.shape, t.shape)
        new.append(torch.from_numpy(np.array(a)))
    return tree_lib.unflatten(treedef, new)


def _whole_grads(params, cfg, batch, ctx):
    """The params placed by the rules (train mode) as DTensors, the
    gradients of ``train_loss`` under ``ctx`` (each process its block,
    gathered whole here), and the loss."""
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import use_context
    from repro_torch.models import model as TM
    dparams = sh.param_shardings(params, ctx, mode="train")
    leaves = tree_lib.leaves(dparams)
    for p in leaves:
        p.requires_grad_(True)
    rows = {k: torch.from_numpy(sh.local_rows(v, ctx))
            for k, v in batch.items()}
    with use_context(ctx):
        loss, _ = TM.train_loss(dparams, cfg, rows)
        loss.backward()
    grads = [g.full_tensor() for g in (p.grad for p in leaves)]
    return float(loss.detach()), grads


def _gathered_rows(x, ctx):
    from repro_torch.distributed import compat
    from repro_torch.distributed.context import use_context
    with use_context(ctx):
        return compat.all_gather(x.detach().contiguous(), ctx.batch_axes, 0)


def _rank_ep(rank, ref, out_dir):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import context_for_mesh, make_mesh
    from repro_torch.models import moe as TMOE
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    ctx = context_for_mesh(make_mesh(*EP_MESH, device_type="cpu"))
    params = _port_params(ref, "ep", cfg)
    gaps, route = [], TMOE._route

    def recording(p, m, x2d):
        logits = x2d.float() @ p["router"]
        top = logits[:, :m.num_experts].detach().topk(m.top_k + 1, -1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return route(p, m, x2d)
    TMOE._route = recording
    blocks, body = [], TMOE._moe_ep_body

    def recording_body(x, router, w_gate, *a, **kw):
        blocks.append(tuple(w_gate.shape))
        return body(x, router, w_gate, *a, **kw)
    TMOE._moe_ep_body = recording_body
    inp = _inputs()
    loss, grads = _whole_grads(params, cfg, {"tokens": inp["ep_tokens"],
                                             "labels": inp["ep_labels"]}, ctx)
    import torch
    import torch.distributed as dist
    gap = torch.tensor(min(gaps))
    dist.all_reduce(gap, op=dist.ReduceOp.MIN)
    if rank == 0:
        np.savez(os.path.join(out_dir, "ep.npz"), loss=loss,
                 gap=float(gap), blocks=np.array(blocks),
                 **{f"grad_{i}": g.numpy()
                                    for i, g in enumerate(grads)})


def _rank_dec(rank, ref, out_dir):
    import dataclasses
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import use_context
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import context_for_mesh, make_mesh
    from repro_torch.models import model as TM
    inp = _inputs()
    res = {}
    mesh = make_mesh(*DEC_MESH, device_type="cpu")
    # flash-decode: the model on sequence chunks of the cache
    cfg = get_smoke_config("qwen3-32b")
    params = _port_params(ref, "dec", cfg)
    ctx = dataclasses.replace(context_for_mesh(mesh, flash_decode=True))
    with use_context(ctx), torch.no_grad():
        rows = sh.local_rows(inp["dec_prompt"], ctx)
        _, cache = TM.prefill(params, cfg, {"tokens": rows}, CACHE_LEN)
        cache = steps.seq_chunks(cache, ctx)
        assert cache["blocks"][0]["k"].shape[2] == CACHE_LEN // 4
        for t in range(2):
            logits, cache = TM.decode_step(
                params, cfg, sh.local_rows(inp["dec_tokens"][t], ctx),
                cache, PROMPT + t)
            res[f"dec_{t}"] = _gathered_rows(logits, ctx).numpy()
    # the serve steps: DTensor params (serve placement), global batch
    dparams = sh.param_shardings(params, ctx, mode="serve")
    with use_context(ctx):
        pred, cert, cache = steps.make_serve_prefill(cfg, CACHE_LEN)(
            dparams, {"tokens": inp["dec_prompt"]})
        for t in range(2):
            pred, cert, cache = steps.make_serve_decode(cfg)(
                dparams, cache, torch.from_numpy(inp["dec_tokens"][t]),
                PROMPT + t)
            res[f"serve_pred_{t}"] = pred.numpy()
            res[f"serve_cert_{t}"] = cert.numpy()
    # sequence-parallel forward and gradients, 6 heads over 4
    cfg = _sp_config(get_smoke_config)
    params = _port_params(ref, "sp", cfg)
    ctx = context_for_mesh(mesh)
    with use_context(ctx), torch.no_grad():
        logits, _ = TM.forward(params, cfg, {
            "tokens": torch.from_numpy(sh.local_rows(inp["sp_tokens"],
                                                        ctx))})
        res["sp_logits"] = _gathered_rows(logits, ctx).numpy()
    _, grads = _whole_grads(params, cfg, {"tokens": inp["sp_tokens"],
                                          "labels": inp["sp_labels"]}, ctx)
    res.update({f"sp_grad_{i}": g.numpy() for i, g in enumerate(grads)})
    if rank == 0:
        np.savez(os.path.join(out_dir, "dec.npz"), **res)


def _rank_tp(rank, ref, out_dir):
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import use_context
    from repro_torch.launch.mesh import context_for_mesh, make_mesh
    from repro_torch.models import model as TM
    ctx = context_for_mesh(make_mesh(*DEC_MESH, device_type="cpu"))
    res = {}
    for tag, arch, _ in TP_ARCHS:
        cfg = get_smoke_config(arch)
        params = _port_params(ref, tag, cfg)
        batch, steps = _tp_batch(cfg)
        dparams = sh.param_shardings(params, ctx, mode="serve")
        rows = {k: torch.from_numpy(sh.local_rows(v, ctx))
                for k, v in batch.items() if k != "labels"}
        with use_context(ctx), torch.no_grad():
            mine = sh.local_params(dparams)
            res[f"{tag}_share"] = (sum(t.numel() for t in
                                       tree_lib.leaves(mine))
                                   / sum(t.numel() for t in
                                         tree_lib.leaves(params)))
            if "attn" in mine["blocks"][0]:
                res[f"{tag}_wq"] = tuple(
                    mine["blocks"][0]["attn"]["wq"].shape)
            logits, _ = TM.forward(dparams, cfg, rows)
            res[f"{tag}_logits"] = _gathered_rows(logits, ctx).numpy()
            logits, cache = TM.prefill(dparams, cfg, rows, CACHE_LEN)
            res[f"{tag}_dec_p"] = _gathered_rows(logits, ctx).numpy()
            res[f"{tag}_cache"] = [tuple(t.shape) for t in
                                   tree_lib.leaves(cache["blocks"])][0]
            for t in range(2):
                logits, cache = TM.decode_step(
                    dparams, cfg, torch.from_numpy(
                        sh.local_rows(steps[t], ctx)), cache, PROMPT + t)
                res[f"{tag}_dec_{t}"] = _gathered_rows(logits, ctx).numpy()
        _, grads = _whole_grads(params, cfg, batch, ctx)
        res.update({f"{tag}_grad_{i}": g.numpy()
                    for i, g in enumerate(grads)})
    if rank == 0:
        np.savez(os.path.join(out_dir, "tp.npz"), **res)


def _rank_uv(rank, ref, out_dir):
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import use_context
    from repro_torch.launch import steps as serve
    from repro_torch.launch.mesh import context_for_mesh, make_mesh
    from repro_torch.models import model as TM
    ctx = context_for_mesh(make_mesh(*DEC_MESH, device_type="cpu"))
    widths, head = [], TM.lm_logits

    def recording(*a, **kw):
        out = head(*a, **kw)
        widths.append(out.shape[-1])
        return out
    TM.lm_logits = recording
    res = {}
    for tag, arch, _ in UV_ARCHS:
        cfg = _uv_config(get_smoke_config, arch)
        params = _port_params(ref, tag, cfg)
        batch, steps = _tp_batch(cfg)
        dparams = sh.param_shardings(params, ctx, mode="serve")
        rows = {k: torch.from_numpy(sh.local_rows(v, ctx))
                for k, v in batch.items() if k != "labels"}
        with use_context(ctx), torch.no_grad():
            logits, _ = TM.forward(dparams, cfg, rows)
            res[f"{tag}_logits"] = _gathered_rows(logits, ctx).numpy()
        with use_context(ctx):
            pred, cert, cache = serve.make_serve_prefill(cfg, CACHE_LEN)(
                dparams, {"tokens": batch["tokens"]})
            res[f"{tag}_pred_p"], res[f"{tag}_cert_p"] = pred, cert
            for t in range(2):
                pred, cert, cache = serve.make_serve_decode(cfg)(
                    dparams, cache, torch.from_numpy(steps[t]), PROMPT + t)
                res[f"{tag}_pred_{t}"], res[f"{tag}_cert_{t}"] = pred, cert
        res[f"{tag}_loss"], grads = _whole_grads(params, cfg, batch, ctx)
        res.update({f"{tag}_grad_{i}": g.numpy()
                    for i, g in enumerate(grads)})
    with open(os.path.join(out_dir, f"uv_widths_{rank}.json"), "w") as f:
        json.dump(sorted(set(widths)), f)
    if rank == 0:
        np.savez(os.path.join(out_dir, "uv.npz"),
                 **{k: np.asarray(v) for k, v in res.items()})


def _rank_pod(rank, ref, out_dir):
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import use_context
    from repro_torch.launch.mesh import context_for_mesh, make_mesh
    from repro_torch.launch.train import _place
    from repro_torch.training import (AdamWConfig, TrainStepConfig,
                                      init_opt_state, make_train_step)
    cfg = get_smoke_config("olmo-1b")
    ctx = context_for_mesh(make_mesh(*POD_MESH, device_type="cpu"))
    params = _port_params(ref, "tr", cfg)
    params, opt = _place(params, init_opt_state(params), ctx)
    step = make_train_step(cfg, AdamWConfig(**TRAIN_OPT),
                           TrainStepConfig(compress_pod_grads=True))
    inp = _inputs()
    losses = []
    with use_context(ctx):
        for t in range(TRAIN_STEPS):
            params, opt, metrics = step(params, opt, {
                "tokens": torch.from_numpy(inp["tr_tokens"][t]),
                "labels": torch.from_numpy(inp["tr_labels"][t])})
            losses.append(float(metrics["loss"]))
    whole = tree_lib.leaves(sh.gather_tree(params))
    shapes = [[tuple(m.shape), tuple(m.to_local().shape),
               [getattr(p, "dim", None) for p in m.placements]]
              for m in tree_lib.leaves(opt["m"])]
    with open(os.path.join(out_dir, f"pod_shapes_{rank}.json"), "w") as f:
        json.dump(shapes, f)
    if rank == 0:
        np.savez(os.path.join(out_dir, "pod.npz"), losses=np.array(losses),
                 **{f"final_{i}": t.detach().numpy()
                    for i, t in enumerate(whole)})


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax") / "ref.npz")
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    _run_all([[sys.executable, __file__, "jax", path]], env)
    return path


def _spawn(phase, ref_path, tmp_path):
    store = str(tmp_path / f"store_{phase}")
    env = _env(OMP_NUM_THREADS="1")
    _run_all([[sys.executable, __file__, "rank", phase, str(r), store,
               ref_path, str(tmp_path)] for r in range(WORLD)], env)
    return np.load(str(tmp_path / f"{phase}.npz"))


def _assert_grads(got, ref, rtol):
    """Each gradient leaf within ``rtol`` of its largest reference entry."""
    assert len(got) == len(ref) > 0
    for i, (g, r) in enumerate(zip(got, ref)):
        scale = max(float(np.abs(r).max()), 1e-12)
        err = float(np.abs(g - r).max())
        assert err <= rtol * scale, (i, err, scale)


def _leaves(npz, prefix):
    return [npz[f"{prefix}{i}"] for i in range(_count(npz, prefix))]


def _count(ref, prefix):
    return sum(1 for k in ref.files if k.startswith(prefix))


def test_ep_moe_train_loss_against_jax_ep(jax_ref, tmp_path):
    ref = np.load(jax_ref)
    got = _spawn("ep", jax_ref, tmp_path)
    assert float(got["gap"]) > ROUTER_NEAR, (
        f"a token's router logits lie within {float(got['gap'])} of a tie")
    assert abs(float(got["loss"]) - float(ref["ep_loss"])) <= 1e-5
    assert abs(float(got["loss"]) - float(ref["ep_loss_local"])) <= 2e-2
    _assert_grads(_leaves(got, "grad_"), _leaves(ref, "ep_grad_"), 1e-4)
    # each process's experts: 8 padded experts over 4, F 128 over 2
    assert {tuple(b) for b in got["blocks"]} == {(2, 128, 64)}


def test_tensor_parallel_layers_against_jax(jax_ref, tmp_path):
    ref = np.load(jax_ref)
    got = _spawn("tp", jax_ref, tmp_path)
    for tag, _, _ in TP_ARCHS:
        # the projections split four ways, the norms and router whole
        assert float(got[f"{tag}_share"]) < 0.35, (tag, got[f"{tag}_share"])
        for k in ("logits", "dec_p", "dec_0", "dec_1"):
            np.testing.assert_allclose(got[f"{tag}_{k}"], ref[f"{tag}_{k}"],
                                       atol=1e-5, rtol=0, err_msg=tag + k)
        _assert_grads(_leaves(got, f"{tag}_grad_"),
                      _leaves(ref, f"{tag}_grad_"), 1e-4)
    # olmo's cache (reps, B 2 of 4, C, KV 4 over 4, hd): its kv head;
    # falcon-mamba's conv state (reps, B, K - 1, Di 256 over 4)
    assert tuple(got["tpo_cache"])[3] == 1
    assert tuple(got["tpm_cache"])[-1] == 64
    # the query-heads layout (4 query heads, 2 kv heads over 4): one query
    # head's columns of wq (hd 32), a cache of both kv heads; danube's is
    # its ring of 20 slots (window 64 over CACHE_LEN)
    for tag in ("tpd", "tpq"):
        assert tuple(got[f"{tag}_wq"])[-1] == 32, tag
        assert tuple(got[f"{tag}_cache"])[1:4] == (2, CACHE_LEN, 2), tag


def test_flash_decode_and_seq_parallel_against_jax(jax_ref, tmp_path):
    ref = np.load(jax_ref)
    got = _spawn("dec", jax_ref, tmp_path)
    for t in range(2):
        np.testing.assert_allclose(got[f"dec_{t}"], ref[f"dec_flash_{t}"],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[f"dec_{t}"], ref[f"dec_dense_{t}"],
                                   atol=1e-4, rtol=0)
        # the serve steps pick JAX's greedy token wherever its top-2 gap
        # clears the guard
        jl = ref[f"dec_flash_{t}"]
        top = np.sort(jl, axis=-1)
        clear = top[:, -1] - top[:, -2] > ROUTER_NEAR
        assert clear.any()
        np.testing.assert_array_equal(got[f"serve_pred_{t}"][clear],
                                      jl.argmax(-1)[clear])
        np.testing.assert_allclose(got[f"serve_cert_{t}"],
                                   top[:, -1] - top[:, -2], atol=1e-4)
    np.testing.assert_allclose(got["sp_logits"], ref["sp_logits"],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(ref["sp_logits"], ref["sp_logits_local"],
                               atol=1e-5, rtol=0)
    _assert_grads(_leaves(got, "sp_grad_"), _leaves(ref, "sp_grad_"), 1e-4)


@pytest.fixture(scope="module")
def uneven_vocab(jax_ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("uv")
    got = _spawn("uv", jax_ref, tmp)
    widths = []
    for r in range(WORLD):
        with open(tmp / f"uv_widths_{r}.json") as f:
            widths.append(json.load(f))
    return got, widths


@pytest.mark.parametrize("tag", [t for t, _, _ in UV_ARCHS],
                         ids=[a for _, a, _ in UV_ARCHS])
def test_uneven_vocab_logits_in_padded_blocks_against_jax(jax_ref,
                                                          uneven_vocab, tag):
    ref = np.load(jax_ref)
    got, widths = uneven_vocab
    # every process's block is ceil(510 / 4) wide, as the reference's
    assert widths == [[128]] * WORLD
    assert 128 in ref["uv_widths"] and UV_VOCAB not in ref["uv_widths"]
    np.testing.assert_allclose(got[f"{tag}_logits"], ref[f"{tag}_logits"],
                               atol=1e-5, rtol=0)
    assert got[f"{tag}_logits"].shape[-1] == UV_VOCAB
    assert abs(float(got[f"{tag}_loss"]) - float(ref[f"{tag}_loss"])) <= 1e-5
    _assert_grads(_leaves(got, f"{tag}_grad_"),
                  _leaves(ref, f"{tag}_grad_"), 1e-4)
    for k in ("p", "0", "1"):
        # JAX's greedy token wherever its top-2 gap clears the guard
        jl = ref[f"{tag}_dec_{k}"]
        top = np.sort(jl, axis=-1)
        clear = top[:, -1] - top[:, -2] > ROUTER_NEAR
        assert clear.any()
        np.testing.assert_array_equal(got[f"{tag}_pred_{k}"][clear],
                                      jl.argmax(-1)[clear])
        np.testing.assert_allclose(got[f"{tag}_cert_{k}"],
                                   top[:, -1] - top[:, -2], atol=1e-4)


def test_pod_int8_exchange_and_zero1_train_against_jax(jax_ref, tmp_path):
    ref = np.load(jax_ref)
    got = _spawn("pod", jax_ref, tmp_path)
    losses = got["losses"]
    assert abs(losses[0] - float(ref["tr_loss_0"])) <= 1e-4
    for t in range(1, TRAIN_STEPS):
        assert abs(losses[t] - float(ref[f"tr_loss_{t}"])) <= 1e-3
    for i in range(_count(ref, "tr_final_")):
        np.testing.assert_allclose(got[f"final_{i}"], ref[f"tr_final_{i}"],
                                   atol=1e-3, rtol=0)
    split = 0
    for r in range(WORLD):
        with open(tmp_path / f"pod_shapes_{r}.json") as f:
            for glob, loc, dims in json.load(f):
                if dims[0] is not None:       # the pod axis is mesh dim 0
                    split += 1
                    assert loc[dims[0]] * 2 <= glob[dims[0]]
    assert split > 0


def test_train_launcher_mesh_resume_and_jax_checkpoint(tmp_path):
    """``launch/train.py --mesh 2x2x2 --compress-pod-grads`` over 8 gloo
    processes: the loss falls; resuming from its step-2 checkpoint gives
    the uninterrupted run's step-4 checkpoint bit for bit; that checkpoint
    loads in the JAX ``CheckpointManager``."""
    import shutil
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.train",
            "--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--mesh",
            "2x2x2", "--compress-pod-grads", "--batch", "8", "--seq", "16",
            "--lr", "1e-2", "--log-every", "1", "--ckpt-every", "2"]
    env = _env(OMP_NUM_THREADS="1")
    full, part = tmp_path / "full", tmp_path / "part"
    out = _run_all([base + ["--steps", "6", "--ckpt-dir", str(full)]],
                   env)[0]
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if "loss=" in line]
    assert len(losses) == 6 and losses[-1] < losses[0], out[-2000:]
    shutil.copytree(full / "step_000000002", part / "step_000000002")
    (part / "LATEST").write_text("step_000000002")
    _run_all([base + ["--steps", "4", "--ckpt-dir", str(part), "--resume"]],
             env)
    a = np.load(full / "step_000000004" / "arrays.npz")
    b = np.load(part / "step_000000004" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    probe = (
        "import jax, numpy as np\n"
        "from repro.checkpoint import CheckpointManager\n"
        "from repro.configs import get_smoke_config\n"
        "from repro.models import model as JM\n"
        "from repro.training import init_opt_state\n"
        "p = JM.init_params(get_smoke_config('qwen2-0.5b'), "
        "jax.random.PRNGKey(0))\n"
        f"(p, o), meta = CheckpointManager({str(full)!r}).restore("
        "(p, init_opt_state(p)), step=4)\n"
        "print(meta['step'], len(jax.tree.leaves((p, o))), "
        "int(o['step']))\n")
    res = subprocess.run([sys.executable, "-c", probe], env=_env(
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"), cwd=ROOT,
        capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    step, n, opt_step = res.stdout.split()
    assert (int(step), int(n), int(opt_step)) == (4, len(a.files), 4)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(sys.argv[2])
    else:
        _rank_main(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5],
                   sys.argv[6])
