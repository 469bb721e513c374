"""The port's dry-run (``repro_torch/launch/dryrun.py``), its cost counter
(``profiling/trace_cost.py``) and roofline (``profiling/roofline.py``).

Each trace over a process group runs in a subprocess (the dry-run's fake
group is global to a process); the counter's own cases run here, on real
CPU tensors where no group is needed, and the kernel wrappers' on fake
ones, the only tensors a charged call takes.

* FLOP parity with the JAX HLO count: the reference's ``run_cell``
  (``repro.launch.dryrun``: ``launch.steps``, ``_with_shardings``,
  ``_batch_pspecs``, ``hlo_cost.analyze_hlo_text``) lowered on an Auto
  ``jax.sharding.Mesh`` of 8 host devices (as ``tests/
  test_torch_distributed.py`` builds its meshes; its production mesh and
  config lookups pointed at that mesh and the smoke configs), against the
  port's ``trace_cell`` on a fake mesh of the same shape, B 8 x S 64 (also
  S 62 on (2, 4)). The port's FLOPs equal JAX's minus the differences
  named in ``_named``, within 1 %:

  - ``embed``: under a mesh the reference embeds by a one-hot product
    (``repro/models/common.py:160-162``), 2 x tokens x vocab block x D;
    the port gathers rows. In a train step its weight gradient is a
    second such product.
  - ``loss``: the reference's one-hot ``einsum`` for the gold logit
    (``common.py:185-187``), 2 x tokens x vocab block; the port gathers.
  - ``shared_gate``: the gradient of the MoE shared expert's (D, 1) gate
    product with respect to its input is an outer product, which XLA
    writes as a broadcast multiply, not a ``dot``; the port's ``mm``
    counts 2 x tokens x D per MoE layer.
  Attention names no difference: where the query heads tile the model
  axis, both packages attend with this process's query heads over the
  whole sequence (the port over the kv heads they read), and the
  cases here all have such heads.

* ``TraceCost`` by hand: one matmul, a stacked weight read one layer at a
  time, an indexed read, an in-place cache-row write, the peak of live
  storages, each collective kind in the reference's operand convention
  (over groups of 4 and 2), a functional collective, a DTensor op
  counted at its local block, and the bytes of groups that span more than
  one 8-rank NVLink node.
* Each kernel wrapper under the counter, on fake tensors: its formula's
  FLOPs and bytes, nothing from its plain version, outputs (and the
  backward's gradients) of the kernel's shapes; a charged call on real
  tensors raises, and another thread sees no counter.
* ``compat.local_shape_and_offset`` under ``FakeTensorMode`` equals torch's
  helper on real tensors (which raises on fakes), every rank of a
  (2, 2, 4) mesh.
* ``RooflineReport`` math on the H100's constants.
* A vocab that does not tile the model axis (smoke qwen2, tied, and
  falcon-mamba, untied, at V 510 on (2, 4), a train step): the traced
  logits are ceil(510 / 4) = 128 columns wide, and the peak, the FLOPs
  and the bytes fall below the same cell's with the logits whole on
  every process (``models/common.py`` ``vocab_blocks`` forced to one
  block, the split before padded blocks).
* Production-mesh cells through ``run_cell``: olmo-1b decode_32k on both
  meshes, falcon-mamba-7b long_500k, llama4-maverick train_4k single,
  olmo-1b train_4k on both (the multi-pod moments ZeRO-1 over 'pod'), and
  every skip with the reference's reason; the CLI on two cells.
"""
import json
import math
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import counts
from repro_torch.kernels import ref as kref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.top2gap import top2gap
from repro_torch.profiling import hw
from repro_torch.profiling.roofline import RooflineReport
from repro_torch.profiling.trace_cost import TraceCost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def _run(code: str, env_extra=None) -> dict:
    """Run ``code`` in a fresh interpreter; its last stdout line is JSON."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.update(env_extra or {})
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# FLOP parity with the JAX HLO count
# ---------------------------------------------------------------------------

# name, arch, kind, seq, batch, mesh
CASES = [
    ("qwen2_prefill", "qwen2-0.5b", "prefill", 64, 8, (4, 2)),
    ("qwen2_train", "qwen2-0.5b", "train", 64, 8, (4, 2)),
    ("qwen2_decode", "qwen2-0.5b", "decode", 64, 8, (4, 2)),
    ("mamba_prefill", "falcon-mamba-7b", "prefill", 64, 8, (4, 2)),
    ("moe_train", "qwen2-moe-a2.7b", "train", 64, 8, (4, 2)),
    ("seamless_prefill", "seamless-m4t-large-v2", "prefill", 64, 8, (4, 2)),
    ("qwen2_prefill_2x4", "qwen2-0.5b", "prefill", 64, 8, (2, 4)),
    ("qwen2_prefill_2x4_s62", "qwen2-0.5b", "prefill", 62, 8, (2, 4)),
    ("qwen2_train_2x4", "qwen2-0.5b", "train", 64, 8, (2, 4)),
]

_JAX = """
import json, os, sys
import jax, numpy as np
jax.devices()   # 8 host devices, before the reference module sets 512
from jax.sharding import Mesh
import repro.launch.dryrun as D
from repro.configs import get_smoke_config
from repro.configs.shapes import ShapeCell
out = {}
for name, arch, kind, seq, batch, dims in json.loads(sys.argv[1]):
    axes = ("pod", "data", "model")[-len(dims):]
    mesh = Mesh(np.array(jax.devices()).reshape(dims), axes)
    D.make_production_mesh = lambda multi_pod=False, mesh=mesh: mesh
    D.get_config = get_smoke_config
    D.SHAPES = {name: ShapeCell(name, kind, seq, batch)}
    row = D.run_cell(arch, name, "single")
    assert row["status"] == "ok", row.get("traceback")
    out[name] = row["hlo_flops"]
print(json.dumps(out))
"""

_PORT = """
import json, sys
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch.dryrun import trace_cell
out = {}
for name, arch, kind, seq, batch, dims in json.loads(sys.argv[1]):
    cost, _, _ = trace_cell(get_smoke_config(arch),
                            ShapeCell(name, kind, seq, batch), dims, "cpu")
    out[name] = [cost.flops, cost.kernel_calls]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def parity():
    cases = json.dumps(CASES)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    res = {}
    for tag, code in (("jax", _JAX), ("port", _PORT)):
        out = subprocess.run([sys.executable, "-c", code, cases], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=TIMEOUT)
        assert out.returncode == 0, out.stderr[-4000:]
        res[tag] = json.loads(out.stdout.strip().splitlines()[-1])
    return res


def _named(arch, kind, seq, batch, dims):
    """The named differences (module docstring): {name: JAX's FLOPs minus
    the port's}."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    n_model = dims[-1]
    rows = batch // math.prod(dims[:-1])
    tokens = rows * (1 if kind == "decode" else seq)
    vocab = cfg.vocab_size // n_model if cfg.vocab_size % n_model == 0 \
        else cfg.vocab_size
    embed = 2 * tokens * vocab * cfg.d_model
    out = {"embed": embed * (2 if kind == "train" else 1)}
    if kind == "train":
        out["loss"] = 2 * tokens * vocab
    if kind == "train" and cfg.moe is not None and cfg.moe.num_shared_experts:
        out["shared_gate"] = -2 * tokens * cfg.d_model * cfg.num_layers
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flops_equal_the_jax_hlo_count_less_the_named_differences(parity,
                                                                   case):
    name, arch, kind, seq, batch, dims = case
    jax_flops = parity["jax"][name]
    port_flops, calls = parity["port"][name]
    named = _named(arch, kind, seq, batch, dims)
    assert port_flops == pytest.approx(jax_flops - sum(named.values()),
                                       rel=0.01), (jax_flops, port_flops,
                                                   named)
    # every attention / scan layer went through its charged kernel
    assert calls.get("top2gap", 0) == (0 if kind == "train" else 1)
    assert sum(calls.values()) > 1


def test_the_known_figures_are_reproduced(parity):
    """qwen2 smoke on (4, 2): prefill 92,405,760 (JAX) against 84,017,152
    (the port), train 360,775,680 against 343,932,928; on (2, 4) the gap
    is the embedding's alone (module docstring)."""
    assert parity["jax"]["qwen2_prefill"] == 92_405_760
    assert parity["port"]["qwen2_prefill"][0] == 84_017_152
    assert parity["jax"]["qwen2_train"] == 360_775_680
    assert parity["port"]["qwen2_train"][0] == 343_932_928
    gap = (parity["jax"]["qwen2_prefill_2x4"]
           - parity["port"]["qwen2_prefill_2x4"][0])
    assert gap == 8_388_608


# ---------------------------------------------------------------------------
# TraceCost by hand (real CPU tensors, no process group)
# ---------------------------------------------------------------------------

def test_matmul_flops_and_bytes():
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    with TraceCost() as cost:
        a @ b
    assert cost.flops == 2 * 64 * 32 * 16
    assert cost.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert counts.counter() is None


def test_stacked_weight_read_one_layer_at_a_time_costs_the_layer():
    reps, d = 8, 32
    stack, x = torch.ones(reps, d, d), torch.ones(16, d)
    with TraceCost() as cost:
        for i in range(reps):
            x = x @ stack[i]
    assert cost.flops == reps * 2 * 16 * d * d
    # each product reads its layer's slice, not the (reps, d, d) stack;
    # the select views move nothing
    assert cost.bytes == reps * (16 * d + d * d + 16 * d) * 4


def test_indexed_read_reads_the_rows_it_returns():
    table, idx = torch.ones(1000, 64), torch.arange(8)
    with TraceCost() as cost:
        torch.nn.functional.embedding(idx, table)
    assert cost.bytes == 8 * 8 + 2 * 8 * 64 * 4


def test_in_place_cache_row_write_costs_the_rows():
    cache = torch.zeros(4, 128, 2, 8, dtype=torch.bfloat16)
    new = torch.ones(4, 2, 8, dtype=torch.bfloat16)
    rows, slot = torch.arange(4), torch.tensor([3, 9, 0, 127])
    with TraceCost() as cost:
        cache[rows, slot] = new
    # the two index vectors, the values read, the rows written: not the
    # 16 KiB cache
    assert cost.bytes == 2 * 4 * 8 + 2 * (4 * 2 * 8 * 2)
    assert cost.peak_live == 0     # in place: nothing new


def test_peak_counts_live_storages_and_the_arguments():
    with TraceCost(argument_bytes=1000) as cost:
        a = torch.ones(256)          # 1 KiB
        b = a * 2                    # 1 KiB
        del a
        c = b + 1                    # 1 KiB, a freed
        d = c.view(16, 16)           # a view: no storage
        del b, c, d
    assert cost.peak_live == 2 * 1024
    assert cost.peak_memory_bytes == 1000 + 2 * 1024
    assert cost.live == 0


_COLLECTIVES = """
import json, torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._functional_collectives import all_reduce as f_ar
from repro_torch.distributed import compat
from repro_torch.profiling.trace_cost import TraceCost
compat.fake_process_group(8, rank=7)
mesh = compat.init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
model, data = mesh.get_group("model"), mesh.get_group("data")
out = {}
def count(fn):
    with FakeTensorMode():
        x = torch.ones(16)
        with TraceCost() as cost:
            fn(x)
    return {k: v for k, v in cost.collective.items() if v}, cost.bytes
out["all-reduce"] = count(lambda x: dist.all_reduce(x, group=model))
out["all-gather"] = count(lambda x: dist.all_gather(
    [torch.empty(16) for _ in range(4)], x, group=model))
out["all-gather-2"] = count(lambda x: dist.all_gather(
    [torch.empty(16) for _ in range(2)], x, group=data))
out["reduce-scatter"] = count(lambda x: dist.reduce_scatter_tensor(
    torch.empty(4), x, group=model))
out["all-to-all"] = count(lambda x: dist.all_to_all_single(
    torch.empty(16), x, group=model))
out["functional"] = count(lambda x: f_ar(x, "sum", model))
# a DTensor op is counted at its local block
with FakeTensorMode():
    d = compat.distribute_tensor(torch.ones(8, 8), mesh,
                                 [compat.Shard(0), compat.Replicate()])
    with TraceCost() as cost:
        d + d
out["dtensor_add"] = [{}, cost.bytes]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def collectives():
    return _run(_COLLECTIVES)


# operand convention: all-gather result / group, reduce-scatter result x
# group, the rest the result; a 16-element f32 vector is 64 bytes
@pytest.mark.parametrize("case,kind,operand,result", [
    ("all-reduce", "all-reduce", 64, 64),
    ("all-gather", "all-gather", 64, 256),       # group of 4
    ("all-gather-2", "all-gather", 64, 128),     # group of 2
    ("reduce-scatter", "reduce-scatter", 64, 16),
    ("all-to-all", "all-to-all", 64, 64),
    ("functional", "all-reduce", 64, 64),
])
def test_collective_bytes_in_the_operand_convention(collectives, case, kind,
                                                    operand, result):
    coll, nbytes = collectives[case]
    assert coll == {kind: operand}
    assert nbytes == operand + result


def test_a_dtensor_op_is_counted_at_its_local_block(collectives):
    # (8, 8) f32 sharded over 2 data processes: a (4, 8) block, read twice
    # and written once
    assert collectives["dtensor_add"][1] == 3 * 4 * 8 * 4


_CROSS_NODE = """
import json, torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.distributed import compat
from repro_torch.profiling.roofline import t_collective_by_domain
from repro_torch.profiling.trace_cost import TraceCost
compat.fake_process_group(32, rank=31)
mesh = compat.init_device_mesh("cpu", (2, 2, 8),
                               mesh_dim_names=("pod", "data", "model"))
out = {}
for ax in ("pod", "data", "model"):
    with FakeTensorMode():
        x = torch.ones(16)
        with TraceCost() as cost:
            dist.all_reduce(x, group=mesh.get_group(ax))
    out[ax] = [cost.collective_cross_node, t_collective_by_domain(cost)]
print(json.dumps(out))
"""


def test_groups_across_nvlink_nodes_are_charged_at_the_network_rate():
    res = _run(_CROSS_NODE)
    # rank 31's 'model' group is ranks 24-31, one 8-GPU node; its 'pod'
    # pair (15, 31) and 'data' pair (23, 31) span two nodes
    assert res["model"] == [0, pytest.approx(64 / hw.ICI_BW)]
    for ax in ("pod", "data"):
        assert res[ax] == [64, pytest.approx(64 / hw.DCN_BW)]


# ---------------------------------------------------------------------------
# the kernel wrappers, charged as their kernels
# ---------------------------------------------------------------------------

def _nb(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _fake(*tensors):
    """Fakes of ``tensors`` (their shapes, dtypes and requires_grad) in a
    new ``FakeTensorMode``, and the mode."""
    mode = FakeTensorMode()
    return mode, [mode.from_tensor(t) for t in tensors]


def _charged_only(cost, *names):
    """Only the kernels' rows: nothing of the plain versions."""
    assert {n for _, n in cost.top_contributors(100, "bytes")} <= {
        f"x{cost.kernel_calls[k]} kernel:{k}" for k in names}
    assert cost.kernel_calls == {k: cost.kernel_calls[k] for k in names}


def test_top2gap_is_charged_as_its_kernel():
    mode, (scores,) = _fake(torch.randn(4, 50))
    with mode, TraceCost() as cost:
        gap, idx = top2gap(scores)
    assert (gap.shape, gap.dtype) == ((4,), torch.float32)
    assert (idx.shape, idx.dtype) == ((4,), torch.int32)
    assert cost.flops == 0
    assert cost.bytes == _nb(scores) + 4 * 4 + 4 * 4
    assert cost.kernel_calls == {"top2gap": 1}
    _charged_only(cost, "top2gap")


# a length tensor is fake, with no values: the whole cache is charged
@pytest.mark.parametrize("valid,rows", [(torch.tensor([5, 16],
                                                      dtype=torch.int32),
                                         32), (7, 14)])
def test_decode_attention_reads_the_valid_rows(valid, rows):
    mode, (q, k, v) = _fake(torch.randn(2, 4, 32), torch.randn(2, 16, 2, 32),
                            torch.randn(2, 16, 2, 32))
    if isinstance(valid, torch.Tensor):
        valid = mode.from_tensor(valid)
    with mode, TraceCost() as cost:
        out, lse = decode_attention(q, k, v, valid, return_lse=True)
    assert (out.shape, lse.shape) == (q.shape, (2, 4))
    assert lse.dtype == torch.float32
    assert cost.flops == 4 * 2 * 16 * 4 * 32
    idx = _nb(valid) if isinstance(valid, torch.Tensor) else 0
    assert cost.bytes == (_nb(q, out, lse) + idx
                          + 2 * rows * 2 * 32 * 4)
    _charged_only(cost, "decode_attention")


def test_flash_attention_forward_and_backward_are_charged():
    mode, (q, k, v, dout) = _fake(
        torch.randn(2, 8, 4, 32, requires_grad=True),
        torch.randn(2, 8, 2, 32, requires_grad=True),
        torch.randn(2, 8, 2, 32, requires_grad=True), torch.randn(2, 8, 4, 32))
    with mode, TraceCost() as cost:
        out = flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad(out, (q, k, v), dout)
    assert out.shape == q.shape
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    pairs = 4.0 * 2 * 8 * 8 * 4 * 32
    assert cost.kernel_calls == {"flash_attention": 1,
                                 "flash_attention_bwd": 1}
    assert cost.flops == pairs + 2 * pairs
    # the forward writes each row's log-sum-exp, (B, H, S) f32, and the
    # backward reads it
    lse = 2 * 4 * 8 * 4
    assert cost.bytes == (_nb(q, k, v, out) + lse
                          + _nb(q, k, v, out, dout) + lse + _nb(q, k, v))
    _charged_only(cost, "flash_attention", "flash_attention_bwd")


def test_mamba_scan_forward_and_backward_are_charged():
    b, s, di, n = 1, 6, 8, 4
    mode, (dt, a, bm, cm, d, x, dy) = _fake(
        torch.rand(b, s, di, requires_grad=True), -torch.rand(di, n),
        torch.randn(b, s, n), torch.randn(b, s, n), torch.ones(di),
        torch.randn(b, s, di, requires_grad=True), torch.randn(b, s, di))
    with mode, TraceCost() as cost:
        y, h = mamba_scan(dt, a, bm, cm, d, x)
        ddt, dx = torch.autograd.grad(y, (dt, x), dy)
    assert (y.shape, y.dtype) == ((b, s, di), torch.float32)
    assert (h.shape, h.dtype) == ((b, di, n), torch.float32)
    assert (ddt.shape, dx.shape) == (dt.shape, x.shape)
    assert cost.kernel_calls == {"mamba_scan": 1, "mamba_scan_bwd": 1}
    assert cost.flops == 2 * b * s * di * n + 4 * b * s * di * n
    # the forward writes the state entering each 32-step chunk, (B,
    # ceil(S / 32), Di, N) f32, and the backward reads it
    states = 4 * b * -(-s // 32) * di * n
    fwd = _nb(dt, a, bm, cm, d, x, y, h) + states
    bwd = _nb(dt, a, bm, cm, d, x, dy) + states + _nb(dt, a, bm, cm, d, x)
    assert cost.bytes == fwd + bwd
    _charged_only(cost, "mamba_scan", "mamba_scan_bwd")


def test_mamba_decode_charges_its_two_step_kernels():
    """The SSM mixer's decode step on fakes: each step kernel charged once
    (FLOPs: the jnp decode's two einsums; bytes: each input read once, the
    outputs written once and the conv and SSM states written back), beside
    the four projections' matrix products and nothing of the recurrence's
    plain ops; nothing launched."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.mamba_step import (mamba_conv_step,
                                                mamba_ssm_step)
    from repro_torch.models import mamba as TMB
    cfg = get_smoke_config("falcon-mamba-7b")
    b, d, di, n, k, r = 3, cfg.d_model, 256, cfg.ssm.d_state, 4, 8
    g = torch.Generator().manual_seed(0)
    p = TMB.make_mamba_params(
        cfg, lambda shape: torch.randn(shape, generator=g),
        lambda shape, lo, hi: torch.rand(shape, generator=g),
        lambda shape, v, dtype: torch.full(shape, v, dtype=dtype),
        torch.float32)
    names = sorted(p)
    mode, fakes = _fake(*(p[k_] for k_ in names), torch.randn(b, 1, d),
                        torch.randn(b, k - 1, di), torch.randn(b, di, n))
    fp = dict(zip(names, fakes))
    x, conv, ssm = fakes[-3:]
    launches = (mamba_conv_step.launches, mamba_ssm_step.launches)
    with mode, TraceCost() as cost:
        out, cache = TMB.mamba_decode(fp, cfg, x, {"conv": conv,
                                                   "ssm": ssm})
    assert (out.shape, out.dtype) == ((b, 1, d), torch.float32)
    assert cache["conv"] is conv and cache["ssm"] is ssm
    assert cost.kernel_calls == {"mamba_conv_step": 1, "mamba_ssm_step": 1}
    assert (mamba_conv_step.launches, mamba_ssm_step.launches) == launches
    matmuls = 2 * b * (d * 2 * di + di * (r + 2 * n) + r * di + di * d)
    assert cost.flops == matmuls + 2 * b * k * di + 2 * b * di * n
    rows = {name: v for v, name in cost.top_contributors(100, "bytes")}
    vec = b * di * 4                          # one (B, 1, Di) f32 tensor
    assert rows["x1 kernel:mamba_conv_step"] == (
        _nb(fp["conv_w"], fp["conv_b"]) + 2 * vec + 2 * _nb(conv))
    assert rows["x1 kernel:mamba_ssm_step"] == (
        _nb(fp["dt_proj_b"], fp["A_log"], fp["D"]) + 4 * vec
        + 2 * b * n * 4 + 2 * _nb(ssm))
    assert {name.split(" ", 1)[1] for name in rows} <= {
        "kernel:mamba_conv_step", "kernel:mamba_ssm_step", "aten.mm",
        "aten._unsafe_view"}


def test_a_charged_call_on_real_tensors_raises():
    with TraceCost():
        with pytest.raises(RuntimeError, match="fake tensors only"):
            top2gap(torch.randn(3, 9))


def test_another_thread_sees_no_counter():
    scores = torch.randn(3, 9, generator=torch.Generator().manual_seed(5))
    seen = {}

    def other():
        seen["counter"] = counts.counter()
        seen["out"] = top2gap(scores)
    with TraceCost() as cost:
        assert counts.counter() is cost
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert seen["counter"] is None and cost.kernel_calls == {}
    want = kref.top2gap_ref(scores)
    assert all(torch.equal(a, b) for a, b in zip(seen["out"], want))


def test_without_a_counter_the_wrappers_run_their_plain_versions():
    scores = torch.randn(3, 9, generator=torch.Generator().manual_seed(4))
    assert counts.counter() is None
    gap, idx = top2gap(scores)
    want = kref.top2gap_ref(scores)
    assert torch.equal(gap, want[0]) and torch.equal(idx, want[1])


# ---------------------------------------------------------------------------
# local_shape_and_offset on fake tensors
# ---------------------------------------------------------------------------

_OFFSETS = """
import itertools, json, torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor._utils import \\
    compute_local_shape_and_global_offset as torch_helper
from repro_torch.distributed import compat
S, R = compat.Shard, compat.Replicate
PLACES = [[S(0), R(), S(1)], [S(0), S(0), R()], [R(), S(1), S(1)],
          [S(1), S(0), S(0)], [R(), R(), S(0)]]
SHAPES = [(8, 12), (5, 7), (3, 2), (16, 4)]
bad, raised = [], 0
for rank in range(16):
    compat.fake_process_group(16, rank=rank)
    mesh = compat.init_device_mesh("cpu", (2, 2, 4),
                                   mesh_dim_names=("pod", "data", "model"))
    for shape, pl in itertools.product(SHAPES, PLACES):
        want = tuple(map(tuple, torch_helper(shape, mesh, pl)))
        with FakeTensorMode():
            got = compat.local_shape_and_offset(shape, mesh, pl)
            try:
                torch_helper(shape, mesh, pl)
            except Exception:
                raised += 1
        if got != want:
            bad.append([rank, shape, str(pl), got, want])
    dist.destroy_process_group()
print(json.dumps({"bad": bad, "raised": raised,
                  "n": 16 * len(SHAPES) * len(PLACES)}))
"""


def test_local_shape_and_offset_on_fake_tensors_equals_the_real_value():
    res = _run(_OFFSETS)
    assert res["bad"] == []
    # torch's helper itself raises under fake tensors (the ZeRO-1 trap)
    assert res["raised"] == res["n"] > 0


# ---------------------------------------------------------------------------
# roofline math
# ---------------------------------------------------------------------------

def test_roofline_report_math():
    rep = RooflineReport(
        arch="x", shape="train_4k", mesh="single", chips=256,
        hlo_flops=1e12, hlo_bytes=1e10, collective_bytes=1e10,
        collective_breakdown={}, model_flops_total=200e12,
        model_bytes_total=1e12)
    assert rep.t_compute == pytest.approx(1e12 / hw.PEAK_FLOPS_BF16)
    assert rep.t_memory == pytest.approx(1e10 / hw.HBM_BW)
    assert rep.t_collective == pytest.approx(1e10 / hw.ICI_BW)
    assert rep.dominant == "collective"
    assert rep.bound_time == rep.t_collective
    assert rep.useful_flops_ratio == pytest.approx(200e12 / (1e12 * 256))
    useful = max(200e12 / (256 * hw.PEAK_FLOPS_BF16),
                 1e12 / (256 * hw.HBM_BW))
    d = rep.to_dict()
    assert d["roofline_fraction"] == pytest.approx(useful / rep.t_collective)
    from repro.profiling.roofline import RooflineReport as JaxReport
    jd = JaxReport(**{k: getattr(rep, k) for k in (
        "arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes",
        "collective_bytes", "collective_breakdown", "model_flops_total",
        "model_bytes_total")}).to_dict()
    assert list(jd) == list(d)      # the reference's keys, in its order


def test_h100_constants_beside_the_v5e_ones():
    from repro.profiling import hw as jhw
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "HBM_BYTES", "ICI_BW",
                 "DCN_BW", "CHIPS_PER_POD"):
        assert hasattr(hw, name), name
    assert hw.CHIPS_PER_POD == jhw.CHIPS_PER_POD == 256
    assert hw.DCN_BW == 50e9 and hw.NVLINK_DOMAIN == 8
    assert hw.SMEM_BYTES_PER_SM == 228 * 1024 and hw.L2_BYTES == 50 * 2 ** 20


# ---------------------------------------------------------------------------
# a vocab that does not tile the model axis
# ---------------------------------------------------------------------------

UNEVEN_ARCHS = ("qwen2-0.5b", "falcon-mamba-7b")

_UNEVEN = """
import dataclasses, json
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch.dryrun import trace_cell
from repro_torch.models import common, model
widths, head, padded = [], model.lm_logits, common.vocab_blocks

def recording(*a, **kw):
    out = head(*a, **kw)
    widths.append(out.shape[-1])
    return out
model.lm_logits = recording
out = {}
for arch in ARCHS:
    cfg = dataclasses.replace(get_smoke_config(arch), vocab_size=510)
    for tag, blocks in (("padded", padded),
                        ("whole", lambda vocab: (1, vocab, 0, vocab))):
        common.vocab_blocks = blocks
        widths.clear()
        cost, _, _ = trace_cell(cfg, ShapeCell("train", "train", 64, 8),
                                (2, 4), "cpu")
        out[f"{arch}_{tag}"] = [cost.peak_memory_bytes, cost.flops,
                                cost.bytes, sorted(set(widths))]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def uneven():
    return _run(f"ARCHS = {UNEVEN_ARCHS!r}\n" + _UNEVEN)


@pytest.mark.parametrize("arch", UNEVEN_ARCHS)
def test_uneven_vocab_traces_padded_logit_blocks(uneven, arch):
    peak, flops, nbytes, widths = uneven[f"{arch}_padded"]
    w_peak, w_flops, w_bytes, w_widths = uneven[f"{arch}_whole"]
    assert widths == [128] and w_widths == [510]
    assert peak < w_peak and flops < w_flops and nbytes < w_bytes


# ---------------------------------------------------------------------------
# production-mesh cells
# ---------------------------------------------------------------------------

CELLS = [("olmo-1b", "decode_32k", "single"), ("olmo-1b", "decode_32k",
                                               "multi"),
         ("falcon-mamba-7b", "long_500k", "single"),
         ("llama4-maverick-400b-a17b", "train_4k", "single"),
         ("olmo-1b", "train_4k", "single"), ("olmo-1b", "train_4k",
                                             "multi")]

_CELLS = """
import json, sys
from repro_torch.launch.dryrun import run_cell
rows = [run_cell(a, s, m, device="cpu") for a, s, m in json.loads(sys.argv[1])]
print(json.dumps(rows))
"""


@pytest.fixture(scope="module")
def cells():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _CELLS, json.dumps(CELLS)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    rows = json.loads(out.stdout.strip().splitlines()[-1])
    return {(r["arch"], r["shape"], r["mesh"]): r for r in rows}


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_production_cell_traces(cells, cell):
    row = cells[cell]
    assert row["status"] == "ok", row.get("traceback")
    assert row["chips"] == (512 if cell[2] == "multi" else 256)
    assert row["hlo_flops"] > 0 and row["hlo_bytes"] > 0
    assert row["dominant"] in ("compute", "memory", "collective")
    assert row["peak_memory_bytes"] > row["memory_analysis"][
        "argument_size_in_bytes"] > 0
    assert row["collective_bytes"] == sum(
        row["collective_breakdown"].values()) > 0
    # every group of the production meshes spans more than one 8-GPU node
    assert row["collective_bytes_cross_node"] == row["collective_bytes"]
    assert row["t_collective_by_domain"] == pytest.approx(
        row["collective_bytes"] / hw.DCN_BW)


def test_production_cells_charge_their_kernels(cells):
    from repro_torch.configs import get_config
    olmo = get_config("olmo-1b")
    assert cells[("olmo-1b", "decode_32k", "single")]["kernel_calls"] == {
        "decode_attention": olmo.num_layers, "top2gap": 1}
    # the SSM's decode step: its conv and its recurrence, a kernel each
    mamba = get_config("falcon-mamba-7b")
    assert cells[("falcon-mamba-7b", "long_500k", "single")][
        "kernel_calls"] == {"mamba_conv_step": mamba.num_layers,
                            "mamba_ssm_step": mamba.num_layers,
                            "top2gap": 1}
    llama = get_config("llama4-maverick-400b-a17b")
    # remat: the forward twice, the backward once a layer
    assert cells[("llama4-maverick-400b-a17b", "train_4k", "single")][
        "kernel_calls"] == {"flash_attention": 2 * llama.num_layers,
                            "flash_attention_bwd": llama.num_layers}


def test_multi_pod_halves_the_work_and_splits_the_moments(cells):
    single = cells[("olmo-1b", "train_4k", "single")]
    multi = cells[("olmo-1b", "train_4k", "multi")]
    assert multi["hlo_flops"] == pytest.approx(single["hlo_flops"] / 2,
                                               rel=0.01)
    # the arguments a device holds: bf16 params in (data x model) blocks,
    # the two f32 moments the same, and on the multi-pod mesh also split
    # over 'pod' (ZeRO-1) wherever a dim is left: every leaf but the
    # embedding, whose two dims are both split already; AdamW's step
    # count (4 B); int32 tokens and labels by rows
    from repro_torch.configs import get_config
    cfg = get_config("olmo-1b")
    p, e = cfg.param_count(), cfg.vocab_size * cfg.d_model
    batch = 2 * 256 * 4096 * 4
    want_single = 2 * p / 256 + 8 * p / 256 + 4 + batch / 16
    want_multi = (2 * p / 256 + 8 * (p - e) / 512 + 8 * e / 256 + 4
                  + batch / 32)
    assert single["memory_analysis"]["argument_size_in_bytes"] == \
        pytest.approx(want_single, rel=1e-9)
    assert multi["memory_analysis"]["argument_size_in_bytes"] == \
        pytest.approx(want_multi, rel=1e-9)


def test_decode_cell_on_both_meshes(cells):
    """The counterpart of ``tests/test_multidevice.py::
    test_dryrun_cell_subprocess``."""
    one = cells[("olmo-1b", "decode_32k", "single")]
    two = cells[("olmo-1b", "decode_32k", "multi")]
    assert (one["chips"], two["chips"]) == (256, 512)
    # olmo's 16 kv heads tile the model axis: the cache's kv heads over
    # 'model', its rows over the batch axes (8, then 4 a process)
    assert two["hlo_flops"] < one["hlo_flops"]


def test_every_skip_has_the_reference_reason():
    from repro.configs import get_config as jget
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.configs.shapes import skip_reason as jskip
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.dryrun import run_cell
    skips = 0
    for mesh in ("single", "multi"):
        for arch in ARCH_IDS:
            for shape in SHAPES:
                want = jskip(jget(arch), JSHAPES[shape])
                if want is None:
                    continue
                row = run_cell(arch, shape, mesh, device="cpu")
                assert row == {"arch": arch, "shape": shape, "mesh": mesh,
                               "status": "skip", "reason": want}
                skips += 1
    assert skips == 14


def test_cli_runs_cells_and_writes_rows(tmp_path):
    out = tmp_path / "rows.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", "decode_32k", "--mesh", "both",
         "--device", "cpu", "--out", str(out)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "2 ok, 0 documented skips, 0 errors" in res.stdout
    rows = json.loads(out.read_text())
    assert [r["mesh"] for r in rows] == ["single", "multi"]
    assert all(np.isfinite(r["roofline_fraction"]) for r in rows)


def test_cli_serve_profiles(tmp_path):
    out = tmp_path / "profiles.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--serve-profiles-out", str(out)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "qwen2-0.5b" in json.loads(out.read_text())


def test_the_cli_defaults_to_the_card(monkeypatch):
    from repro_torch.launch import dryrun
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k"])
