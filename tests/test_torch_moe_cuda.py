"""The port's mixture-of-experts path on the card against the same
functions on the CPU.

Every test here is marked ``cuda`` and skips where no CUDA device is
available; the file imports torch only (no jax), so it runs on the GPU
machine: ``PYTHONPATH=src python -m pytest -q -m cuda tests/``.

* ``apply_moe_local`` at qwen2-moe-a2.7b's widths (d 2048, 60 experts
  padded to 64, expert d_ff 1408, top-4 by sigmoid, 4 shared experts) and
  jamba-v0.1's (d 4096, 16 experts, expert d_ff 14336, top-2 by softmax),
  float32, at T 1 (a jamba decode step), 8 (the fused decode's slots) and
  200 (the longest prefill; qwen2-moe drops entries there): the card's
  output within 1e-4 of the CPU's (other summation orders over 2048-14336
  terms, TF32 off), the same experts chosen, and two card calls
  bit-equal (the dispatch and the combine use no atomics).
* Its backward at T 8 and 200 in f32 against the CPU's (1e-4 of each
  gradient's largest entry), and under deterministic algorithms twice,
  bit-equal, in f32 and bf16.
* A smoke qwen2-0.5b → qwen2-moe-a2.7b cascade served on the card, fused
  at spec_k 4: each stage's ``compile_counts()`` equals the CPU run's, and
  the tokens equal the CPU run's up to the first step whose CPU top-2 gap
  is below 1e-4.

The routers are drawn at a larger scale than the init's 0.02, so that
every token's k-th and (k+1)-th router logits lie far apart: their logits
have a standard deviation of 8 (at unit scale jamba's softmax
probabilities below the top one underflow to equal zeros, and top-k
picks among the ties freely); each test asserts that gap exceeds
1e-4 on its inputs, so rounding between the devices cannot flip a choice.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.cascade import Cascade
from repro_torch.core.gears import Gear
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.serving import token_engine as TT

pytestmark = pytest.mark.cuda

ROUTER_NEAR = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _router_gap(p, m, x):
    """The smallest gap over tokens between the k-th and (k+1)-th router
    logit among the real experts."""
    logits = x.float() @ p["router"]
    top = torch.topk(logits[:, :m.num_experts], m.top_k + 1, dim=-1).values
    return float((top[:, -2] - top[:, -1]).min())


@pytest.fixture(scope="module", params=["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def full_width_moe(request):
    """(cfg, one MoE layer's f32 params on the CPU): weights at the init's
    scale 0.02, the router at 8 / sqrt(d), so that its logits over
    unit-variance tokens have a standard deviation of 8. Skips first
    without a card: the jamba layer alone is 11 GB."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config(request.param)
    gen = torch.Generator()
    gen.manual_seed(0)
    p = TMOE.make_moe_params(cfg, lambda shape, dtype=None: torch.randn(
        shape, generator=gen) * 0.02)
    p["router"] = torch.randn(p["router"].shape, generator=gen) \
        * (8.0 / cfg.d_model ** 0.5)
    return cfg, p


@pytest.mark.parametrize("t", [1, 8, 200])
def test_apply_moe_local_on_card_matches_cpu(cuda, full_width_moe, t):
    cfg, p_cpu = full_width_moe
    x = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (t, cfg.d_model)).astype(np.float32))
    assert _router_gap(p_cpu, cfg.moe, x) > ROUTER_NEAR
    p_gpu = _to(p_cpu, cuda)
    y_cpu, aux_cpu = TMOE.apply_moe_local(p_cpu, cfg, x)
    y_gpu, aux_gpu = TMOE.apply_moe_local(p_gpu, cfg, x.to(cuda))
    y_again, _ = TMOE.apply_moe_local(p_gpu, cfg, x.to(cuda))
    torch.cuda.synchronize()
    _, idx_cpu, _ = TMOE._route(p_cpu, cfg.moe, x)
    _, idx_gpu, _ = TMOE._route(p_gpu, cfg.moe, x.to(cuda))
    assert torch.equal(idx_gpu.cpu(), idx_cpu)
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux_gpu.cpu(), aux_cpu, atol=0, rtol=1e-5)
    assert torch.equal(y_again, y_gpu)
    cap = TMOE._capacity(t, cfg.moe.top_k, cfg.moe.num_experts, 1.25)
    e_pad = p_cpu["router"].shape[-1]
    dest, _ = TMOE._dispatch_indices(idx_gpu, e_pad, cap)
    dest_cpu, _ = TMOE._dispatch_indices(idx_cpu, e_pad, cap)
    assert torch.equal(dest.cpu(), dest_cpu)


def _moe_grads(p, cfg, x, dy):
    """d sum(dy * apply_moe_local(p, x)[0] + aux) / d (every param, x)."""
    leaves = [p[k] for k in ("router", "w_gate", "w_up", "w_down")]
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves] + [
        x.detach().clone().requires_grad_(True)]
    q = dict(p, router=leaves[0], w_gate=leaves[1], w_up=leaves[2],
             w_down=leaves[3])
    y, aux = TMOE.apply_moe_local(q, cfg, leaves[4])
    ((y * dy).sum() + aux).backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("t", [8, 200])
def test_apply_moe_local_backward_on_card(cuda, full_width_moe, t,
                                          monkeypatch):
    """The MoE FFN's backward on the card (the sorted dispatch's gathers
    and scatter, the batched expert products, the router's softmax and
    top-k): in f32 every gradient within 1e-4 of its largest CPU entry,
    the same experts routed; and under ``torch.use_deterministic_algorithms``
    (cuBLAS's workspace set as it needs) the backward runs, no op refusing,
    and two calls agree bit for bit, in f32 and in bf16."""
    cfg, p_cpu = full_width_moe
    rng = np.random.default_rng(t + 1)
    x = torch.from_numpy(rng.standard_normal((t, cfg.d_model))
                         .astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((t, cfg.d_model))
                          .astype(np.float32))
    assert _router_gap(p_cpu, cfg.moe, x) > ROUTER_NEAR
    want = _moe_grads(p_cpu, cfg, x, dy)
    p_gpu = _to(p_cpu, cuda)
    got = _moe_grads(p_gpu, cfg, x.to(cuda), dy.to(cuda))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()))
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            p_d = {k: v.to(dtype) if k != "router" else v
                   for k, v in p_gpu.items() if k != "shared"}
            if "shared" in p_gpu:
                p_d["shared"] = {k: v.to(dtype)
                                 for k, v in p_gpu["shared"].items()}
            runs = [_moe_grads(p_d, cfg, x.to(cuda, dtype), dy.to(cuda, dtype))
                    for _ in range(2)]
            torch.cuda.synchronize()
            for a, b in zip(*runs):
                assert torch.equal(a, b), dtype
    finally:
        torch.use_deterministic_algorithms(False)


def _cascade_params(dev):
    out = {}
    for m, arch, seed in (("a", "qwen2-0.5b", 0), ("b", "qwen2-moe-a2.7b",
                                                   7)):
        cfg = get_smoke_config(arch)
        p = TM.init_params(cfg, seed=seed, dtype=torch.float32, device="cpu")
        for blk in p["blocks"]:
            if "moe" in blk:
                # logits of std ~8 over the unit-variance normed tokens
                blk["moe"]["router"].mul_(8.0 / 0.02 / 128 ** 0.5)
        out[m] = (cfg, _to(p, dev))
    return out


def _serve(dev, prompts):
    stages = _cascade_params(dev)
    gear = Gear(cascade=Cascade(("a", "b"), (1e9,)),
                min_queue_lens={"a": 1, "b": 1},
                load_fractions={"a": {0: 1.0}, "b": {1: 1.0}})
    engines = [TT.SlotEngine(m, stages[m][1], stages[m][0], n_slots=3,
                             max_len=40, device=dev) for m in ("a", "b")]
    te = TT.TokenEngine(engines, gear, min_tokens=2, spec_k=4)
    return te, te.serve([TT.TokenRequest(i, p, 6)
                         for i, p in enumerate(prompts)])


def test_moe_cascade_on_card_matches_cpu(cuda, monkeypatch):
    """Every request escalates (threshold 1e9) and stage b serves it. The
    CPU run, which runs eagerly, records every routing call's gap; the
    card's graphs cannot (a replay runs no Python)."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, 8 + 3 * i).astype(np.int32)
               for i in range(6)]
    gaps, route = [], TMOE._route

    def recording(p, m, x2d):
        gaps.append(_router_gap(p, m, x2d))
        return route(p, m, x2d)
    with monkeypatch.context() as mp:
        mp.setattr(TMOE, "_route", recording)
        runs = {"cpu": _serve("cpu", prompts)}
    assert gaps and min(gaps) > ROUTER_NEAR
    runs[str(cuda)] = _serve(cuda, prompts)
    (tc, oc), (tg, og) = runs["cpu"], runs[str(cuda)]
    assert tg.stats()["compiles"] == tc.stats()["compiles"]
    assert tg.stages[1].graphs.captured == \
        tg.stages[1].compile_counts()["fused_decode"]
    for rid, c in oc.items():
        g = og[rid]
        assert g.resolver == c.resolver == 1
        near = np.flatnonzero(np.asarray(c.stage_gaps[1]) < 1e-4)
        n = int(near[0]) + 1 if near.size else len(c.tokens)
        assert g.tokens[:n] == c.tokens[:n], rid
