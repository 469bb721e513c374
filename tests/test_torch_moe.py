"""The port's mixture-of-experts FFN and the model paths that use it
(qwen2-moe-a2.7b, llama4-maverick-400b-a17b, the jamba-v0.1 hybrid)
against the JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both packages; the
JAX params (float32, ``init_params`` / ``make_moe_params``) are carried
across by ``repro_torch.convert``.

* Units: ``_route`` in both branches (softmax + top-k + renormalise, and
  the sigmoid of the top-k logits) with and without padded experts (20
  experts pad to 32, which no smoke config reaches); ``_capacity`` over a
  sweep; ``_dispatch_indices`` bit-equal, with a hypothesis case over
  seeds; ``apply_moe_local`` at capacity factors 0.05 (drops), 1.25 and
  8.0 (none); the aux loss.
* Model level, on the smoke configs of the three architectures and on
  jamba's at 16 layers (two repetitions of its 8-layer period):
  ``forward`` logits and aux loss, ``prefill`` logits and cache,
  ``decode_step`` logits and cache.
* Decisions: a qwen2-0.5b → qwen2-moe-a2.7b smoke cascade through the
  port's ``TokenEngine`` serves the JAX engine's tokens, resolvers, hops
  and logical steps, and each stage's ``compile_counts()`` equals the JAX
  engine's key for key (the MoE stage prefills at exact length, batch 1).

Tolerances (float32, other summation orders): router weights and
probabilities within 1e-6, expert indices and dispatch slots equal; MoE
outputs within 1e-5; aux losses within rtol 1e-6 (one layer) and 1e-5
(summed over layers); logits within atol 1e-4 / rtol 1e-4 and caches
within 1e-5, the limits of ``tests/test_torch_model.py``.

Routing has a near-tie limit like the decision threshold's: a token whose
k-th and (k+1)-th router logits are within rounding of each other may pick
another expert in the other package. Every test that routes asserts, on
the port's own router logits for the inputs it uses, that this gap exceeds
ROUTER_NEAR (1e-4) for every token; it fails, not skips, where one does
not. Decision tests also keep the 1e-4 guard on the certainties the
escalation rule reads.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import MoEConfig as JMoEConfig
from repro.core.cascade import Cascade as JCascade
from repro.core.gears import Gear as JGear
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models.common import ArrayFactory
from repro.serving import token_engine as JT
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core.cascade import Cascade
from repro_torch.core.certainty import StreamingCertainty
from repro_torch.core.gears import Gear
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.serving import token_engine as TT

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)

ROUTE_TOL = dict(atol=1e-6, rtol=0)
MOE_TOL = dict(atol=1e-5, rtol=0)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=0)
ROUTER_NEAR = 1e-4
NEAR = 1e-4
MOE_ARCHS = ["qwen2-moe-a2.7b", "llama4-maverick-400b-a17b",
             "jamba-v0.1-52b"]
MODELS = MOE_ARCHS + ["jamba-16"]


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _configs(name):
    """(JAX cfg, torch cfg): a smoke config, a smoke config with 20
    experts (padded to 32), or jamba's at 16 layers."""
    if name == "jamba-16":
        return (jax_smoke_config("jamba-v0.1-52b").scaled(num_layers=16),
                get_smoke_config("jamba-v0.1-52b").scaled(num_layers=16))
    if name.endswith("-e20"):
        jcfg, tcfg = _configs(name[:-4])
        return tuple(c.scaled(moe=dataclasses.replace(c.moe, num_experts=20))
                     for c in (jcfg, tcfg))
    return jax_smoke_config(name), get_smoke_config(name)


def _router_gaps(monkeypatch):
    """Records, for every routing call of the port, the smallest gap over
    tokens between the k-th and (k+1)-th largest router logit among the
    real experts."""
    gaps = []
    route = TMOE._route

    def recording(p, m, x2d):
        logits = x2d.float() @ p["router"]
        top = torch.topk(logits[:, :m.num_experts], m.top_k + 1,
                         dim=-1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return route(p, m, x2d)
    monkeypatch.setattr(TMOE, "_route", recording)
    return gaps


def _assert_routing_clear(gaps):
    assert gaps, "no routing call was recorded"
    assert min(gaps) > ROUTER_NEAR, (
        f"a token's k-th and (k+1)-th router logits lie within "
        f"{min(gaps)} <= {ROUTER_NEAR}: the expert choice cannot be held "
        f"exactly across the packages")


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def _moe_params(jcfg, seed=0):
    tree = jax.tree.map(np.asarray, JMOE.make_moe_params(
        ArrayFactory(jax.random.PRNGKey(seed), False, jnp.float32), jcfg))
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree,
                                                              device="cpu")


ROUTE_CASES = ["qwen2-moe-a2.7b", "llama4-maverick-400b-a17b",
               "jamba-v0.1-52b", "qwen2-moe-a2.7b-e20", "jamba-v0.1-52b-e20"]


@pytest.mark.parametrize("name", ROUTE_CASES)
def test_route_matches_jax(name, monkeypatch):
    """Weights, expert indices and router probabilities: sigmoid of the
    top-k logits (qwen2-moe, llama4) and softmax + top-k + renormalise
    (jamba), with padded experts masked and never chosen."""
    jcfg, tcfg = _configs(name)
    jp, tp = _moe_params(jcfg)
    x = _rand(1, (96, jcfg.d_model))
    gaps = _router_gaps(monkeypatch)
    w, idx, probs = TMOE._route(tp, tcfg.moe, torch.from_numpy(x))
    _assert_routing_clear(gaps)
    jw, jidx, jprobs = JMOE._route(jp, jcfg.moe, jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **ROUTE_TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                               **ROUTE_TOL)
    e_pad = TMOE.padded_num_experts(tcfg.moe)
    assert e_pad == JMOE.padded_num_experts(jcfg.moe) == probs.shape[-1]
    assert e_pad == (32 if name.endswith("-e20") else tcfg.moe.num_experts)
    assert int(idx.max()) < tcfg.moe.num_experts
    assert float(probs[:, tcfg.moe.num_experts:].sum()) == 0.0
    if tcfg.moe.norm_topk_prob:
        torch.testing.assert_close(w.sum(-1), torch.ones(96), atol=1e-6,
                                   rtol=0)


def test_padded_num_experts_matches_jax():
    for e in (1, 8, 16, 17, 20, 32, 60, 64, 100, 128):
        assert TMOE.padded_num_experts(MoEConfig(e, 1, 8)) == \
            JMOE.padded_num_experts(JMoEConfig(e, 1, 8))
    assert TMOE.padded_num_experts(get_config("qwen2-moe-a2.7b").moe) == 64


def test_capacity_matches_jax():
    for t in (1, 7, 8, 9, 13, 64, 200, 1000, 4096):
        for k in (1, 2, 4):
            for e in (8, 16, 60, 128):
                for f in (0.05, 1.0, 1.25, 8.0):
                    assert TMOE._capacity(t, k, e, f) == \
                        JMOE._capacity(t, k, e, f), (t, k, e, f)


def _dispatch_case(seed, t, k, e, cap):
    rng = np.random.default_rng(seed)
    # distinct experts per token, as top-k gives them
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)]) \
        .astype(np.int32)
    dest, src = TMOE._dispatch_indices(torch.from_numpy(idx).long(), e, cap)
    jdest, jsrc = JMOE._dispatch_indices(jnp.asarray(idx), e, cap)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    return dest.numpy(), idx


@pytest.mark.parametrize("t,k,e,cap", [(64, 2, 8, 16), (64, 4, 8, 8),
                                       (13, 4, 64, 8), (200, 2, 16, 32),
                                       (8, 4, 60, 8), (33, 1, 128, 8)])
def test_dispatch_indices_bit_equal(t, k, e, cap):
    dest, idx = _dispatch_case(t, t, k, e, cap)
    kept = dest < e * cap
    np.testing.assert_array_equal(dest[kept] // cap, idx.reshape(-1)[kept])
    assert len(np.unique(dest[kept])) == kept.sum()


@given(st.integers(0, 10 ** 6))
@settings(max_examples=10, deadline=None)
def test_dispatch_indices_bit_equal_over_seeds(seed):
    """Repeated experts per token included (the JAX property test's
    inputs): the stable sort keeps token-major order either way."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 8, (64, 2)).astype(np.int32)
    dest, src = TMOE._dispatch_indices(torch.from_numpy(idx).long(), 8, 16)
    jdest, jsrc = JMOE._dispatch_indices(jnp.asarray(idx), 8, 16)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))


@pytest.mark.parametrize("cf", [0.05, 1.25, 8.0])
@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b",
                                  "llama4-maverick-400b-a17b",
                                  "jamba-v0.1-52b", "qwen2-moe-a2.7b-e20"])
def test_apply_moe_local_matches_jax(name, cf, monkeypatch):
    """y and the aux loss at a capacity that drops most entries (0.05),
    the default (1.25) and one that drops none (8.0)."""
    jcfg, tcfg = _configs(name)
    jp, tp = _moe_params(jcfg, seed=2)
    x = _rand(3, (64, jcfg.d_model))
    gaps = _router_gaps(monkeypatch)
    y, aux = TMOE.apply_moe_local(tp, tcfg, torch.from_numpy(x),
                                  capacity_factor=cf)
    _assert_routing_clear(gaps)
    jy, jaux = JMOE.apply_moe_local(jp, jcfg, jnp.asarray(x),
                                    capacity_factor=cf)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    _, idx, _ = TMOE._route(tp, tcfg.moe, torch.from_numpy(x))
    e_pad = tp["router"].shape[-1]
    cap = TMOE._capacity(64, tcfg.moe.top_k, tcfg.moe.num_experts, cf)
    dest, _ = TMOE._dispatch_indices(idx, e_pad, cap)
    dropped = int((dest == e_pad * cap).sum())
    if cf != 1.25:
        assert (dropped > 0) == (cf == 0.05)
    y2, none = TMOE.apply_moe_local(tp, tcfg, torch.from_numpy(x),
                                    capacity_factor=cf, with_aux=False)
    assert none is None and torch.equal(y2, y)


def test_aux_loss_matches_jax():
    t, e = 1024, 8
    for probs, idx in (
            (np.full((t, e), 1.0 / e, np.float32),
             np.tile(np.arange(e), t // e).reshape(t, 1)),
            (np.eye(e, dtype=np.float32)[np.zeros(t, int)],
             np.zeros((t, 1), np.int64)),
            (np.random.default_rng(0).dirichlet(np.ones(e), t)
             .astype(np.float32),
             np.random.default_rng(1).integers(0, e, (t, 2)))):
        got = TMOE.aux_load_balance_loss(torch.from_numpy(probs),
                                         torch.from_numpy(idx), e)
        want = JMOE.aux_load_balance_loss(jnp.asarray(probs),
                                          jnp.asarray(idx), e)
        assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_bf16_moe_keeps_the_activation_dtype():
    """Under bf16 weights the output stays bf16 (the combine adds in the
    activation dtype) and the router stays float32."""
    tcfg = get_smoke_config("qwen2-moe-a2.7b")
    params = TM.init_params(tcfg, seed=0, device="cpu")
    p = params["blocks"][0]["moe"]
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].dtype == p["shared"]["gate"].dtype == torch.bfloat16
    x = torch.from_numpy(_rand(4, (24, tcfg.d_model))).bfloat16()
    y, aux = TMOE.apply_moe_local(TM._rep(p, 0), tcfg, x)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert torch.isfinite(y.float()).all()


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MODELS)
def model(request):
    jcfg, tcfg = _configs(request.param)
    tree = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    return (request.param, jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def _caches_close(tcache, jcache):
    tl = [t for blk in tcache["blocks"] for t in blk.values()]
    jl = [a for blk in jcache["blocks"] for a in blk.values()]
    assert [list(b) for b in tcache["blocks"]] == \
        [sorted(b) for b in jcache["blocks"]]
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(to_numpy(t), np.asarray(j, np.float32),
                                   **CACHE_TOL)


def test_init_params_layout_matches_jax(model):
    """The port's own init builds the JAX tree: shapes and dtypes (the
    router float32), expert weights drawn at scale 0.02."""
    name, jcfg, tcfg, _, _ = model
    jtree = JM.init_params(jcfg, jax.random.PRNGKey(0))
    ttree = TM.init_params(tcfg, seed=0, device="cpu")
    jl, jdef = jax.tree.flatten(jtree)
    tl, tdef = jax.tree.flatten(ttree)
    assert jdef == tdef
    for j, t in zip(jl, tl):
        assert j.shape == tuple(t.shape)
        assert str(j.dtype) == str(t.dtype).replace("torch.", "")
    moe = [b["moe"] for b in ttree["blocks"] if "moe" in b]
    assert moe and all(m["router"].dtype == torch.float32 for m in moe)
    w = moe[0]["w_gate"].float()
    assert w.dim() == 4 and abs(float(w.std()) - 0.02) < 2e-3


def test_forward_matches_jax(model, monkeypatch):
    name, jcfg, tcfg, jp, tp = model
    toks = _tokens(1, (2, 13))
    gaps = _router_gaps(monkeypatch)
    tl, taux = TM.forward(tp, tcfg, {"tokens": toks})
    _assert_routing_clear(gaps)
    jl, jaux = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert float(taux) > 0.0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_prefill_matches_jax(model, monkeypatch):
    name, jcfg, tcfg, jp, tp = model
    toks = _tokens(2, (2, 11))
    gaps = _router_gaps(monkeypatch)
    tl, tc = TM.prefill(tp, tcfg, {"tokens": toks}, cache_len=16)
    _assert_routing_clear(gaps)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        cache_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _caches_close(tc, jc)
    # the last position of a forward over the same batch: the same tokens
    # share the routing call, so the same capacity and drops
    full, _ = TM.forward(tp, tcfg, {"tokens": toks})
    torch.testing.assert_close(tl, full[:, -1], **{
        "atol": LOGIT_TOL["atol"], "rtol": LOGIT_TOL["rtol"]})


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_step_matches_jax(model, ragged, monkeypatch):
    name, jcfg, tcfg, jp, tp = model
    toks = _tokens(3, (3, 10))
    nxt = _tokens(4, (3, 1))
    index = np.asarray([10, 7, 9], np.int32) if ragged else np.int32(10)
    gaps = _router_gaps(monkeypatch)
    _, tc = TM.prefill(tp, tcfg, {"tokens": toks}, cache_len=16)
    tl, tc = TM.decode_step(tp, tcfg, nxt, tc, torch.as_tensor(index))
    _assert_routing_clear(gaps)
    _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                       cache_len=16)
    jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                            jnp.asarray(index))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _caches_close(tc, jc)


def test_hybrid_block_pattern_and_cache_over_two_reps():
    """jamba at 16 layers: two repetitions of the 8-layer period (SSM
    mixers but position 4, MoE at the odd positions), one attention cache
    per repetition, the SSM caches stacked over both."""
    tcfg = _configs("jamba-16")[1]
    pattern = TM.block_pattern(tcfg)
    assert TM.num_reps(tcfg) == 2 and len(pattern) == 8
    assert [s.mixer for s in pattern].count("attn") == 1
    assert pattern[4].mixer == "attn"
    assert [s.ffn for s in pattern] == ["dense", "moe"] * 4
    cache = TM.init_cache(tcfg, 2, 16, device="cpu")
    assert cache["blocks"][4]["k"].shape[0] == 2
    assert cache["blocks"][0]["ssm"].shape[:2] == (2, 2)
    full = get_config("jamba-v0.1-52b").scaled(num_layers=16)
    assert TM.num_reps(full) == 2 and not TM.bucketed_prefill_supported(full)


# ---------------------------------------------------------------------------
# decisions: a qwen2 → qwen2-moe smoke cascade
# ---------------------------------------------------------------------------

MODES = [("fused", 1), ("fused", 4), ("reference", 1)]
N_SLOTS, MAX_NEW, MIN_TOKENS, EARLY_MARGIN = 3, 6, 2, 0.5


@pytest.fixture(scope="module")
def cascade():
    """Per stage: (JAX cfg, torch cfg, JAX params, torch params); the
    prompts; a threshold across the widest gap of the stage-a final
    certainties (the middle half), so both outcomes occur."""
    stages = {}
    for m, arch, seed in (("a", "qwen2-0.5b", 0), ("b", "qwen2-moe-a2.7b",
                                                   7)):
        jcfg = jax_smoke_config(arch)
        tree = jax.tree.map(np.asarray, JM.init_params(
            jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32))
        stages[m] = (jcfg, get_smoke_config(arch),
                     jax.tree.map(jnp.asarray, tree),
                     params_from_numpy(tree, device="cpu"))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, 8 + 3 * i).astype(np.int32)
               for i in range(6)]
    finals = []
    for p in prompts:
        _, gaps = TT.greedy_generate(stages["a"][3], stages["a"][1], p,
                                     MAX_NEW)
        c = StreamingCertainty()
        for g in gaps:
            c.update(float(g))
        finals.append(c.value)
    s = np.sort(finals)[1:-1]
    k = int(np.argmax(np.diff(s)))
    return stages, prompts, float(0.5 * (s[k] + s[k + 1]))


def _serve(lib, stages, prompts, thr, mode, spec_k):
    side, kw = (2, {}) if lib is JT else (3, {"device": "cpu"})
    C, G = (JCascade, JGear) if lib is JT else (Cascade, Gear)
    gear = G(cascade=C(("a", "b"), (thr,)), min_queue_lens={"a": 1, "b": 1},
             load_fractions={"a": {0: 1.0}, "b": {1: 1.0}})
    engines = [lib.SlotEngine(m, stages[m][side], stages[m][side - 2],
                              n_slots=N_SLOTS, max_len=40, **kw)
               for m in ("a", "b")]
    te = lib.TokenEngine(engines, gear, min_tokens=MIN_TOKENS,
                         early_margin=EARLY_MARGIN, mode=mode,
                         spec_k=spec_k)
    reqs = [lib.TokenRequest(i, p, MAX_NEW) for i, p in enumerate(prompts)]
    return te, te.serve(reqs)


def _near_boundaries(out, thr):
    """Requests whose stage-0 streamed certainty, where the rule reads it,
    lies within NEAR of the boundary it is compared with."""
    near = []
    for rid, res in out.items():
        c = StreamingCertainty()
        for pos, g in enumerate(res.stage_gaps[0], start=1):
            v = c.update(float(g))
            bounds = [thr] if pos >= MAX_NEW else []
            if pos >= MIN_TOKENS:
                bounds.append(thr * EARLY_MARGIN)
            if any(abs(v - b) <= NEAR for b in bounds):
                near.append(rid)
    return near


@pytest.mark.parametrize("mode,spec_k", MODES)
def test_moe_cascade_matches_jax(cascade, mode, spec_k, monkeypatch):
    stages, prompts, thr = cascade
    jte, jout = _serve(JT, stages, prompts, thr, mode, spec_k)
    near = _near_boundaries(jout, thr)
    assert near == [], (
        f"requests {near} stream a certainty within {NEAR} of a decision "
        f"boundary (threshold {thr}): the comparison cannot be exact")
    gaps = _router_gaps(monkeypatch)
    tte, tout = _serve(TT, stages, prompts, thr, mode, spec_k)
    _assert_routing_clear(gaps)
    assert sorted(tout) == sorted(jout)
    for rid, j in jout.items():
        t = tout[rid]
        assert t.tokens == j.tokens, rid
        assert (t.resolver, t.hops) == (j.resolver, j.hops), rid
        assert (t.first_token_step, t.done_step) == \
            (j.first_token_step, j.done_step), rid
        for si in j.stage_gaps:
            np.testing.assert_allclose(t.stage_gaps[si], j.stage_gaps[si],
                                       atol=1e-4, rtol=0)
    assert {r.resolver for r in tout.values()} == {0, 1}
    assert tte.stats()["compiles"] == jte.stats()["compiles"]
    moe = tte.stages[1]
    assert not TM.bucketed_prefill_supported(moe.cfg)
    assert moe.stats.prefill_shapes and all(
        b == 1 for b, _ in moe.stats.prefill_shapes)
    cc = moe.compile_counts()
    assert cc["bucketed_prefill"] == 0
    assert cc["reference_prefill"] == len({n for _, n in
                                           moe.stats.prefill_shapes})
