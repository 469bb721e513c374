"""The port's token cascade against the JAX package's, and against the token
DES that replays it, on the CPU.

Three two-stage cascades at smoke size, from JAX float32 params converted
through ``repro_torch.convert``: qwen2-0.5b → qwen2-0.5b (seeds 0 and 7),
falcon-mamba-7b → falcon-mamba-7b, and the heterogeneous qwen2-0.5b →
qwen3-32b (qk-norm, an untied head, another width per head group; one
shared 512-token vocabulary), each at ``spec_k`` 1 and 3.

* The torch ``TokenEngine`` serves the JAX engine's tokens, resolvers,
  hops and logical steps exactly; per-stage gaps agree within 1e-4
  (float32 logits from other summation orders).
* The torch engine's per-stage gap streams, replayed through the port's
  ``TokenReplayBackend`` and ``ServingSimulator.run_token_trace``, give
  the engine's resolvers and token counts (the engine and the DES share
  one decision layer), and the same run as the JAX DES replaying the JAX
  engine's streams.

The stage-a threshold sits mid-way across the widest gap between the
requests' end-of-stream certainties in their middle half, so both
outcomes occur; a guard then asserts that no streamed certainty the
decision rule reads (every position against ``early_margin`` x threshold,
the last against the threshold) lies within 1e-4 of its boundary, so
rounding between the packages cannot flip a decision.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.cascade import Cascade as JCascade
from repro.core.execution import TokenReplayBackend as JTokenReplayBackend
from repro.core.gears import Gear as JGear
from repro.core.lp import Replica as JReplica
from repro.core.profiles import synthetic_family as j_synthetic_family
from repro.core.simulator import ServingSimulator as JServingSimulator
from repro.core.simulator import SimConfig as JSimConfig
from repro.models import model as JM
from repro.serving import token_engine as JT
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.cascade import Cascade
from repro_torch.core.certainty import StreamingCertainty
from repro_torch.core.execution import TokenReplayBackend
from repro_torch.core.gears import Gear
from repro_torch.core.lp import Replica
from repro_torch.core.profiles import synthetic_family
from repro_torch.core.simulator import ServingSimulator, SimConfig
from repro_torch.models import model as TM
from repro_torch.serving import token_engine as TT

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)

GAP_TOL = dict(atol=1e-4, rtol=0)
NEAR = 1e-4
MIN_TOKENS, EARLY_MARGIN, N_SLOTS, MAX_NEW = 2, 0.5, 3, 6
CASES = {
    "qwen2": ("qwen2-0.5b", "qwen2-0.5b"),
    "falcon-mamba": ("falcon-mamba-7b", "falcon-mamba-7b"),
    "qwen2-to-qwen3": ("qwen2-0.5b", "qwen3-32b"),
}


@pytest.fixture(scope="module", params=list(CASES))
def cascade(request):
    """Per stage: (JAX cfg, torch cfg, JAX params, torch params); the
    requests; a threshold that splits them."""
    stages = {}
    for m, arch, seed in zip(("a", "b"), CASES[request.param], (0, 7)):
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
    return request.param, stages, prompts, float(0.5 * (s[k] + s[k + 1]))


def _serve(lib, stages, prompts, thr, spec_k):
    side, kw = (2, {}) if lib is JT else (3, {"device": "cpu"})
    C, G = (JCascade, JGear) if lib is JT else (Cascade, Gear)
    gear = G(cascade=C(("a", "b"), (thr,)), min_queue_lens={"a": 1, "b": 1},
             load_fractions={"a": {0: 1.0}, "b": {1: 1.0}},
             decode_slots={"a": N_SLOTS, "b": N_SLOTS})
    engines = [lib.SlotEngine(m, stages[m][side], stages[m][side - 2],
                              n_slots=N_SLOTS, max_len=40, **kw)
               for m in ("a", "b")]
    te = lib.TokenEngine(engines, gear, min_tokens=MIN_TOKENS,
                         early_margin=EARLY_MARGIN, spec_k=spec_k)
    reqs = [lib.TokenRequest(i, p, MAX_NEW) for i, p in enumerate(prompts)]
    return gear, te.serve(reqs)


def _near_boundaries(out, thr):
    """Requests whose stage-0 streamed certainty, where the rule reads it,
    lies within NEAR of the boundary it is compared with."""
    near = []
    for rid, res in out.items():
        c = StreamingCertainty()
        gaps = res.stage_gaps[0]
        for pos, g in enumerate(gaps, start=1):
            v = c.update(float(g))
            bounds = [thr] if pos >= MAX_NEW else []
            if pos >= MIN_TOKENS:
                bounds.append(thr * EARLY_MARGIN)
            if any(abs(v - b) <= NEAR for b in bounds):
                near.append(rid)
    return near


def _replay(lib_sim, Backend, family, Rep, Cfg, gear, prompts, out):
    backend = Backend.from_gap_streams(
        ["a", "b"], [out[i].stage_gaps for i in range(len(prompts))],
        [MAX_NEW] * len(prompts))
    sim = lib_sim(family(["a", "b"], seed=0),
                  [Rep("a", 0, 1e-3), Rep("b", 1, 2e-3)], 2,
                  Cfg(max_batch=8))
    return sim.run_token_trace(
        gear, np.zeros(len(prompts)), [p.size for p in prompts], backend,
        mode="continuous", n_slots=N_SLOTS, min_tokens=MIN_TOKENS,
        early_margin=EARLY_MARGIN)


@pytest.mark.parametrize("spec_k", [1, 3])
def test_engine_and_token_des_decisions_match_jax(cascade, spec_k):
    name, stages, prompts, thr = cascade
    jgear, jout = _serve(JT, stages, prompts, thr, spec_k)
    near = _near_boundaries(jout, thr)
    assert near == [], (
        f"{name}: requests {near} stream a certainty within {NEAR} of a "
        f"decision boundary (threshold {thr}): the comparison cannot be "
        f"exact")
    tgear, tout = _serve(TT, stages, prompts, thr, spec_k)
    assert sorted(tout) == sorted(jout)
    for rid, j in jout.items():
        t = tout[rid]
        assert t.tokens == j.tokens, (name, rid)
        assert (t.resolver, t.hops) == (j.resolver, j.hops), (name, rid)
        assert (t.first_token_step, t.done_step) == \
            (j.first_token_step, j.done_step), (name, rid)
        assert sorted(t.stage_gaps) == sorted(j.stage_gaps)
        for si in j.stage_gaps:
            np.testing.assert_allclose(t.stage_gaps[si], j.stage_gaps[si],
                                       **GAP_TOL)
    resolvers = [tout[i].resolver for i in range(len(prompts))]
    assert 0 in resolvers and 1 in resolvers          # the threshold splits

    tres = _replay(ServingSimulator, TokenReplayBackend, synthetic_family,
                   Replica, SimConfig, tgear, prompts, tout)
    assert tres.completed == len(prompts)
    np.testing.assert_array_equal(tres.resolver, resolvers)
    np.testing.assert_array_equal(
        tres.tokens_out, [len(tout[i].tokens) for i in range(len(prompts))])
    total = sum(tres.per_model_prefill_time.values()) + \
        sum(tres.per_model_decode_time.values())
    assert total == pytest.approx(float(tres.device_busy.sum()))

    jres = _replay(JServingSimulator, JTokenReplayBackend,
                   j_synthetic_family, JReplica, JSimConfig, jgear, prompts,
                   jout)
    assert (tres.completed, tres.offered) == (jres.completed, jres.offered)
    np.testing.assert_array_equal(tres.resolver, jres.resolver)
    np.testing.assert_array_equal(tres.tokens_out, jres.tokens_out)
    np.testing.assert_array_equal(tres.complete, jres.complete)
    np.testing.assert_array_equal(tres.first_token, jres.first_token)
    assert tres.total_tokens == jres.total_tokens
    assert tres.per_model_steps == jres.per_model_steps


def test_token_engine_refuses_stages_of_different_vocabularies():
    """An escalation replays stage a's tokens into stage b, so the stages
    must share a vocabulary: a clear ValueError at construction."""
    small = get_smoke_config("qwen2-0.5b")
    other = small.scaled(vocab_size=256)
    engines = [TT.SlotEngine(m, TM.init_params(c, seed=0, device="cpu"), c,
                             n_slots=1, max_len=16, device="cpu")
               for m, c in (("a", small), ("b", other))]
    gear = Gear(cascade=Cascade(("a", "b"), (1.0,)),
                min_queue_lens={"a": 1, "b": 1},
                load_fractions={"a": {0: 1.0}, "b": {1: 1.0}})
    with pytest.raises(ValueError, match="one vocabulary"):
        TT.TokenEngine(engines, gear)
