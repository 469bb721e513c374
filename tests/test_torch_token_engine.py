"""The port's TokenEngine against the JAX TokenEngine on the same requests,
on the CPU.

Both engines serve one ``TokenRequest`` set over converted float32 smoke
params (``get_smoke_config("qwen2-0.5b")``), each with its default
bfloat16 KV-slot pool, in both modes and at ``spec_k`` 1 and 4: one stage,
two stages where every request escalates (threshold 1e9), and two stages
with a mid-range threshold that splits the population. Tokens, resolver,
hops and the logical steps must be identical; per-stage gap streams agree
within 1e-4 (float32 logits from different summation orders). The torch
device fold is held against the host ``StreamingCertainty`` for all three
modes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.serving import token_engine as JT
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.cascade import Cascade
from repro_torch.core.certainty import (StreamingCertainty, device_fold_init,
                                        device_fold_update,
                                        device_fold_value)
from repro_torch.core.gears import Gear
from repro_torch.serving import token_engine as TT

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)

GAP_TOL = dict(atol=1e-4, rtol=0)
MODES = [("fused", 1), ("fused", 4), ("reference", 1)]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_config("qwen2-0.5b")
    tcfg = get_smoke_config("qwen2-0.5b")
    params = {}
    for name, seed in (("a", 0), ("b", 7)):
        tree = jax.tree.map(np.asarray, JM.init_params(
            jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32))
        params[name] = (jax.tree.map(jnp.asarray, tree),
                        params_from_numpy(tree, device="cpu"))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, tcfg.vocab_size, 6 + 3 * i).astype(np.int32)
               for i in range(5)]
    return jcfg, tcfg, params, prompts


def _gear(lib_cascade, lib_gear, models, thresholds):
    return lib_gear(cascade=lib_cascade(tuple(models), tuple(thresholds)),
                    min_queue_lens={m: 1 for m in models},
                    load_fractions={m: {i: 1.0}
                                    for i, m in enumerate(models)})


def _serve(lib, cfg, params, prompts, models, thr, mode, spec_k):
    """Serve the prompts through ``lib``'s engine (JAX or torch)."""
    kw = {} if lib is JT else {"device": "cpu"}
    side = 0 if lib is JT else 1
    stages = [lib.SlotEngine(m, params[m][side], cfg, n_slots=3, max_len=40,
                             **kw) for m in models]
    if lib is JT:
        from repro.core.cascade import Cascade as JC
        from repro.core.gears import Gear as JG
        gear = _gear(JC, JG, models, thr)
    else:
        gear = _gear(Cascade, Gear, models, thr)
    te = lib.TokenEngine(stages, gear, min_tokens=2, mode=mode,
                         spec_k=spec_k)
    reqs = [lib.TokenRequest(i, p, 6) for i, p in enumerate(prompts)]
    return te.serve(reqs), te


def _midrange_threshold(tcfg, params, prompts):
    """A stage-a threshold halfway between two neighbouring end-of-stream
    certainty folds around the median, so the population splits and no
    request sits on the threshold."""
    finals = []
    for p in prompts:
        _, gaps = TT.greedy_generate(params["a"][1], tcfg, p, 6)
        c = StreamingCertainty()
        for g in gaps:
            c.update(float(g))
        finals.append(c.value)
    s = np.sort(finals)
    mid = len(s) // 2
    return float(0.5 * (s[mid - 1] + s[mid]))


def _assert_same(jout, tout):
    assert sorted(jout) == sorted(tout)
    for rid in jout:
        j, t = jout[rid], tout[rid]
        assert t.tokens == j.tokens, rid
        assert (t.resolver, t.hops) == (j.resolver, j.hops), rid
        assert (t.first_token_step, t.done_step) == \
            (j.first_token_step, j.done_step), rid
        assert sorted(t.stage_gaps) == sorted(j.stage_gaps)
        for si in j.stage_gaps:
            np.testing.assert_allclose(t.stage_gaps[si], j.stage_gaps[si],
                                       **GAP_TOL)


@pytest.mark.parametrize("mode,spec_k", MODES)
def test_single_stage_matches_jax(setup, mode, spec_k):
    jcfg, tcfg, params, prompts = setup
    jout, _ = _serve(JT, jcfg, params, prompts, ["a"], [], mode, spec_k)
    tout, te = _serve(TT, tcfg, params, prompts, ["a"], [], mode, spec_k)
    _assert_same(jout, tout)
    assert all(r.resolver == 0 and len(r.tokens) == 6
               for r in tout.values())
    if spec_k > 1:       # terminal stage: scans really batch steps
        st = te.stats()
        assert st["decode_calls"] < st["decode_steps"]
        assert st["spec_discarded"] == 0


@pytest.mark.parametrize("mode,spec_k", MODES)
def test_escalate_all_matches_jax(setup, mode, spec_k):
    jcfg, tcfg, params, prompts = setup
    jout, _ = _serve(JT, jcfg, params, prompts, ["a", "b"], [1e9], mode,
                     spec_k)
    tout, _ = _serve(TT, tcfg, params, prompts, ["a", "b"], [1e9], mode,
                     spec_k)
    _assert_same(jout, tout)
    assert all(r.resolver == 1 and r.hops == 1 for r in tout.values())


@pytest.mark.parametrize("mode,spec_k", MODES)
def test_midrange_threshold_matches_jax(setup, mode, spec_k):
    jcfg, tcfg, params, prompts = setup
    thr = _midrange_threshold(tcfg, params, prompts)
    jout, _ = _serve(JT, jcfg, params, prompts, ["a", "b"], [thr], mode,
                     spec_k)
    tout, _ = _serve(TT, tcfg, params, prompts, ["a", "b"], [thr], mode,
                     spec_k)
    _assert_same(jout, tout)
    resolvers = {r.resolver for r in tout.values()}
    assert resolvers == {0, 1}          # the threshold splits


@pytest.mark.parametrize("mode", ["ewma", "mean", "min"])
def test_device_fold_matches_host_fold(mode):
    rng = np.random.default_rng(0)
    gaps = rng.uniform(0.0, 8.0, size=(12, 3)).astype(np.float32)
    st = device_fold_init(3, "cpu")
    host = [StreamingCertainty(mode=mode, beta=0.35) for _ in range(3)]
    assert torch.all(device_fold_value(st, mode) == 0.0)
    for t in range(12):
        st = device_fold_update(st, torch.from_numpy(gaps[t]), 0.35)
        for b in range(3):
            host[b].update(float(gaps[t, b]))
        np.testing.assert_allclose(device_fold_value(st, mode).numpy(),
                                   [h.value for h in host], rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError):
        device_fold_value(st, "median")


def test_slot_engine_and_token_engine_validation(setup):
    _, tcfg, params, _ = setup
    eng = TT.SlotEngine("m", params["a"][1], tcfg, n_slots=1, max_len=16,
                        device="cpu")
    with pytest.raises(ValueError):
        eng.prefill_into_slot(np.arange(16, dtype=np.int32))  # no headroom
    slot, tok, gap = eng.prefill_into_slot(np.arange(4, dtype=np.int32))
    assert 0 <= tok < tcfg.vocab_size and gap >= 0.0
    with pytest.raises(RuntimeError):
        eng.prefill_into_slot(np.arange(4, dtype=np.int32))   # pool full
    eng.release(slot)
    with pytest.raises(ValueError):
        eng.release(slot)                                     # double free
    with pytest.raises(RuntimeError):
        eng.decode_fused()                                    # none resident
    eng.prefill_batch([np.arange(4, dtype=np.int32)])
    with pytest.raises(ValueError):
        eng.decode_fused(k=13)                       # 4 + 13 > max_len
    gear1 = _gear(Cascade, Gear, ["m"], [])
    with pytest.raises(ValueError):
        TT.TokenEngine([eng], gear1, mode="reference", spec_k=2)
    with pytest.raises(ValueError):
        TT.TokenEngine([eng], gear1, mode="turbo")
    with pytest.raises(ValueError):
        TT.TokenEngine([eng], _gear(Cascade, Gear, ["x"], []))
    with pytest.raises(ValueError):
        TT.SlotEngine("m", params["a"][1], tcfg, n_slots=1, max_len=16,
                      device="meta")


@pytest.mark.parametrize("spec_k", [1, 4])
def test_sliding_window_exact_length_fallback_matches_jax(spec_k):
    """A sliding-window ring (16 slots) at or below the length bucket makes
    right padding inexact: those joiners prefill one by one at their exact
    length, as in the JAX engine, while a boundary whose bucket is below
    the ring stays one padded call. Decisions equal the JAX engine's."""
    over = dict(sliding_window=16, norm_type="nonparametric_ln")
    jcfg = jax_smoke_config("qwen2-0.5b").scaled(**over)
    tcfg = get_smoke_config("qwen2-0.5b").scaled(**over)
    tree = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(3), dtype=jnp.float32))
    params = {"a": (jax.tree.map(jnp.asarray, tree),
                    params_from_numpy(tree, device="cpu"))}
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (4, 5, 7, 14, 20)]
    jout, jte = _serve(JT, jcfg, params, prompts, ["a"], [], "fused",
                       spec_k)
    tout, tte = _serve(TT, tcfg, params, prompts, ["a"], [], "fused",
                       spec_k)
    _assert_same(jout, tout)
    shapes = tte.stages[0].stats.prefill_shapes
    assert shapes == jte.stages[0].stats.prefill_shapes
    assert (3, 8) in shapes                     # padded: bucket 8 < ring
    assert {(1, 14), (1, 20)} <= shapes         # exact: bucket >= ring
