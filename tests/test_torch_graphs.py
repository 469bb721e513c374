"""Compiled-step semantics on the CPU: the port's executable counts against
the JAX engines', and the state the graphs read kept at fixed addresses.

On the card every fixed-shape entry point of ``SlotEngine`` and
``InferenceEngine`` runs from a captured CUDA graph
(``repro_torch/serving/graphs.py``); on the CPU the same entry points run
eagerly and record the same keys. So the port's ``compile_counts()`` must
equal the JAX engine's key for key, for the same requests: the scenario of
``tests/test_decode_loop.py::test_compile_counts_bounded_by_bucket_grid``
(8 prompt lengths, 4 slots of 40 tokens) in fused mode at ``spec_k`` 1 and
4 and in reference mode, on qwen2-0.5b and on falcon-mamba-7b's smoke
configs, over float32 params converted from the JAX ones. A float32 SSM
pool widens its conv state at its first decode, so the JAX engine compiles
a second decode executable for the widened operands; the port's graph keys
carry the pool's dtypes and count it too.

Tokens are compared exactly (float32 logits; the same rows as
``tests/test_torch_token_engine.py``, where no near-tie occurs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.cascade import Cascade as JCascade
from repro.core.gears import Gear as JGear
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving import tinymodels as JY
from repro.serving import token_engine as JT
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, tiny_params_from_numpy
from repro_torch.core.cascade import Cascade
from repro_torch.core.gears import Gear
from repro_torch.kernels import counts
from repro_torch.serving import engine as TE
from repro_torch.serving import tinymodels as TY
from repro_torch.serving import token_engine as TT
from repro_torch.serving.graphs import GraphCache

torch.set_num_threads(1)

LENS = [5, 6, 7, 9, 11, 13, 17, 19]        # 8 distinct prompt lengths
ARCHS = ["qwen2-0.5b", "falcon-mamba-7b"]
MODES = [("fused", 1), ("fused", 4), ("reference", 1)]


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(arch, JAX cfg, torch cfg, {stage: (JAX params, torch params)},
    prompts) with float32 params from seeds 0 and 7."""
    jcfg = jax_smoke_config(request.param)
    params = {}
    for m, seed in (("a", 0), ("b", 7)):
        tree = jax.tree.map(np.asarray, JM.init_params(
            jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32))
        params[m] = (jax.tree.map(jnp.asarray, tree),
                     params_from_numpy(tree, device="cpu"))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in LENS]
    return (request.param, jcfg, get_smoke_config(request.param), params,
            prompts)


def _gear(C, G, models, thresholds):
    return G(cascade=C(tuple(models), tuple(thresholds)),
             min_queue_lens={m: 1 for m in models},
             load_fractions={m: {i: 1.0} for i, m in enumerate(models)})


def _serve(lib, arch, models, thresholds, mode, spec_k, max_new=4):
    _, jcfg, tcfg, params, prompts = arch
    jax_side = lib is JT
    cfg = jcfg if jax_side else tcfg
    kw = {} if jax_side else {"device": "cpu"}
    stages = [lib.SlotEngine(m, params[m][0 if jax_side else 1], cfg,
                             n_slots=4, max_len=40, **kw) for m in models]
    C, G = (JCascade, JGear) if jax_side else (Cascade, Gear)
    te = lib.TokenEngine(stages, _gear(C, G, models, thresholds),
                         min_tokens=2, mode=mode, spec_k=spec_k)
    out = te.serve([lib.TokenRequest(i, p, max_new)
                    for i, p in enumerate(prompts)])
    return te, out


@pytest.mark.parametrize("mode,spec_k", MODES)
def test_compile_counts_match_jax(arch, mode, spec_k):
    """One stage: every entry point's count equals the JAX engine's, the
    bucketed prefill stays on the bucket grid (each served shape once),
    and the exact-length prefills count their distinct lengths."""
    name = arch[0]
    jte, jout = _serve(JT, arch, ["a"], [], mode, spec_k)
    tte, tout = _serve(TT, arch, ["a"], [], mode, spec_k)
    for rid in jout:
        assert tout[rid].tokens == jout[rid].tokens, rid
    eng = tte.stages[0]
    cc = eng.compile_counts()
    assert cc == jte.stages[0].compile_counts()
    assert tte.stats()["compiles"] == jte.stats()["compiles"]
    assert cc["total"] == sum(v for k, v in cc.items() if k != "total")
    grid = len(eng.len_buckets) * len(eng.batch_buckets)
    ssm = name == "falcon-mamba-7b"
    if mode == "reference" or ssm:
        assert cc["bucketed_prefill"] == 0
        assert cc["reference_prefill"] == len(set(LENS))
    else:
        assert cc["bucketed_prefill"] == len(eng.stats.prefill_shapes) \
            <= grid
        assert cc["bucketed_prefill"] < len(set(LENS))
        assert cc["reference_prefill"] == 0
    if mode == "reference":
        assert cc["fused_decode"] == 0
        # the widened f32 conv pool is a second operand signature
        assert cc["reference_decode"] == (2 if ssm else 1)
    else:
        assert cc["reference_decode"] == 0
        assert 1 <= cc["fused_decode"] <= spec_k + int(ssm)
        if spec_k == 1:
            assert cc["fused_decode"] == (2 if ssm else 1)


def test_compile_counts_match_jax_on_an_escalating_cascade(arch):
    """Two stages, every request escalating (threshold 1e9): both stages'
    counts equal the JAX engine's, at spec_k 4."""
    jte, jout = _serve(JT, arch, ["a", "b"], [1e9], "fused", 4)
    tte, tout = _serve(TT, arch, ["a", "b"], [1e9], "fused", 4)
    assert all(r.resolver == 1 for r in tout.values())
    for rid in jout:
        assert tout[rid].tokens == jout[rid].tokens, rid
    assert tte.stats()["compiles"] == jte.stats()["compiles"]
    if arch[0] == "falcon-mamba-7b":
        for cc in tte.stats()["compiles"].values():
            assert cc["bucketed_prefill"] == 0
            assert cc["reference_prefill"] == len(set(LENS))


def _addresses(eng):
    out = {"dev_tok": eng.dev_tok.data_ptr(),
           "dev_pos": eng.dev_pos.data_ptr(),
           "dev_active": eng.dev_active.data_ptr()}
    out.update({f"fold.{n}": t.data_ptr() for n, t in eng._fold.items()})
    for i, blk in enumerate(eng.cache["blocks"]):
        out.update({f"cache.{i}.{n}": t.data_ptr() for n, t in blk.items()})
    return out


@pytest.mark.parametrize("mode,spec_k", MODES)
def test_state_stays_in_place_and_decisions_match_jax(arch, mode, spec_k):
    """The device-resident state keeps its addresses through a whole serve
    (joins, fused steps, leaves); only an f32 SSM pool's conv state is
    replaced, once, by its widening. The served tokens, resolvers and
    logical steps still equal the JAX engine's."""
    _, jcfg, tcfg, params, prompts = arch
    eng = TT.SlotEngine("a", params["a"][1], tcfg, n_slots=4, max_len=40,
                        device="cpu")
    before = _addresses(eng)
    te = TT.TokenEngine([eng], _gear(Cascade, Gear, ["a"], []),
                        min_tokens=2, mode=mode, spec_k=spec_k)
    tout = te.serve([TT.TokenRequest(i, p, 6) for i, p in enumerate(prompts)])
    after = _addresses(eng)
    widened = {k for k in before if k.endswith(".conv")}
    assert {k: v for k, v in after.items() if k not in widened} == \
        {k: v for k, v in before.items() if k not in widened}
    assert all(eng.cache["blocks"][int(k.split(".")[1])]["conv"].dtype
               == torch.float32 for k in widened)
    _, jout = _serve(JT, arch, ["a"], [], mode, spec_k, max_new=6)
    for rid in jout:
        t, j = tout[rid], jout[rid]
        assert t.tokens == j.tokens, rid
        assert (t.resolver, t.first_token_step, t.done_step) == \
            (j.resolver, j.first_token_step, j.done_step), rid


def test_graph_cache_on_the_cpu_runs_eagerly_and_records_keys():
    cache = GraphCache(torch.device("cpu"))
    calls = []

    def fn(x, y):
        calls.append(1)
        return x + y, x * y

    x = np.arange(4, dtype=np.float32)
    for i in range(3):
        s, p = cache.run(("add", 4), fn, x, torch.full((4,), float(i)))
        assert torch.equal(s, torch.from_numpy(x) + i)
        assert torch.equal(p, torch.from_numpy(x) * i)
    cache.run(("add", 8), fn, np.zeros(8, np.float32), torch.zeros(8))
    cache.run(("mul", 4), fn, x, x)
    assert len(calls) == 5 and len(cache) == 3
    assert cache.count("add") == 2 and cache.count("mul") == 1
    assert cache.count("sub") == 0
    assert cache.captured == cache.replays == 0
    assert cache.capture_seconds == 0.0


def test_launch_counts_record_a_capture_and_add_it_at_each_replay():
    """A capture launches nothing: its launches are recorded, not counted,
    and every replay counts them."""
    def wrapper():
        counts.launched(wrapper)
    wrapper.launches = 0
    wrapper()
    assert wrapper.launches == 1
    with counts.recording() as rec:
        wrapper()
        wrapper()
    assert wrapper.launches == 1 and rec == {wrapper: 2}
    for _ in range(3):
        counts.replayed(rec)
    assert wrapper.launches == 7


def test_inference_engine_counts_one_graph_per_bucket_as_jax_jits():
    """The port's graphs per bucket equal the JAX engine's executables for
    the same calls: warmup at one length, batches padded to buckets and
    split past the last one, and a second token length."""
    cfg = JY.TINY_FAMILY[0]
    jp = JY.init_tiny(cfg, jax.random.PRNGKey(0))
    tp = tiny_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    j = JE.InferenceEngine(cfg.name, lambda p, t: JY.apply_tiny(cfg, p, t),
                           jp, buckets=(1, 2, 4, 8))
    tcfg = TY.TINY_FAMILY[0]
    t = TE.InferenceEngine(cfg.name, lambda p, x: TY.apply_tiny(tcfg, p, x),
                           tp, buckets=(1, 2, 4, 8))
    rng = np.random.default_rng(0)
    for eng in (j, t):
        eng.warmup(16)
    assert len(t.graphs) == j._fn._cache_size() == 4
    for n, length in ((3, 16), (11, 16), (5, 24), (1, 24)):
        tok = rng.integers(0, cfg.vocab, (n, length)).astype(np.int32)
        js, ts = j.infer(tok), t.infer(tok)
        assert ts.shape == (n, cfg.n_classes)
        np.testing.assert_allclose(ts.numpy(), js, atol=1e-4, rtol=0)
    assert len(t.graphs) == j._fn._cache_size() == 6
    assert t.graphs.count("bucket") == 6
