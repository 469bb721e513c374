"""The port's SSM path (Mamba-1, falcon-mamba-7b) against the JAX package,
on the CPU.

Inputs are made from a seed with numpy and handed to both packages. On the
CPU the ``mamba_scan`` wrapper runs its plain version (a sequential scan),
which is held against the Pallas kernel in interpret mode and against
``repro.kernels.ref.mamba_scan_ref`` over the sweep of
tests/test_kernels.py. The model parts run on
``get_smoke_config("falcon-mamba-7b")`` (4 layers, d 128, d_inner 256,
d_state 8, d_conv 4, vocab 512) with float32 params from the JAX
``init_params`` carried across by ``params_from_numpy``.

Tolerances: the scan within 2e-4 of the Pallas kernel (the JAX sweep's own
limit) and 1e-5 of the JAX sequential oracle (the same recurrence, other
summation order over N); mixer outputs and caches within 1e-5 and logits
within 1e-4 / rtol 1e-4 (the JAX model's chunked associative scan sums in
another order than the sequential scan); greedy tokens equal up to the
first step whose JAX top-2 gap is below 1e-4; engine decisions (tokens,
resolvers, hops, logical steps) identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.cascade import Cascade as JCascade
from repro.core.gears import Gear as JGear
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.models import mamba as JMB
from repro.models import model as JM
from repro.serving import token_engine as JT
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import cache_from_numpy, params_from_numpy, to_numpy
from repro_torch.core.cascade import Cascade
from repro_torch.core.certainty import StreamingCertainty
from repro_torch.core.gears import Gear
from repro_torch.kernels import ref as tref
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TM
from repro_torch.serving import token_engine as TT

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)

ARCH = "falcon-mamba-7b"
PALLAS_TOL = dict(atol=2e-4, rtol=0)
ORACLE_TOL = dict(atol=1e-5, rtol=0)
MIXER_TOL = dict(atol=1e-5, rtol=0)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
MODES = [("fused", 1), ("fused", 4), ("reference", 1)]


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _scan_inputs(b, s, di, n, seed):
    return (np.abs(_rand(seed, (b, s, di))) * 0.1,        # dt
            -np.abs(_rand(seed + 1, (di, n))),           # a = -exp(A_log)
            _rand(seed + 2, (b, s, n)), _rand(seed + 3, (b, s, n)),
            _rand(seed + 4, (di,)), _rand(seed + 5, (b, s, di)))


# ---------------------------------------------------------------------------
# the scan: plain version against the Pallas kernel and the JAX oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,di,n,chunk", [
    (2, 64, 64, 8, 32), (1, 200, 128, 16, 64), (2, 33, 32, 4, 16),
])
def test_mamba_scan_plain_matches_pallas(b, s, di, n, chunk):
    ins = _scan_inputs(b, s, di, n, seed=s)
    before = mamba_scan.launches
    y, h_last = mamba_scan(*map(_t, ins))
    assert mamba_scan.launches == before          # the CPU path counts nothing
    assert y.dtype == torch.float32 and h_last.shape == (b, di, n)
    yp = mamba_scan_pallas(*map(jnp.asarray, ins), chunk=chunk, block_di=32,
                           interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), **PALLAS_TOL)
    yj, hj = jref.mamba_scan_ref(*map(jnp.asarray, ins))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **ORACLE_TOL)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(hj), **ORACLE_TOL)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_mamba_scan_initial_state_and_bf16_x(x_dtype):
    """A nonzero h0 carries in, and bf16 x is read as its f32 value."""
    b, s, di, n = 2, 17, 32, 8
    ins = list(_scan_inputs(b, s, di, n, seed=3))
    h0 = _rand(9, (b, di, n))
    xt = _t(ins[5]).to(getattr(torch, x_dtype))
    xj = jnp.asarray(ins[5]).astype(x_dtype)
    y, h = tref.mamba_scan_ref(*map(_t, ins[:5]), xt, _t(h0))
    yj, hj = jref.mamba_scan_ref(*map(jnp.asarray, ins[:5]), xj,
                                 jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **ORACLE_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **ORACLE_TOL)
    # scanning in two pieces, the second from the first's last state,
    # equals one scan
    y1, h1 = tref.mamba_scan_ref(*(_t(a[:, :9]) if a.ndim == 3 else _t(a)
                                   for a in ins[:5]), xt[:, :9], _t(h0))
    y2, h2 = tref.mamba_scan_ref(*(_t(a[:, 9:]) if a.ndim == 3 else _t(a)
                                   for a in ins[:5]), xt[:, 9:], h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-6, rtol=0)
    torch.testing.assert_close(h2, h, atol=1e-6, rtol=0)


def test_mamba_scan_rejects_unsupported_device():
    ins = [torch.zeros(1, 2, 4)] * 6
    with pytest.raises(ValueError):
        mamba_scan(*(t.to("meta") for t in ins))


# ---------------------------------------------------------------------------
# the mixer on the smoke config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config(ARCH)
    tcfg = get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    # nonzero conv biases exercise the bias path
    for blk in tree["blocks"]:
        blk["mamba"]["conv_b"] = _rand(4, blk["mamba"]["conv_b"].shape, 0.1)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(
        tree, device="cpu")


def _layer(tree, r=0):
    """Rep ``r`` of the first block's mixer params."""
    return jax.tree.map(lambda a: a[r], tree["blocks"][0]["mamba"])


def _tlayer(tree, r=0):
    return {k: v[r] for k, v in tree["blocks"][0]["mamba"].items()}


def test_causal_conv_matches_jax():
    xz, w, b = _rand(1, (2, 9, 32)), _rand(2, (4, 32)), _rand(3, (32,))
    out = TMB._causal_conv(_t(xz), _t(w), _t(b))
    ref = JMB._causal_conv(jnp.asarray(xz), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MIXER_TOL)


def test_selective_scan_matches_jax():
    """From a nonzero initial state, over several of the JAX chunks."""
    b, s, di, n = 2, 21, 32, 8
    dt, _, bm, cm, dv, x = _scan_inputs(b, s, di, n, seed=5)
    a_log = _rand(6, (di, n), 0.5)
    h0 = _rand(7, (b, di, n))
    y, h = TMB.selective_scan(*map(_t, (dt, a_log, bm, cm, dv, x, h0)))
    yj, hj = JMB.selective_scan(*map(jnp.asarray,
                                     (dt, a_log, bm, cm, dv, x, h0)),
                                chunk=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **MIXER_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **MIXER_TOL)


@pytest.mark.parametrize("seq", [20, 2])   # 2 < d_conv - 1: padded tail
def test_mamba_prefill_and_decode_match_jax(smoke, seq):
    """One mixer layer: the prefill's output and {conv, ssm} cache, then
    three decode steps that update that cache in place."""
    jcfg, tcfg, jp, tp = smoke
    pj, pt = _layer(jp), _tlayer(tp)
    x = _rand(11, (2, seq, tcfg.d_model))
    out, cache = TMB.mamba_prefill(pt, tcfg, _t(x))
    outj, cj = JMB.mamba_prefill(pj, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(outj), **MIXER_TOL)
    assert cache["conv"].shape == (2, 3, 256) and cache["ssm"].dtype == \
        torch.float32
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(cj[name]),
                                   **MIXER_TOL)
    fwd = TMB.mamba_forward(pt, tcfg, _t(x))
    assert torch.equal(fwd, out)
    for step in range(3):
        xs = _rand(20 + step, (2, 1, tcfg.d_model))
        conv, ssm = cache["conv"], cache["ssm"]
        out, cache2 = TMB.mamba_decode(pt, tcfg, _t(xs), cache)
        outj, cj = JMB.mamba_decode(pj, jcfg, jnp.asarray(xs), cj)
        assert cache2 is cache and cache["conv"] is conv \
            and cache["ssm"] is ssm                    # written in place
        np.testing.assert_allclose(out.numpy(), np.asarray(outj),
                                   **MIXER_TOL)
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(cj[name]), **MIXER_TOL)


def _mixer_params(n, seed):
    """Numpy f32 mixer params for the smoke width (d 128, d_inner 256,
    dt_rank 8, d_conv 4) at d_state ``n``, scaled so that every term of
    the step is of order one."""
    di, r = 256, 8
    shapes = {"in_proj": ((128, 2 * di), 0.1), "conv_w": ((4, di), 0.5),
              "conv_b": ((di,), 0.1), "x_proj": ((di, r + 2 * n), 0.1),
              "dt_proj_w": ((r, di), 0.3), "D": ((di,), 1.0),
              "out_proj": ((di, 128), 0.1)}
    p = {k: _rand(seed + i, shape, scale)
         for i, (k, (shape, scale)) in enumerate(shapes.items())}
    rng = np.random.default_rng(seed + 10)
    p["dt_proj_b"] = rng.uniform(-4.0, -2.0, (di,)).astype(np.float32)
    p["A_log"] = rng.uniform(0.0, 1.1, (di, n)).astype(np.float32)
    return p


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("pool", [torch.bfloat16, torch.float32],
                         ids=["bf16_pool", "widened_f32_pool"])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_mamba_decode_steps_match_jax(n, pool, rows):
    """Three decode steps after a prefill at every d_state the step
    kernels take, under f32 weights, from a narrow bf16 conv pool (read
    widened, written back rounded, the pool keeping its dtype) and from a
    widened f32 one: each step's output, conv and SSM state against the
    JAX ``mamba_decode`` given the same cache, both caches written in
    place (the same tensors, the conv state shifted by one tap)."""
    jcfg, tcfg = (dataclasses.replace(c, ssm=dataclasses.replace(
        c.ssm, d_state=n)) for c in (jax_smoke_config(ARCH),
                                     get_smoke_config(ARCH)))
    npp = _mixer_params(n, seed=40 + n)
    pt = {k: _t(v) for k, v in npp.items()}
    pj = {k: jnp.asarray(v) for k, v in npp.items()}
    _, cache = TMB.mamba_prefill(pt, tcfg, _t(_rand(41, (rows, 6, 128))))
    cache = {"conv": cache["conv"].to(pool), "ssm": cache["ssm"]}
    conv, ssm = cache["conv"], cache["ssm"]
    conv_tol = MIXER_TOL if pool == torch.float32 else dict(atol=1e-5,
                                                            rtol=2.0 ** -8)
    for step in range(3):
        xs = _rand(50 + step, (rows, 1, 128))
        # copies: the port writes its cache in place, which a zero-copy
        # array would see
        jcache = {"conv": jnp.array(conv.float().numpy(), copy=True),
                  "ssm": jnp.array(ssm.numpy(), copy=True)}
        before = conv.clone()
        out, cache2 = TMB.mamba_decode(pt, tcfg, _t(xs), cache)
        outj, cj = JMB.mamba_decode(pj, jcfg, jnp.asarray(xs), jcache)
        assert cache2 is cache and cache["conv"] is conv \
            and cache["ssm"] is ssm                    # written in place
        assert conv.dtype == pool and ssm.dtype == torch.float32
        assert torch.equal(conv[:, :-1], before[:, 1:])
        np.testing.assert_allclose(out.numpy(), np.asarray(outj),
                                   **MIXER_TOL)
        np.testing.assert_allclose(ssm.numpy(), np.asarray(cj["ssm"]),
                                   **MIXER_TOL)
        np.testing.assert_allclose(conv.float().numpy(),
                                   np.asarray(cj["conv"]), **conv_tol)


# ---------------------------------------------------------------------------
# the model on the smoke config
# ---------------------------------------------------------------------------

def _cache_close(tcache, jcache):
    for tb, jb in zip(tcache["blocks"], jcache["blocks"], strict=True):
        assert sorted(tb) == sorted(jb) == ["conv", "ssm"]
        for name in ("conv", "ssm"):
            assert tuple(tb[name].shape) == jb[name].shape
            np.testing.assert_allclose(to_numpy(tb[name]),
                                       np.asarray(jb[name], np.float32),
                                       **MIXER_TOL)


def test_forward_prefill_decode_match_jax(smoke):
    jcfg, tcfg, jp, tp = smoke
    toks = _tokens(1, (2, 19))
    jl, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, aux = TM.forward(tp, tcfg, {"tokens": toks})
    assert tl.shape == (2, 19, 512) and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)

    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        cache_len=24)
    tl, tc = TM.prefill(tp, tcfg, {"tokens": toks}, cache_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _cache_close(tc, jc)
    with pytest.raises(ValueError):
        TM.prefill(tp, tcfg, {"tokens": toks}, cache_len=8)
    ci = np.asarray([19, 19], np.int32)
    for step in range(3):
        nxt = _tokens(10 + step, (2, 1))
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                                jnp.asarray(ci))
        tl, tc2 = TM.decode_step(tp, tcfg, nxt, tc, _t(ci))
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _cache_close(tc, jc)
        ci = ci + 1


def test_decode_widens_a_narrow_conv_pool_like_jax(smoke):
    """A bf16 pool under f32 weights: the JAX decode returns an f32 conv
    state (its concatenate promotes), so the port widens the pool leaf
    once and decodes on the same values; the SSM state stays f32."""
    jcfg, tcfg, jp, tp = smoke
    tc = TM.init_cache(tcfg, 2, 16, device="cpu")
    jc = JM.init_cache(jcfg, 2, 16)
    assert tc["blocks"][0]["conv"].dtype == torch.bfloat16
    assert jc["blocks"][0]["conv"].dtype == jnp.bfloat16
    nxt = _tokens(3, (2, 1))
    jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                            jnp.asarray([0, 0], np.int32))
    tl, tc = TM.decode_step(tp, tcfg, nxt, tc, _t([0, 0]))
    assert jc["blocks"][0]["conv"].dtype == jnp.float32
    assert tc["blocks"][0]["conv"].dtype == torch.float32
    assert tc["blocks"][0]["ssm"].dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _cache_close(tc, jc)


def test_greedy_decode_matches_forward_and_jax(smoke):
    """prefill + N x decode_step == the teacher-forced forward, position
    for position (port of tests/test_token_engine.py:24-52), and the
    greedy tokens equal the JAX ones."""
    jcfg, tcfg, jp, tp = smoke
    prompt = _tokens(0, (11,))
    n_new = 5
    gen, gaps = TT.greedy_generate(tp, tcfg, prompt, n_new)
    assert gen.shape == (n_new,) and np.isfinite(gaps).all() \
        and (gaps >= 0).all()
    seq = np.concatenate([prompt, gen])[None, :]
    full, _ = TM.forward(tp, tcfg, {"tokens": seq})
    step_logits, cache = TM.prefill(tp, tcfg, {"tokens": prompt[None]},
                                    cache_len=prompt.size + n_new)
    for k in range(n_new):
        torch.testing.assert_close(step_logits[0],
                                   full[0, prompt.size - 1 + k],
                                   atol=1e-4, rtol=1e-4)
        assert int(torch.argmax(step_logits[0])) == int(gen[k])
        step_logits, cache = TM.decode_step(
            tp, tcfg, np.asarray([[gen[k]]], np.int32), cache,
            _t(np.asarray([prompt.size + k], np.int32)))
    jt, jg = JT.greedy_generate(jp, jcfg, prompt, n_new)
    near = np.flatnonzero(jg < 1e-4)
    n = int(near[0]) + 1 if near.size else len(jt)
    np.testing.assert_array_equal(gen[:n], jt[:n])
    np.testing.assert_allclose(gaps[:n], jg[:n], **LOGIT_TOL)


def test_prefill_bucketed_refuses_ssm(smoke):
    """Right padding is not exact for an SSM state (port of
    tests/test_decode_loop.py:223-237)."""
    _, tcfg, _, tp = smoke
    assert not TM.bucketed_prefill_supported(tcfg)
    assert TM.bucketed_prefill_supported(get_smoke_config("qwen2-0.5b"))
    with pytest.raises(ValueError):
        TM.prefill_bucketed(tp, tcfg, np.zeros((2, 8), np.int32),
                            np.asarray([4, 8], np.int32), cache_len=16)


def test_init_params_and_cache_layout_match_jax():
    """Same trees, shapes and dtypes as the JAX init and cache (values
    differ: the generators differ); A_log, D and dt_proj_b are f32."""
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    assert get_config(ARCH).ssm.d_state == 16
    for jtree, ttree in (
            (JM.init_params(jcfg, jax.random.PRNGKey(0)),
             TM.init_params(tcfg, seed=0, device="cpu")),
            (JM.init_cache(jcfg, 3, 16), TM.init_cache(tcfg, 3, 16,
                                                       device="cpu"))):
        # the JAX tree carried across keeps every leaf's dtype too
        moved = cache_from_numpy(jax.tree.map(np.asarray, jtree),
                                 device="cpu")
        jl, jdef = jax.tree.flatten(jtree)
        for other in (ttree, moved):
            tl, tdef = jax.tree.flatten(other)
            assert jdef == tdef
            for j, t in zip(jl, tl):
                assert j.shape == tuple(t.shape)
                assert str(j.dtype) == str(t.dtype).replace("torch.", "")
    m = TM.init_params(tcfg, seed=0, device="cpu")["blocks"][0]["mamba"]
    assert m["A_log"].dtype == m["D"].dtype == m["dt_proj_b"].dtype \
        == torch.float32
    assert 0.0 <= float(m["A_log"].min()) and float(m["A_log"].max()) <= 1.1
    assert -4.0 <= float(m["dt_proj_b"].min()) \
        and float(m["dt_proj_b"].max()) <= -2.0
    assert abs(float(m["in_proj"].float().std()) - 0.02) < 2e-3


# ---------------------------------------------------------------------------
# the token engine
# ---------------------------------------------------------------------------

def _gear(lib_cascade, lib_gear, models, thresholds):
    return lib_gear(cascade=lib_cascade(tuple(models), tuple(thresholds)),
                    min_queue_lens={m: 1 for m in models},
                    load_fractions={m: {i: 1.0}
                                    for i, m in enumerate(models)})


@pytest.fixture(scope="module")
def engine_setup():
    jcfg = jax_smoke_config(ARCH)
    tcfg = get_smoke_config(ARCH)
    params = {}
    for name, seed in (("a", 0), ("b", 7)):
        tree = jax.tree.map(np.asarray, JM.init_params(
            jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32))
        params[name] = (jax.tree.map(jnp.asarray, tree),
                        params_from_numpy(tree, device="cpu"))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, tcfg.vocab_size, 2 + 3 * i).astype(np.int32)
               for i in range(5)]                 # from 2 < d_conv - 1 up
    finals = []
    for p in prompts:
        _, gaps = TT.greedy_generate(params["a"][1], tcfg, p, 6)
        c = StreamingCertainty()
        for g in gaps:
            c.update(float(g))
        finals.append(c.value)
    s = np.sort(finals)
    thr = float(0.5 * (s[1] + s[2]))              # splits the population
    return jcfg, tcfg, params, prompts, thr


def _serve(lib, cfg, params, prompts, thr, mode, spec_k):
    models = ["a", "b"]
    if lib is JT:
        kw, side, gear = {}, 0, _gear(JCascade, JGear, models, [thr])
    else:
        kw, side, gear = {"device": "cpu"}, 1, _gear(Cascade, Gear, models,
                                                     [thr])
    stages = [lib.SlotEngine(m, params[m][side], cfg, n_slots=3, max_len=40,
                             **kw) for m in models]
    te = lib.TokenEngine(stages, gear, min_tokens=2, mode=mode,
                         spec_k=spec_k)
    reqs = [lib.TokenRequest(i, p, 6) for i, p in enumerate(prompts)]
    return te.serve(reqs), stages


@pytest.mark.parametrize("mode,spec_k", MODES)
def test_token_engine_matches_jax(engine_setup, mode, spec_k):
    """A two-stage SSM cascade whose threshold splits the population
    (port of tests/test_decode_loop.py:240-254): every decision equal to
    the JAX engine's, every prefill exact-length at batch 1, and the conv
    pool widened to f32 by the first decode as the JAX pool is."""
    jcfg, tcfg, params, prompts, thr = engine_setup
    jout, jst = _serve(JT, jcfg, params, prompts, thr, mode, spec_k)
    tout, tst = _serve(TT, tcfg, params, prompts, thr, mode, spec_k)
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
                                       **LOGIT_TOL)
    assert {r.resolver for r in tout.values()} == {0, 1}
    for je, te in zip(jst, tst):
        assert te.stats.prefill_shapes == je.stats.prefill_shapes
        assert te.stats.prefill_shapes and all(
            b == 1 for b, _ in te.stats.prefill_shapes)
        assert te.stats.prefill_calls == te.stats.prefill_prompts
        for jb, tb in zip(je.cache["blocks"], te.cache["blocks"]):
            assert str(jb["conv"].dtype) == str(tb["conv"].dtype).replace(
                "torch.", "") == "float32"
