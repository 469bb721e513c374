"""The port's model (repro_torch.models) against the JAX model on the same
inputs, on the CPU.

Params come from the JAX ``init_params(..., dtype=float32)`` at
``get_smoke_config("qwen2-0.5b")`` size (4 layers, d 128, 4 heads, 2 KV
heads, hd 32, vocab 512), with seeded random QKV biases so the bias path is
exercised, converted through ``repro_torch.convert``. Besides the qwen2
smoke config, two variants of it cover the other ported branches: qk-norm
with LayerNorm and an untied head, and a sliding-window ring with the
non-parametric LayerNorm.

Tolerances: logits atol 1e-4 / rtol 1e-4 and cache contents atol 1e-5
(float32, different summation order and transcendental implementations);
greedy tokens equal up to the first step whose JAX top-2 gap is below 1e-4
(near-ties may flip across frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import certainty as jcert
from repro.models import model as JM
from repro.serving.token_engine import greedy_generate as jax_greedy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import cache_from_numpy, params_from_numpy, to_numpy
from repro_torch.core import certainty as tcert
from repro_torch.models import model as TM
from repro_torch.serving.token_engine import greedy_generate

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=0)

VARIANTS = {
    "qwen2": {},
    "qknorm_layernorm_untied": dict(qk_norm=True, norm_type="layernorm",
                                    tie_embeddings=False),
    "swa_nonparametric_ln": dict(sliding_window=16,
                                 norm_type="nonparametric_ln"),
}


def _configs(variant):
    over = VARIANTS[variant]
    return (jax_smoke_config("qwen2-0.5b").scaled(**over),
            get_smoke_config("qwen2-0.5b").scaled(**over))


def _params(jcfg, seed=0):
    tree = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32))
    rng = np.random.default_rng(seed + 100)
    for blk in tree["blocks"]:
        for name in ("bq", "bk", "bv"):
            if name in blk["attn"]:
                blk["attn"][name] = (rng.standard_normal(
                    blk["attn"][name].shape) * 0.02).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree,
                                                       device="cpu")


def _cache_close(tcache, jcache):
    tleaves = [t for blk in tcache["blocks"] for t in (blk["k"], blk["v"])]
    jleaves = [a for blk in jcache["blocks"] for a in (blk["k"], blk["v"])]
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(to_numpy(t), np.asarray(j, np.float32),
                                   **CACHE_TOL)


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    jcfg, tcfg = _configs(variant)
    jp, tp = _params(jcfg)
    toks = _tokens(1, (2, 20))
    jl, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, aux = TM.forward(tp, tcfg, {"tokens": toks})
    assert tl.dtype == torch.float32 and tl.shape == (2, 20, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_matches_jax(variant):
    """Pad path (20 < 24) for the flat cache; cut-and-roll path for the
    16-slot sliding-window ring."""
    jcfg, tcfg = _configs(variant)
    jp, tp = _params(jcfg)
    toks = _tokens(2, (2, 20))
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        cache_len=24)
    tl, tc = TM.prefill(tp, tcfg, {"tokens": toks}, cache_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _cache_close(tc, jc)
    with pytest.raises(ValueError):
        TM.prefill(tp, tcfg, {"tokens": toks}, cache_len=8)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("ragged", [False, True])
def test_decode_step_matches_jax(variant, ragged):
    """Three decode steps from the same prefill cache, scalar or ragged
    (B,) cache_index; the port writes the cache in place."""
    jcfg, tcfg = _configs(variant)
    jp, tp = _params(jcfg)
    toks = _tokens(3, (2, 20))
    _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                       cache_len=24)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    ci = np.asarray([20, 7], np.int32) if ragged else np.int32(20)
    for step in range(3):
        nxt = _tokens(10 + step, (2, 1))
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                                jnp.asarray(ci))
        tl, tc2 = TM.decode_step(tp, tcfg, nxt, tc, torch.from_numpy(
            np.asarray(ci)))
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _cache_close(tc, jc)
        ci = ci + 1


def test_prefill_bucketed_matches_jax():
    jcfg, tcfg = _configs("qwen2")
    jp, tp = _params(jcfg, seed=3)
    lens = np.asarray([5, 9, 14, 1], np.int32)   # last row: batch-pad row
    arr = np.zeros((4, 16), np.int32)
    for i, n in enumerate(lens):
        arr[i, :n] = _tokens(20 + i, (n,))
    jl, jc = JM.prefill_bucketed(jp, jcfg, jnp.asarray(arr),
                                 jnp.asarray(lens), cache_len=32)
    tl, tc = TM.prefill_bucketed(tp, tcfg, arr, lens, cache_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _cache_close(tc, jc)
    # right padding is invisible to each row's real positions
    for i, n in enumerate(lens[:3]):
        solo, _ = TM.prefill(tp, tcfg, {"tokens": arr[i:i + 1, :n]},
                             cache_len=32)
        np.testing.assert_allclose(tl[i].numpy(), solo[0].numpy(),
                                   atol=1e-5, rtol=0)
    assert TM.bucketed_prefill_supported(tcfg)
    with pytest.raises(ValueError):
        TM.prefill_bucketed(tp, tcfg, arr, lens, cache_len=8)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("mode", ["ewma", "min"])
def test_decode_fused_steps_matches_jax(k, mode):
    """k fused greedy steps (argmax/top-2 gap + device fold) from the same
    bucketed-prefill cache; one inactive row rides along at position 0."""
    jcfg, tcfg = _configs("qwen2")
    jp, tp = _params(jcfg, seed=4)
    lens = np.asarray([6, 11, 3], np.int32)
    arr = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lens):
        arr[i, :n] = _tokens(30 + i, (n,))
    jl, jc = JM.prefill_bucketed(jp, jcfg, jnp.asarray(arr),
                                 jnp.asarray(lens), cache_len=32)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    first = np.array(jnp.argmax(jl, axis=-1), np.int32)
    gaps0 = np.array(jcert.top2_gap(jl), np.float32)
    active = np.asarray([True, True, False])
    rows = np.arange(3)
    jst = jcert.device_fold_set_rows(jcert.device_fold_init(3),
                                     jnp.asarray(rows), jnp.asarray(gaps0))
    tst = tcert.device_fold_set_rows(tcert.device_fold_init(3, "cpu"),
                                     torch.from_numpy(rows),
                                     torch.from_numpy(gaps0))
    jout = JM.decode_fused_steps(jp, jcfg, jnp.asarray(first), jc,
                                 jnp.asarray(lens), jnp.asarray(active), jst,
                                 k=k, mode=mode)
    tout = TM.decode_fused_steps(tp, tcfg, torch.from_numpy(first), tc,
                                 torch.from_numpy(lens),
                                 torch.from_numpy(active), tst, k=k,
                                 mode=mode)
    jtt, jgt, jct, jtok, jc2, jpos, jst2 = jout
    ttt, tgt, tct, ttok, tc2, tpos, tst2 = tout
    assert ttt.shape == (k, 3) and ttt.dtype == torch.int32
    assert (np.asarray(jgt) > 1e-4).all()        # no near-tie in this draw
    np.testing.assert_array_equal(ttt.numpy(), np.asarray(jtt))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jgt), **LOGIT_TOL)
    np.testing.assert_allclose(tct.numpy(), np.asarray(jct), **LOGIT_TOL)
    for name in ("mean", "min", "ewma"):
        np.testing.assert_allclose(tst2[name].numpy(),
                                   np.asarray(jst2[name]), **LOGIT_TOL)
    np.testing.assert_array_equal(tst2["count"].numpy(),
                                  np.asarray(jst2["count"]))
    _cache_close(tc2, jc2)
    with pytest.raises(ValueError):
        TM.decode_fused_steps(tp, tcfg, torch.from_numpy(first), tc,
                              torch.from_numpy(lens),
                              torch.from_numpy(active), tst, k=0)


def test_greedy_generate_matches_jax():
    jcfg, tcfg = _configs("qwen2")
    jp, tp = _params(jcfg, seed=1)
    prompt = _tokens(5, (11,))
    jt, jg = jax_greedy(jp, jcfg, prompt, 8)
    tt, tg = greedy_generate(tp, tcfg, prompt, 8)
    near = np.flatnonzero(jg < 1e-4)
    n = int(near[0]) + 1 if near.size else len(jt)
    np.testing.assert_array_equal(tt[:n], jt[:n])
    np.testing.assert_allclose(tg[:n], jg[:n], **LOGIT_TOL)


def test_unported_configs_raise():
    """Every arch id is registered, and every model path is ported: the
    encoder-decoder and the vision frontend, which once refused here,
    build with the JAX init's tree and never right-pad their prompts (as
    in the reference). An MoE FFN is ported: a dense config given one
    builds, and its prefill is never right-padded (capacity routing
    depends on the call's tokens)."""
    for arch in ("seamless-m4t-large-v2", "internvl2-1b"):
        cfg = get_smoke_config(arch)
        own = jax.tree.structure(TM.init_params(cfg, device="cpu"))
        assert own == jax.tree.structure(JM.init_params(
            jax_smoke_config(arch), jax.random.PRNGKey(0)))
        assert not TM.bucketed_prefill_supported(cfg)
    assert get_config("olmo-1b").name == "olmo-1b"
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    moe = get_smoke_config("qwen2-0.5b").scaled(
        moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=64))
    params = TM.init_params(moe, device="cpu")
    assert all(tuple(b["moe"]["w_gate"].shape) == (4, 4, 128, 64)
               for b in params["blocks"])
    assert not TM.bucketed_prefill_supported(moe)


def test_init_params_layout_matches_jax():
    """Same tree, shapes and dtypes as the JAX init (values differ: the
    generators differ)."""
    jcfg, tcfg = _configs("qknorm_layernorm_untied")
    jtree = JM.init_params(jcfg, jax.random.PRNGKey(0))
    ttree = TM.init_params(tcfg, seed=0, device="cpu")
    jl, jdef = jax.tree.flatten(jtree)
    tl, tdef = jax.tree.flatten(ttree)
    assert jdef == tdef
    for j, t in zip(jl, tl):
        assert j.shape == tuple(t.shape)
        assert str(j.dtype) == str(t.dtype).replace("torch.", "")
    w = ttree["blocks"][0]["attn"]["wq"].float()
    assert abs(float(w.std()) - 0.02) < 2e-3
