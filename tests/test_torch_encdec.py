"""The port's encoder-decoder (seamless-m4t-large-v2) and vision-prefix
(internvl2-1b) model paths against the JAX package's, on the CPU, and the
port's counterparts of ``tests/test_models_smoke.py``'s forward and
prefill/decode shape checks over all ten arch ids.

Params come from the JAX ``init_params(..., dtype=float32)`` at each smoke
config (seamless: 4 decoder and 2 encoder layers, d 128, 4 = 4 KV heads at
hd 32, LayerNorm with bias, GeGLU, frontend_dim 128; internvl2: 4 layers,
4 heads over 2 KV, QKV bias, 8 prefix embeddings of width 64), with every
norm scale and LayerNorm bias moved off 1 and 0 so a misapplied norm
shows, carried across by ``repro_torch.convert``. Inputs are numpy arrays
from seeded generators handed to both packages.

Tolerances: ``encode`` within 1e-5 (float32, other summation orders);
logits within atol 1e-4 / rtol 1e-4 and caches within 1e-5, as in
``tests/test_torch_dense.py``; greedy tokens equal wherever the JAX top-2
gap exceeds 1e-4 (near-ties may flip across frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import certainty as jcert
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.convert import cache_from_numpy, params_from_numpy, to_numpy
from repro_torch.core import certainty as tcert
from repro_torch.models import attention as TA
from repro_torch.models import model as TM

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)

ENCODE_TOL = dict(atol=1e-5, rtol=0)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=0)
NEAR = 1e-4
SEAMLESS, INTERNVL = "seamless-m4t-large-v2", "internvl2-1b"
S_SRC = 24                    # source frames per row (not a tile multiple)


def _perturb_norms(tree, rng):
    """Every norm scale moved off 1 and every LayerNorm bias off 0."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k.endswith("scale"):
                out[k] = (v * (1.0 + 0.1 * rng.standard_normal(v.shape))
                          ).astype(np.float32)
            elif k == "bias":
                out[k] = (0.1 * rng.standard_normal(v.shape)
                          ).astype(np.float32)
            else:
                out[k] = _perturb_norms(v, rng)
        return out
    if isinstance(tree, list):
        return [_perturb_norms(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module", params=[SEAMLESS, INTERNVL])
def model(request):
    arch = request.param
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    tree = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    tree = _perturb_norms(tree, np.random.default_rng(1))
    return (arch, jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def _batch(cfg, seed, b, s):
    """tokens (B, S) and the arch's extra input, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
             .astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["source_frames"] = rng.standard_normal(
            (b, S_SRC, cfg.frontend.frontend_dim or cfg.d_model)) \
            .astype(np.float32)
    if cfg.frontend.kind == "vision":
        batch["prefix_embeddings"] = rng.standard_normal(
            (b, cfg.frontend.num_prefix_embeddings,
             cfg.frontend.frontend_dim)).astype(np.float32)
    return batch


def _prefix_len(cfg) -> int:
    return (cfg.frontend.num_prefix_embeddings
            if cfg.frontend.kind == "vision" else 0)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves(cache):
    """The cache's tensors in a fixed order: self K/V, then cross K/V."""
    out = [blk[n] for blk in cache["blocks"] for n in ("k", "v")]
    for blk in cache.get("cross", []):
        out += [blk[n] for n in ("ck", "cv") if n in blk]
    return out


def _cache_close(tcache, jcache):
    assert sorted(tcache) == sorted(jcache)
    tl, jl = _leaves(tcache), _leaves(jcache)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(to_numpy(t), np.asarray(j, np.float32),
                                   **CACHE_TOL)


# ---------------------------------------------------------------------------
# params and the encoder
# ---------------------------------------------------------------------------

def test_params_carry_across_and_own_init_has_jax_layout(model):
    """The converted tree equals the JAX tree, structure and values:
    ``frontend_proj`` on both, ``encoder`` (one rep-stacked block, its
    final norm) and each decoder block's ``cross_norm`` + ``cross`` on
    seamless only. The port's own init builds the JAX init's structure,
    shapes and dtypes."""
    arch, jcfg, tcfg, jp, tp = model
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert jdef == tdef
    for j, t in zip(jl, tl):
        assert np.array_equal(np.asarray(j), t.numpy())
    assert "frontend_proj" in tp
    assert ("encoder" in tp) == (arch == SEAMLESS)
    assert ("cross" in tp["blocks"][0]) == (arch == SEAMLESS)
    if arch == SEAMLESS:
        enc = tp["encoder"]["blocks"][0]
        assert tuple(enc["attn"]["wq"].shape) == (2, 128, 128)
        assert "bias" in tp["encoder"]["final_norm"]
    own = jax.tree.flatten(TM.init_params(tcfg, seed=0, device="cpu"))
    ref = jax.tree.flatten(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    assert own[1] == ref[1]
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in own[0]] == [(j.shape, str(j.dtype)) for j in ref[0]]


def test_encode_matches_jax():
    """The encoder (full self-attention: every frame sees every frame,
    RoPE applied; GeGLU; its final LayerNorm) within 1e-5."""
    jcfg, tcfg = jax_smoke_config(SEAMLESS), get_smoke_config(SEAMLESS)
    tree = _perturb_norms(jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)),
        np.random.default_rng(4))
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(
        tree, device="cpu")
    frames = _batch(tcfg, 5, 2, 1)["source_frames"]
    jm = JM.encode(jp, jcfg, jnp.asarray(frames))
    tm = TM.encode(tp, tcfg, frames)
    assert tm.shape == (2, S_SRC, 128) and tm.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **ENCODE_TOL)
    # not causal: the first frame's output sees the last frame
    frames2 = frames.copy()
    frames2[:, -1] += 1.0
    assert not np.allclose(TM.encode(tp, tcfg, frames2)[:, 0].numpy(),
                           tm[:, 0].numpy(), atol=1e-3)


@pytest.mark.parametrize("sq", [1, 7])
def test_cross_attention_matches_jax(sq):
    """``cross_attention`` alone: Sq decoder rows over 24 memory rows (the
    decode kernel's form at Sq 1, the flash kernel's full form with its
    own key length above), and ``make_cross_kv``."""
    jcfg, tcfg = jax_smoke_config(SEAMLESS), get_smoke_config(SEAMLESS)
    tree = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(6), dtype=jnp.float32))
    cross = jax.tree.map(lambda a: a[1], tree["blocks"][0]["cross"])
    tcross = params_from_numpy(cross, device="cpu")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, sq, 128)).astype(np.float32)
    mem = rng.standard_normal((2, S_SRC, 128)).astype(np.float32)
    jcross = jax.tree.map(jnp.asarray, cross)
    jo = JA.cross_attention(jcross, jcfg, jnp.asarray(x), jnp.asarray(mem))
    to = TA.cross_attention(tcross, tcfg, torch.from_numpy(x),
                            torch.from_numpy(mem))
    assert to.shape == (2, sq, 128)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **ENCODE_TOL)
    jk, jv = JA.make_cross_kv(jcross, jcfg, jnp.asarray(mem))
    tk, tv = TA.make_cross_kv(tcross, tcfg, torch.from_numpy(mem))
    assert tuple(tk.shape) == (2, S_SRC, 4, 32)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **ENCODE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **ENCODE_TOL)


@pytest.mark.parametrize("sq,sk,d", [(32, 500, 64), (7, 24, 32),
                                    (65, 3, 80)])
def test_flash_attention_keys_of_their_own_length_match_jax(sq, sk, d):
    """The flash wrapper's plain version (what a CPU tensor runs) in its
    full form over Sk keys for Sq queries, against the JAX package's
    ``kernels/ref.py`` on the same inputs in its (B, H, S, hd) layout;
    the causal and windowed forms refuse Sk != Sq."""
    from repro.kernels import ref as jref
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(15)
    q = rng.standard_normal((2, sq, 4, d)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, d)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, d)).astype(np.float32)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=False)
    jout = jref.flash_attention_ref(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)),
        causal=False)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jout).transpose(0, 2, 1, 3),
                               **ENCODE_TOL)
    for window in (0, 4):
        with pytest.raises(ValueError):
            flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=True, window=window)


# ---------------------------------------------------------------------------
# model parity
# ---------------------------------------------------------------------------

def test_forward_matches_jax(model):
    _, jcfg, tcfg, jp, tp = model
    batch = _batch(tcfg, 8, 2, 20)
    jl, _ = JM.forward(jp, jcfg, _jax(batch))
    tl, aux = TM.forward(tp, tcfg, batch)
    s_tot = 20 + _prefix_len(tcfg)
    assert tl.dtype == torch.float32 and tl.shape == (2, s_tot, 512)
    assert float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_prefill_matches_jax(model):
    """Last-position logits and the cache (self K/V over prefix and text;
    seamless's cross K/V from the encoder) against JAX; a cache_len short
    of the prefix plus the prompt raises in both."""
    _, jcfg, tcfg, jp, tp = model
    batch = _batch(tcfg, 9, 2, 20)
    n = 20 + _prefix_len(tcfg)
    jl, jc = JM.prefill(jp, jcfg, _jax(batch), cache_len=n + 4)
    tl, tc = TM.prefill(tp, tcfg, batch, cache_len=n + 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _cache_close(tc, jc)
    assert tc["blocks"][0]["k"].shape[2] == n + 4
    if tcfg.is_encoder_decoder:
        assert tuple(tc["cross"][0]["ck"].shape) == (4, 2, S_SRC, 4, 32)
    with pytest.raises(ValueError):
        JM.prefill(jp, jcfg, _jax(batch), cache_len=n - 1)
    with pytest.raises(ValueError):
        TM.prefill(tp, tcfg, batch, cache_len=n - 1)


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_matches_jax_and_forward(model, ragged):
    """Three teacher-forced decode steps from one JAX prefill cache, scalar
    or ragged (B,) ``cache_index`` (positions count the prefix): logits
    and cache against JAX's, and each row's logits against the port's own
    forward over the same tokens and frames or prefix."""
    _, jcfg, tcfg, jp, tp = model
    batch = _batch(tcfg, 10, 2, 23)
    pre = _prefix_len(tcfg)
    lens = np.asarray([20, 7] if ragged else [20, 20], np.int32)
    head = dict(batch, tokens=batch["tokens"][:, :20])
    _, jc = JM.prefill(jp, jcfg, _jax(head), cache_len=pre + 24)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    ci = pre + lens if ragged else np.int32(pre + 20)
    toks = batch["tokens"]
    for step in range(3):
        nxt = np.stack([toks[b, lens[b] + step] for b in range(2)])[:, None]
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                                jnp.asarray(ci))
        tl, tc = TM.decode_step(tp, tcfg, nxt, tc,
                                torch.from_numpy(np.asarray(ci)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _cache_close(tc, jc)
        for b in range(2):
            n = int(lens[b]) + step + 1
            seq = np.concatenate([toks[b, :lens[b]],
                                  toks[b, lens[b]:lens[b] + step + 1]])
            row = {k: v[b:b + 1] for k, v in batch.items()}
            row["tokens"] = seq[None].astype(np.int32)
            fl, _ = TM.forward(tp, tcfg, row)
            np.testing.assert_allclose(tl[b].numpy(),
                                       fl[0, pre + n - 1].numpy(),
                                       **LOGIT_TOL)
        ci = ci + 1


@pytest.mark.parametrize("k", [1, 3])
def test_decode_fused_steps_carries_the_cross_cache(model, k):
    """k fused greedy steps (argmax/top-2 gap + device fold) from the same
    prefill cache against JAX: seamless's ``cache["cross"]`` rides along
    unchanged; one inactive row rides at position 0."""
    _, jcfg, tcfg, jp, tp = model
    batch = _batch(tcfg, 11, 3, 9)
    pre = _prefix_len(tcfg)
    jl, jc = JM.prefill(jp, jcfg, _jax(batch), cache_len=pre + 9 + k)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    cross_before = [blk[n].clone() for blk in tc.get("cross", [])
                    for n in ("ck", "cv") if n in blk]
    first = np.array(jnp.argmax(jl, axis=-1), np.int32)
    gaps0 = np.array(jcert.top2_gap(jl), np.float32)
    active = np.asarray([True, False, True])
    pos = np.full(3, pre + 9, np.int32)
    rows = np.arange(3)
    jst = jcert.device_fold_set_rows(jcert.device_fold_init(3),
                                     jnp.asarray(rows), jnp.asarray(gaps0))
    tst = tcert.device_fold_set_rows(tcert.device_fold_init(3, "cpu"),
                                     torch.from_numpy(rows),
                                     torch.from_numpy(gaps0))
    jout = JM.decode_fused_steps(jp, jcfg, jnp.asarray(first), jc,
                                 jnp.asarray(pos), jnp.asarray(active), jst,
                                 k=k)
    tout = TM.decode_fused_steps(tp, tcfg, torch.from_numpy(first), tc,
                                 torch.from_numpy(pos),
                                 torch.from_numpy(active), tst, k=k)
    jtt, jgt, jct, jtok, jc2, jpos, _ = jout
    ttt, tgt, tct, ttok, tc2, tpos, _ = tout
    assert (np.asarray(jgt) > NEAR).all()        # no near-tie in this draw
    np.testing.assert_array_equal(ttt.numpy(), np.asarray(jtt))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jgt), **LOGIT_TOL)
    np.testing.assert_allclose(tct.numpy(), np.asarray(jct), **LOGIT_TOL)
    _cache_close(tc2, jc2)
    assert ("cross" in tc2) == tcfg.is_encoder_decoder
    cross_after = [blk[n] for blk in tc2.get("cross", [])
                   for n in ("ck", "cv") if n in blk]
    assert len(cross_after) == len(cross_before) == \
        (2 if tcfg.is_encoder_decoder else 0)
    for before, after in zip(cross_before, cross_after):
        assert torch.equal(before, after)


def test_greedy_decode_tokens_match_jax(model):
    """Eight greedy steps, prefill then decode_step, on both packages: the
    tokens agree up to the first step whose JAX top-2 gap is within the
    near-tie guard."""
    _, jcfg, tcfg, jp, tp = model
    batch = _batch(tcfg, 12, 1, 6)
    pre = _prefix_len(tcfg)
    jl, jc = JM.prefill(jp, jcfg, _jax(batch), cache_len=pre + 14)
    tl, tc = TM.prefill(tp, tcfg, batch, cache_len=pre + 14)
    jt, tt, jg = [], [], []
    for i in range(8):
        jtok = int(jnp.argmax(jl[0]))
        jt.append(jtok)
        tt.append(int(torch.argmax(tl[0])))
        jg.append(float(jcert.top2_gap(jl)[0]))
        nxt = np.asarray([[jtok]], np.int32)
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                                jnp.asarray(pre + 6 + i, jnp.int32))
        tl, tc = TM.decode_step(tp, tcfg, nxt, tc, pre + 6 + i)
    near = np.flatnonzero(np.asarray(jg) < NEAR)
    n = int(near[0]) + 1 if near.size else len(jt)
    assert tt[:n] == jt[:n]


def test_init_cache_matches_jax_layout():
    """``init_cache(..., source_len=)`` has the JAX cache's structure,
    shapes and dtype: self K/V per position and, for the enc-dec, the
    cross K/V at the source length."""
    for arch in (SEAMLESS, INTERNVL):
        jc = JM.init_cache(jax_smoke_config(arch), 3, 40, source_len=17)
        tc = TM.init_cache(get_smoke_config(arch), 3, 40, device="cpu",
                           source_len=17)
        jl, jdef = jax.tree.flatten(jc)
        tl, tdef = jax.tree.flatten(tc)
        assert jdef == tdef
        assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for t in tl] == [(j.shape, str(j.dtype)) for j in jl]
        assert all(not t.any() for t in tl)


def test_bucketed_prefill_stays_refused():
    """As in the reference, neither family right-pads its prompts."""
    for arch in (SEAMLESS, INTERNVL):
        cfg = get_smoke_config(arch)
        assert not TM.bucketed_prefill_supported(cfg)
        assert not JM.bucketed_prefill_supported(jax_smoke_config(arch))
        with pytest.raises(ValueError):
            TM.prefill_bucketed(TM.init_params(cfg, device="cpu"), cfg,
                                np.zeros((1, 4), np.int32), [4], 8)


# ---------------------------------------------------------------------------
# the port's counterparts of tests/test_models_smoke.py, every arch id
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JARCH_IDS)
def test_forward_shapes_every_arch(arch):
    """The forward half of ``test_forward_and_train_step``: the port's own
    bf16 init at the smoke config, a (2, 24) batch (with 8 prefix
    embeddings or 16 source frames where the arch takes them): logits
    (2, S_tot, V) f32 and finite, the aux loss a finite scalar."""
    assert arch in ARCH_IDS
    cfg = get_smoke_config(arch)
    params = TM.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg, 13, 2, 24)
    if cfg.is_encoder_decoder:
        batch["source_frames"] = batch["source_frames"][:, :16]
    logits, aux = TM.forward(params, cfg, batch)
    assert logits.shape == (2, 24 + _prefix_len(cfg), cfg.vocab_size)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    assert aux.shape == () and bool(torch.isfinite(aux))


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_prefill_decode_shapes_every_arch(arch):
    """``test_prefill_decode_shapes``: the cache covers prefix and prompt
    (S_tot + 4), prefill logits (B, V), one decode step at S_tot gives
    finite (B, V) logits, and the cache keeps the JAX cache's structure
    (``cross`` included) through the step."""
    cfg = get_smoke_config(arch)
    jcfg = jax_smoke_config(arch)
    params = TM.init_params(cfg, seed=0, device="cpu")
    b, s = 2, 16
    batch = _batch(cfg, 14, b, s)
    s_tot = s + _prefix_len(cfg)
    logits, cache = TM.prefill(params, cfg, batch, cache_len=s_tot + 4)
    assert logits.shape == (b, cfg.vocab_size)
    jcache = JM.init_cache(jcfg, b, s_tot + 4, spec_only=True,
                           source_len=S_SRC)
    structure = jax.tree.structure(cache)
    assert structure == jax.tree.structure(jcache)
    dlogits, cache2 = TM.decode_step(params, cfg, np.zeros((b, 1), np.int32),
                                     cache, s_tot)
    assert dlogits.shape == (b, cfg.vocab_size)
    assert bool(torch.isfinite(dlogits).all())
    assert jax.tree.structure(cache2) == structure
