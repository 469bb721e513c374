"""The port's sharding rules, int8 pod exchange and the kernels' new plain
forms against the JAX package and float64 math, in one process (no
process group).

* Rules: for all ten arch ids' smoke params and caches, in train and serve
  modes, with ('data',) and ('pod', 'data') batch axes, every leaf's
  logical axes and spec equal JAX's ``param_logical_axes`` /
  ``param_pspecs`` / ``cache_logical_axes`` / ``cache_pspecs`` (both cache
  layouts); ``sanitize_pspec(s)`` on fake mesh shapes (with
  ``tests/test_sharding.py``'s cases), ``opt_state_pspecs``' ZeRO-1
  expansion and ``tree_bytes`` equal JAX's. Specs are compared entry for
  entry as tuples.
* The int8 exchange: per-pod gradients stacked from a numpy seed; the
  port's int8 blocks and scales bit-equal to the reference's jnp math
  (``repro/training/train_step.py:45-56``), the dequantised mean within
  one float32 ulp.
* ``decode_attention_ref(return_lse=True)`` against float64 math, rows
  with no valid key giving 0 and -inf; the n-shard flash-decode
  (``_flash_decode_shard`` + ``_combine_partials``, empty shards
  included) against the unsplit decode; ``flash_attention_ref`` with
  ``q_offset`` on query chunks, and its gradient, equal to slices of the
  unchunked call.
* The query-heads layout's kv heads (``kv_heads_read``, ``_kv_local``)
  against the reference's ``_repeat_kv`` order, for the production
  configs' head counts over 16 and the smoke ones over 4, and one whose
  local heads do not fall into whole groups (12 / 3 over 4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.distributed import sharding as jsh
from repro.distributed.context import DistContext as JDistContext
from repro.models import model as JM
from repro.training import init_opt_state as j_init_opt_state
from repro.training.optimizer import opt_state_pspecs as j_opt_state_pspecs
from repro_torch import tree as tree_lib
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.context import DistContext
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.training import init_opt_state, opt_state_pspecs
from repro_torch.training.train_step import dequantize_mean, quantize_int8

torch.set_num_threads(1)

BATCH_AXES = [("data",), ("pod", "data")]
MESHES = [{"data": 16, "model": 16, "pod": 2}, {"data": 4, "model": 2},
          {"data": 2, "model": 4, "pod": 2}]


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _jax_leaves(tree):
    """JAX tree's leaves where tuples (axes) and specs are leaves."""
    return jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, (tuple, JP)))


def _port_leaves(tree):
    return sh._spec_leaves(tree)


def _as_tuple(spec):
    return tuple(spec)


def _same(jtree, ttree):
    jl, tl = _jax_leaves(jtree), _port_leaves(ttree)
    assert len(jl) == len(tl) > 0
    for a, b in zip(jl, tl):
        assert _as_tuple(a) == _as_tuple(b), (a, b)


def _pair(arch):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = JM.init_params(jcfg, spec_only=True)
    tparams = TM.init_params(tcfg, seed=0, device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_arch_ids_are_the_same():
    assert tuple(ARCH_IDS) == tuple(JARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_rules_equal_jax(arch):
    _, _, jparams, tparams = _pair(arch)
    assert [tuple(a.shape) for a in jax.tree.leaves(jparams)] == \
        [tuple(t.shape) for t in tree_lib.leaves(tparams)]
    _same(jsh.param_logical_axes(jparams), sh.param_logical_axes(tparams))
    for axes in BATCH_AXES:
        jctx = JDistContext(mesh=None, batch_axes=axes)
        tctx = DistContext(mesh=None, batch_axes=axes)
        for mode in ("train", "serve"):
            jspecs = jsh.param_pspecs(jparams, jctx, mode)
            tspecs = sh.param_pspecs(tparams, tctx, mode)
            _same(jspecs, tspecs)
            for shape in MESHES:
                if "pod" in axes and "pod" not in shape:
                    continue
                js = jsh.sanitize_pspecs(jparams, jspecs, _FakeMesh(shape))
                ts = sh.sanitize_pspecs(tparams, tspecs, shape)
                _same(js, ts)
                for zero1 in (None, "pod") if "pod" in shape else (None,):
                    jo = j_opt_state_pspecs(js, zero1_axis=zero1)
                    to = opt_state_pspecs(ts, zero1_axis=zero1)
                    _same(jo["m"], to["m"])
                    _same(jo["v"], to["v"])
                    assert _as_tuple(jo["step"]) == _as_tuple(to["step"])
                    # the moments sanitize as the launchers do
                    _same(jsh.sanitize_pspecs(jparams, jo["m"],
                                              _FakeMesh(shape)),
                          sh.sanitize_pspecs(tparams, to["m"], shape))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_rules_equal_jax(arch):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    src = 6 if tcfg.is_encoder_decoder else 0
    jcache = JM.init_cache(jcfg, 4, 16, spec_only=True, source_len=src)
    tcache = TM.init_cache(tcfg, 4, 16, device="cpu", source_len=src)
    for seq in (False, True):
        _same(jsh.cache_logical_axes(jcache, seq),
              sh.cache_logical_axes(tcache, seq))
        for axes in BATCH_AXES:
            jctx = JDistContext(mesh=None, batch_axes=axes)
            tctx = DistContext(mesh=None, batch_axes=axes)
            jspecs = jsh.cache_pspecs(jcache, jctx, "serve", seq)
            tspecs = sh.cache_pspecs(tcache, tctx, "serve", seq)
            _same(jspecs, tspecs)
            for shape in MESHES:
                if "pod" in axes and "pod" not in shape:
                    continue
                _same(jsh.sanitize_pspecs(jcache, jspecs, _FakeMesh(shape)),
                      sh.sanitize_pspecs(tcache, tspecs, shape))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tree_bytes_equal_jax(arch):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TM.init_params(tcfg, seed=0, device="cpu")
    assert sh.tree_bytes(tparams) == jsh.tree_bytes(jparams)
    assert sh.tree_bytes(init_opt_state(tparams)) == \
        jsh.tree_bytes(j_init_opt_state(jparams))


SANITIZE_CASES = [
    ((24, 128, 32768, 2, 64), (None, "data", None, "model", None)),
    ((1, 32768), ("data", "model")),
    ((256, 10), (("pod", "data"), None)),
    ((6, 8), ("model", ("pod", "data"))),
    ((5,), (None,)),
    ((4, 16, 2), ("data",)),
    ((), ()),
]


@pytest.mark.parametrize("shape,spec", SANITIZE_CASES)
def test_sanitize_pspec_equals_jax(shape, spec):
    for mesh in MESHES:
        if any("pod" in (e if isinstance(e, tuple) else (e,))
               for e in spec if e) and "pod" not in mesh:
            continue
        j = jsh.sanitize_pspec(shape, JP(*spec), _FakeMesh(mesh))
        t = sh.sanitize_pspec(shape, sh.P(*spec), mesh)
        assert _as_tuple(j) == _as_tuple(t)
    # tests/test_sharding.py's cases
    fake = {"data": 16, "model": 16, "pod": 2}
    assert sh.sanitize_pspec((24, 128, 32768, 2, 64),
                             sh.P(None, "data", None, "model", None),
                             fake) == (None, "data", None, None, None)
    assert sh.sanitize_pspec((1, 32768), sh.P("data", "model"), fake) == \
        (None, "model")
    assert sh.sanitize_pspec((256, 10), sh.P(("pod", "data"), None),
                             fake) == (("pod", "data"), None)


def test_logical_specs_equal_jax():
    for axes in BATCH_AXES:
        jctx = JDistContext(mesh=None, batch_axes=axes)
        tctx = DistContext(mesh=None, batch_axes=axes)
        assert _as_tuple(jsh.batch_pspec(jctx)) == \
            _as_tuple(sh.batch_pspec(tctx))
        for mode in ("train", "serve"):
            for names in [("fsdp", "heads"), ("batch", "seq", None, None),
                          ("ep", None, "ffn"), ("vocab", "fsdp"),
                          ("batch", "kv_seq", None, None)]:
                assert _as_tuple(jsh.logical_pspec(names, jctx, mode)) == \
                    _as_tuple(sh.logical_pspec(names, tctx, mode))
    with pytest.raises(ValueError):
        sh.resolve_axis("nope", DistContext(mesh=None), "train")


def test_constrain_without_a_mesh_is_the_identity():
    x = torch.randn(2, 3)
    assert sh.constrain(x, "batch", None) is x


# ---------------------------------------------------------------------------
# the int8 pod exchange
# ---------------------------------------------------------------------------

def _jax_quantise(g):
    """The reference's per-pod math (train_step.py:45-56) without the
    collectives."""
    gf = g.astype(jnp.float32)
    scale = jnp.max(jnp.abs(gf)) / 127.0 + 1e-12
    q = jnp.clip(jnp.round(gf / scale), -127, 127).astype(jnp.int8)
    return q, scale


@pytest.mark.parametrize("npods,shape,dtype", [
    (2, (64, 33), np.float32), (4, (7, 5, 3), np.float32),
    (2, (1000,), "bfloat16"), (3, (16, 16), np.float32)])
def test_int8_exchange_equals_jax(npods, shape, dtype):
    rng = np.random.default_rng(npods * 10 + len(shape))
    grads = rng.standard_normal((npods,) + shape).astype(np.float32)
    grads[0].flat[0] = 2.5 * np.abs(grads[0]).max()     # an outlier
    grads[-1][...] *= 1e-3
    jg = jnp.asarray(grads).astype(jnp.bfloat16 if dtype == "bfloat16"
                                   else jnp.float32)
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    jq, js, tq, ts = [], [], [], []
    for p in range(npods):
        a, b = _jax_quantise(jg[p])
        c, d = quantize_int8(tg[p])
        jq.append(np.asarray(a))
        js.append(np.asarray(b))
        tq.append(c.numpy())
        ts.append(d.numpy())
        np.testing.assert_array_equal(tq[-1], jq[-1])
        assert ts[-1].tobytes() == js[-1].tobytes()
    q_all, s_all = np.stack(jq), np.stack(js)
    deq = q_all.astype(np.float32) * s_all.reshape((npods,) + (1,) * len(
        shape))
    jmean = np.asarray(jnp.sum(jnp.asarray(deq), axis=0) / npods)
    tmean = dequantize_mean(torch.from_numpy(np.stack(tq)),
                            torch.from_numpy(np.stack(ts))).numpy()
    ulp = np.spacing(np.abs(jmean).astype(np.float32))
    assert np.all(np.abs(tmean - jmean) <= ulp)
    # within half a quantisation step of each pod's own gradient
    for p in range(npods):
        err = np.abs(tq[p].astype(np.float32) * ts[p]
                     - tg[p].float().numpy())
        assert err.max() <= ts[p] / 2 * (1 + 1e-5) + 1e-7


# ---------------------------------------------------------------------------
# the kernels' new plain forms
# ---------------------------------------------------------------------------

def _decode_f64(q, k, v, vl):
    b, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    out = np.zeros((b, h, d))
    lse = np.full((b, h), -np.inf)
    for i in range(b):
        n = int(vl[i])
        if n == 0:
            continue
        for hh in range(h):
            s = k[i, :n, hh // g].astype(np.float64) @ \
                q[i, hh].astype(np.float64) / np.sqrt(d)
            m = s.max()
            w = np.exp(s - m)
            lse[i, hh] = m + np.log(w.sum())
            out[i, hh] = (w / w.sum()) @ v[i, :n, hh // g].astype(np.float64)
    return out, lse


@pytest.mark.parametrize("h,kv,d", [(4, 2, 32), (14, 2, 64), (8, 8, 80)])
def test_decode_ref_lse_against_float64(h, kv, d):
    rng = np.random.default_rng(h + d)
    b, c = 5, 37
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, c, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, c, kv, d)).astype(np.float32)
    vl = np.array([0, 1, 17, 37, 0], np.int32)
    out, lse = tref.decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(vl), return_lse=True)
    ro, rl = _decode_f64(q, k, v, vl)
    np.testing.assert_allclose(out.numpy(), ro, atol=2e-6, rtol=0)
    fin = np.isfinite(rl)
    np.testing.assert_allclose(lse.numpy()[fin], rl[fin], atol=2e-6, rtol=0)
    assert np.all(np.isneginf(lse.numpy()[~fin]))
    assert np.all(out.numpy()[vl == 0] == 0)
    plain = tref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v),
                                      torch.from_numpy(vl))
    assert torch.equal(plain, out)


@pytest.mark.parametrize("n,ci", [(2, 0), (4, 9), (4, 31), (8, 5), (8, 30)])
def test_flash_decode_shards_combine_to_the_unsplit_decode(n, ci):
    """n shards of a 32-slot cache, each through ``_flash_decode_shard``,
    combined by ``_combine_partials`` over a leading shard dim: the slot
    write and the output of one unsplit write + decode (shards past the
    new token are empty)."""
    rng = np.random.default_rng(n * 100 + ci)
    b, h, kv, d, c = 3, 8, 2, 32, 32
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    kn, vn = (torch.from_numpy(rng.standard_normal((b, kv, d)).astype(
        np.float32)) for _ in range(2))
    kc, vc = (torch.from_numpy(rng.standard_normal((b, c, kv, d)).astype(
        np.float32)) for _ in range(2))
    cis = torch.tensor([ci, max(ci - 3, 0), ci])
    rows = torch.arange(b)
    k1, v1 = kc.clone(), vc.clone()
    k1[rows, cis], v1[rows, cis] = kn, vn
    ref = tref.decode_attention_ref(q, k1, v1, cis + 1)
    chunk = c // n
    outs, lses = [], []
    k2, v2 = kc.clone(), vc.clone()
    for r in range(n):
        o, l_ = TA._flash_decode_shard(q, kn, vn,
                                       k2[:, r * chunk:(r + 1) * chunk],
                                       v2[:, r * chunk:(r + 1) * chunk],
                                       cis, r * chunk)
        assert torch.isfinite(o).all() and not torch.isnan(l_).any()
        outs.append(o)
        lses.append(l_)
    out = TA._combine_partials(torch.stack(outs), torch.stack(lses),
                               lambda t: t.amax(0), lambda t: t.sum(0))
    assert torch.equal(k2, k1) and torch.equal(v2, v1)
    torch.testing.assert_close(out, ref, atol=2e-6, rtol=0)
    # one shard's rescale dropped (its weight 1 instead of exp(lse - m))
    # fails the same limit, wherever that shard is not the largest
    ls, os_ = torch.stack(lses), torch.stack(outs)
    w = torch.exp(ls - ls.amax(0))
    r = int(torch.argmin(torch.where(torch.isinf(ls), 2.0, w).amin((1, 2))))
    if n > 2 and ci > 8:
        assert float(w[r].min()) < 0.5
        w[r] = torch.where(torch.isinf(ls[r]), 0.0, 1.0)
        bad = (os_ * w[..., None]).sum(0) / w.sum(0)[..., None]
        assert (bad - ref).abs().max() > 2e-6


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("chunks", [2, 4])
def test_flash_ref_q_offset_chunks_equal_slices(window, chunks):
    """Each query chunk at its offset, over the keys up to its end, gives
    that chunk of the whole call, and so do its gradients."""
    rng = np.random.default_rng(window + chunks)
    b, s, h, kv, d = 2, 24, 4, 2, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d)).astype(
        np.float32)).requires_grad_(True) for n in (h, kv, kv))
    dout = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32))
    whole = tref.flash_attention_ref(q, k, v, causal=True, window=window)
    gq, gk, gv = torch.autograd.grad(whole, (q, k, v), dout)
    c = s // chunks
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for r in range(chunks):
        end = (r + 1) * c
        part = tref.flash_attention_ref(q[:, r * c:end], k[:, :end],
                                        v[:, :end], causal=True,
                                        window=window, q_offset=r * c)
        torch.testing.assert_close(part, whole[:, r * c:end], atol=1e-6,
                                   rtol=0)
        a, bk, bv = torch.autograd.grad(part, (q, k, v),
                                        dout[:, r * c:end])
        dq, dk, dv = dq + a, dk + bk, dv + bv
        # the plain backward with the offset, against autograd
        o = part.detach()
        pq, pk, pv = tref.flash_attention_bwd_ref(
            q[:, r * c:end].detach(), k[:, :end].detach(),
            v[:, :end].detach(), o, dout[:, r * c:end], causal=True,
            window=window, q_offset=r * c)
        torch.testing.assert_close(pq, a[:, r * c:end], atol=1e-5, rtol=0)
        torch.testing.assert_close(pk, bk[:, :end], atol=1e-5, rtol=0)
        torch.testing.assert_close(pv, bv[:, :end], atol=1e-5, rtol=0)
    for got, want in ((dq, gq), (dk, gk), (dv, gv)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):     # the keys must end at the chunk
        tref.flash_attention_ref(q[:, :c], k, v, causal=True, q_offset=0)
    with pytest.raises(ValueError):
        tref.flash_attention_ref(q[:, :c], k, v, causal=False, q_offset=1)


def test_replace_keeps_the_port_config_in_step():
    """The 6-head config the sequence-parallel tests use is the same in
    both packages."""
    j = dataclasses.replace(jax_smoke_config("qwen2-0.5b"), num_heads=6)
    t = dataclasses.replace(get_smoke_config("qwen2-0.5b"), num_heads=6)
    assert (j.num_heads, j.num_kv_heads, j.head_dim, j.d_model) == \
        (t.num_heads, t.num_kv_heads, t.head_dim, t.d_model)


@pytest.mark.parametrize("h,kv,n", [(64, 8, 16), (32, 8, 16), (4, 2, 4),
                                    (8, 2, 4), (12, 3, 4)])
def test_kv_heads_read_follow_the_reference_repeat(h, kv, n, monkeypatch):
    """In the query-heads layout each process's query heads read the kv
    heads the reference's ``_repeat_kv`` gives them, and the plain flash
    and decode over what ``_kv_local`` takes (a strided view of the
    slice; a copy with one kv head per local head where they do not fall
    into whole groups) equal the unsplit calls' heads."""
    import types
    from repro.models.attention import _repeat_kv
    want = np.asarray(_repeat_kv(jnp.arange(kv).reshape(1, 1, kv, 1),
                                 h)).reshape(h)
    m = h // n
    rng = np.random.default_rng(h * 100 + kv * 10 + n)
    d, s = 8, 5
    q = torch.from_numpy(rng.standard_normal((2, s, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, s, kv, d))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, s, kv, d))
                         .astype(np.float32))
    full = tref.flash_attention_ref(q, k, v, causal=True)
    step = tref.decode_attention_ref(q[:, -1], k, v, s)
    cfg = types.SimpleNamespace(num_heads=h, num_kv_heads=kv)
    monkeypatch.setattr(TA, "get_context",
                        lambda: types.SimpleNamespace(model_axis="model"))
    monkeypatch.setattr(TA.compat, "axis_size", lambda axis, mesh=None: n)
    whole_groups = 0
    for r in range(n):
        lo, hi, group, heads = TA.kv_heads_read(h, kv, n, r)
        got = [lo + j // group if heads is None else heads[j]
               for j in range(m)]
        assert got == list(want[r * m:(r + 1) * m]), (r, lo, hi, group)
        monkeypatch.setattr(TA.compat, "axis_index",
                            lambda axis, mesh=None, r=r: r)
        ks, vs = TA._kv_local(cfg, k, v)
        if heads is None:
            whole_groups += 1
            assert (hi - lo) * group == m
            assert ks.shape[2] == hi - lo and ks.data_ptr() == \
                k[:, :, lo:].data_ptr()         # a view: the cache stays
        else:
            assert group == 1 and lo == heads[0] and hi == heads[-1] + 1
            assert ks.shape[2] == m
        mine = slice(r * m, (r + 1) * m)
        torch.testing.assert_close(
            tref.flash_attention_ref(q[:, :, mine].contiguous(), ks, vs,
                                     causal=True), full[:, :, mine],
            atol=1e-6, rtol=0)
        torch.testing.assert_close(
            tref.decode_attention_ref(q[:, -1, mine].contiguous(), ks, vs,
                                      s), step[:, mine], atol=1e-6, rtol=0)
    # every config of the repo falls into whole groups; 12 / 3 on 4 not
    assert whole_groups == (n if (h, kv) != (12, 3) else 2)
