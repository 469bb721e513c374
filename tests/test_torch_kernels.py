"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (repro_torch.kernels
.ref); those are held against the Pallas kernels in interpret mode and
against repro.kernels.ref on the same seeded numpy inputs, over the shape
sweeps of tests/test_kernels.py. The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_kernels_cuda.py.

The flash backward has no Pallas counterpart: its plain version
(``ref.flash_attention_bwd_ref``) is held against ``jax.grad`` of the JAX
model's ``sdpa_gqa``. The selective scan's chunk states (the forward's
optional output for its backward) are held against the plain recurrence
stopped at each chunk's start, and against the JAX oracle's last state of
the same prefix.

Tolerances: indices exactly equal; top-2 gaps within 1e-6 (the same f32
subtraction of the same two values, ties included); attention within
1e-5 in f32 (different summation order); its gradients within 1e-5 of
each's largest entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.top2gap import top2gap_pallas
from repro_torch import kernels as K
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.top2gap import argmax_gap, top2gap

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor (bf16 rounding is
    round-to-nearest-even in both)."""
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# top2gap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,v", [(1, 128), (4, 1000), (8, 512), (3, 4097),
                                 (16, 3157), (2, 50304)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_top2gap_plain_matches_pallas(b, v, dtype):
    xj, xt = _both(_rand(b * v, (b, v), 3.0), dtype)
    gap, idx = top2gap(xt)
    pgap, pidx = top2gap_pallas(xj, interpret=True)
    rgap, ridx = jref.top2gap_ref(xj)
    assert gap.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(gap.numpy(), np.asarray(pgap), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(gap.numpy(), np.asarray(rgap), atol=1e-6,
                               rtol=0)


def test_top2gap_ties_and_blocks():
    """Exact top-1 ties across Pallas vocab blocks: gap 0, lowest index."""
    x = np.zeros((3, 1024), np.float32)
    x[0, 5] = 7.0
    x[0, 700] = 7.0
    x[1, 1000] = 3.0
    x[1, 1] = 2.5
    x[2] = -1.0
    x[2, [600, 90, 1023]] = 4.0                 # three-way tie
    gap, idx = top2gap(torch.from_numpy(x))
    pgap, pidx = top2gap_pallas(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
    np.testing.assert_array_equal(idx.numpy(), [5, 1000, 90])
    np.testing.assert_allclose(gap.numpy(), np.asarray(pgap), atol=1e-6)
    np.testing.assert_allclose(gap.numpy(), [0.0, 0.5, 0.0], atol=1e-6)


def test_argmax_gap_order_and_cpu_path_counts_nothing():
    K.reset_launch_counts()
    x = torch.from_numpy(_rand(1, (4, 300)))
    idx, gap = argmax_gap(x)
    ref_gap, ref_idx = tref.top2gap_ref(x)
    assert torch.equal(idx, ref_idx) and torch.equal(gap, ref_gap)
    assert K.launch_counts()["top2gap"] == 0


def test_top2gap_rejects_unsupported_device():
    with pytest.raises(ValueError):
        top2gap(torch.zeros(2, 8, device="meta"))


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def _decode_inputs(b, h, hkv, c, d, seed, dtype="float32"):
    q = _rand(seed, (b, h, d))
    k = _rand(seed + 1, (b, c, hkv, d))          # model layout (B,C,KV,hd)
    v = _rand(seed + 2, (b, c, hkv, d))
    return [_both(a, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("b,h,hkv,c,d,vl", [
    (2, 8, 2, 256, 32, [1, 100]), (1, 4, 4, 64, 16, [64]),
    (3, 16, 8, 640, 64, [639, 1, 320]), (2, 4, 1, 100, 32, [1, 1]),
    (3, 14, 2, 96, 64, [96, 48, 1]),
])
def test_decode_attention_plain_matches_pallas(b, h, hkv, c, d, vl):
    (qj, qt), (kj, kt), (vj, vt) = _decode_inputs(b, h, hkv, c, d, seed=c)
    vl_np = np.asarray(vl, np.int32)
    out = decode_attention(qt, kt, vt, torch.from_numpy(vl_np))
    # the Pallas kernel takes (B, HKV, C, D)
    pout = decode_attention_pallas(qj, kj.transpose(0, 2, 1, 3),
                                   vj.transpose(0, 2, 1, 3),
                                   jnp.asarray(vl_np), block_c=64,
                                   interpret=True)
    rout = jref.decode_attention_ref(qj, kj.transpose(0, 2, 1, 3),
                                     vj.transpose(0, 2, 1, 3),
                                     jnp.asarray(vl_np))
    np.testing.assert_allclose(out.numpy(), np.asarray(pout), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), atol=1e-5,
                               rtol=0)


def test_decode_attention_scalar_valid_len_and_garbage_masked():
    (_, qt), (_, kt), (_, vt) = _decode_inputs(2, 8, 2, 128, 32, seed=3)
    out = decode_attention(qt, kt, vt, 64)
    k2, v2 = kt.clone(), vt.clone()
    k2[:, 64:] = 1e4
    v2[:, 64:] = -1e4
    out2 = decode_attention(qt, k2, v2, torch.tensor([64, 64]))
    np.testing.assert_allclose(out.numpy(), out2.numpy(), atol=1e-6)


def test_decode_attention_cpu_path_counts_nothing():
    K.reset_launch_counts()
    (_, qt), (_, kt), (_, vt) = _decode_inputs(1, 4, 2, 16, 32, seed=5)
    decode_attention(qt, kt, vt, 3)
    assert K.launch_counts()["decode_attention"] == 0


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _flash_inputs(b, h, hkv, s, d, seed, dtype="float32"):
    q = _rand(seed, (b, s, h, d))                 # model layout (B,S,H,hd)
    k = _rand(seed + 1, (b, s, hkv, d))
    v = _rand(seed + 2, (b, s, hkv, d))
    return [_both(a, dtype) for a in (q, k, v)]


def _t(a):
    """(B, S, H, D) -> the Pallas layout (B, H, S, D)."""
    return a.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", [
    (2, 4, 2, 64, 32, True, 0), (1, 8, 8, 96, 16, True, 0),
    (2, 4, 1, 160, 64, True, 0),
    (1, 2, 2, 33, 32, True, 0),       # ragged S (padding path)
    (1, 4, 2, 128, 32, True, 16), (1, 4, 2, 128, 32, True, 48),
    (2, 4, 2, 50, 32, False, 0),      # non-causal (encoder path)
    (2, 14, 2, 40, 64, True, 0),      # qwen2 grouping G = 7
])
def test_flash_attention_plain_matches_pallas(b, h, hkv, s, d, causal,
                                              window):
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(b, h, hkv, s, d, seed=s)
    out = flash_attention(qt, kt, vt, causal=causal, window=window)
    pout = flash_attention_pallas(_t(qj), _t(kj), _t(vj), causal=causal,
                                  window=window, block_q=32, block_k=32,
                                  interpret=True)
    np.testing.assert_allclose(out.numpy(), _t(np.asarray(pout)), atol=1e-5,
                               rtol=0)
    if causal:
        rout = jref.flash_attention_ref(_t(qj), _t(kj), _t(vj),
                                        window=window)
        np.testing.assert_allclose(out.numpy(), _t(np.asarray(rout)),
                                   atol=1e-5, rtol=0)


def test_flash_attention_right_padding_invisible_to_real_rows():
    """Right-padded buckets: rows before the pads are unchanged."""
    (_, qt), (_, kt), (_, vt) = _flash_inputs(2, 4, 2, 24, 32, seed=9)
    full = flash_attention(qt, kt, vt)
    pad = [torch.cat([t, torch.from_numpy(_rand(i, (2, 8, t.shape[2], 32)))],
                     dim=1) for i, t in enumerate((qt, kt, vt))]
    padded = flash_attention(*pad)
    torch.testing.assert_close(padded[:, :24], full, atol=1e-6, rtol=0)


def test_flash_attention_cpu_path_counts_nothing():
    K.reset_launch_counts()
    (_, qt), (_, kt), (_, vt) = _flash_inputs(1, 4, 2, 8, 32, seed=1)
    flash_attention(qt, kt, vt)
    assert K.launch_counts()["flash_attention"] == 0


def test_concurrent_first_use_builds_and_loads_a_kernel_once(monkeypatch):
    """Threads (more than cores) that reach an unbuilt kernel together,
    as the server's consumers can: one nvcc build, one library load, one
    bound function for all of them."""
    import ctypes
    import os
    import sys
    import threading
    import time

    from repro_torch.kernels import build
    calls = {"build": 0, "load": 0}

    def slow_build_all():
        calls["build"] += 1
        time.sleep(0.05)
        return {"fake": "libfake.so"}

    class FakeLib:
        def __init__(self, path):
            calls["load"] += 1
            self.entry = type("Fn", (), {})()

    monkeypatch.setattr(build, "build_all", slow_build_all)
    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_fns", {})
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        build.function("fake", "entry", [ctypes.c_int])))
        for _ in range(4 * (os.cpu_count() or 2))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"build": 1, "load": 1}
    assert len(got) == len(threads) and all(f is got[0] for f in got)


# ---------------------------------------------------------------------------
# flash attention backward (no Pallas counterpart: JAX differentiates sdpa)
# ---------------------------------------------------------------------------

_BWD_SHAPES = [  # b, sq, sk, h, kv, causal, window
    (2, 70, 70, 4, 2, True, 0),       # causal, a ragged last tile
    (1, 130, 130, 8, 2, True, 48),    # windowed past the window
    (2, 33, 77, 4, 4, False, 0),      # full, Sk != Sq (cross attention)
    (1, 64, 40, 4, 1, False, 0),      # full, fewer keys than queries
]


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("b,sq,sk,h,kv,causal,window", _BWD_SHAPES)
def test_flash_attention_bwd_ref_matches_jax_grad(b, sq, sk, h, kv, causal,
                                                  window, d):
    """dq, dk, dv of the plain backward against ``jax.grad`` of the JAX
    model's ``sdpa_gqa`` (its causal/windowed mask, or none) on the same
    inputs and output gradient, f32, within 1e-5 of each's largest
    entry."""
    import jax
    from repro.models import attention as JA
    seed = 100 + sq + sk + d
    q = _rand(seed, (b, sq, h, d))
    k = _rand(seed + 1, (b, sk, kv, d))
    v = _rand(seed + 2, (b, sk, kv, d))
    do = _rand(seed + 3, (b, sq, h, d))
    mask = JA.causal_mask(sq, sk, window) if causal else None

    def loss(q, k, v):
        return jnp.sum(JA.sdpa_gqa(q, k, v, mask) * do)

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                  for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    o = tref.flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    grads = tref.flash_attention_bwd_ref(qt, kt, vt, o, torch.from_numpy(do),
                                         causal=causal, window=window)
    for g, jg, t in zip(grads, jgrads, (qt, kt, vt)):
        jg = np.asarray(jg)
        assert g.dtype == torch.float32 and g.shape == t.shape
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-5 * float(np.abs(jg).max()))


_LSE_FORMS = [  # b, sq, sk, h, kv, causal, window, q_offset
    (2, 70, 70, 4, 2, True, 0, 0),        # causal, a ragged last tile
    (1, 130, 130, 8, 2, True, 48, 0),     # windowed past the window
    (2, 33, 77, 4, 4, False, 0, 0),       # full, Sk != Sq
    (1, 40, 100, 6, 2, True, 0, 60),      # a chunk of queries at q_offset
    (1, 40, 100, 6, 2, True, 32, 60),     # the same, windowed
]


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("b,sq,sk,h,kv,causal,window,q_offset", _LSE_FORMS)
def test_flash_attention_lse_ref_matches_jax_logsumexp(b, sq, sk, h, kv,
                                                       causal, window,
                                                       q_offset, d):
    """The plain version of the forward's log-sum-exp output, and the
    wrapper's ``return_lse`` on the CPU, against ``jax.nn.logsumexp`` of
    the scaled scores as the JAX model's ``sdpa_gqa`` forms them (its
    ``causal_mask`` with the offset, or none), f32, within 1e-5 (the
    same sums in another order)."""
    import jax
    from repro.models import attention as JA
    seed = 300 + sq + sk + d + q_offset
    q = _rand(seed, (b, sq, h, d))
    k = _rand(seed + 1, (b, sk, kv, d))
    v = _rand(seed + 2, (b, sk, kv, d))
    qg = jnp.asarray(q).reshape(b, sq, kv, h // kv, d)
    scores = jnp.einsum("bqkgd,bskd->bkgqs", qg, jnp.asarray(k),
                        preferred_element_type=jnp.float32)
    scores = scores / jnp.sqrt(jnp.asarray(d, jnp.float32))
    if causal:
        mask = JA.causal_mask(sq, sk, window, offset=q_offset)
        scores = jnp.where(mask[None, None, None], scores, JA.NEG_INF)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1)).reshape(b, h, sq)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = tref.flash_attention_lse_ref(qt, kt, causal=causal, window=window,
                                       q_offset=q_offset)
    assert got.dtype == torch.float32 and got.shape == (b, h, sq)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    out, lse = flash_attention(qt, kt, vt, causal=causal, window=window,
                               q_offset=q_offset, return_lse=True)
    assert torch.equal(lse, got)
    assert torch.equal(out, flash_attention(qt, kt, vt, causal=causal,
                                            window=window,
                                            q_offset=q_offset))


def test_flash_attention_differentiates_on_the_cpu_and_counts_nothing():
    """On a CPU tensor the wrapper's output carries autograd's graph
    through the plain version, whose gradients are the plain backward's;
    neither wrapper counts a launch there. bf16 inputs give bf16
    gradients."""
    K.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(_rand(i, (2, 40, n, 64))).to(dtype)
                   .requires_grad_(True) for i, n in ((1, 4), (2, 2),
                                                       (3, 2)))
        do = torch.from_numpy(_rand(4, (2, 40, 4, 64))).to(dtype)
        out = flash_attention(q, k, v, causal=True, window=16)
        assert out.grad_fn is not None
        out.backward(do)
        ref_grads = flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                        out.detach(), do, causal=True,
                                        window=16)
        for t, g in zip((q, k, v), ref_grads):
            assert t.grad.dtype == dtype == g.dtype
            torch.testing.assert_close(t.grad.float(), g.float(), atol=2e-2
                                       if dtype == torch.bfloat16 else 1e-6,
                                       rtol=0)
    assert K.launch_counts()["flash_attention"] == 0
    assert K.launch_counts()["flash_attention_bwd"] == 0


def test_forward_only_kernels_differentiate_on_the_cpu():
    """decode_attention, mamba_scan and top2gap have no backward kernel;
    on the CPU their plain versions still carry gradients (their CUDA
    wrappers refuse inputs that require grad; see the cuda tests)."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    q = torch.from_numpy(_rand(1, (2, 4, 32))).requires_grad_(True)
    kc = torch.from_numpy(_rand(2, (2, 10, 2, 32))).requires_grad_(True)
    out = decode_attention(q, kc, kc, torch.tensor([3, 10]))
    out.sum().backward()
    assert q.grad is not None and kc.grad is not None
    assert float(kc.grad[0, 3:].abs().max()) == 0.0   # masked slots
    x = torch.from_numpy(_rand(3, (1, 5, 8))).requires_grad_(True)
    dt = torch.full((1, 5, 8), 0.1, requires_grad=True)
    y, h = mamba_scan(dt, -torch.ones(8, 4), torch.ones(1, 5, 4),
                      torch.ones(1, 5, 4), torch.ones(8), x)
    (y.sum() + h.sum()).backward()
    assert x.grad is not None and dt.grad is not None
    s = torch.from_numpy(_rand(4, (3, 50))).requires_grad_(True)
    gap, _ = top2gap(s)
    gap.sum().backward()
    assert float(s.grad.abs().sum()) == pytest.approx(6.0)


def test_forward_only_refuses_tracked_inputs():
    """The contract the CUDA wrappers of the forward-only kernels apply
    before a launch: with grad mode on and an input that requires grad it
    raises, pointing at torch.no_grad(); under no_grad, or with no tracked
    input, it lets the launch through."""
    from repro_torch.kernels import counts
    a = torch.zeros(2, requires_grad=True)
    b = torch.zeros(2)
    with pytest.raises(RuntimeError, match="no backward.*torch.no_grad"):
        counts.forward_only("decode_attention", b, a)
    counts.forward_only("decode_attention", b, None)
    with torch.no_grad():
        counts.forward_only("decode_attention", a, b)


_BWD64_CASES = [(True, 0, 40, 40), (True, 9, 50, 50), (False, 0, 20, 33)]


def _bwd64(causal, window, sq, sk):
    """Seeded inputs (o the f32 output rounded to bf16) and the backward
    written out in float64: P, dS = P (dP - D(o)) and the inputs, with k
    repeated over each GQA group."""
    b, h, kv, d = 2, 4, 2, 32
    q, k, v, do = (torch.from_numpy(_rand(i, shape)) for i, shape in
                   ((1, (b, sq, h, d)), (2, (b, sk, kv, d)),
                    (3, (b, sk, kv, d)), (4, (b, sq, h, d))))
    o16 = tref.flash_attention_ref(q, k, v, causal=causal,
                                   window=window).bfloat16().float()
    qd, kd, vd, dod, od = (t.double() for t in (q, k, v, do, o16))
    kr, vr = kd.repeat_interleave(h // kv, 2), vd.repeat_interleave(
        h // kv, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kr) / d ** 0.5
    if causal:
        i = torch.arange(sq)
        keep = i[None] <= i[:, None]
        if window:
            keep &= i[None] > i[:, None] - window
        s = s.masked_fill(~keep, -float("inf"))
    p = torch.softmax(s, -1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dod, vr)
    ds = p * (dp - (dod * od).sum(-1).transpose(1, 2)[..., None])
    return (q, k, v, o16, do), (p, ds, qd, kr, dod)


def _by_kv_head(x, kv):
    """(B, Sk, H, hd) summed over each GQA group: (B, Sk, KV, hd)."""
    b, sk, h, d = x.shape
    return x.reshape(b, sk, kv, h // kv, d).sum(3)


@pytest.mark.parametrize("causal,window,sq,sk", _BWD64_CASES)
def test_flash_attention_bwd_ref_reads_delta_from_o(causal, window, sq, sk):
    """The plain backward reads D = dO . o from the o given: where o is
    the f32 output rounded to bf16 it equals the backward written out in
    float64 (P, dP, dS = P (dP - D(o)))."""
    ins, (p, ds, qd, kr, dod) = _bwd64(causal, window, sq, sk)
    kv, d = ins[1].shape[2], ins[0].shape[3]
    got = tref.flash_attention_bwd_ref(*ins, causal, window)
    want = (torch.einsum("bhqk,bkhd->bqhd", ds, kr) / d ** 0.5,
            _by_kv_head(torch.einsum("bhqk,bqhd->bkhd", ds, qd), kv)
            / d ** 0.5,
            _by_kv_head(torch.einsum("bhqk,bqhd->bkhd", p, dod), kv))
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("causal,window,sq,sk", _BWD64_CASES)
def test_bwd_rounding_scale_is_the_terms_root_sum_square(causal, window, sq,
                                                         sk):
    """``profiling.flash_bwd_ab.rounding_scale``, the scale of the bf16
    backward's P and dS roundings that chip_smoke's limit reads: the
    root-sum-square of the terms of dq = dS.K, dk = dS^T.Q (each over
    sqrt(hd)) and dv = P^T.dO, written out in float64, within 1e-5 of
    each's largest entry."""
    from repro_torch.profiling.flash_bwd_ab import rounding_scale
    ins, (p, ds, qd, kr, dod) = _bwd64(causal, window, sq, sk)
    kv, d = ins[1].shape[2], ins[0].shape[3]
    got = rounding_scale(*ins, causal, window)
    want = ((torch.einsum("bhqk,bkhd->bqhd", ds ** 2, kr ** 2) / d).sqrt(),
            (_by_kv_head(torch.einsum("bhqk,bqhd->bkhd", ds ** 2, qd ** 2),
                         kv) / d).sqrt(),
            _by_kv_head(torch.einsum("bhqk,bqhd->bkhd", p ** 2, dod ** 2),
                        kv).sqrt())
    for x, w in zip(got, want):
        assert x.dtype == torch.float32 and x.shape == w.shape
        np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


# ---------------------------------------------------------------------------
# the selective scan's chunk states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [33, 77, 95, 32])
@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_plain_returns_the_chunk_states(s, with_h0):
    """``return_states=True`` on the CPU: y and h_last the same bits as
    without it, and the state entering every 32-step chunk (tail chunks of
    1, 13 and 31 steps, and one whole chunk) the same bits as the plain
    recurrence run to that chunk's start (h0, or zeros, for the first), and
    within 1e-5 of the JAX oracle's last state of the same prefix."""
    b, di, n = 2, 40, 8
    rng = np.random.default_rng(s)
    ins = [np.log1p(np.exp(rng.standard_normal((b, s, di)) * 0.5 - 3.0)),
           -np.exp(rng.uniform(0.0, 1.1, (di, n))),
           rng.standard_normal((b, s, n)), rng.standard_normal((b, s, n)),
           rng.standard_normal(di), rng.standard_normal((b, s, di))]
    ins = [a.astype(np.float32) for a in ins]
    h0 = rng.standard_normal((b, di, n)).astype(np.float32) \
        if with_h0 else None
    t = [torch.from_numpy(a) for a in ins]
    th0 = None if h0 is None else torch.from_numpy(h0)
    before = mamba_scan.launches
    y, h_last, states = mamba_scan(*t, th0, return_states=True)
    assert mamba_scan.launches == before          # the CPU path counts nothing
    y0, h0_last = mamba_scan(*t, th0)
    assert torch.equal(y, y0) and torch.equal(h_last, h0_last)
    chunks = -(-s // tref.SCAN_CHUNK)
    assert states.shape == (b, chunks, di, n)
    assert states.dtype == torch.float32 and not states.requires_grad
    for c in range(chunks):
        t0 = c * tref.SCAN_CHUNK
        if t0 == 0:
            want = torch.zeros(b, di, n) if th0 is None else th0
        else:
            want = tref.mamba_scan_ref(*(a[:, :t0] if a.dim() == 3 else a
                                         for a in t), th0)[1]
            jw = jref.mamba_scan_ref(
                *(jnp.asarray(a[:, :t0] if a.ndim == 3 else a)
                  for a in ins),
                None if h0 is None else jnp.asarray(h0))[1]
            np.testing.assert_allclose(states[:, c].numpy(),
                                       np.asarray(jw), atol=1e-5, rtol=0)
        assert torch.equal(states[:, c], want), c
