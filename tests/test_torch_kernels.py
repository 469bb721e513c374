"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (repro_torch.kernels
.ref); those are held against the Pallas kernels in interpret mode and
against repro.kernels.ref on the same seeded numpy inputs, over the shape
sweeps of tests/test_kernels.py. The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_kernels_cuda.py.

Tolerances: indices exactly equal; top-2 gaps within 1e-6 (the same f32
subtraction of the same two values, ties included); attention within
1e-5 in f32 (different summation order).
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
from repro_torch.kernels.flash_attention import flash_attention
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
