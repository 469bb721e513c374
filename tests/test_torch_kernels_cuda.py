"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
available; the file imports torch only (no jax), so it runs on the GPU
machine: ``PYTHONPATH=src python -m pytest -q -m cuda tests/``.

Tolerances: top2gap bit-exact (the same two f32 values subtracted, ties
included); attention within 1e-5 in f32 and 2e-2 in bf16 against the f32
plain version on the same inputs (bf16 output rounding, and in the bf16
flash kernel P rounded to bf16 before P.V as the JAX model does; the
kernels use the fast exp); the selective scan within 2e-4 of its plain
version (f32 throughout, other summation order over N; the JAX sweep's
limit); the flash backward within 1e-4 (f32) and 1e-2 (bf16) of each
gradient's largest entry in its plain version (the bf16 output rounded
once, and D = dO . o read from the bf16 o); the
smoke-size models within 1e-4 of their CPU runs in f32, a train step's
gradients within 1e-4 of each leaf's largest entry; the tiny
classifier's scores within 1e-4 of its CPU run in f32, and the certainties
``EngineBackend.execute`` reduces on the card bit-equal to the CPU's for
the same scores.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core import execution as TX
from repro_torch.core.cascade import Cascade
from repro_torch.core.certainty import device_fold_init
from repro_torch.core.gears import Gear
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_bwd
from repro_torch.kernels.mamba_step import mamba_conv_step, mamba_ssm_step
from repro_torch.kernels.top2gap import argmax_gap, top2gap
from repro_torch.models import model as TM
from repro_torch.serving import engine as TE
from repro_torch.serving import tinymodels as TY
from repro_torch.serving import token_engine as TT

pytestmark = pytest.mark.cuda


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _to(tree, dev):
    """The param tree (nested dicts and lists of tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# blocks a row is split over (kCluster in csrc/top2gap.cu)
_CLUSTER = 16


@pytest.mark.parametrize("b,v", [(1, 151936), (8, 151936), (3, 4097),
                                 (5, 2), (1, 3), (8, 17), (1, 4097),
                                 (8, 65024), (2, 32767), (2, 32769),
                                 (2, 65535), (2, 65537), (1, 262143),
                                 (1, 262145)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_top2gap_kernel_matches_plain(cuda, b, v, dtype):
    """V from 2 (most cluster slices empty) to the qwen2 vocab; one short
    of and one past G x 4,096 elements (slices of 1,024 f32 vectors a
    block) and G x 16,384 (one full round of 8 f32 loads a thread); rows
    after the first have no planted tie."""
    x = torch.from_numpy(_rand(v, (b, v), 3.0)).to(cuda, dtype)
    top = x[0].max() + 1.0
    x[0, v - 1] = top                            # planted exact tie ...
    x[0, min(7, v - 2)] = top                    # ... lower index wins
    before = top2gap.launches
    gap, idx = top2gap(x)
    torch.cuda.synchronize()
    assert top2gap.launches == before + 1
    rgap, ridx = tref.top2gap_ref(x)
    assert torch.equal(idx, ridx) and torch.equal(gap, rgap)
    assert int(idx[0]) == min(7, v - 2) and float(gap[0]) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,width", [(4, 1001), (3, 151939)])
def test_top2gap_kernel_strided_rows(cuda, dtype, rows, width):
    """Rows of a wider buffer (row stride != V) and an unaligned start,
    random with no planted tie: the unaligned heads and tails go through
    the first and the last rank and still agree bit for bit."""
    buf = torch.from_numpy(_rand(3, (rows, width))).to(cuda, dtype)
    for x in (buf[:, :width - 2], buf[:, 1:], buf[:, 3:width - 5]):
        gap, idx = top2gap(x)
        rgap, ridx = tref.top2gap_ref(x)
        assert torch.equal(idx, ridx) and torch.equal(gap, rgap)


def _slices(first: int, v: int, g: int, e: int):
    """The kernel's split of a row whose first element sits ``first``
    elements past a 16-byte boundary: (lo, hi) index ranges of the head,
    of each of the g ranks' vector slices, and of the tail."""
    mis = first % e
    head = min(v, e - mis if mis else 0)
    nvec = (v - head) // e
    per = -(-nvec // g)
    out = [(0, head)]
    for r in range(g):
        v0 = min(nvec, r * per)
        v1 = min(nvec, v0 + per)
        out.append((head + v0 * e, head + v1 * e))
    out.append((head + nvec * e, v))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,v,width,offset", [
    (8, 151936, 151936, 0), (1, 151936, 151939, 3), (8, 65024, 65031, 1),
    (8, 4097, 4101, 2), (3, 37, 43, 5), (8, 1000, 1000, 0)])
def test_top2gap_kernel_ties_at_slice_edges(cuda, dtype, b, v, width,
                                            offset):
    """Exact top-1 ties planted on the first and last element of every
    cluster slice at once, across neighbouring ranks, between the first
    and the last rank, and in the unaligned head and tail of rows of a
    wider buffer (row stride ``width``, start ``offset``): gap 0 and the
    lowest index, bit-equal to the plain version. Two more rows have no
    tie: one left random, and one whose top-1 is the row's last element
    and whose top-2, half a unit lower, its first (the tail's and the
    head's rank, or the first and last slice of an aligned row)."""
    e = 16 // (4 if dtype == torch.float32 else 2)
    buf = torch.from_numpy(_rand(v + b, (b + 2, width), 3.0)).to(cuda,
                                                                  dtype)
    x = buf[:, offset:offset + v]
    want = []
    for row in range(b):
        parts = [(lo, hi) for lo, hi in _slices(row * width + offset, v,
                                                _CLUSTER, e) if hi > lo]
        if row % 3 == 2:     # both ends of every part
            at = [i for lo, hi in parts for i in (lo, hi - 1)]
        elif row % 3 == 1:   # the first and the last part
            at = [parts[0][0], parts[-1][1] - 1]
        else:                # last of one part, first of the next
            k = row % len(parts)
            at = [parts[k][1] - 1, parts[(k + 1) % len(parts)][0]]
        x[row, at] = x[row].max() + 1.0
        want.append(min(at))
    top = x[b + 1].max() + 1.0
    x[b + 1, 0] = top - 0.5
    x[b + 1, v - 1] = top
    gap, idx = top2gap(x)
    rgap, ridx = tref.top2gap_ref(x)
    assert torch.equal(idx, ridx) and torch.equal(gap, rgap)
    assert idx[:b].tolist() == want
    assert all(g_ == 0.0 for g_ in gap[:b].tolist())
    assert int(idx[b + 1]) == v - 1 and float(gap[b + 1]) == 0.5


# the last case is f32 activations over the engine's bf16 slot pool: the
# kernel computes in f32 on the bf16 cache, as the plain version does
@pytest.mark.parametrize("dtype,kv_dtype,atol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.float32, torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("h,kv,d", [(14, 2, 64), (4, 2, 32), (16, 2, 32),
                                    (8, 8, 64), (16, 2, 128)])
def test_decode_attention_kernel_matches_plain(cuda, dtype, kv_dtype, atol,
                                               h, kv, d):
    b, c = 8, 512
    q = torch.from_numpy(_rand(1, (b, h, d))).to(cuda, dtype)
    pool = torch.from_numpy(_rand(2, (3, b, c, kv, d))).to(cuda, kv_dtype)
    vpool = torch.from_numpy(_rand(3, (3, b, c, kv, d))).to(cuda, kv_dtype)
    vl = torch.tensor([1, 2, 33, 256, 511, 512, 100, 64], dtype=torch.int32,
                      device=cuda)
    before = decode_attention.launches
    out = decode_attention(q, pool[1], vpool[1], vl)   # strided layer view
    assert decode_attention.launches == before + 1 and out.dtype == dtype
    ref = tref.decode_attention_ref(q.float(), pool[1].float(),
                                    vpool[1].float(), vl)
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,kv_dtype,atol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.float32, torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("b,h,kv,c,lens", [
    # qwen2-moe-a2.7b's fused decode: 8 slots of 512, a group of 1
    (8, 16, 16, 512, [1, 2, 33, 256, 511, 512, 100, 64]),
    # jamba-v0.1's batch-1 steps after a 200-token prompt: a group of 4
    (1, 32, 8, 204, [201]), (1, 32, 8, 204, [204])])
def test_decode_attention_kernel_at_moe_and_hybrid_heads(cuda, dtype,
                                                         kv_dtype, atol, b,
                                                         h, kv, c, lens):
    q = torch.from_numpy(_rand(4, (b, h, 128))).to(cuda, dtype)
    pool = torch.from_numpy(_rand(5, (2, b, c, kv, 128))).to(cuda, kv_dtype)
    vpool = torch.from_numpy(_rand(6, (2, b, c, kv, 128))).to(cuda,
                                                              kv_dtype)
    vl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    out = decode_attention(q, pool[1], vpool[1], vl)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1 and out.dtype == dtype
    ref = tref.decode_attention_ref(q.float(), pool[1].float(),
                                    vpool[1].float(), vl)
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,kv_dtype,atol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.float32, torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("b,h,kv,d,c", [
    # h2o-danube-1.8b's full 4,096-slot ring and its B 8 slot pool
    (1, 32, 8, 80, 4096), (8, 32, 8, 80, 512),
    # seamless-m4t's cross attention: one query over 500 encoder keys
    (4, 16, 16, 64, 500)])
def test_decode_attention_kernel_every_slot_valid(cuda, dtype, kv_dtype,
                                                  atol, b, h, kv, d, c):
    """Every row valid to C (a full ring; the cross attention's
    ``valid_len = S_src``), at hd 80 and at the cross-attention shape."""
    q = torch.from_numpy(_rand(41, (b, h, d))).to(cuda, dtype)
    pool = torch.from_numpy(_rand(42, (2, b, c, kv, d))).to(cuda, kv_dtype)
    vpool = torch.from_numpy(_rand(43, (2, b, c, kv, d))).to(cuda,
                                                             kv_dtype)
    before = decode_attention.launches
    out = decode_attention(q, pool[1], vpool[1], c)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1 and out.dtype == dtype
    ref = tref.decode_attention_ref(q.float(), pool[1].float(),
                                    vpool[1].float(), c)
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


def test_decode_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(2, 4, 64, device=cuda)
    k = torch.zeros(2, 16, 2, 64, device=cuda)
    with pytest.raises(TypeError):
        decode_attention(q.bfloat16(), k, k, 3)
    with pytest.raises(ValueError):
        decode_attention(q[..., :48], k[..., :48], k[..., :48], 3)
    with pytest.raises(ValueError):
        decode_attention(q, k.transpose(1, 2), k.transpose(1, 2), 3)
    wide = torch.zeros(2, 16, 2, 96, device=cuda)           # hd 96
    with pytest.raises(ValueError):
        decode_attention(torch.zeros(2, 4, 96, device=cuda), wide, wide, 3)
    with pytest.raises(ValueError):                            # G 9
        decode_attention(torch.zeros(2, 18, 64, device=cuda), k, k, 3)


_DECODE_DTYPES = {0: (torch.float32, torch.float32, 1e-5),
                  1: (torch.bfloat16, torch.bfloat16, 2e-2),
                  2: (torch.float32, torch.bfloat16, 1e-5)}


@pytest.mark.parametrize("code", sorted(_DECODE_DTYPES))
@pytest.mark.parametrize("g", range(1, 9))
@pytest.mark.parametrize("c,d", [(512, 64), (4096, 64), (512, 128),
                                 (4096, 32), (512, 80), (4096, 80)])
def test_decode_attention_kernel_cluster_slices(cuda, code, g, c, d):
    """The cluster's 8 slices of a row: valid_len at the slice and tile
    edges (1, 63, 64, 65, 511, 512; at C 4096 also 4095 and 4096, several
    tiles per block), rows with valid_len 1 beside full rows in one call,
    every group size G 1-8 and the three dtype codes, over the layer view
    of a rep-stacked pool; hd 32, 64, 80 (h2o-danube: three strided
    output columns a lane, 160-byte rows) and 128."""
    dtype, kv_dtype, atol = _DECODE_DTYPES[code]
    b, kv = 8, 2
    h = g * kv
    lens = [1, 63, 64, 65, 511, 512, 1, c] if c == 512 else \
        [1, 4096, 65, 512, 4095, 1, 2049, 64]
    q = torch.from_numpy(_rand(11, (b, h, d))).to(cuda, dtype)
    pool = torch.from_numpy(_rand(12, (2, b, c, kv, d))).to(cuda, kv_dtype)
    vpool = torch.from_numpy(_rand(13, (2, b, c, kv, d))).to(cuda, kv_dtype)
    vl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    out = decode_attention(q, pool[1], vpool[1], vl)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1 and out.dtype == dtype
    ref = tref.decode_attention_ref(q.float(), pool[1].float(),
                                    vpool[1].float(), vl)
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,causal,window", [(64, True, 0), (256, True, 0),
                                             (77, True, 0), (130, True, 48),
                                             (90, False, 0), (1, True, 0)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, atol, s, causal,
                                              window):
    b, h, kv, d = 8, 14, 2, 64
    q = torch.from_numpy(_rand(1, (b, s, h, d))).to(cuda, dtype)
    k = torch.from_numpy(_rand(2, (b, s, kv, d))).to(cuda, dtype)
    v = torch.from_numpy(_rand(3, (b, s, kv, d))).to(cuda, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == before + 1
    ref = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("h,kv", [(16, 16), (32, 8)])
@pytest.mark.parametrize("s", [1, 16, 17, 64, 129, 200])
def test_flash_attention_kernel_at_moe_and_hybrid_heads(cuda, dtype, atol,
                                                        h, kv, s):
    """Batch-1 exact-length prefills at hd 128: qwen2-moe-a2.7b's heads
    (H 16 = KV 16) over its prompt lengths, jamba-v0.1's (H 32 over KV
    8)."""
    q = torch.from_numpy(_rand(7, (1, s, h, 128))).to(cuda, dtype)
    k = torch.from_numpy(_rand(8, (1, s, kv, 128))).to(cuda, dtype)
    v = torch.from_numpy(_rand(9, (1, s, kv, 128))).to(cuda, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and out.dtype == dtype
    ref = tref.flash_attention_ref(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("d", [32, 64, 80, 128])
def test_flash_attention_kernel_head_dims(cuda, d):
    q = torch.from_numpy(_rand(1, (2, 70, 4, d))).to(cuda)
    k = torch.from_numpy(_rand(2, (2, 70, 2, d))).to(cuda)
    v = torch.from_numpy(_rand(3, (2, 70, 2, d))).to(cuda)
    torch.testing.assert_close(flash_attention(q, k, v),
                               tref.flash_attention_ref(q, k, v),
                               atol=1e-5, rtol=0)


def test_flash_attention_kernel_right_padding_bit_identical(cuda):
    """Masked pad keys add exact zeros, so real rows of a right-padded
    bucket are bit-identical to the unpadded call on the card."""
    b, h, kv, d, s = 4, 14, 2, 64, 75
    q, k, v = (torch.from_numpy(_rand(i, (b, 128, n, d))).to(
        cuda, torch.bfloat16) for i, n in ((1, h), (2, kv), (3, kv)))
    full = flash_attention(q[:, :s].contiguous(), k[:, :s].contiguous(),
                           v[:, :s].contiguous())
    padded = flash_attention(q, k, v)
    assert torch.equal(padded[:, :s], full)


_MODES = {"causal": (True, 0), "window7": (True, 7),
          "window100": (True, 100), "full": (False, 0)}


@pytest.mark.parametrize("d", [32, 64, 80, 128])
@pytest.mark.parametrize("g,b", [(1, 1), (2, 8), (7, 8)])
@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("s", [1, 17, 64, 65, 100, 256, 512])
def test_flash_attention_bf16_kernel_sweep(cuda, d, g, b, mode, s):
    """The bf16 wgmma kernel against the f32 plain version: S below, at,
    across and past the 64-row tiles, causal, windowed (7 and 100) and
    full, group sizes 1, 2 and 7, B 1 and 8, hd 32, 64, 80 (32-byte
    swizzled tiles, an n80 P.V) and 128."""
    causal, window = _MODES[mode]
    kv = 2 if g > 1 else 1
    h = g * kv
    q = torch.from_numpy(_rand(21, (b, s, h, d))).to(cuda, torch.bfloat16)
    k = torch.from_numpy(_rand(22, (b, s, kv, d))).to(cuda, torch.bfloat16)
    v = torch.from_numpy(_rand(23, (b, s, kv, d))).to(cuda, torch.bfloat16)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [32, 64, 80, 128])
@pytest.mark.parametrize("sq,sk", [(32, 500), (1, 77), (65, 64), (130, 200),
                                   (17, 1), (500, 500)])
def test_flash_attention_kernel_keys_of_their_own_length(cuda, dtype, atol,
                                                         d, sq, sk):
    """The full form over Sk keys for Sq queries (the encoder-decoder's
    cross attention at prefill: the encoder's 500 keys for a 32-token
    decoder prompt; and tails of queries and keys that are not multiples
    of the 64-row tiles, either longer), GQA group 2, B 3."""
    b, h, kv = 3, 4, 2
    q = torch.from_numpy(_rand(51, (b, sq, h, d))).to(cuda, dtype)
    k = torch.from_numpy(_rand(52, (b, sk, kv, d))).to(cuda, dtype)
    v = torch.from_numpy(_rand(53, (b, sk, kv, d))).to(cuda, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=False)
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("s", [1, 65, 200])
def test_flash_attention_f32_kernel_at_hd80(cuda, mode, s):
    """hd 80 (h2o-danube: 32 heads over 8 KV) on the f32 path in all
    three forms."""
    causal, window = _MODES[mode]
    q = torch.from_numpy(_rand(61, (2, s, 32, 80))).to(cuda)
    k = torch.from_numpy(_rand(62, (2, s, 8, 80))).to(cuda)
    v = torch.from_numpy(_rand(63, (2, s, 8, 80))).to(cuda)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ref = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


_LSE_FORMS = {  # causal, window, Sq, Sk, q_offset
    "causal": (True, 0, 200, 200, 0), "window": (True, 48, 200, 200, 0),
    "full": (False, 0, 130, 77, 0), "q_offset": (True, 0, 72, 200, 128),
    "q_offset_window": (True, 48, 72, 200, 128)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("form", sorted(_LSE_FORMS))
def test_flash_attention_lse_output(cuda, dtype, d, form):
    """The forward's log-sum-exp output: the output of a launch that
    writes it bit-equal to one that does not, and each row's value within
    1e-5 of ``torch.logsumexp`` of the plain scaled scores over the keys
    it sees (``ref.flash_attention_lse_ref``) on the same (upcast)
    inputs; causal, windowed, full (Sk != Sq) and a chunk at q_offset,
    GQA group 3, B 2."""
    causal, window, sq, sk, off = _LSE_FORMS[form]
    b, h, kv = 2, 6, 2
    q = torch.from_numpy(_rand(71, (b, sq, h, d))).to(cuda, dtype)
    k = torch.from_numpy(_rand(72, (b, sk, kv, d))).to(cuda, dtype)
    v = torch.from_numpy(_rand(73, (b, sk, kv, d))).to(cuda, dtype)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=off, return_lse=True)
    plain = flash_attention(q, k, v, causal=causal, window=window,
                            q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert torch.equal(out, plain)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    want = tref.flash_attention_lse_ref(q.float(), k.float(), causal=causal,
                                        window=window, q_offset=off)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=0)


def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda):
    """Causal and windowed calls need q_offset + Sq <= Sk (and the full
    form no offset); hd 96 has no instantiation; nothing falls back to the
    plain version."""
    q = torch.zeros(1, 8, 4, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 12, 2, 64, device=cuda, dtype=torch.bfloat16)
    before = flash_attention.launches
    with pytest.raises(ValueError):
        flash_attention(q, k, k, causal=True, q_offset=5)
    with pytest.raises(ValueError):
        flash_attention(q, k, k, causal=True, window=4, q_offset=5)
    with pytest.raises(ValueError):
        flash_attention(k.repeat(1, 1, 2, 1), q[:, :, :2], q[:, :, :2],
                        causal=True)
    with pytest.raises(ValueError):
        flash_attention(q, k, k, causal=False, q_offset=1)
    wide = torch.zeros(1, 8, 2, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 8, 4, 96, device=cuda,
                                    dtype=torch.bfloat16), wide, wide,
                        causal=False)
    assert flash_attention.launches == before


@pytest.mark.parametrize("d,window", [(64, 0), (128, 0), (64, 100),
                                      (32, 7), (80, 0), (80, 100)])
def test_flash_attention_kernel_right_padding_at_several_n(cuda, d, window):
    """Real rows of a 256-row bucket are bit-identical to the unpadded call
    for prompts ending inside, at and just past a 64-row tile."""
    b, h, kv, s = 2, 14, 2, 256
    q, k, v = (torch.from_numpy(_rand(30 + i, (b, s, n, d))).to(
        cuda, torch.bfloat16) for i, n in ((1, h), (2, kv), (3, kv)))
    padded = flash_attention(q, k, v, window=window)
    for n in (1, 17, 63, 64, 65, 100, 200, 255):
        part = flash_attention(q[:, :n].contiguous(), k[:, :n].contiguous(),
                               v[:, :n].contiguous(), window=window)
        assert torch.equal(padded[:, :n], part), n


def test_smoke_model_on_card_matches_cpu(cuda):
    """Bucketed prefill + 3 fused decode steps at smoke size in f32: the
    kernels in the model's layouts agree with the CPU plain path."""
    cfg = get_smoke_config("qwen2-0.5b")
    p_cpu = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    p_gpu = _to(p_cpu, cuda)
    rng = np.random.default_rng(0)
    lens = np.asarray([5, 12, 9], np.int32)
    arr = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lens):
        arr[i, :n] = rng.integers(0, cfg.vocab_size, n)
    outs = []
    for p, dev in ((p_cpu, "cpu"), (p_gpu, cuda)):
        logits, cache = TM.prefill_bucketed(p, cfg, arr, lens, cache_len=32)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        res = TM.decode_fused_steps(
            p, cfg, tok, cache, torch.as_tensor(lens, device=dev),
            torch.tensor([True, True, False], device=dev),
            device_fold_init(3, dev), k=3)
        outs.append((logits.cpu(), res[0].cpu(), res[1].cpu()))
    (l0, t0, g0), (l1, t1, g1) = outs
    torch.testing.assert_close(l1, l0, atol=1e-4, rtol=1e-4)
    assert torch.equal(t1, t0)
    torch.testing.assert_close(g1, g0, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["olmo-1b", "h2o-danube-1.8b",
                                  "qwen3-32b"])
def test_dense_smoke_models_on_card_match_cpu(cuda, arch):
    """olmo-1b (non-parametric LN), h2o-danube-1.8b (its 64-slot ring,
    prompts of 80 tokens) and qwen3-32b (qk-norm, untied head) at smoke
    size in f32: forward, prefill and 3 decode steps through the kernels
    agree with the CPU plain path within 1e-4."""
    cfg = get_smoke_config(arch)
    p_cpu = TM.init_params(cfg, seed=2, dtype=torch.float32, device="cpu")
    p_gpu = _to(p_cpu, cuda)
    s = 80
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, s + 3)) \
        .astype(np.int32)
    outs = []
    for p, dev in ((p_cpu, "cpu"), (p_gpu, cuda)):
        full, _ = TM.forward(p, cfg, {"tokens": toks})
        last, cache = TM.prefill(p, cfg, {"tokens": toks[:, :s]},
                                 cache_len=s + 3)
        steps = [TM.decode_step(p, cfg, toks[:, pos:pos + 1], cache,
                                pos)[0].cpu() for pos in range(s, s + 3)]
        outs.append((full.cpu(), last.cpu(), torch.stack(steps)))
    for a, b in zip(outs[1], outs[0]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    # decode past the window equals the windowed forward on the card
    torch.testing.assert_close(outs[1][2], outs[1][0][:, s:s + 3]
                               .transpose(0, 1), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-1b",
                                  "h2o-danube-1.8b@hd80"])
def test_encdec_vlm_and_hd80_smoke_models_on_card_match_cpu(cuda, arch):
    """seamless-m4t (encoder-decoder: the encoder's full flash attention,
    cross attention by flash over the source keys at forward and prefill
    and by the decode kernel in each step), internvl2 (8 prefix
    embeddings before the text) and h2o-danube at hd 80 (its smoke config
    with 2 heads of 80 over 1 KV head, the 64-slot ring) at smoke size in
    f32: forward, prefill, 3 decode steps and ``decode_fused_steps``
    through the kernels agree with the CPU plain path within 1e-4, and
    decode with the card's own forward."""
    name, _, variant = arch.partition("@")
    cfg = get_smoke_config(name)
    if variant:
        cfg = cfg.scaled(num_heads=2, num_kv_heads=1, head_dim=80)
    p_cpu = TM.init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    p_gpu = _to(p_cpu, cuda)
    rng = np.random.default_rng(2)
    s = 80 if variant else 20
    toks = rng.integers(0, cfg.vocab_size, (2, s + 3)).astype(np.int32)
    extra = {}
    if cfg.is_encoder_decoder:
        extra["source_frames"] = _rand(3, (2, 70, cfg.frontend.frontend_dim))
    if cfg.frontend.kind == "vision":
        extra["prefix_embeddings"] = _rand(
            4, (2, cfg.frontend.num_prefix_embeddings,
                cfg.frontend.frontend_dim))
    n_pre = extra["prefix_embeddings"].shape[1] if cfg.frontend.kind == \
        "vision" else 0
    outs = []
    for p, dev in ((p_cpu, "cpu"), (p_gpu, cuda)):
        full, _ = TM.forward(p, cfg, {"tokens": toks, **extra})
        last, cache = TM.prefill(p, cfg, {"tokens": toks[:, :s], **extra},
                                 cache_len=n_pre + s + 3)
        steps = [TM.decode_step(p, cfg, toks[:, i:i + 1], cache,
                                n_pre + i)[0].cpu() for i in range(s, s + 2)]
        res = TM.decode_fused_steps(
            p, cfg, torch.as_tensor(toks[:, s + 2], device=dev), cache,
            torch.full((2,), n_pre + s + 2, dtype=torch.int32, device=dev),
            torch.ones(2, dtype=torch.bool, device=dev),
            device_fold_init(2, dev), k=1)
        outs.append((full.cpu(), last.cpu(), torch.stack(steps),
                     res[1].cpu()))
    for a, b in zip(outs[1], outs[0]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(outs[1][2], outs[1][0][:, n_pre + s:
                                                     n_pre + s + 2]
                               .transpose(0, 1), atol=1e-4, rtol=1e-4)


def test_reference_mode_reduces_through_the_kernel(cuda):
    """Reference mode and ``greedy_generate`` on the card take each
    prefill's and each decode step's argmax and gap from the top2gap
    kernel (one launch per batch-1 prefill and per decode call), and
    serve what the CPU run serves in f32: tokens equal up to the first
    near-tie (gap < 1e-4), gaps within 1e-4."""
    cfg = get_smoke_config("qwen2-0.5b")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 5 + 4 * i).astype(np.int32)
               for i in range(4)]
    gear = Gear(cascade=Cascade(("a",), ()), min_queue_lens={"a": 1},
                load_fractions={"a": {0: 1.0}})
    p_cpu = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    runs = {}
    for dev in ("cpu", cuda):
        params = _to(p_cpu, dev)
        eng = TT.SlotEngine("a", params, cfg, n_slots=2, max_len=32,
                            device=dev)
        te = TT.TokenEngine([eng], gear, min_tokens=2, mode="reference")
        before = top2gap.launches
        out = te.serve([TT.TokenRequest(i, p, 6)
                        for i, p in enumerate(prompts)])
        st = te.stats()
        launched = top2gap.launches - before
        g_before = top2gap.launches
        toks, gaps = TT.greedy_generate(params, cfg, prompts[0], 5)
        g_launched = top2gap.launches - g_before
        runs[str(dev)] = out, launched, st, (toks, gaps), g_launched
    (c_out, c_n, _, c_greedy, c_gn) = runs["cpu"]
    (g_out, g_n, g_st, g_greedy, g_gn) = runs[str(cuda)]
    assert c_n == 0 and c_gn == 0
    assert g_n == g_st["prefill_prompts"] + g_st["decode_calls"] > 0
    assert g_gn == 5
    pairs = [(c_out[r].tokens, g_out[r].tokens, c_out[r].gaps,
              g_out[r].gaps) for r in c_out]
    pairs.append((list(c_greedy[0]), list(g_greedy[0]), list(c_greedy[1]),
                  list(g_greedy[1])))
    for ct, gt, cg, gg in pairs:
        assert len(ct) == len(gt)
        for a, b, x, y in zip(ct, gt, cg, gg):
            assert a == b and abs(x - y) <= 1e-4
            if x < 1e-4:
                break


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("b,s,di", [(1, 200, 512), (2, 33, 70), (1, 1, 64),
                                    (2, 130, 256), (1, 31, 31), (2, 32, 33),
                                    (1, 33, 64), (1, 65, 96), (2, 64, 8192)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_kernel_matches_plain(cuda, n, b, s, di, x_dtype,
                                         with_h0):
    """y and h_last against the plain scan on the same card inputs, at
    every N (4 states a thread: 1, 2 or 4 lanes a channel): S below, at,
    one past and two runs past the kernel's 32-step runs (and not a
    multiple of its 8-step groups), Di one short of and one past a block's
    32 channels and not a multiple of 4 or 8, x in f32 and bf16, a zero
    and a nonzero initial state."""
    f = lambda seed, shape, scale=1.0: torch.from_numpy(  # noqa: E731
        _rand(seed, shape, scale)).to(cuda)
    dt = torch.nn.functional.softplus(f(1, (b, s, di), 0.5) - 3.0)
    a = -torch.exp(f(2, (di, n), 0.5))
    bm, cm = f(3, (b, s, n)), f(4, (b, s, n))
    d = f(5, (di,))
    x = f(6, (b, s, di)).to(x_dtype)
    h0 = f(7, (b, di, n)) if with_h0 else None
    before = mamba_scan.launches
    y, h = mamba_scan(dt, a, bm, cm, d, x, h0)
    assert mamba_scan.launches == before + 1
    ry, rh = tref.mamba_scan_ref(dt, a, bm, cm, d, x, h0)
    torch.testing.assert_close(y, ry, atol=2e-4, rtol=0)
    torch.testing.assert_close(h, rh, atol=2e-4, rtol=0)


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("b,s,di", [(1, 200, 512), (2, 33, 70), (1, 1, 64),
                                    (1, 31, 31), (2, 64, 8192)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_kernel_writes_the_chunk_states(cuda, n, b, s, di,
                                                   with_h0):
    """The forward with ``return_states``: one launch, y and h_last the
    same bits as the launch without it, and the state entering every
    32-step chunk within 2e-4 of the plain version's (its first chunk's
    h0, or zeros, exactly)."""
    f = lambda seed, shape, scale=1.0: torch.from_numpy(  # noqa: E731
        _rand(seed, shape, scale)).to(cuda)
    dt = torch.nn.functional.softplus(f(1, (b, s, di), 0.5) - 3.0)
    a = -torch.exp(f(2, (di, n), 0.5))
    ins = (dt, a, f(3, (b, s, n)), f(4, (b, s, n)), f(5, (di,)),
           f(6, (b, s, di)).bfloat16(), f(7, (b, di, n)) if with_h0 else None)
    before = mamba_scan.launches
    y, h, states = mamba_scan(*ins, return_states=True)
    assert mamba_scan.launches == before + 1
    y0, h0 = mamba_scan(*ins)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    want = tref.mamba_scan_ref(*ins, return_states=True)[2]
    assert states.shape == want.shape and states.dtype == torch.float32
    assert torch.equal(states[:, 0], want[:, 0])
    torch.testing.assert_close(states, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_kernel_unaligned_operands(cuda, x_dtype):
    """Operands whose rows are not 16-byte aligned take the element-wise
    staging: dt and x as views of wider buffers at odd offsets and odd
    step strides, B and C as column slices at an odd offset."""
    b, s, di, n, r = 2, 45, 96, 16, 7
    f = lambda seed, shape: torch.from_numpy(  # noqa: E731
        _rand(seed, shape)).to(cuda)
    dt = f(1, (b, s, di + 3)).abs().mul_(0.05)[..., 1:di + 1]
    x = f(2, (b, s, di + 5)).to(x_dtype)[..., 3:di + 3]
    dbc = f(3, (b, s, r + 2 * n))
    bm, cm = dbc[..., r:r + n], dbc[..., r + n:]
    a = -torch.exp(f(4, (di, n)) * 0.5)
    d = f(5, (di,))
    h0 = f(6, (b, di, n))
    y, h = mamba_scan(dt, a, bm, cm, d, x, h0)
    ry, rh = tref.mamba_scan_ref(dt, a, bm, cm, d, x, h0)
    torch.testing.assert_close(y, ry, atol=2e-4, rtol=0)
    torch.testing.assert_close(h, rh, atol=2e-4, rtol=0)


def test_mamba_scan_kernel_reads_strided_b_c(cuda):
    """B and C as column slices of one wider projection (the model's f32
    path hands them over without a copy)."""
    b, s, di, n, r = 2, 70, 128, 16, 8
    dbc = torch.from_numpy(_rand(1, (b, s, r + 2 * n))).to(cuda)
    dt = torch.from_numpy(np.abs(_rand(2, (b, s, di))) * 0.1).to(cuda)
    a = -torch.from_numpy(np.abs(_rand(3, (di, n)))).to(cuda)
    d = torch.from_numpy(_rand(4, (di,))).to(cuda)
    x = torch.from_numpy(_rand(5, (b, s, di))).to(cuda)
    bm, cm = dbc[..., r:r + n], dbc[..., r + n:]
    y, h = mamba_scan(dt, a, bm, cm, d, x)
    ry, rh = tref.mamba_scan_ref(dt, a, bm, cm, d, x)
    torch.testing.assert_close(y, ry, atol=2e-4, rtol=0)
    torch.testing.assert_close(h, rh, atol=2e-4, rtol=0)


def test_mamba_scan_kernel_rejects_what_it_does_not_take(cuda):
    b, s, di = 1, 8, 32

    def ins(n=16, dt_dtype=torch.float32, x_dtype=torch.float32):
        return (torch.zeros(b, s, di, device=cuda, dtype=dt_dtype),
                torch.zeros(di, n, device=cuda),
                torch.zeros(b, s, n, device=cuda),
                torch.zeros(b, s, n, device=cuda),
                torch.zeros(di, device=cuda),
                torch.zeros(b, s, di, device=cuda, dtype=x_dtype))
    before = mamba_scan.launches
    with pytest.raises(ValueError):
        mamba_scan(*ins(n=32))                       # d_state 32
    with pytest.raises(TypeError):
        mamba_scan(*ins(dt_dtype=torch.bfloat16))    # dt must be f32
    with pytest.raises(TypeError):
        mamba_scan(*ins(x_dtype=torch.float16))      # x f32 or bf16
    t = ins()
    with pytest.raises(ValueError):                  # x's Di axis strided
        mamba_scan(*t[:5], torch.zeros(b, s, 2 * di, device=cuda)[..., ::2])
    with pytest.raises(ValueError):
        mamba_scan(*t, torch.zeros(b, di, 8, device=cuda))   # h0 shape
    assert mamba_scan.launches == before


def _step_case(dev, b, di, n, dtype, pool=None, seed=0):
    """One decode step's kernel inputs: x_new and z the halves of one
    in_proj output, B and C column views of one x_proj output (dt_rank 8
    columns before them), the conv pool (B, 3, Di) in ``pool`` (default:
    ``dtype``), an f32 state; the SSM step's x is left to the conv's
    output (None here)."""
    def f(i, shape, scale=1.0):
        return torch.from_numpy(_rand(seed + i, shape, scale)).to(dev)
    xz = f(1, (b, 1, 2 * di)).to(dtype)
    dbc = f(2, (b, 1, 8 + 2 * n)).to(dtype)
    conv = (xz[..., :di], f(3, (b, 3, di)).to(pool or dtype),
            f(4, (4, di), 0.5).to(dtype), f(5, (di,), 0.1).to(dtype))
    ssm = (f(6, (b, 1, di)).to(dtype), f(7, (di,), 0.5) - 3.0,
           f(8, (di, n), 0.5).abs(), dbc[..., 8:8 + n], dbc[..., 8 + n:],
           f(9, (di,)), None, xz[..., di:], f(10, (b, di, n)))
    return conv, ssm


def _step_close(got, want):
    """bf16: within 2 units in the last place of ``want`` (at least 2^-17)
    and at most 0.1 % of the elements not bit-equal; f32: within 1e-5
    absolute plus relative. The kernels sum over K and N in another order
    than the plain chain's cuBLAS products, which moves an f32 sum's last
    bits; in bf16 that flips a rounding by one unit, which the next
    product's rounding can carry to two."""
    assert got.dtype == want.dtype and got.shape == want.shape
    w, d = want.float(), (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
        assert bool((d <= 2 * ulp.clamp_min(2.0 ** -17)).all()), float(
            (d / ulp).max())
        assert float((got != want).float().mean()) <= 1e-3
    else:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,di,n,dtype,pool", [
    (32, 8192, 16, torch.bfloat16, None),     # falcon-mamba-7b's decode
    (1, 8192, 16, torch.bfloat16, None),      # jamba's forward
    (3, 200, 4, torch.bfloat16, None), (2, 72, 8, torch.bfloat16, None),
    (5, 8192, 8, torch.bfloat16, None), (1, 33, 4, torch.bfloat16, None),
    (4, 256, 16, torch.float32, None), (2, 100, 4, torch.float32, None),
    (4, 100, 8, torch.float32, torch.bfloat16),   # the narrow pool
    (3, 8192, 16, torch.float32, torch.bfloat16)])
def test_mamba_step_kernels_match_plain(cuda, b, di, n, dtype, pool):
    """Each decode-step kernel against its plain version on clones of the
    same card inputs, at every N, Di not a multiple of a block's channels,
    bf16 and f32 activations and a narrow bf16 pool under f32, with B and
    C read through x_proj's strides: one launch each, the conv state and
    the SSM state the plain chain's bits (the same roundings, op for op),
    xc and out within ``_step_close``."""
    conv, ssm = _step_case(cuda, b, di, n, dtype, pool)
    rpool, h = conv[1].clone(), ssm[8]
    rh = h.clone()
    before = (mamba_conv_step.launches, mamba_ssm_step.launches)
    xc = mamba_conv_step(*conv)
    rxc = tref.mamba_conv_step_ref(conv[0], rpool, conv[2], conv[3])
    out = mamba_ssm_step(*ssm[:6], xc, ssm[7], h)
    rout = tref.mamba_ssm_step_ref(*ssm[:6], xc, ssm[7], rh)
    assert (mamba_conv_step.launches, mamba_ssm_step.launches) == (
        before[0] + 1, before[1] + 1)
    assert conv[1].dtype == (pool or dtype) and torch.equal(conv[1], rpool)
    assert torch.equal(h, rh)
    _step_close(xc, rxc)
    _step_close(out, rout)


def test_mamba_step_kernels_reject_what_they_do_not_take(cuda):
    b, di, n = 2, 64, 16
    conv, ssm = _step_case(cuda, b, di, n, torch.bfloat16)
    x = conv[0].clone()
    before = (mamba_conv_step.launches, mamba_ssm_step.launches)
    with pytest.raises(ValueError):                  # d_conv 5
        mamba_conv_step(conv[0], torch.zeros(b, 4, di, device=cuda,
                                             dtype=torch.bfloat16),
                        torch.zeros(5, di, device=cuda,
                                    dtype=torch.bfloat16), conv[3])
    with pytest.raises(TypeError):                   # f32 pool under bf16
        mamba_conv_step(conv[0], conv[1].float(), conv[2], conv[3])
    with pytest.raises(TypeError):                   # f16 activations
        mamba_conv_step(conv[0].half(), conv[1].half(), conv[2].half(),
                        conv[3].half())
    with pytest.raises(ValueError):                  # channels strided
        mamba_conv_step(conv[0], torch.zeros(b, 3, 2 * di, device=cuda,
                                             dtype=torch.bfloat16)[..., ::2],
                        conv[2], conv[3])
    with pytest.raises(ValueError):                  # d_state 32
        mamba_ssm_step(*ssm[:2], torch.zeros(di, 32, device=cuda),
                       *ssm[3:6], x, ssm[7], torch.zeros(b, di, 32,
                                                         device=cuda))
    with pytest.raises(TypeError):                   # a bf16 state
        mamba_ssm_step(*ssm[:6], x, ssm[7], ssm[8].bfloat16())
    with pytest.raises(TypeError):                   # dt_raw in f32
        mamba_ssm_step(ssm[0].float(), *ssm[1:6], x, ssm[7], ssm[8])
    with pytest.raises(ValueError):                  # the state's rows
        mamba_ssm_step(*ssm[:6], x, ssm[7],          # not contiguous
                       ssm[8].transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):                  # state off 16 bytes
        mamba_ssm_step(*ssm[:6], x, ssm[7], torch.zeros(
            b * di * n + 1, device=cuda)[1:].view(b, di, n))
    with pytest.raises(RuntimeError):                # no backward
        mamba_ssm_step(*ssm[:6], x.float().requires_grad_().bfloat16(),
                       ssm[7], ssm[8])
    assert (mamba_conv_step.launches, mamba_ssm_step.launches) == before


def test_mamba_step_kernels_count_k_times_layers_per_fused_call(cuda):
    """A 64-layer SSM smoke model served through the engine's fused
    decode: every call, its eager warm-up and its graph replays alike,
    counts k x 64 launches of each step kernel (no capture counts), and
    no scan launches outside the prefills."""
    cfg = dataclasses.replace(get_smoke_config("falcon-mamba-7b"),
                              num_layers=64)
    params = TM.init_params(cfg, seed=3, device=cuda)
    eng = TT.SlotEngine("a", params, cfg, n_slots=4, max_len=64, device=cuda)
    rng = np.random.default_rng(2)
    for n in (7, 11):
        eng.prefill_batch([rng.integers(0, cfg.vocab_size, n)
                           .astype(np.int32)])
    scans = mamba_scan.launches
    for k in (1, 3, 1, 3, 3):
        before = (mamba_conv_step.launches, mamba_ssm_step.launches)
        eng.decode_fused(k)
        torch.cuda.synchronize()
        assert (mamba_conv_step.launches - before[0],
                mamba_ssm_step.launches - before[1]) == (64 * k, 64 * k)
    assert eng.graphs.replays == 3 and mamba_scan.launches == scans


def test_ssm_smoke_model_on_card_matches_cpu(cuda):
    """falcon-mamba-7b at smoke size in f32: prefill (the scan kernel in
    every layer) and 3 decode steps agree with the CPU plain path, and a
    fused two-request engine run launches the scan once per layer per
    prefill and no attention kernel."""
    cfg = get_smoke_config("falcon-mamba-7b")
    p_cpu = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    p_gpu = _to(p_cpu, cuda)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 21)) \
        .astype(np.int32)
    outs = []
    for p, dev in ((p_cpu, "cpu"), (p_gpu, cuda)):
        before = mamba_scan.launches
        logits, cache = TM.prefill(p, cfg, {"tokens": prompt}, cache_len=32)
        if dev == cuda:
            assert mamba_scan.launches == before + cfg.num_layers
        steps = [logits]
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        for k in range(3):
            logits, cache = TM.decode_step(p, cfg, tok[:, None], cache,
                                           torch.full((2,), 21 + k,
                                                      device=dev))
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            steps.append(logits)
        outs.append(torch.stack(steps).cpu())
    torch.testing.assert_close(outs[1], outs[0], atol=1e-4, rtol=1e-4)
    assert torch.equal(outs[1].argmax(-1), outs[0].argmax(-1))
    eng = TT.SlotEngine("a", p_gpu, cfg, n_slots=2, max_len=32, device=cuda)
    gear = Gear(cascade=Cascade(("a",), ()), min_queue_lens={"a": 1},
                load_fractions={"a": {0: 1.0}})
    te = TT.TokenEngine([eng], gear, min_tokens=2, spec_k=4)
    counts = {n: f.launches for n, f in (("scan", mamba_scan),
                                         ("decode", decode_attention),
                                         ("flash", flash_attention))}
    out = te.serve([TT.TokenRequest(i, prompt[i], 5) for i in range(2)])
    st = te.stats()
    assert all(len(r.tokens) == 5 for r in out.values())
    assert mamba_scan.launches - counts["scan"] == \
        cfg.num_layers * st["prefill_calls"] == cfg.num_layers * 2
    assert decode_attention.launches == counts["decode"]
    assert flash_attention.launches == counts["flash"]
    assert all(b == 1 for b, _ in eng.stats.prefill_shapes)


# ---------------------------------------------------------------------------
# The one-shot classifier path: InferenceEngine and EngineBackend on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 129])
def test_tiny_inference_engine_on_card_matches_cpu(cuda, n):
    """t-base (the widest member) on the card against its CPU run: scores
    within 1e-4 in f32 with TF32 off (``resolve_device``), the bucket
    padding and the oversize split included."""
    resolve_device(cuda)
    cfg = TY.TINY_FAMILY[4]
    p_cpu = TY.init_tiny(cfg, seed=1, device="cpu")
    engines = [TE.InferenceEngine(cfg.name,
                                  lambda p, t: TY.apply_tiny(cfg, p, t), p)
               for p in (p_cpu, _to(p_cpu, cuda))]
    assert engines[1].device.type == "cuda"
    tok = np.random.default_rng(n).integers(0, 64, (n, 32)).astype(np.int32)
    ref = engines[0].infer(tok)
    out = engines[1].infer(tok)
    assert out.device.type == "cuda" and out.shape == (n, 2)
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-4)


class _RowScores:
    """Stub engine: row ``tokens[i, 0]`` of a fixed (N, 2) score table, on
    the table's device."""

    def __init__(self, scores):
        self.scores = scores

    def infer(self, tokens):
        rows = torch.from_numpy(np.asarray(tokens)[:, 0].astype(np.int64))
        return self.scores[rows.to(self.scores.device)]


@pytest.mark.parametrize("n", [1, 7, 64, 128])
def test_engine_backend_execute_on_card_matches_cpu(cuda, n):
    """The same (n, 2) f32 scores reduced by the top2gap kernel on the
    card and by its plain version on the CPU: certainties bit-equal,
    predictions equal (an exact tie: gap 0, the lower class), one kernel
    launch per ``execute``."""
    table = torch.from_numpy(_rand(n, (200, 2), 3.0))
    table[5] = torch.tensor([1.5, 1.5])
    toks = np.arange(200, dtype=np.int32)[:, None].repeat(4, 1)
    labels = np.random.default_rng(n).integers(0, 2, 200).astype(np.int32)
    sids = [(5 + 37 * i) % 200 for i in range(n)]
    out = []
    for dev in ("cpu", cuda):
        b = TX.EngineBackend({"m": _RowScores(table.to(dev))},
                             tokens=toks, labels=labels)
        before = top2gap.launches
        out.append(b.execute("m", sids))
        assert top2gap.launches - before == (1 if dev == cuda else 0)
    cpu, gpu = out
    assert gpu.certs.dtype == np.float64
    assert np.array_equal(gpu.certs, cpu.certs)
    assert np.array_equal(gpu.preds, cpu.preds)
    assert gpu.correct == cpu.correct
    if 5 in sids:
        i = sids.index(5)
        assert gpu.certs[i] == 0.0 and gpu.preds[i] == 0


@pytest.mark.parametrize("estimator", ["top2_gap_softmax", "max_prob",
                                       "neg_entropy"])
def test_engine_backend_other_estimators_on_card_match_cpu(cuda, estimator):
    """``EngineBackend.execute`` with an estimator other than top2_gap
    reduces on the card with torch ops (no top2gap launch): certainties
    within 1e-6 abs / 1e-6 rel of the CPU's for the same (n, 5) scores
    (f32 softmax and entropy in another order), predictions equal, ties to
    the lower class."""
    table = torch.from_numpy(_rand(3, (200, 5), 3.0))
    table[5] = torch.tensor([1.5, 0.0, 1.5, -1.0, 1.5])
    table[6] = 0.25
    toks = np.arange(200, dtype=np.int32)[:, None].repeat(4, 1)
    labels = np.random.default_rng(3).integers(0, 5, 200).astype(np.int32)
    sids = [5, 6] + [(11 + 37 * i) % 200 for i in range(62)]
    out = []
    for dev in ("cpu", cuda):
        b = TX.EngineBackend({"m": _RowScores(table.to(dev))},
                             estimator=estimator, tokens=toks, labels=labels)
        before = top2gap.launches
        out.append(b.execute("m", sids))
        assert top2gap.launches == before
    cpu, gpu = out
    assert gpu.certs.dtype == np.float64
    np.testing.assert_allclose(gpu.certs, cpu.certs, atol=1e-6, rtol=1e-6)
    assert np.array_equal(gpu.preds, cpu.preds)
    assert gpu.preds[0] == 0 and gpu.preds[1] == 0
    assert gpu.correct == cpu.correct


def test_tiny_family_trains_and_serves_on_card(cuda):
    """A short family run on the card: training, profiles through the
    engine backend (runtimes positive, mem 4 B per parameter), and one
    top2gap launch per executed batch."""
    fam = TY.TINY_FAMILY[:2]
    out = TY.train_tiny_family(n_train=256, n_val=128, steps_scale=0.05,
                               family=fam, device=cuda)
    assert all(t.device.type == "cuda"
               for t in TY._leaves(out[0][fam[0].name]))
    backend = TY.make_engine_backend(*out, family=fam, batch_sizes=(1, 4),
                                     repeats=2)
    for cfg in fam:
        prof = backend.profiles[cfg.name]
        assert np.all(prof.batch_runtimes > 0)
        assert prof.mem_bytes == 4 * sum(
            t.numel() for t in TY._leaves(out[0][cfg.name]))
    before = top2gap.launches
    for k in range(3):
        ex = backend.execute(fam[0].name, list(range(k, k + 5)))
        assert len(ex.certs) == 5 and np.all(ex.certs >= 0)
    assert top2gap.launches - before == 3


def test_top2gap_launch_count_exact_under_threads(cuda):
    """The server's consumer threads launch concurrently: the wrapper's
    count loses no launch."""
    import sys
    import threading
    x = torch.from_numpy(_rand(0, (4, 2))).to(cuda)
    n_threads, per_thread = 16, 200
    before = top2gap.launches

    def work():
        for _ in range(per_thread):
            top2gap(x)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert top2gap.launches - before == n_threads * per_thread


# ---------------------------------------------------------------------------
# Compiled steps: CUDA graph replays against direct eager calls
# ---------------------------------------------------------------------------

def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _equal_trees(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_equal_trees, a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def _graph_engine(cuda, arch, n_slots=4, max_len=64):
    cfg = get_smoke_config(arch)
    params = TM.init_params(cfg, seed=3, device=cuda)
    return TT.SlotEngine("a", params, cfg, n_slots=n_slots, max_len=max_len,
                         device=cuda)


def _check_prefill_replay(eng, prompts):
    """One bucketed prefill through the engine against ``prefill_bucketed``
    called eagerly on the same padded batch: first tokens and gaps
    bit-equal, and the joiners' pool lanes equal to the eager cache rows.
    Returns whether the call replayed a graph."""
    n = len(prompts)
    bb = eng._batch_bucket(n)
    lb = eng._len_bucket(max(p.size for p in prompts))
    arr = np.zeros((bb, lb), np.int32)
    lens = np.ones((bb,), np.int32)
    for i, p in enumerate(prompts):
        arr[i, :p.size] = p
        lens[i] = p.size
    logits, cache1 = TM.prefill_bucketed(eng.params, eng.cfg, arr, lens,
                                         cache_len=eng.max_len)
    etok, egap = argmax_gap(logits)
    replays = eng.graphs.replays
    slots, toks, gaps = eng.prefill_batch(prompts)
    assert np.array_equal(toks, etok[:n].cpu().numpy())
    assert np.array_equal(gaps, egap[:n].cpu().numpy())
    rows = torch.as_tensor(slots, device=eng.device)
    for pool, new in zip(eng.cache["blocks"], cache1["blocks"]):
        for name, leaf in pool.items():
            assert torch.equal(leaf[:, rows], new[name][:, :n])
    return eng.graphs.replays == replays + 1


def _check_fused_replay(eng, k, mode="ewma", beta=0.35):
    """k fused steps through the engine against ``decode_fused_steps``
    called eagerly on a clone of the engine's state: traces and the state
    after the call bit-equal. Returns whether the call replayed."""
    active = torch.from_numpy(eng.active).to(eng.device)
    tt, gt, ct, tok, cache, pos, fold = TM.decode_fused_steps(
        eng.params, eng.cfg, eng.dev_tok.clone(), _clone(eng.cache),
        eng.dev_pos.clone(), active, _clone(eng._fold), k=k, beta=beta,
        mode=mode)
    replays = eng.graphs.replays
    out = eng.decode_fused(k, mode=mode, beta=beta)
    for got, want in zip(out, (tt, gt, ct)):
        assert np.array_equal(got, want.cpu().numpy())
    assert torch.equal(eng.dev_tok, tok) and torch.equal(eng.dev_pos, pos)
    assert _equal_trees(eng._fold, fold) and _equal_trees(eng.cache, cache)
    return eng.graphs.replays == replays + 1


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b",
                                  "qwen2-moe-a2.7b"])
def test_fused_graphs_match_eager_calls_bit_for_bit(cuda, arch):
    """Every replay of the bucketed prefill (qwen2) and of the fused decode
    at k 1 and 3 equals the direct eager call, at least twice each on new
    inputs; the first call of a key is its eager warm-up. The MoE decode
    (routing, the sorted dispatch, the ordered combine) replays bit-equal
    too."""
    eng = _graph_engine(cuda, arch)
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32)

    bucketed = TM.bucketed_prefill_supported(eng.cfg)
    eng.prefill_batch([prompt(9)])
    for n in (12, 14):                 # the same (1, 16) bucket
        if bucketed:
            assert _check_prefill_replay(eng, [prompt(n)])
        else:                          # exact-length, eager
            eng.prefill_batch([prompt(n)])
    for k in (1, 3):
        eng.decode_fused(k)
        assert all(_check_fused_replay(eng, k) for _ in range(3))
    cc = eng.compile_counts()
    assert cc["fused_decode"] == 2
    assert cc["bucketed_prefill"] == (1 if bucketed else 0)
    assert cc["reference_prefill"] == (0 if bucketed else 3)
    assert len(eng.graphs._graphs) == cc["total"] - cc["reference_prefill"]


def test_reference_decode_graph_matches_eager_calls(cuda):
    """Reference mode: each replay of the (n_slots, 1) decode equals
    ``decode_step`` and the argmax/gap reduction called eagerly on a clone
    of the pool."""
    eng = _graph_engine(cuda, "qwen2-0.5b")
    rng = np.random.default_rng(1)
    nxt = {}
    for n in (7, 10, 13):
        slot, tok, _ = eng.prefill_into_slot(
            rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32))
        nxt[slot] = tok
    for i in range(4):
        toks = np.zeros((eng.n_slots, 1), np.int32)
        for s, t in nxt.items():
            toks[s, 0] = t
        logits, cache = TM.decode_step(eng.params, eng.cfg, toks,
                                       _clone(eng.cache),
                                       torch.from_numpy(eng.pos).to(cuda))
        etok, egap = argmax_gap(logits)
        replays = eng.graphs.replays
        out = eng.decode(nxt)
        assert eng.graphs.replays == replays + (1 if i else 0)
        for s, (t, g) in out.items():
            assert t == int(etok[s]) and g == float(egap[s])
        assert _equal_trees(eng.cache, cache)
        nxt = {s: t for s, (t, _) in out.items()}
    assert eng.compile_counts() == {"reference_prefill": 3,
                                    "reference_decode": 1,
                                    "bucketed_prefill": 0,
                                    "fused_decode": 0, "total": 4}


def test_graph_replays_count_their_kernel_launches(cuda):
    """A replay counts the launches its capture recorded: after N fused
    single steps top2gap has launched N times and decode attention N times
    per layer, the warm-up included, the capture not."""
    eng = _graph_engine(cuda, "qwen2-0.5b")
    eng.prefill_batch([np.arange(5, dtype=np.int32)])
    before = {n: f.launches for n, f in (("top2gap", top2gap),
                                         ("decode", decode_attention),
                                         ("flash", flash_attention))}
    for _ in range(6):
        eng.decode_fused(1)
    torch.cuda.synchronize()
    assert eng.graphs.replays == 5
    assert top2gap.launches - before["top2gap"] == 6
    assert decode_attention.launches - before["decode"] == \
        6 * eng.cfg.num_layers
    assert flash_attention.launches == before["flash"]


def test_inference_engine_graphs_match_eager_at_every_bucket(cuda):
    """Each bucket's graph replay returns the scores a direct eager call of
    ``apply_tiny`` gives on the same padded batch, bit for bit, on two
    batches each: a full one and the smallest the engine pads to it."""
    cfg = TY.TINY_FAMILY[1]
    params = TY.init_tiny(cfg, 0, device=cuda)
    eng = TE.InferenceEngine(cfg.name, lambda p, x: TY.apply_tiny(cfg, p, x),
                             params, buckets=(1, 2, 4, 8, 16))
    eng.warmup(32)
    assert len(eng.graphs) == 5 and eng.graphs.replays == 0
    rng = np.random.default_rng(2)
    for lo, b in zip((0,) + eng.buckets, eng.buckets):
        for n in (b, lo + 1):
            tok = np.zeros((b, 32), np.int32)
            tok[:n] = rng.integers(0, cfg.vocab, (n, 32))
            with torch.no_grad():
                want = TY.apply_tiny(cfg, params, torch.from_numpy(tok)
                                     .to(cuda))[:n]
            assert torch.equal(eng.infer(tok[:n]), want)
    assert len(eng.graphs) == 5
    assert eng.graphs.replays == 2 * len(eng.buckets)


def test_inference_engine_serves_concurrent_threads_their_own_scores(cuda):
    """Consumer threads call one engine at once (logical devices hosting
    replicas of one model): 16 threads, more than the cores, each with its
    own batch, under a shortened switch interval; every call returns its
    own batch's scores."""
    import sys
    import threading
    cfg = TY.TINY_FAMILY[1]
    params = TY.init_tiny(cfg, 1, device=cuda)
    eng = TE.InferenceEngine(cfg.name, lambda p, x: TY.apply_tiny(cfg, p, x),
                             params, buckets=(8,))
    eng.warmup(32)
    rng = np.random.default_rng(3)
    n_threads = 16
    toks = [rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
            for _ in range(n_threads)]
    want = [eng.infer(t) for t in toks]
    assert not torch.equal(want[0], want[1])
    bad = []

    def work(i):
        for _ in range(100):
            if not torch.equal(eng.infer(toks[i]), want[i]):
                bad.append(i)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not bad and len(eng.graphs) == 1
    assert eng.graphs.replays == n_threads * 101


# ---------------------------------------------------------------------------
# flash attention backward and training on the card
# ---------------------------------------------------------------------------

def _bwd_case(dev, dtype, b, sq, sk, h, kv, d, causal, window, seed=0):
    q = torch.from_numpy(_rand(seed, (b, sq, h, d))).to(dev, dtype)
    k = torch.from_numpy(_rand(seed + 1, (b, sk, kv, d))).to(dev, dtype)
    v = torch.from_numpy(_rand(seed + 2, (b, sk, kv, d))).to(dev, dtype)
    do = torch.from_numpy(_rand(seed + 3, (b, sq, h, d))).to(dev, dtype)
    o = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal, window=window).to(dtype)
    return q, k, v, o, do


def _rel(a, r, scale=None):
    """max |a - r| over the largest |r| (or over ``scale``)."""
    return float((a.float() - r).abs().max()
                 / (r.abs().max() if scale is None else scale))


def _lse(ins, causal, window):
    """The forward's log-sum-exp for ``_bwd_case``'s inputs, as the
    plain version gives it."""
    return tref.flash_attention_lse_ref(ins[0], ins[1], causal=causal,
                                        window=window)


_BWD_CASES = [(mode, 2, 65, 65, 4, 2) for mode in sorted(_MODES)] + [
    (mode, 1, 200, 200, 14, 2) for mode in sorted(_MODES)] + [
    (mode, 2, 1, 1, 2, 1) for mode in sorted(_MODES)] + [
    (mode, 1, 130, 130, 16, 2) for mode in sorted(_MODES)] + [
    ("full", 3, 33, 77, 4, 4), ("full", 1, 130, 64, 8, 2),
    ("causal", 1, 100, 100, 16, 1), ("window7", 2, 70, 70, 16, 1),
    ("full", 2, 70, 100, 8, 2)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("d", [32, 64, 80, 128])
@pytest.mark.parametrize("mode,b,sq,sk,h,kv", _BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(cuda, dtype, tol, d, mode,
                                                  b, sq, sk, h, kv):
    """dq, dk, dv of the backward kernel against the plain backward on the
    same inputs (o the f32 forward rounded to the dtype; D = dO . o read
    from it, as the kernel reads it; the plain log-sum-exp as the forward
    hands it over): causal, windowed (7, 100) and full, Sk != Sq in the
    full form only, tiles ragged on both axes, GQA groups 1-7, 8 (a whole
    cluster of query heads, its last key tile nearly empty at Sk 130) and
    16 (two heads a block), 4 with the last key tile part-empty, hd
    32-128; f32 within 1e-4 and bf16 within 1e-2 of each
    gradient's largest entry (the bf16 output's rounding and P's and dS's
    as bf16 operands). At one query
    over one key dq and dk vanish in exact arithmetic: there each is held
    within the same share of dv's largest entry."""
    causal, window = _MODES[mode]
    ins = _bwd_case(cuda, dtype, b, sq, sk, h, kv, d, causal, window)
    before = flash_attention_bwd.launches
    grads = flash_attention_bwd(*ins, causal=causal, window=window,
                                lse=_lse(ins, causal, window))
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    refs = tref.flash_attention_bwd_ref(*(t.float() for t in ins),
                                        causal=causal, window=window)
    scale = float(refs[2].abs().max()) if sq == sk == 1 else None
    for g, r, t in zip(grads, refs, ins):
        assert g.dtype == dtype and g.shape == t.shape
        assert bool(torch.isfinite(g).all())
        assert _rel(g, r, scale) <= tol


@pytest.mark.parametrize("h,kv", [(16, 16), (14, 2), (16, 2)])
def test_flash_attention_bwd_kernel_is_deterministic(cuda, h, kv):
    """No atomics: two calls give the same bits (the resume check's
    premise), at GQA groups 1 (no cluster), 7 and 8 (the dk, dv partials
    of a cluster's query heads summed in a fixed order)."""
    ins = _bwd_case(cuda, torch.bfloat16, 2, 300, 300, h, kv, 64, True, 0)
    lse = _lse(ins, True, 0)
    a = flash_attention_bwd(*ins, lse=lse)
    b = flash_attention_bwd(*ins, lse=lse)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_attention_autograd_runs_the_backward_kernel(cuda):
    """On the card with inputs that require grad the wrapper returns an
    output with a grad_fn; backward launches the backward kernel once and
    gives the plain backward's gradients. Under no_grad the same call
    launches the forward only and returns no graph."""
    q, k, v, _, do = _bwd_case(cuda, torch.float32, 2, 96, 96, 8, 2, 64,
                               True, 40)
    for t in (q, k, v):
        t.requires_grad_(True)
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v, window=40)
    assert out.grad_fn is not None
    out.backward(do)
    torch.cuda.synchronize()
    assert flash_attention.launches == f0 + 1
    assert flash_attention_bwd.launches == b0 + 1
    refs = tref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                        out.detach(), do, window=40)
    for t, r in zip((q, k, v), refs):
        assert _rel(t.grad, r) <= 1e-4
    with torch.no_grad():
        assert flash_attention(q, k, v, window=40).grad_fn is None
    assert flash_attention_bwd.launches == b0 + 1


def test_flash_attention_bwd_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, o, do = _bwd_case(cuda, torch.float32, 1, 8, 8, 4, 2, 64, True,
                               0)
    before = flash_attention_bwd.launches
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o[:, :4], do)
    with pytest.raises(TypeError):
        flash_attention_bwd(q, k, v, o.bfloat16(), do)
    bf = [t.bfloat16() for t in (q, k, v, o, do)]
    with pytest.raises(ValueError):   # the bf16 kernel reads the LSE
        flash_attention_bwd(*bf)
    with pytest.raises(ValueError):
        flash_attention_bwd(*bf, lse=torch.zeros(1, 4, 4, device=cuda))
    wide = torch.zeros(1, 8, 2, 96, device=cuda)
    with pytest.raises(ValueError):
        flash_attention_bwd(torch.zeros(1, 8, 4, 96, device=cuda), wide,
                            wide, torch.zeros(1, 8, 4, 96, device=cuda),
                            torch.zeros(1, 8, 4, 96, device=cuda))
    assert flash_attention_bwd.launches == before


def test_forward_only_kernels_raise_under_grad_on_the_card(cuda):
    """decode_attention and top2gap have no backward kernel (they only
    serve): on CUDA inputs that require grad (grad mode on) each raises
    instead of returning an output without a grad_fn; under no_grad each
    launches. mamba_scan differentiates (the next test)."""
    q = torch.zeros(2, 4, 64, device=cuda, requires_grad=True)
    kc = torch.zeros(2, 16, 2, 64, device=cuda)
    s = torch.zeros(2, 100, device=cuda, requires_grad=True)
    before = {f: f.launches for f in (decode_attention, top2gap)}
    for call in (lambda: decode_attention(q, kc, kc, 8),
                 lambda: top2gap(s)):
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    assert all(f.launches == n for f, n in before.items())
    with torch.no_grad():
        decode_attention(q, kc, kc, 8)
        top2gap(s)
    torch.cuda.synchronize()
    assert all(f.launches == n + 1 for f, n in before.items())


def test_mamba_scan_gradient_flows_on_the_card(cuda):
    """Under grad the scan goes through its autograd Function: one forward
    launch, and backward() launches mamba_scan_bwd once; every input's
    gradient (dt, a, B, C, D, x, h0) within 1e-5 of its largest entry in
    the plain recurrence. Under no_grad the forward launches alone and its
    output has no grad_fn."""
    b, s, di, n = 2, 45, 96, 16
    f = lambda seed, shape, scale=1.0: torch.from_numpy(  # noqa: E731
        _rand(seed, shape, scale)).to(cuda)
    ins = [torch.nn.functional.softplus(f(1, (b, s, di), 0.5) - 3.0),
           -torch.exp(f(2, (di, n), 0.5)), f(3, (b, s, n)), f(4, (b, s, n)),
           f(5, (di,)), f(6, (b, s, di)), f(7, (b, di, n))]
    leaves = [t.clone().requires_grad_(True) for t in ins]
    dy, dh = f(8, (b, s, di)), f(9, (b, di, n))
    f0, b0 = mamba_scan.launches, mamba_scan_bwd.launches
    y, h = mamba_scan(*leaves)
    assert y.grad_fn is not None and mamba_scan.launches == f0 + 1
    ((y * dy).sum() + (h * dh).sum()).backward()
    torch.cuda.synchronize()
    assert mamba_scan_bwd.launches == b0 + 1
    refs = tref.mamba_scan_bwd_ref(*ins, dy, dh)
    for t, r in zip(leaves, refs):
        torch.testing.assert_close(t.grad, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()))
    with torch.no_grad():
        assert mamba_scan(*leaves)[0].grad_fn is None
    assert mamba_scan_bwd.launches == b0 + 1


def _scan_bwd_case(cuda, b, s, di, n, x_dtype, with_h0, with_dh, seed=0):
    f = lambda k, shape, scale=1.0: torch.from_numpy(  # noqa: E731
        _rand(seed + k, shape, scale)).to(cuda)
    return (torch.nn.functional.softplus(f(1, (b, s, di), 0.5) - 3.0),
            -torch.exp(f(2, (di, n), 0.5)), f(3, (b, s, n)), f(4, (b, s, n)),
            f(5, (di,)), f(6, (b, s, di)).to(x_dtype),
            f(7, (b, di, n)) if with_h0 else None, f(8, (b, s, di)),
            f(9, (b, di, n)) if with_dh else None)


def _held_scan_bwd(got, ins, x_dtype):
    """Every gradient within 1e-5 of its largest entry in the f32 plain
    recurrence (on the same bf16-valued x), a bf16 dx also within 2^-8 of
    its value (the kernel's f32 dx rounded once)."""
    want = tref.mamba_scan_bwd_ref(*ins[:5], ins[5].float(), *ins[6:])
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        tol = 1e-5 * float(w.abs().max()) + 1e-30
        if i == 5:
            assert g.dtype == x_dtype
            if x_dtype == torch.bfloat16:
                tol = tol + 2.0 ** -8 * w.abs()
        assert bool(((g.float() - w).abs() <= tol).all()), i


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("b,s,di", [(1, 1, 64), (2, 31, 33), (1, 32, 96),
                                    (2, 33, 70), (1, 200, 512),
                                    (2, 77, 1000), (4, 512, 256)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_bwd_kernel_matches_plain(cuda, n, b, s, di, x_dtype,
                                             with_h0):
    """The backward kernel against the plain reverse recurrence at every
    N: S of one step, one short of, at and one past the kernel's 32-step
    chunks, a tail chunk of 13 and 16 whole chunks; Di one past and short
    of a block's 32 channels and a tail of 8; x in f32 and bf16; with and
    without h0 (and dh_last with it): one launch each."""
    ins = _scan_bwd_case(cuda, b, s, di, n, x_dtype, with_h0, with_h0)
    before = mamba_scan_bwd.launches
    got = mamba_scan_bwd(*ins)
    torch.cuda.synchronize()
    assert mamba_scan_bwd.launches == before + 1
    _held_scan_bwd(got, ins, x_dtype)


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("b,s,di", [(1, 1, 64), (2, 31, 33), (1, 32, 96),
                                    (2, 33, 70), (1, 200, 512),
                                    (2, 77, 1000), (4, 512, 256)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_bwd_kernel_from_the_forward_states(cuda, n, b, s, di,
                                                       x_dtype, with_h0):
    """The backward fed the forward kernel's chunk states, at every case
    of the test above: one launch of each, within the same limits, and the
    same bits as the backward that launches the forward for them."""
    ins = _scan_bwd_case(cuda, b, s, di, n, x_dtype, with_h0, with_h0)
    f0, b0 = mamba_scan.launches, mamba_scan_bwd.launches
    states = mamba_scan(*ins[:7], return_states=True)[2]
    got = mamba_scan_bwd(*ins, states=states)
    torch.cuda.synchronize()
    assert (mamba_scan.launches, mamba_scan_bwd.launches) == (f0 + 1, b0 + 1)
    _held_scan_bwd(got, ins, x_dtype)
    for g, w in zip(got, mamba_scan_bwd(*ins)):
        assert (g is None and w is None) or torch.equal(g, w)
    assert mamba_scan.launches == f0 + 2


def test_mamba_scan_bwd_kernel_is_deterministic(cuda):
    """Two calls on the same inputs give the same bits (no atomics: the
    partial sums over channels, batch and steps add in a fixed order)."""
    ins = _scan_bwd_case(cuda, 4, 300, 2048, 16, torch.bfloat16, True, True)
    one, two = mamba_scan_bwd(*ins), mamba_scan_bwd(*ins)
    for a, b in zip(one, two):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a.view(torch.int32),
                           b.view(torch.int16) if b.dtype == torch.bfloat16
                           else b.view(torch.int32))


def test_mamba_scan_bwd_kernel_reads_strided_operands(cuda):
    """B and C as column slices of one projection, dt and x as views at
    odd offsets and step strides, dy transposed from another layout: the
    kernel reads them by strides (dy is made contiguous when its last axis
    is not)."""
    b, s, di, n, r = 2, 70, 96, 16, 8
    f = lambda seed, shape: torch.from_numpy(  # noqa: E731
        _rand(seed, shape)).to(cuda)
    dbc = f(1, (b, s, r + 2 * n))
    dt = f(2, (b, s, di + 3)).abs().mul_(0.05)[..., 1:di + 1]
    x = f(3, (b, s, di + 5))[..., 3:di + 3]
    a = -torch.exp(f(4, (di, n)) * 0.5)
    d = f(5, (di,))
    dy = f(6, (b, di, s)).transpose(1, 2)
    bm, cm = dbc[..., r:r + n], dbc[..., r + n:]
    got = mamba_scan_bwd(dt, a, bm, cm, d, x, None, dy)
    _held_scan_bwd(got, (dt, a, bm, cm, d, x, None, dy.contiguous(), None),
                   torch.float32)


def test_mamba_scan_bwd_kernel_rejects_what_it_does_not_take(cuda):
    ins = list(_scan_bwd_case(cuda, 1, 8, 32, 16, torch.float32, True,
                              True))
    before = mamba_scan_bwd.launches
    with pytest.raises(ValueError):                  # dy's shape
        mamba_scan_bwd(*ins[:7], ins[7][:, :4], ins[8])
    with pytest.raises(TypeError):                   # dy must be f32
        mamba_scan_bwd(*ins[:7], ins[7].bfloat16(), ins[8])
    with pytest.raises(ValueError):                  # dh_last's shape
        mamba_scan_bwd(*ins[:8], ins[8][:, :16])
    with pytest.raises(ValueError):                  # d_state 32
        mamba_scan_bwd(ins[0], torch.zeros(32, 32, device=cuda),
                       torch.zeros(1, 8, 32, device=cuda),
                       torch.zeros(1, 8, 32, device=cuda), *ins[4:6], None,
                       ins[7])
    with pytest.raises(TypeError):                   # x f32 or bf16
        mamba_scan_bwd(*ins[:5], ins[5].half(), *ins[6:])
    assert mamba_scan_bwd.launches == before
    # the forward's chunk states: shape (B, ceil(S / 32), Di, N), f32,
    # contiguous, on x's device
    states = mamba_scan(*ins[:7], return_states=True)[2]
    f0 = mamba_scan.launches
    for bad in (states[:, :, :16], torch.zeros(1, 2, 32, 16, device=cuda),
                states.double(), states.bfloat16(), states.cpu(),
                torch.zeros(1, 1, 16, 32, device=cuda).transpose(2, 3)):
        with pytest.raises(ValueError):
            mamba_scan_bwd(*ins, states=bad)
    assert (mamba_scan.launches, mamba_scan_bwd.launches) == (f0, before)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "qwen2-moe-a2.7b",
                                  "jamba-v0.1-52b"])
def test_launcher_smoke_resume_on_card(cuda, arch, tmp_path, capsys,
                                       monkeypatch):
    """``launch.train --smoke`` on the card for the SSM, MoE and hybrid
    models: 6 steps with a checkpoint at 3, against 3 steps and then
    ``--resume`` to 6, under deterministic algorithms: the step-6
    checkpoints are equal leaf for leaf, bit for bit, and the scan and
    flash backward kernels ran."""
    import repro_torch.launch.train as train_cli
    from repro_torch.kernels import launch_counts, reset_launch_counts
    common = ["--arch", arch, "--smoke", "--batch", "2", "--seq", "32",
              "--device", "cuda", "--ckpt-every", "3", "--log-every", "3"]
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        reset_launch_counts()
        train_cli.main(common + ["--steps", "6", "--ckpt-dir",
                                 str(tmp_path / "a")])
        counts = launch_counts()
        train_cli.main(common + ["--steps", "3", "--ckpt-dir",
                                 str(tmp_path / "b")])
        train_cli.main(common + ["--steps", "6", "--ckpt-dir",
                                 str(tmp_path / "b"), "--resume"])
    finally:
        torch.use_deterministic_algorithms(False)
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "device" in out
    cfg = get_smoke_config(arch)
    ssm = sum(s.mixer == "ssm" for s in TM.block_pattern(cfg)) \
        * TM.num_reps(cfg)
    assert counts["mamba_scan_bwd"] == 6 * ssm
    assert counts["flash_attention_bwd"] == 6 * (cfg.num_layers - ssm)
    a = np.load(tmp_path / "a" / "step_000000006" / "arrays.npz")
    b = np.load(tmp_path / "b" / "step_000000006" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 10
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmo-1b", "h2o-danube-1.8b",
                                  "internvl2-1b", "seamless-m4t-large-v2",
                                  "falcon-mamba-7b", "qwen2-moe-a2.7b",
                                  "jamba-v0.1-52b"])
@pytest.mark.parametrize("remat", [False, True])
def test_smoke_train_step_on_card_matches_cpu(cuda, arch, remat):
    """One train step at smoke size in f32: the loss and every gradient
    on the card (the flash kernels forward and backward) within 1e-4 of
    each leaf's largest CPU entry, and the parameters after AdamW within
    what the gradients' difference moves them; flash launches = attention
    layers x (1 + remat), backward launches = attention layers, and the
    same for the scan over the Mamba layers (SSM and hybrid models)."""
    from repro_torch import tree as tree_lib
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.training import AdamWConfig, adamw_update, \
        init_opt_state
    cfg = get_smoke_config(arch)
    p_cpu = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 40))
             .astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 40))
             .astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["source_frames"] = _rand(6, (2, 70, cfg.frontend.frontend_dim))
    if cfg.frontend.kind == "vision":
        batch["prefix_embeddings"] = _rand(
            7, (2, cfg.frontend.num_prefix_embeddings,
                cfg.frontend.frontend_dim))
    # self attention (enc-dec: + the encoder's and cross), and Mamba
    ssm = sum(s.mixer == "ssm" for s in TM.block_pattern(cfg)) \
        * TM.num_reps(cfg)
    layers = cfg.num_layers - ssm
    if cfg.is_encoder_decoder:
        layers = cfg.encdec.num_encoder_layers + 2 * cfg.num_layers
    out = []
    for p in (p_cpu, _to(p_cpu, cuda)):
        leaves = tree_lib.leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        reset_launch_counts()
        loss, _ = TM.train_loss(p, cfg, batch, remat=remat)
        loss.backward()
        counts = launch_counts()
        grads = [t.grad for t in leaves]
        adamw_update(p, grads, init_opt_state(p),
                     AdamWConfig(learning_rate=1e-3, eps=1e-3))
        out.append((float(loss.detach()), [g.cpu() for g in grads],
                    [t.detach().cpu() for t in leaves], counts))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-5)
    for g, r in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4 * float(
            r.abs().max()) + 1e-12)
    # eps 1e-3 keeps the update smooth: a weight moves by at most lr/eps
    # per unit of gradient difference
    for a, r, g, rg in zip(out[1][2], out[0][2], out[1][1], out[0][1]):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-3 * (
            1e-3 + float((g - rg).abs().max()) / 1e-3) + 1e-6)
    assert out[0][3]["flash_attention"] == 0
    assert out[1][3]["flash_attention"] == layers * (2 if remat else 1)
    assert out[1][3]["flash_attention_bwd"] == layers
    assert out[0][3]["mamba_scan"] == 0
    assert out[1][3]["mamba_scan"] == ssm * (2 if remat else 1)
    assert out[1][3]["mamba_scan_bwd"] == ssm


# ---------------------------------------------------------------------------
# the distributed layer's kernel forms: the decode kernel's log-sum-exp,
# the sharded flash-decode's combine, flash with q_offset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,kv,d,dtype", [(14, 2, 64, torch.bfloat16),
                                          (64, 8, 128, torch.bfloat16),
                                          (32, 8, 80, torch.float32)])
def test_decode_attention_kernel_lse_form(cuda, h, kv, d, dtype):
    """The LSE form's output bit-equal to a call without it; the LSE
    within 1e-5 of the plain version's (f32, -inf exactly on a row with
    no valid key, whose output is 0)."""
    b, c = 6, 300
    q, k, v = (torch.from_numpy(_rand(90 + i, s)).to(cuda, dtype)
               for i, s in enumerate(((b, h, d), (b, c, kv, d),
                                      (b, c, kv, d))))
    vl = torch.tensor([0, 1, 64, 65, 299, 300], dtype=torch.int32,
                      device=cuda)
    out, lse = decode_attention(q, k, v, vl, return_lse=True)
    plain = decode_attention(q, k, v, vl)
    _, rlse = tref.decode_attention_ref(q.float(), k.float(), v.float(), vl,
                                        return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    assert bool((out[0] == 0).all())
    assert torch.equal(torch.isneginf(lse), torch.isneginf(rlse))
    fin = ~torch.isneginf(rlse)
    torch.testing.assert_close(lse[fin], rlse[fin], atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_flash_decode_shards_combine_on_the_card(cuda, n):
    """n cache shards through ``_flash_decode_shard`` in turn, merged by
    ``_combine_partials``: within 1e-5 of the unsplit f32 kernel."""
    from repro_torch.models import attention as TA
    b, h, kv, d, c = 4, 14, 2, 64, 256
    q = torch.from_numpy(_rand(95, (b, h, d))).to(cuda)
    kn, vn = (torch.from_numpy(_rand(96 + i, (b, kv, d))).to(cuda)
              for i in range(2))
    kc, vc = (torch.from_numpy(_rand(98 + i, (b, c, kv, d))).to(cuda)
              for i in range(2))
    ci = torch.tensor([0, 31, 200, 255], device=cuda)
    rows = torch.arange(b, device=cuda)
    k1, v1 = kc.clone(), vc.clone()
    k1[rows, ci], v1[rows, ci] = kn, vn
    want = decode_attention(q, k1, v1, (ci + 1).to(torch.int32))
    chunk = c // n
    parts = [TA._flash_decode_shard(q, kn, vn,
                                    kc[:, r * chunk:(r + 1) * chunk],
                                    vc[:, r * chunk:(r + 1) * chunk], ci,
                                    r * chunk) for r in range(n)]
    got = TA._combine_partials(torch.stack([p[0] for p in parts]),
                               torch.stack([p[1] for p in parts]),
                               lambda t: t.amax(0), lambda t: t.sum(0))
    torch.cuda.synchronize()
    assert torch.equal(kc, k1) and torch.equal(vc, v1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype,d,window", [(torch.bfloat16, 64, 0),
                                            (torch.bfloat16, 128, 0),
                                            (torch.float32, 64, 100),
                                            (torch.bfloat16, 80, 100)])
def test_flash_attention_q_offset_chunks_equal_slices(cuda, dtype, d,
                                                      window):
    """4 query chunks of 64 at their offsets, over the keys up to each
    chunk's end: outputs and dq bit-equal to the unchunked kernels'
    slices; the chunks' dk and dv sum to the unchunked ones within the
    dtype's rounding."""
    b, s, h, kv = 2, 256, 8, 2
    q, k, v, do = (torch.from_numpy(_rand(60 + i, sh)).to(cuda, dtype)
                   for i, sh in enumerate(((b, s, h, d), (b, s, kv, d),
                                           (b, s, kv, d), (b, s, h, d))))
    whole, lse = flash_attention(q, k, v, window=window, return_lse=True)
    dq_w, dk_w, dv_w = flash_attention_bwd(q, k, v, whole, do,
                                           window=window, lse=lse)
    dk, dv = torch.zeros_like(k, dtype=torch.float32), \
        torch.zeros_like(v, dtype=torch.float32)
    c = s // 4
    for r in range(4):
        end = (r + 1) * c
        qc, doc = q[:, r * c:end].contiguous(), do[:, r * c:end].contiguous()
        part, lse = flash_attention(qc, k[:, :end], v[:, :end],
                                    window=window, q_offset=r * c,
                                    return_lse=True)
        gq, gk, gv = flash_attention_bwd(qc, k[:, :end], v[:, :end], part,
                                         doc, window=window, q_offset=r * c,
                                         lse=lse)
        torch.cuda.synchronize()
        assert torch.equal(part, whole[:, r * c:end])
        assert torch.equal(gq, dq_w[:, r * c:end])
        dk[:, :end] += gk.float()
        dv[:, :end] += gv.float()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for got, want in ((dk, dk_w), (dv, dv_w)):
        scale = float(want.float().abs().max())
        assert float((got - want.float()).abs().max()) <= tol * scale
