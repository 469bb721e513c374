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
limit); the
smoke-size models within 1e-4 of their CPU runs in f32; the tiny
classifier's scores within 1e-4 of its CPU run in f32, and the certainties
``EngineBackend.execute`` reduces on the card bit-equal to the CPU's for
the same scores.
"""
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
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.top2gap import top2gap
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
                                 (4096, 32)])
def test_decode_attention_kernel_cluster_slices(cuda, code, g, c, d):
    """The cluster's 8 slices of a row: valid_len at the slice and tile
    edges (1, 63, 64, 65, 511, 512; at C 4096 also 4095 and 4096, several
    tiles per block), rows with valid_len 1 beside full rows in one call,
    every group size G 1-8 and the three dtype codes, over the layer view
    of a rep-stacked pool."""
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


@pytest.mark.parametrize("d", [32, 64, 128])
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


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("g,b", [(1, 1), (2, 8), (7, 8)])
@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("s", [1, 17, 64, 65, 100, 256, 512])
def test_flash_attention_bf16_kernel_sweep(cuda, d, g, b, mode, s):
    """The bf16 wgmma kernel against the f32 plain version: S below, at,
    across and past the 64-row tiles, causal, windowed (7 and 100) and
    full, group sizes 1, 2 and 7, B 1 and 8, hd 32, 64 and 128."""
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


@pytest.mark.parametrize("d,window", [(64, 0), (128, 0), (64, 100),
                                      (32, 7)])
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
