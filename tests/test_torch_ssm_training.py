"""Training the SSM path: the selective scan's gradient, on the CPU.

The port's scan backward is the plain reverse recurrence
``ref.mamba_scan_bwd_ref``, the math the CUDA backward
(``csrc/mamba_scan_bwd.cu``) runs. It has no Pallas counterpart: the JAX
model differentiates its jnp ``selective_scan`` (a chunked associative scan
inside ``lax.scan``) with XLA. So the recurrence is held against
``jax.vjp`` of ``repro.models.mamba.selective_scan`` with respect to dt,
a_log (through ``a = -exp(a_log)``), B, C, D, x and h0, over N 4, 8 and 16,
S 1, 37 and 130 (the JAX chunk 64: one short chunk, and three with a padded
tail), a zero and a random initial state (the random one with a random
dh_last cotangent), and x in f32 and bf16; and against autograd through
``ref.mamba_scan_ref`` in float64. The model's gradients run through the
``mamba_scan`` wrapper, which differentiates on both devices, on a smoke
falcon-mamba block against ``jax.grad`` of the JAX mixer.

Tolerances: 1e-5 of each gradient's largest entry in f32 (the JAX scan
sums in another order and runs the recurrence as an associative scan); a
bf16 x's dx also within the bf16 roundings of JAX's (JAX rounds dx's two
cotangents to bf16 apart and adds them in bf16, the recurrence rounds their
f32 sum once: 2^-8 of each part and twice 2^-8 of the sum); 1e-10 in float64 (the same recurrence, differentiated by autograd); the
mixer's gradients within 1e-5 of each leaf's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import mamba as JMB
from repro.models import model as JM
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ref as tref
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_bwd
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TM
from repro_torch import tree as tree_lib

torch.set_num_threads(1)

ARCH = "falcon-mamba-7b"
GRADS = ("ddt", "da_log", "db", "dc", "dd", "dx", "dh0")
JAX_CHUNK = 64
F32_REL = 1e-5


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _inputs(b, s, di, n, seed, random_h0):
    """dt around 0.05 (as softplus(dt_proj) makes it), a_log in [0, 1.1)
    as the init draws it, unit-scale B, C, D, x; a zero or random h0; dy
    and, with a random h0, a random dh_last."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)) * 0.5 - 3.0))
    a_log = rng.uniform(0.0, 1.1, (di, n))
    bm, cm = rng.standard_normal((b, s, n)), rng.standard_normal((b, s, n))
    d, x = rng.standard_normal(di), rng.standard_normal((b, s, di))
    h0 = (rng.standard_normal((b, di, n)) if random_h0
          else np.zeros((b, di, n)))
    dy = rng.standard_normal((b, s, di))
    dh = rng.standard_normal((b, di, n)) if random_h0 else None
    f32 = lambda a: None if a is None else a.astype(np.float32)  # noqa: E731
    return tuple(map(f32, (dt, a_log, bm, cm, d, x, h0, dy, dh)))


def _jax_vjp(dt, a_log, bm, cm, d, x, h0, dy, dh, x_dtype):
    """jax.vjp of the JAX selective_scan at chunk JAX_CHUNK: the seven
    cotangents, dx in x's dtype."""
    xj = jnp.asarray(x).astype(x_dtype)
    (y, h_last), vjp = jax.vjp(
        lambda *a: JMB.selective_scan(*a, chunk=JAX_CHUNK),
        *map(jnp.asarray, (dt, a_log, bm, cm, d)), xj, jnp.asarray(h0))
    cot_h = jnp.zeros_like(h_last) if dh is None else jnp.asarray(dh)
    return [np.asarray(g.astype(jnp.float32)) if g.dtype == jnp.bfloat16
            else np.asarray(g) for g in vjp((jnp.asarray(dy), cot_h))]


def _port_grads(dt, a_log, bm, cm, d, x, h0, dy, dh, x_dtype, zero_h0):
    """The reverse recurrence's gradients, da carried to a_log through
    a = -exp(a_log) (d a_log = da * a)."""
    t = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    a = -torch.exp(t(a_log))
    xt = t(x).to(x_dtype)
    out = tref.mamba_scan_bwd_ref(t(dt), a, t(bm), t(cm), t(d), xt,
                                  None if zero_h0 else t(h0), t(dy), t(dh))
    ddt, da, db, dc, dd, dx, dh0 = out
    return [ddt, da * a, db, dc, dd, dx, dh0]


def _held(got, want, what):
    for name, g, w in zip(GRADS, got, want):
        if g is None:
            continue
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        tol = F32_REL * float(np.abs(w).max()) + 1e-30
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("random_h0", [False, True])
@pytest.mark.parametrize("s", [1, 37, 130])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_scan_bwd_ref_matches_jax_vjp(n, s, random_h0, x_dtype):
    """The seven gradients against jax.vjp of the JAX selective_scan, each
    within 1e-5 of its largest entry. A bf16 x enters both as its bf16
    value: the f32 cotangents of both are held so, and JAX's bf16 dx to
    the recurrence's bf16 dx within their roundings; a zero h0 goes to the
    recurrence as None (no dh0), the rest equal bit for bit to the
    recurrence from an explicit zero state."""
    b, di = 2, 24
    ins = _inputs(b, s, di, n, seed=100 * n + s, random_h0=random_h0)
    dt, a_log, bm, cm, d, x, h0, dy, dh = ins
    if x_dtype == "bfloat16":   # both sides read the same bf16 values
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                       .astype(jnp.float32))
    want = _jax_vjp(dt, a_log, bm, cm, d, x, h0, dy, dh, "float32")
    got = _port_grads(dt, a_log, bm, cm, d, x, h0, dy, dh, torch.float32,
                      not random_h0)
    _held(got, want, f"N={n} S={s}")
    if not random_h0:
        assert got[6] is None
        explicit = _port_grads(dt, a_log, bm, cm, d, x, h0, dy, dh,
                               torch.float32, False)
        for g, e in zip(got[:6], explicit[:6]):
            assert torch.equal(g, e)
        _held(explicit, want, f"N={n} S={s} explicit zero h0")
    if x_dtype == "bfloat16":
        want_bf = _jax_vjp(dt, a_log, bm, cm, d, x, h0, dy, dh, "bfloat16")
        got_bf = _port_grads(dt, a_log, bm, cm, d, x, h0, dy, dh,
                             torch.bfloat16, not random_h0)
        assert got_bf[5].dtype == torch.bfloat16
        # the bf16 dx is the f32 one rounded once
        assert torch.equal(got_bf[5], got[5].to(torch.bfloat16))
        _held(got_bf[:5], want_bf[:5], f"N={n} S={s} bf16 x")
        # JAX rounds x's two cotangents (the scan's dt sum_n g B and the
        # skip's D dy) to bf16 each and adds them in bf16; the recurrence
        # rounds their f32 sum once
        w = want_bf[5]
        skip = d * dy
        scan = got[5].numpy() - skip
        np.testing.assert_array_less(
            np.abs(got_bf[5].float().numpy() - w),
            2.0 ** -8 * (np.abs(scan) + np.abs(skip) + 2 * np.abs(w))
            + F32_REL * float(np.abs(w).max()) + 1e-30)


@pytest.mark.parametrize("random_h0", [False, True])
@pytest.mark.parametrize("s", [33, 77, 95])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_scan_bwd_ref_from_the_forward_states(n, s, random_h0):
    """The recurrence fed the plain forward's chunk states (tail chunks of
    1, 13 and 31 steps), as the backward kernel is fed the forward
    kernel's: the same bits as without them, through ``mamba_scan_bwd``
    on CPU tensors too, and so within 1e-5 of each gradient's largest
    entry of jax.vjp of the JAX selective_scan."""
    b, di = 2, 24
    dt, a_log, bm, cm, d, x, h0, dy, dh = _inputs(
        b, s, di, n, seed=300 * n + s, random_h0=random_h0)
    t = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    a = -torch.exp(t(a_log))
    th0 = t(h0) if random_h0 else None
    fwd = (t(dt), a, t(bm), t(cm), t(d), t(x))
    states = mamba_scan(*fwd, th0, return_states=True)[2]
    assert states.shape == (b, -(-s // tref.SCAN_CHUNK), di, n)
    plain = tref.mamba_scan_bwd_ref(*fwd, th0, t(dy), t(dh))
    fed = tref.mamba_scan_bwd_ref(*fwd, th0, t(dy), t(dh), states)
    wrapped = mamba_scan_bwd(*fwd, th0, t(dy), t(dh), states=states)
    for p, f, w in zip(plain, fed, wrapped):
        assert (p is None and f is None and w is None) or (
            torch.equal(p, f) and torch.equal(p, w))
    ddt, da, db, dc, dd, dx, dh0 = fed
    want = _jax_vjp(dt, a_log, bm, cm, d, x, h0, dy, dh, "float32")
    _held([ddt, da * a, db, dc, dd, dx, dh0], want, f"N={n} S={s} states")


@pytest.mark.parametrize("n", [4, 8, 16])
def test_scan_bwd_ref_matches_float64_autograd(n):
    """The recurrence against autograd through the forward plain version,
    both in float64, with h0 and dh_last."""
    b, s, di = 2, 29, 12
    ins = [torch.from_numpy(a).double()
           for a in _inputs(b, s, di, n, seed=7 * n, random_h0=True)]
    dt, a_log, bm, cm, d, x, h0, dy, dh = ins
    a = -torch.exp(a_log)
    leaves = [t.clone().requires_grad_(True) for t in (dt, a, bm, cm, d, x,
                                                       h0)]
    y, h_last = tref.mamba_scan_ref(*leaves)
    assert y.dtype == torch.float64
    want = torch.autograd.grad((y * dy).sum() + (h_last * dh).sum(), leaves)
    got = tref.mamba_scan_bwd_ref(dt, a, bm, cm, d, x, h0, dy, dh)
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float64, name
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10, msg=name)


def test_wrapper_differentiates_on_the_cpu():
    """On CPU tensors ``mamba_scan`` is the plain version under autograd
    and ``mamba_scan_bwd`` the reverse recurrence: the two agree, and
    neither counts a launch."""
    ins = [torch.from_numpy(a)
           for a in _inputs(1, 19, 16, 8, seed=3, random_h0=True)]
    dt, a_log, bm, cm, d, x, h0, dy, dh = ins
    a = -torch.exp(a_log)
    leaves = [t.clone().requires_grad_(True) for t in (dt, a, bm, cm, d, x,
                                                       h0)]
    before = (mamba_scan.launches, mamba_scan_bwd.launches)
    y, h_last = mamba_scan(*leaves)
    auto = torch.autograd.grad((y * dy).sum() + (h_last * dh).sum(), leaves)
    got = mamba_scan_bwd(dt, a, bm, cm, d, x, h0, dy, dh)
    assert (mamba_scan.launches, mamba_scan_bwd.launches) == before
    for name, g, w in zip(GRADS, got, auto):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(
            w.abs().max()), msg=name)


# ---------------------------------------------------------------------------
# the mixer's gradients on a smoke falcon-mamba block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_layer():
    """Rep 0 of the smoke falcon-mamba's first mixer in f32, as numpy."""
    jcfg = jax_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    layer = {k: v[0] for k, v in tree["blocks"][0]["mamba"].items()}
    layer["conv_b"] = _rand(4, layer["conv_b"].shape, 0.1)
    return jcfg, get_smoke_config(ARCH), layer


def test_mamba_forward_gradients_match_jax(smoke_layer):
    """d sum(w * mamba_forward(p, x)) / d (every mixer param, x): the port
    (the wrapper's plain version under autograd) against jax.grad of the
    JAX mixer, which differentiates its chunked associative scan. A_log's
    reaches it through a = -exp(A_log), dt_proj's through softplus, B's
    and C's through x_proj's slices."""
    jcfg, tcfg, layer = smoke_layer
    x = _rand(11, (2, 23, tcfg.d_model))
    w = _rand(12, (2, 23, tcfg.d_model))

    def jloss(p, xx):
        return jnp.sum(JMB.mamba_forward(p, jcfg, xx) * jnp.asarray(w))

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, layer), jnp.asarray(x))
    p = params_from_numpy(layer, device="cpu")
    for t in p.values():
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (TMB.mamba_forward(p, tcfg, xt) * torch.from_numpy(w)).sum().backward()
    for name, g in list(jg_p.items()) + [("x", jg_x)]:
        got = (xt if name == "x" else p[name]).grad
        assert got is not None, name
        want = np.asarray(g)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=F32_REL * float(np.abs(want).max()) + 1e-30,
            err_msg=name)


# ---------------------------------------------------------------------------
# depth cuts of the trained configurations
# ---------------------------------------------------------------------------

def test_depth_cut_inside_one_block_period():
    """jamba-v0.1 cut to its first 3 layers (what trains on one card) is
    the period's first 3 positions, one rep deep: Mamba + dense FFN, Mamba
    + MoE, Mamba + dense FFN, no attention; the full-width parameter count
    is the 4.02 B the training row states. At smoke width such a cut
    trains: a finite loss and a gradient for every leaf."""
    full = get_config("jamba-v0.1-52b")
    cut = full.scaled(num_layers=3)
    assert TM.block_pattern(cut) == TM.block_pattern(full)[:3]
    assert TM.num_reps(cut) == 1
    assert [(s.mixer, s.ffn) for s in TM.block_pattern(cut)] == [
        ("ssm", "dense"), ("ssm", "moe"), ("ssm", "dense")]
    assert round(cut.param_count() / 1e9, 2) == 4.02
    with pytest.raises(ValueError, match="block period"):
        TM.block_pattern(full.scaled(num_layers=12))
    smoke = get_smoke_config("jamba-v0.1-52b")
    cfg = smoke.scaled(num_layers=3)
    params = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    leaves = tree_lib.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16))
             .astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 16))
             .astype(np.int32)}
    loss, _ = TM.train_loss(params, cfg, batch, remat=True)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in leaves)


@pytest.mark.parametrize("arch,layers,billions", [
    ("falcon-mamba-7b", 40, 4.74), ("qwen2-moe-a2.7b", 6, 4.05),
    ("jamba-v0.1-52b", 3, 4.02)])
def test_training_cuts_fit_the_card(arch, layers, billions):
    """Each training row's depth cut at full width: its parameter count,
    and 12 B a parameter (bf16 params and grads, f32 m and v) under 60 GB
    of the card's 80, leaving room for activations and the optimizer's
    sliced temporaries."""
    cut = get_config(arch).scaled(num_layers=layers)
    assert round(cut.param_count() / 1e9, 2) == billions
    assert 12 * cut.param_count() < 60e9
