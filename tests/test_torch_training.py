"""The port's training path against the JAX package's, on the CPU.

Params and AdamW state come from the JAX package (``init_params`` /
``init_opt_state``) and are carried across by ``repro_torch.convert``;
batches are numpy arrays from seeded generators (or the shared
``SyntheticDataset``) handed to both packages. On the CPU every kernel
wrapper runs its plain version, and autograd differentiates it, so every
arch id is covered here, MoE and SSM included.

* AdamW: ``tests/test_training.py``'s manual reference, no decay on norms,
  clipping, the schedule; and one update of a mixed bf16/f32 tree against
  the JAX ``adamw_update``, decay and clipping on.
* ``cross_entropy_loss`` against JAX, with ``ignore_id`` labels.
* ``SyntheticDataset`` bit-equal to the JAX package's, for plain,
  vision-prefix and encoder-decoder archs; the shape cells.
* One train step over all ten arch ids in f32 (``test_models_smoke``'s
  train half): the loss, every gradient leaf and every parameter delta
  against JAX's, with remat off, on ("full") and "dots".
* Microbatch equivalence on olmo-1b smoke in f32, and against JAX's
  microbatched step; the loss falling on qwen2-0.5b smoke; the "dots"
  policy keeping the matmul outputs; ``compress_pod_grads`` without a
  mesh the plain step; the
  launcher's checkpoint resume continuing the uninterrupted run bit for
  bit.

Tolerances: the schedule and AdamW on equal inputs within rtol 1e-6
(float32, the same operations); the loss within rtol 1e-5. Gradients: both
packages round the logits to bf16 and, in the backward pass, the logits'
gradient too; the two f32 softmaxes differ by an ulp, so a few of those
bf16 roundings may land a step apart; each gradient leaf is held within
GRAD_RTOL (1e-4) of the leaf's largest JAX entry. A parameter delta after
one AdamW step is lr * (g / (|g| + eps) + decay), g clipped: each is
held within what the two gradients' difference moves it, lr eps |g_t -
g_j| / (m + eps)^2 (m the smaller |g|, 0 where the signs differ), plus
lr * 1e-5 and two float32 steps of the weight for rounding. MoE cases
keep the 1e-4 router-gap guard of ``tests/test_torch_moe.py``: they fail,
not skip, on a near-tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import cell_is_applicable as j_applicable
from repro.configs.shapes import skip_reason as j_skip_reason
from repro.configs.shapes import source_len as j_source_len
from repro.configs.shapes import text_len as j_text_len
from repro.models import common as JC
from repro.models import model as JM
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import SyntheticDataset as JSyntheticDataset
from repro.training import TrainStepConfig as JTrainStepConfig
from repro.training import adamw_update as j_adamw_update
from repro.training import init_opt_state as j_init_opt_state
from repro.training import make_train_step as j_make_train_step
from repro.training.data import dataset_for_cell as j_dataset_for_cell
from repro.training.optimizer import lr_schedule as j_lr_schedule
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.shapes import (SHAPES, cell_is_applicable,
                                        skip_reason, source_len, text_len)
from repro_torch.convert import (opt_state_from_numpy, params_from_numpy,
                                 to_numpy)
from repro_torch.models import common as TC
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.training import (AdamWConfig, SyntheticDataset,
                                  TrainStepConfig, adamw_update,
                                  init_opt_state, make_train_step)
from repro_torch.training.data import dataset_for_cell
from repro_torch.training.optimizer import lr_schedule

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)

GRAD_RTOL = 1e-4
ROUTER_NEAR = 1e-4
# the one-step batches: at this seed every token of the three MoE smoke
# models routes at least 2.6e-4 clear of a near-tie (seeds 11, 13 and 17
# come within 4e-5), which the router guard below holds
BATCH_SEED = 22
LR = 1e-3
OPT = dict(learning_rate=LR, warmup_steps=0, decay_steps=100)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _batch(cfg, seed, b=2, s=24):
    """tokens, labels and the arch's extra input, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
             .astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s))
             .astype(np.int32)}
    if cfg.frontend.kind == "vision":
        batch["prefix_embeddings"] = rng.standard_normal(
            (b, cfg.frontend.num_prefix_embeddings,
             cfg.frontend.frontend_dim)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["source_frames"] = rng.standard_normal(
            (b, 16, cfg.frontend.frontend_dim or cfg.d_model)) \
            .astype(np.float32)
    return batch


def _router_gaps(monkeypatch):
    """The smallest gap, per routing call of the port, between the k-th
    and (k+1)-th router logit among the real experts."""
    gaps = []
    route = TMOE._route

    def recording(p, m, x2d):
        with torch.no_grad():
            logits = x2d.float() @ p["router"]
            top = torch.topk(logits[:, :m.num_experts], m.top_k + 1,
                             dim=-1).values
            gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return route(p, m, x2d)
    monkeypatch.setattr(TMOE, "_route", recording)
    return gaps


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------

def test_adamw_matches_manual_reference():
    cfg = AdamWConfig(learning_rate=1e-2, b1=0.9, b2=0.99, eps=1e-8,
                      weight_decay=0.0, grad_clip_norm=1e9,
                      warmup_steps=0, decay_steps=10 ** 9, min_lr_ratio=1.0)
    params = {"w": torch.tensor([1.0, -2.0])}
    grads = {"w": torch.tensor([0.5, 0.1])}
    state = init_opt_state(params)
    new_p, new_s, _ = adamw_update(params, grads, state, cfg)
    m = 0.1 * np.array([0.5, 0.1])
    v = 0.01 * np.array([0.25, 0.01])
    mhat = m / (1 - 0.9)
    vhat = v / (1 - 0.99)
    expect = np.array([1.0, -2.0]) - 1e-2 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), expect, rtol=1e-5)
    assert new_p["w"] is params["w"]          # updated in place
    assert int(new_s["step"]) == 1 and new_s["step"].dtype == torch.int32


def test_weight_decay_skips_norms():
    cfg = AdamWConfig(learning_rate=1e-2, weight_decay=0.5,
                      grad_clip_norm=1e9, warmup_steps=0,
                      decay_steps=10 ** 9, min_lr_ratio=1.0)
    params = {"w": torch.ones(2), "norm": {"scale": torch.ones(2)},
              "attn": {"bq": torch.ones(2), "wq": torch.ones(2)}}
    grads = tree_lib.tree_map(torch.zeros_like, params)
    new_p, _, _ = adamw_update(params, grads, init_opt_state(params), cfg)
    assert float(new_p["w"][0]) < 1.0                 # decayed
    assert float(new_p["attn"]["wq"][0]) < 1.0
    assert float(new_p["norm"]["scale"][0]) == 1.0    # not decayed
    assert float(new_p["attn"]["bq"][0]) == 1.0


def test_grad_clipping():
    cfg = AdamWConfig(learning_rate=0.0, grad_clip_norm=1.0,
                      warmup_steps=0, decay_steps=10 ** 9)
    params = {"w": torch.zeros(3)}
    grads = {"w": torch.tensor([10.0, 0.0, 0.0])}
    _, state, metrics = adamw_update(params, grads, init_opt_state(params),
                                     cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(10.0)
    # the moments see the clipped gradient
    assert float(state["m"]["w"][0]) == pytest.approx(0.1 * 1.0)


@pytest.mark.parametrize("warmup,decay,floor", [(10, 100, 0.1), (0, 50, 0.0),
                                                (100, 10000, 0.1)])
def test_lr_schedule_matches_jax(warmup, decay, floor):
    cfg = AdamWConfig(learning_rate=1.0, warmup_steps=warmup,
                      decay_steps=decay, min_lr_ratio=floor)
    jcfg = JAdamWConfig(learning_rate=1.0, warmup_steps=warmup,
                        decay_steps=decay, min_lr_ratio=floor)
    steps = [0, 1, 5, 10, 55, 99, 100, 200, 20000]
    ours = [float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
            for s in steps]
    theirs = [float(j_lr_schedule(jcfg, jnp.asarray(s, jnp.int32)))
              for s in steps]
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-7)
    if warmup == 10:
        assert ours[2] == pytest.approx(0.5) and ours[3] == pytest.approx(1)
        assert ours[6] == pytest.approx(0.1, abs=1e-6)


def test_adamw_update_matches_jax_on_a_mixed_tree():
    """Two steps of AdamW on bf16 weights, f32 norm scales and a bias,
    decay 0.1 and a clip that binds: params, moments, norm and lr equal to
    JAX's within float32 rounding (the bf16 params bit for bit, or one
    bf16 step where the f32 results straddle a rounding boundary)."""
    rng = np.random.default_rng(0)
    tree = {"blocks": [{"attn": {"wq": rng.standard_normal((3, 8, 8)),
                                 "bq": rng.standard_normal((3, 8))},
                        "norm1": {"scale": rng.standard_normal((3, 8))}}],
            "embed": {"embedding": rng.standard_normal((16, 8))}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    jparams["blocks"][0]["attn"]["wq"] = \
        jparams["blocks"][0]["attn"]["wq"].astype(jnp.bfloat16)
    cfg = dict(learning_rate=1e-2, weight_decay=0.1, grad_clip_norm=0.5,
               warmup_steps=1, decay_steps=10)
    jstate = j_init_opt_state(jparams)
    params = params_from_numpy(_np_tree(jparams), device="cpu")
    state = opt_state_from_numpy(_np_tree(jstate), device="cpu")
    for step in range(2):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                         .astype(np.float32), tree)
        jg = jax.tree.map(jnp.asarray, g)
        jparams, jstate, jm = j_adamw_update(jparams, jg, jstate,
                                             JAdamWConfig(**cfg))
        params, state, m = adamw_update(
            params, params_from_numpy(g, device="cpu"), state,
            AdamWConfig(**cfg))
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 2
    for t, j in zip(tree_lib.leaves((params, state["m"], state["v"])),
                    jax.tree.leaves((jparams, jstate["m"], jstate["v"]))):
        assert t.dtype == (torch.bfloat16 if j.dtype == jnp.bfloat16
                           else torch.float32)
        jf = np.asarray(j, np.float32)
        step = 2.0 ** -7 * np.abs(jf) if t.dtype == torch.bfloat16 else 0
        np.testing.assert_allclose(to_numpy(t), jf, rtol=1e-5,
                                   atol=1e-7 + np.max(step))


# ---------------------------------------------------------------------------
# loss, data, shapes
# ---------------------------------------------------------------------------

def test_cross_entropy_loss_matches_jax_with_ignored_labels():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, 6] = -1
    for lab in (labels, np.full_like(labels, -1)):
        ours = TC.cross_entropy_loss(torch.from_numpy(logits),
                                     torch.from_numpy(lab))
        theirs = JC.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(lab))
        assert float(ours) == pytest.approx(float(theirs), rel=1e-6,
                                            abs=1e-7)
    # bf16 logits compute in f32, as the reference's
    lb = torch.from_numpy(logits).bfloat16()
    theirs = JC.cross_entropy_loss(jnp.asarray(logits, jnp.bfloat16),
                                   jnp.asarray(labels))
    ours = TC.cross_entropy_loss(lb, torch.from_numpy(labels))
    assert ours.dtype == torch.float32
    assert float(ours) == pytest.approx(float(theirs), rel=1e-6)


@pytest.mark.parametrize("arch,b,s", [("olmo-1b", 4, 32),
                                      ("internvl2-1b", 2, 40),
                                      ("seamless-m4t-large-v2", 3, 20),
                                      ("qwen2-0.5b", 8, 48)])
def test_synthetic_data_bit_equal_to_jax(arch, b, s):
    ours = SyntheticDataset(get_smoke_config(arch), b, s, seed=7)
    theirs = JSyntheticDataset(jax_smoke_config(arch), b, s, seed=7)
    for _ in range(3):
        x, y = ours.next_batch(), theirs.next_batch()
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
    batch = ours.next_batch()
    np.testing.assert_array_equal(batch["tokens"][:, 1:],
                                  batch["labels"][:, :-1])


def test_shape_cells_match_jax():
    assert sorted(SHAPES) == sorted(JSHAPES)
    for name, cell in SHAPES.items():
        assert vars(cell) == vars(JSHAPES[name])
    for arch in JARCH_IDS:
        cfg = get_config(arch)
        from repro.configs import get_config as jget
        jcfg = jget(arch)
        for name in SHAPES:
            assert cell_is_applicable(cfg, SHAPES[name]) == \
                j_applicable(jcfg, JSHAPES[name])
            assert skip_reason(cfg, SHAPES[name]) == \
                j_skip_reason(jcfg, JSHAPES[name])
            assert text_len(cfg, SHAPES[name]) == \
                j_text_len(jcfg, JSHAPES[name])
            assert source_len(cfg, SHAPES[name]) == \
                j_source_len(jcfg, JSHAPES[name])
    ds = dataset_for_cell(get_smoke_config("olmo-1b"), SHAPES["train_4k"],
                          seed=3, batch_override=2)
    jds = j_dataset_for_cell(jax_smoke_config("olmo-1b"), JSHAPES["train_4k"],
                             seed=3, batch_override=2)
    np.testing.assert_array_equal(ds.next_batch()["tokens"],
                                  jds.next_batch()["tokens"])


# ---------------------------------------------------------------------------
# one train step over every arch id
# ---------------------------------------------------------------------------

_JAX_STEPS = {}


def _jax_step(arch):
    """JAX params (f32), a batch, the loss, the gradients and the params
    after one AdamW step, as numpy."""
    if arch not in _JAX_STEPS:
        cfg = jax_smoke_config(arch)
        params = JM.init_params(cfg, jax.random.PRNGKey(0),
                                dtype=jnp.float32)
        batch = _batch(cfg, seed=BATCH_SEED)
        jb = _jax_batch(batch)
        (loss, _), grads = jax.value_and_grad(
            lambda p: JM.train_loss(p, cfg, jb, remat=False),
            has_aux=True)(params)
        new, _, _ = j_adamw_update(params, grads, j_init_opt_state(params),
                                   JAdamWConfig(**OPT))
        _JAX_STEPS[arch] = (_np_tree(params), batch, float(loss),
                            jax.tree.leaves(_np_tree(grads)),
                            jax.tree.leaves(_np_tree(new)))
    return _JAX_STEPS[arch]


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "dots")])
@pytest.mark.parametrize("arch", JARCH_IDS)
def test_one_train_step_matches_jax(arch, remat, policy, monkeypatch):
    params_np, batch, jloss, jgrads, jnew = _jax_step(arch)
    cfg = get_smoke_config(arch)
    gaps = _router_gaps(monkeypatch)
    params = params_from_numpy(params_np, device="cpu")
    leaves = tree_lib.leaves(params)
    before = [p.detach().clone() for p in leaves]
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = TM.train_loss(params, cfg, batch, remat=remat,
                                  remat_policy=policy)
    loss.backward()
    grads = [p.grad for p in leaves]
    assert float(loss.detach()) == pytest.approx(jloss, rel=1e-5)
    assert torch.isfinite(loss) and set(metrics) == {"ce", "aux_loss"}
    assert len(grads) == len(jgrads)
    for g, jg in zip(grads, jgrads):
        assert g is not None and tuple(g.shape) == jg.shape
        np.testing.assert_allclose(
            g.numpy(), jg, rtol=0,
            atol=GRAD_RTOL * float(np.abs(jg).max()) + 1e-12)
    adamw_update(params, grads, init_opt_state(params), AdamWConfig(**OPT))
    # the clipped gradients each package's first AdamW step reads
    clip = [min(1.0, 1.0 / (float(np.sqrt(sum(float(np.square(
        np.asarray(g, np.float64)).sum()) for g in gs))) + 1e-9))
        for gs in ([g.numpy() for g in grads], jgrads)]
    eps = AdamWConfig().eps
    for p0, p1, g, jg, j0, j1 in zip(before, leaves, grads, jgrads,
                                     tree_lib.leaves(params_np), jnew):
        delta, jdelta = (p1.detach() - p0).numpy(), j1 - j0
        gt, gj = g.numpy() * clip[0], jg * clip[1]
        # step 1 moves a weight by lr (g / (|g| + eps) + decay): at most
        # lr eps / (m + eps)^2 per unit of gradient difference, m the
        # smaller |g| (0 where the signs differ)
        m = np.where(np.sign(gt) == np.sign(gj),
                     np.minimum(np.abs(gt), np.abs(gj)), 0.0)
        bound = (LR * (eps * np.abs(gt - gj) / (m + eps) ** 2 * 1.01
                       + 1e-5)
                 + 2 * np.spacing(np.abs(j0).astype(np.float32)))
        assert np.all(np.abs(delta - jdelta) <= bound), (
            float(np.max(np.abs(delta - jdelta) - bound)))
    if cfg.moe is not None:
        assert gaps and min(gaps) > ROUTER_NEAR, (
            f"router near-tie {min(gaps)} <= {ROUTER_NEAR}")


# ---------------------------------------------------------------------------
# the train step: microbatches, the loss falling, remat policies
# ---------------------------------------------------------------------------

def test_microbatch_equivalence():
    """Grad accumulation over 2 microbatches == full batch (same update),
    and the microbatched step matches JAX's."""
    jcfg = jax_smoke_config("olmo-1b")
    cfg = get_smoke_config("olmo-1b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = SyntheticDataset(cfg, batch=8, seq_len=32, seed=0).next_batch()
    ocfg = dict(learning_rate=1e-3, warmup_steps=0, decay_steps=100)
    out = {}
    for n in (1, 2):
        params = params_from_numpy(_np_tree(jparams), device="cpu")
        step = make_train_step(cfg, AdamWConfig(**ocfg),
                               TrainStepConfig(remat=False,
                                               num_microbatches=n))
        params, opt, metrics = step(params, init_opt_state(params), batch)
        out[n] = (params, metrics)
    assert float(out[1][1]["loss"]) == pytest.approx(
        float(out[2][1]["loss"]), rel=1e-4)
    d = max(float((a - b).detach().abs().max()) for a, b in zip(
        tree_lib.leaves(out[1][0]), tree_lib.leaves(out[2][0])))
    assert d < 5e-5
    # against JAX's microbatched step: eps 1e-3 keeps g / (|g| + eps)
    # smooth where a gradient is at the level of f32 noise, so the params
    # hold the accumulation to 1e-6
    ocfg["eps"] = 1e-3
    params = params_from_numpy(_np_tree(jparams), device="cpu")
    step = make_train_step(cfg, AdamWConfig(**ocfg),
                           TrainStepConfig(remat=False, num_microbatches=2))
    out[2] = step(params, init_opt_state(params), batch)[::2]
    jstep = j_make_train_step(jcfg, JAdamWConfig(**ocfg),
                              JTrainStepConfig(remat=False,
                                               num_microbatches=2))
    jnew, _, jm = jax.jit(jstep)(jparams, j_init_opt_state(jparams),
                                 _jax_batch(batch))
    assert float(out[2][1]["loss"]) == pytest.approx(float(jm["loss"]),
                                                     rel=1e-5)
    d = max(float(np.abs(to_numpy(a) - np.asarray(b)).max()) for a, b in zip(
        tree_lib.leaves(out[2][0]), jax.tree.leaves(jnew)))
    assert d < 1e-6


def test_loss_decreases_end_to_end():
    cfg = get_smoke_config("qwen2-0.5b")
    params = TM.init_params(cfg, seed=0, device="cpu")
    dtypes = [p.dtype for p in tree_lib.leaves(params)]
    opt = init_opt_state(params)
    step = make_train_step(
        cfg, AdamWConfig(learning_rate=2e-3, warmup_steps=5,
                         decay_steps=100), TrainStepConfig(remat=True))
    ds = SyntheticDataset(cfg, batch=8, seq_len=48, seed=0)
    losses = []
    for _ in range(20):
        params, opt, m = step(params, opt, ds.next_batch())
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5
    assert int(opt["step"]) == 20
    assert [p.dtype for p in tree_lib.leaves(params)] == dtypes
    assert torch.bfloat16 in dtypes


def test_dots_policy_keeps_the_matmul_outputs():
    """Under "dots" the backward pass recomputes no plain matrix product
    of the forward; under "full" it recomputes every one the backward
    reads: all but w_down's, whose output only the residual add takes
    (the non-reentrant checkpoint stops its recomputation there)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                self.mm += 1
            return func(*args, **(kwargs or {}))

    cfg = get_smoke_config("qwen2-0.5b")
    batch = _batch(cfg, seed=2)
    counts = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        params = TM.init_params(cfg, seed=0, dtype=torch.float32,
                                device="cpu")
        leaves = tree_lib.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = TM.train_loss(params, cfg, batch, remat=remat,
                                remat_policy=policy)
        with Count() as c:
            loss.backward()
        counts[remat, policy] = c.mm
    # per layer: wq, wk, wv, wo, w_gate, w_up
    recomputed = 6 * cfg.num_layers
    assert counts[True, "full"] == counts[False, "full"] + recomputed
    assert counts[True, "dots"] == counts[False, "full"]


def test_compress_pod_grads_is_refused():
    """``compress_pod_grads`` needs a mesh with a 'pod' axis; without one
    the step is the plain one, as the reference's (the multi-rank
    exchange is held against JAX in ``tests/test_torch_distributed.py``).
    An unknown remat policy is refused."""
    cfg = get_smoke_config("qwen2-0.5b")
    batch = _batch(cfg, 0)
    out = []
    for compress in (False, True):
        params = TM.init_params(cfg, seed=0, dtype=torch.float32,
                                device="cpu")
        step = make_train_step(cfg, AdamWConfig(),
                               TrainStepConfig(compress_pod_grads=compress))
        params, _, metrics = step(params, init_opt_state(params), batch)
        out.append((float(metrics["loss"]), tree_lib.leaves(params)))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    with pytest.raises(ValueError, match="remat_policy"):
        cfg = get_smoke_config("qwen2-0.5b")
        params = TM.init_params(cfg, seed=0, dtype=torch.float32,
                                device="cpu")
        TM.train_loss(params, cfg, _batch(cfg, 0), remat=True,
                      remat_policy="most")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b",
                                  "qwen2-moe-a2.7b"])
def test_launcher_resume_continues_the_run_bit_for_bit(tmp_path, capsys,
                                                       arch):
    """``launch.train`` for 6 steps with a checkpoint at 3, against 3
    steps, then ``--resume`` to 6: the step-6 checkpoints are equal, leaf
    for leaf and bit for bit (attention, SSM and MoE smoke models)."""
    import repro_torch.launch.train as train_cli
    common = ["--arch", arch, "--smoke", "--batch", "2", "--seq",
              "16", "--device", "cpu", "--ckpt-every", "3",
              "--log-every", "3"]
    train_cli.main(common + ["--steps", "6", "--ckpt-dir",
                             str(tmp_path / "a")])
    train_cli.main(common + ["--steps", "3", "--ckpt-dir",
                             str(tmp_path / "b")])
    train_cli.main(common + ["--steps", "6", "--ckpt-dir",
                             str(tmp_path / "b"), "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and out.count("done") == 3
    a = np.load(tmp_path / "a" / "step_000000006" / "arrays.npz")
    b = np.load(tmp_path / "b" / "step_000000006" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 10
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_adamw_slices_a_large_leaf_bit_for_bit(monkeypatch):
    """A leaf of more than ``SLICE`` elements is updated one flat slice at
    a time (views, in place): the params and moments equal the whole-leaf
    update bit for bit, and the gradient norm (summed slice by slice) is
    within f32 rounding of the whole-leaf one."""
    from repro_torch.training import optimizer as opt_lib
    rng = np.random.default_rng(9)
    params = {"w": torch.from_numpy(rng.standard_normal((5, 7, 3))
                                    .astype(np.float32)).bfloat16(),
              "scale": torch.from_numpy(rng.standard_normal(11)
                                        .astype(np.float32))}
    grads = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape))
                                 .astype(np.float32)).to(v.dtype)
             for k, v in params.items()}
    cfg = AdamWConfig(learning_rate=1e-2, warmup_steps=0)
    runs = []
    for slice_ in (opt_lib.SLICE, 16):
        monkeypatch.setattr(opt_lib, "SLICE", slice_)
        p = {k: v.clone() for k, v in params.items()}
        state = init_opt_state(p)
        for _ in range(2):
            p, state, m = adamw_update(p, grads, state, cfg)
        runs.append((p, state, m))
    (p1, s1, m1), (p2, s2, m2) = runs
    for k in params:
        assert torch.equal(p1[k], p2[k])
        assert torch.equal(s1["m"][k], s2["m"][k])
        assert torch.equal(s1["v"][k], s2["v"][k])
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-6)
