"""The port's tiny classifier family, engine and EngineBackend against the
JAX package's, on the CPU.

JAX-initialised params (``repro.serving.tinymodels.init_tiny``) are carried
across with ``repro_torch.convert.tiny_params_from_numpy``; the same seeded
tokens go through both. Tolerances: scores, the loss and one SGD step's
params within 1e-5 abs / 1e-5 rel (float32, other summation orders);
certainties from the same scores bit-equal (the same two f32 values
subtracted); certainties from each package's own scores within 1e-5, and
predictions equal wherever JAX's gap exceeds 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.execution import EngineBackend as JEngineBackend
from repro.serving import tinymodels as JT
from repro.serving.engine import InferenceEngine as JInferenceEngine
from repro_torch.convert import tiny_params_from_numpy
from repro_torch.core.execution import EngineBackend as TEngineBackend
from repro_torch.serving import tinymodels as TT
from repro_torch.serving.engine import InferenceEngine as TInferenceEngine

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
FAMILY = JT.TINY_FAMILY


def _jax_params(cfg, seed):
    return JT.init_tiny(cfg, jax.random.PRNGKey(seed))


def _to_torch(jparams):
    return tiny_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  device="cpu")


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 64, size=(n, 32)).astype(np.int32)


def _engines(cfg, seed=0, buckets=(1, 2, 4, 8, 16, 32, 64, 128)):
    jp = _jax_params(cfg, seed)
    j = JInferenceEngine(cfg.name, lambda p, t, c=cfg: JT.apply_tiny(c, p, t),
                         jp, buckets=buckets)
    t = TInferenceEngine(cfg.name, lambda p, x, c=cfg: TT.apply_tiny(c, p, x),
                         _to_torch(jp), buckets=buckets)
    return j, t


@pytest.mark.parametrize("i", range(len(FAMILY)))
def test_apply_tiny_matches_jax(i):
    cfg = FAMILY[i]
    jp = _jax_params(cfg, i)
    tok = _tokens(5, seed=i)
    ref = np.asarray(JT.apply_tiny(cfg, jp, jnp.asarray(tok)))
    out = TT.apply_tiny(cfg, _to_torch(jp), torch.from_numpy(tok))
    assert out.shape == (5, cfg.n_classes) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def _jax_loss(cfg, p, tok, lab):
    logp = jax.nn.log_softmax(JT.apply_tiny(cfg, p, tok))
    return -jnp.mean(jnp.take_along_axis(logp, lab[:, None], 1))


@pytest.mark.parametrize("i", range(len(FAMILY)))
def test_one_training_step_matches_jax(i):
    """The reference's ``train_tiny`` at one step (its init from
    ``PRNGKey(seed)``, its batch from ``default_rng(seed)``) against the
    port's ``sgd_step`` from the same params and batch: the loss before
    the step and every updated param."""
    cfg, seed, batch, lr = FAMILY[i], 3 + i, 16, JT._FAMILY_LR[i]
    tok, lab, _ = JT.synthetic_classification_data(64, seed=seed)
    jp0 = _jax_params(cfg, seed)
    jp1 = JT.train_tiny(cfg, tok, lab, steps=1, batch=batch, lr=lr,
                        seed=seed)
    idx = np.random.default_rng(seed).integers(0, len(tok), batch)
    jloss = float(_jax_loss(cfg, jp0, jnp.asarray(tok[idx]),
                            jnp.asarray(lab[idx])))
    tp = TT._tree_map(_to_torch(jp0), lambda t: t.requires_grad_(True))
    mom = [torch.zeros_like(t) for t in TT._leaves(tp)]
    tloss = TT.sgd_step(cfg, tp, mom, torch.from_numpy(tok[idx]),
                        torch.from_numpy(lab[idx]), lr)
    np.testing.assert_allclose(float(tloss), jloss, **TOL)
    jl = TT._leaves(jax.tree.map(np.asarray, jp1))
    tl = [t.detach().numpy() for t in TT._leaves(tp)]
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    # the step moved the params
    assert any(not np.array_equal(a, np.asarray(b)) for a, b in
               zip(tl, TT._leaves(jax.tree.map(np.asarray, jp0))))


@pytest.mark.parametrize("n", [1, 3, 128, 129, 300])
def test_inference_engine_matches_jax(n):
    """Bucket padding (1, 3 -> 4) and the oversize split (129, 300)."""
    je, te = _engines(FAMILY[2])
    tok = _tokens(n, seed=n)
    ref = je.infer(tok)
    out = te.infer(tok)
    assert isinstance(out, torch.Tensor) and out.shape == (n, 2)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_validation_record_bit_equal_to_jax():
    cfg = FAMILY[1]
    tok, lab, _ = JT.synthetic_classification_data(256, seed=1)
    scores = np.asarray(JT.apply_tiny(cfg, _jax_params(cfg, 0),
                                      jnp.asarray(tok)))
    jrec = JT.validation_record_from_scores(scores, lab)
    trec = TT.validation_record_from_scores(scores, lab)
    assert trec.certs.dtype == np.asarray(jrec.certs).dtype
    assert np.array_equal(trec.certs, np.asarray(jrec.certs))
    assert np.array_equal(trec.correct, jrec.correct)
    assert np.array_equal(trec.preds, jrec.preds)


@pytest.mark.parametrize("i", [0, 4])
def test_engine_backend_execute_matches_jax(i):
    cfg = FAMILY[i]
    je, te = _engines(cfg, seed=i)
    tok, lab, _ = JT.synthetic_classification_data(64, seed=5)
    jb = JEngineBackend({cfg.name: je}, tokens=tok, labels=lab)
    tb = TEngineBackend({cfg.name: te}, tokens=tok, labels=lab)
    sids = [3, 70, 5, 9, 11, 12, 40]
    jx = jb.execute(cfg.name, sids)
    tx = tb.execute(cfg.name, sids)
    np.testing.assert_allclose(tx.certs, jx.certs, atol=1e-5, rtol=0)
    assert tx.certs.dtype == np.float64 and tx.elapsed > 0
    clear = np.asarray(jx.certs) > 1e-4
    assert np.array_equal(np.asarray(tx.preds)[clear],
                          np.asarray(jx.preds)[clear])
    assert len(tx.correct) == len(sids)
    # caller-supplied tokens: no correctness, same certainties
    tx2 = tb.execute(cfg.name, sids, tokens=[tok[s % 64] for s in sids])
    assert tx2.correct is None
    assert np.array_equal(tx2.certs, tx.certs)


def test_profile_mem_bytes_equal_to_jax():
    for cfg in (FAMILY[0], FAMILY[3]):
        je, te = _engines(cfg, buckets=(1, 2))
        jprof = JEngineBackend({cfg.name: je}).profile(
            cfg.name, batch_sizes=(1, 2), repeats=1)
        tprof = TEngineBackend({cfg.name: te}).profile(
            cfg.name, batch_sizes=(1, 2), repeats=1)
        assert tprof.mem_bytes == jprof.mem_bytes > 0
        assert np.all(tprof.batch_runtimes > 0)


def _small_family_arrays(seed=0):
    fam = FAMILY[:2]
    params = {cfg.name: _jax_params(cfg, seed + k)
              for k, cfg in enumerate(fam)}
    tok, lab, _ = JT.synthetic_classification_data(16, seed=seed)
    scores = {cfg.name: np.asarray(JT.apply_tiny(cfg, params[cfg.name],
                                                 jnp.asarray(tok)))
              for cfg in fam}
    return fam, params, scores, tok, lab


def test_artifact_written_by_jax_loads_in_port(tmp_path):
    fam, params, scores, tok, lab = _small_family_arrays()
    path = str(tmp_path / "jax.npz")
    JT.save_tiny_family(path, params, scores, tok, lab)
    tparams, tscores, ttok, tlab = TT.load_tiny_family(path, fam,
                                                       device="cpu")
    assert np.array_equal(ttok, tok) and np.array_equal(tlab, lab)
    for cfg in fam:
        assert np.array_equal(tscores[cfg.name], scores[cfg.name])
        ref = _to_torch(params[cfg.name])
        assert TT._leaves(ref) and len(TT._leaves(ref)) == len(
            TT._leaves(tparams[cfg.name]))
        for a, b in zip(TT._leaves(tparams[cfg.name]), TT._leaves(ref)):
            assert torch.equal(a, b)
        # and the loaded model scores as the JAX one did
        np.testing.assert_allclose(
            TT.apply_tiny(cfg, tparams[cfg.name],
                          torch.from_numpy(tok)).numpy(),
            scores[cfg.name], **TOL)


def test_artifact_written_by_port_loads_in_jax(tmp_path):
    fam, params, scores, tok, lab = _small_family_arrays(seed=2)
    tparams = {n: _to_torch(p) for n, p in params.items()}
    path = str(tmp_path / "port.npz")
    TT.save_tiny_family(path, tparams, scores, tok, lab)
    jparams, jscores, jtok, jlab = JT.load_tiny_family(path, fam)
    assert np.array_equal(jtok, tok) and np.array_equal(jlab, lab)
    for cfg in fam:
        assert np.array_equal(jscores[cfg.name], scores[cfg.name])
        got = jax.tree_util.tree_leaves(jparams[cfg.name])
        want = jax.tree_util.tree_leaves(params[cfg.name])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_port_init_and_family_training_on_cpu():
    """The port's own init (a torch.Generator) and a short family training
    run: reference layout and shapes, finite scores, seeded."""
    cfg = FAMILY[2]
    a = TT.init_tiny(cfg, seed=4, device="cpu")
    b = TT.init_tiny(cfg, seed=4, device="cpu")
    ja = jax.tree.map(np.asarray, _jax_params(cfg, 0))
    assert [t.shape for t in TT._leaves(a)] == \
        [tuple(x.shape) for x in TT._leaves(ja)]
    assert all(torch.equal(x, y) for x, y in zip(TT._leaves(a),
                                                  TT._leaves(b)))
    params_by, scores_by, tok_va, lab_va = TT.train_tiny_family(
        n_train=256, n_val=64, steps_scale=0.02, family=FAMILY[:2],
        device="cpu")
    for cfg in FAMILY[:2]:
        assert scores_by[cfg.name].shape == (64, 2)
        assert np.isfinite(scores_by[cfg.name]).all()
    assert tok_va.shape == (64, 32) and lab_va.shape == (64,)
