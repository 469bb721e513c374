"""The port's other dense architectures, config registry and H100 cost model
against the JAX package's, on the CPU.

* olmo-1b (non-parametric LayerNorm, MHA), h2o-danube-1.8b (GQA, a
  sliding-window ring) and qwen3-32b (qk-norm, an untied head) at their
  smoke configs: JAX float32 params, every norm scale perturbed so a
  misapplied scale shows, carried across by ``repro_torch.convert``.
  forward / prefill / decode logits within atol 1e-4 / rtol 1e-4 (float32,
  other summation orders; the tolerance of ``test_torch_model.py``), decode
  against the port's own forward at the same tolerance, greedy tokens
  equal up to the first step whose JAX top-2 gap is below 1e-4.
* The registry: all ten arch ids, smoke configs equal to JAX's field for
  field, and ``init_params`` building the encoder-decoder and the vision
  frontend with the JAX init's tree (their parity tests are in
  ``tests/test_torch_encdec.py``).
* The cost model: with the port's ``hw`` set to the TPU v5e values of
  ``repro/profiling/hw.py``, every number and the qwen-family plan equal
  the reference's exactly (the same float arithmetic); on its own H100
  defaults qwen3-32b fits one card.
* ``python -m repro_torch.launch.serve --workload qwen --device cpu``.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.gears import SLO as JSLO
from repro.core.plan_state import HardwareSpec as JHardwareSpec
from repro.core.planner import optimize_gear_plan as j_optimize
from repro.core.simulator import ServingSimulator as JServingSimulator
from repro.core.traces import diurnal_like_trace as j_diurnal
from repro.launch import serve as JS
from repro.models import model as JM
from repro.profiling import cost_model as JCM
from repro.profiling import hw as jhw
from repro.serving.token_engine import greedy_generate as jax_greedy
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import cache_from_numpy, params_from_numpy, to_numpy
from repro_torch.core.gears import SLO as TSLO
from repro_torch.core.plan_state import HardwareSpec as THardwareSpec
from repro_torch.core.planner import optimize_gear_plan as t_optimize
from repro_torch.core.simulator import ServingSimulator as TServingSimulator
from repro_torch.core.traces import diurnal_like_trace as t_diurnal
from repro_torch.launch import serve as TS
from repro_torch.models import model as TM
from repro_torch.profiling import cost_model as TCM
from repro_torch.profiling import hw as thw
from repro_torch.serving.token_engine import greedy_generate

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=0)
NEAR = 1e-4
DENSE = ["olmo-1b", "h2o-danube-1.8b", "qwen3-32b"]
ENCDEC_VLM = ["seamless-m4t-large-v2", "internvl2-1b"]


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _perturb_scales(tree, rng):
    """Every norm scale (final, per block, qk-norm) moved off 1."""
    if isinstance(tree, dict):
        return {k: (v * (1.0 + 0.1 * rng.standard_normal(v.shape))
                    ).astype(np.float32)
                if k.endswith("scale") else _perturb_scales(v, rng)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb_scales(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    arch = request.param
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    tree = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    tree = _perturb_scales(tree, np.random.default_rng(1))
    return (arch, jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def _cache_close(tcache, jcache):
    tl = [t for blk in tcache["blocks"] for t in (blk["k"], blk["v"])]
    jl = [a for blk in jcache["blocks"] for a in (blk["k"], blk["v"])]
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(to_numpy(t), np.asarray(j, np.float32),
                                   **CACHE_TOL)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

def test_registry_holds_every_arch_id():
    assert ARCH_IDS == JARCH_IDS and len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_config(arch))
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_smoke_config_equals_jax(arch):
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jax_smoke_config(arch))


@pytest.mark.parametrize("arch", ENCDEC_VLM)
def test_init_params_refuses_unported_families(arch):
    """The families this test once saw refused (the encoder-decoder and
    the vision frontend) are ported: ``init_params`` builds them with the
    JAX init's tree, shapes and dtypes, and JAX's own params, converted,
    run ``forward`` to the JAX logits."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    own = jax.tree.flatten(TM.init_params(cfg, seed=0, device="cpu"))
    ref = jax.tree.flatten(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    assert own[1] == ref[1]
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in own[0]] == [(j.shape, str(j.dtype)) for j in ref[0]]
    tree = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(1), dtype=jnp.float32))
    rng = np.random.default_rng(2)
    batch = {"tokens": _tokens(3, (2, 10))}
    if cfg.is_encoder_decoder:
        batch["source_frames"] = rng.standard_normal(
            (2, 12, cfg.frontend.frontend_dim)).astype(np.float32)
    else:
        batch["prefix_embeddings"] = rng.standard_normal(
            (2, cfg.frontend.num_prefix_embeddings,
             cfg.frontend.frontend_dim)).astype(np.float32)
    jl, _ = JM.forward(jax.tree.map(jnp.asarray, tree), jcfg,
                       {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = TM.forward(params_from_numpy(tree, device="cpu"), cfg, batch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_params_carry_across(dense):
    """The converted tree has the JAX tree's structure and values: qk-norm
    scales (qwen3), an untied ``lm_head`` (qwen3, danube), no scale leaf
    under the non-parametric LayerNorm (olmo); and the port's own init
    builds the same structure, shapes and dtypes."""
    arch, jcfg, tcfg, jp, tp = dense
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert jdef == tdef
    for j, t in zip(jl, tl):
        assert np.array_equal(np.asarray(j), t.numpy())
    attn = tp["blocks"][0]["attn"]
    assert ("q_norm_scale" in attn and "k_norm_scale" in attn) == \
        (arch == "qwen3-32b")
    assert ("lm_head" in tp["embed"]) == (arch != "olmo-1b")
    assert (tp["final_norm"] == {} and tp["blocks"][0]["norm1"] == {}) == \
        (arch == "olmo-1b")
    own = jax.tree.flatten(TM.init_params(tcfg, seed=0, device="cpu"))
    ref = jax.tree.flatten(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    assert own[1] == ref[1]
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in own[0]] == [(j.shape, str(j.dtype)) for j in ref[0]]


# ---------------------------------------------------------------------------
# model parity
# ---------------------------------------------------------------------------

def test_forward_matches_jax(dense):
    _, jcfg, tcfg, jp, tp = dense
    toks = _tokens(1, (2, 20))
    jl, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, _ = TM.forward(tp, tcfg, {"tokens": toks})
    assert tl.dtype == torch.float32 and tl.shape == (2, 20, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_prefill_matches_jax(dense):
    _, jcfg, tcfg, jp, tp = dense
    toks = _tokens(2, (2, 20))
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        cache_len=24)
    tl, tc = TM.prefill(tp, tcfg, {"tokens": toks}, cache_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _cache_close(tc, jc)


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_matches_jax_and_forward(dense, ragged):
    """Three decode steps from one prefill cache, scalar or ragged (B,)
    ``cache_index``: logits and cache against JAX's, and each row's
    logits against the port's own forward over the same tokens."""
    _, jcfg, tcfg, jp, tp = dense
    toks = _tokens(3, (2, 23))
    lens = np.asarray([20, 7] if ragged else [20, 20], np.int32)
    _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :20])},
                       cache_len=24)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    ci = lens.copy() if ragged else np.int32(20)
    for step in range(3):
        nxt = np.stack([toks[b, lens[b] + step] for b in range(2)])[:, None]
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                                jnp.asarray(ci))
        tl, tc = TM.decode_step(tp, tcfg, nxt, tc,
                                torch.from_numpy(np.asarray(ci)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _cache_close(tc, jc)
        for b in range(2):
            # row b's context: its own first lens[b] tokens (the ragged
            # row 1 prefilled 20 and decodes over the first 7 of them)
            n = int(lens[b]) + step + 1
            seq = np.concatenate([toks[b, :lens[b]],
                                  [toks[b, lens[b] + i]
                                   for i in range(step + 1)]])[None]
            fl, _ = TM.forward(tp, tcfg, {"tokens": seq.astype(np.int32)})
            np.testing.assert_allclose(tl[b].numpy(), fl[0, n - 1].numpy(),
                                       **LOGIT_TOL)
        ci = ci + 1


def test_greedy_generate_matches_jax(dense):
    _, jcfg, tcfg, jp, tp = dense
    prompt = _tokens(5, (11,))
    jt, jg = jax_greedy(jp, jcfg, prompt, 8)
    tt, tg = greedy_generate(tp, tcfg, prompt, 8)
    near = np.flatnonzero(jg < NEAR)
    n = int(near[0]) + 1 if near.size else len(jt)
    np.testing.assert_array_equal(tt[:n], jt[:n])
    np.testing.assert_allclose(tg[:n], jg[:n], **LOGIT_TOL)


def test_danube_sliding_window_ring_past_the_window():
    """h2o-danube's 64-slot ring at S 80: the cut-and-rolled prefill cache
    and two decode steps past the window against JAX, and against the
    port's own windowed forward."""
    jcfg = jax_smoke_config("h2o-danube-1.8b")
    tcfg = get_smoke_config("h2o-danube-1.8b")
    assert tcfg.sliding_window == 64
    tree = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(1), dtype=jnp.float32))
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(
        tree, device="cpu")
    s = 80
    toks = _tokens(9, (1, s + 2))
    jfull, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tfull, _ = TM.forward(tp, tcfg, {"tokens": toks})
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), **LOGIT_TOL)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :s])},
                        cache_len=s + 2)
    tl, tc = TM.prefill(tp, tcfg, {"tokens": toks[:, :s]}, cache_len=s + 2)
    assert tc["blocks"][0]["k"].shape[2] == 64
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _cache_close(tc, jc)
    for pos in (s, s + 1):
        nxt = toks[:, pos:pos + 1]
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = TM.decode_step(tp, tcfg, nxt, tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_allclose(tl.numpy(), tfull[:, pos].numpy(),
                                   **LOGIT_TOL)
        _cache_close(tc, jc)


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

_V5E = {n: getattr(jhw, n) for n in ("PEAK_FLOPS_BF16", "HBM_BW",
                                     "HBM_BYTES", "ICI_BW")}


@pytest.fixture
def v5e(monkeypatch):
    """The port's cost model on the reference's TPU v5e constants."""
    for name, value in _V5E.items():
        monkeypatch.setattr(thw, name, value)


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_cost_model_equals_reference_on_v5e_constants(v5e, arch):
    jc, tc = jax_config(arch), get_config(arch)
    for kind in ("train", "prefill", "decode"):
        for tokens, ctx in ((8, 512), (1, 2048), (64, 4096)):
            assert TCM.model_flops(tc, tokens, ctx, kind) == \
                JCM.model_flops(jc, tokens, ctx, kind)
            assert TCM.model_bytes(tc, tokens, ctx, kind) == \
                JCM.model_bytes(jc, tokens, ctx, kind)
    assert TCM.min_slice_chips(tc) == JCM.min_slice_chips(jc)
    for chips in (1, TCM.min_slice_chips(tc), 16):
        for kind in ("prefill", "decode"):
            for b in (1, 8, 128):
                assert TCM.analytic_runtime(tc, b, 2048, kind, chips) == \
                    JCM.analytic_runtime(jc, b, 2048, kind, chips)
    tp = TCM.profile_from_cost_model(tc)
    jp = JCM.profile_from_cost_model(jc)
    assert tp.mem_bytes == jp.mem_bytes
    assert tp.devices_per_replica == jp.devices_per_replica
    assert np.array_equal(tp.batch_runtimes, np.asarray(jp.batch_runtimes))


def test_qwen_family_plan_and_des_equal_reference_on_v5e_constants(v5e):
    """The serve CLI's ``--workload qwen`` backend on both packages: the
    same profiles, the same gear plan (``to_json`` equal) at the JAX CLI's
    defaults, and the same DES run over the cost-model backend."""
    jb, tb = JS.qwen_backend(), TS.qwen_backend()
    assert sorted(jb.profiles) == sorted(tb.profiles)
    for n, jprof in jb.profiles.items():
        tprof = tb.profiles[n]
        assert tprof.devices_per_replica == jprof.devices_per_replica
        assert np.array_equal(tprof.batch_runtimes, jprof.batch_runtimes)
        assert tprof.accuracy == jprof.accuracy
    jplan = j_optimize(jb.profiles, JHardwareSpec(4, 16e9),
                       JSLO(kind="latency", latency_p95=0.3), qps_max=60.0,
                       n_ranges=4).plan
    tplan = t_optimize(tb.profiles, THardwareSpec(4, 16e9),
                       TSLO(kind="latency", latency_p95=0.3), qps_max=60.0,
                       n_ranges=4).plan
    assert tplan.to_json() == jplan.to_json()
    jres = JServingSimulator(jb.profiles, jplan.replicas, 4, backend=jb) \
        .run_trace(jplan, j_diurnal(seconds=20, peak_qps=60.0))
    tres = TServingSimulator(tb.profiles, tplan.replicas, 4, backend=tb) \
        .run_trace(tplan, t_diurnal(seconds=20, peak_qps=60.0))
    assert (tres.completed, tres.offered) == (jres.completed, jres.offered)
    assert tres.p95 == jres.p95 and tres.accuracy == jres.accuracy
    assert len(tres.gear_switches) == len(jres.gear_switches)


def test_h100_defaults_place_qwen3_32b_on_one_card():
    """On the H100's 80 GiB, qwen3-32b (65.5 GB of bf16 weights, 81.9 GB
    with the 1.25 workspace factor) fits one card; on v5e it takes 8."""
    assert thw.HBM_BYTES == 80 * 2 ** 30
    cfg = get_config("qwen3-32b")
    assert TCM.min_slice_chips(cfg) == 1
    assert JCM.min_slice_chips(jax_config("qwen3-32b")) == 8
    # the decode step at B 8, context 512: above the weight-read bound
    # (weights over 3.35 TB/s), below it over the 0.8 bandwidth efficiency
    step = TCM.analytic_runtime(cfg, 8, 512, "decode", 1)
    weights = cfg.active_param_count() * 2.0
    assert weights / thw.HBM_BW < step
    assert step == pytest.approx(
        (weights + 8 * 512 * cfg.kv_cache_bytes_per_token()
         + 8 * cfg.d_model * 8.0) / (thw.HBM_BW * 0.8))


def test_serve_cli_workload_qwen_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "qwen", "--device", "cpu", "--trace-seconds", "6", "--n-ranges",
         "2"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    qwen3 = [ln for ln in lines if ln.split()[:1] == ["qwen3-32b"]]
    assert len(qwen3) == 1 and qwen3[0].endswith("slice=1")
    assert any("memory per logical device: 85.90 GB (4 modelled H100s)"
               in ln for ln in lines)
    assert any(ln.startswith("  range 1 (<= 60 qps):") for ln in lines)
    assert any(ln.startswith("simulated (replay backend):")
               for ln in lines)


@pytest.mark.parametrize("extra", [["--real"],
                                   ["--real", "--tenants",
                                    "a:latency:0.3:600"],
                                   ["--real", "--metrics-out", "m.jsonl"]])
def test_serve_cli_workload_qwen_refuses(extra, capsys):
    """The qwen workload has no real engines: ``--real`` is refused,
    whatever else is asked (``--tenants`` and ``--metrics-out`` alone are
    served, ``tests/test_torch_tenancy.py``)."""
    with pytest.raises(SystemExit):
        TS.main(["--workload", "qwen", "--device", "cpu"] + extra)
    assert "--real serves the tiny workload only" in capsys.readouterr().err
