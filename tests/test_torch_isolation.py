"""The port stands alone: no jax, nothing of the JAX package, and no silent
move to the CPU.

* In a fresh interpreter, importing every ``repro_torch`` module (the
  baselines, admission, scenarios, fleet, MoE, training and distributed
  modules among them; the last start no process group) and ``chip_smoke``, then a training step of the launcher on each
  of the SSM, MoE and hybrid arch ids, leaves neither ``jax`` (nor
  ``jaxlib``) nor any ``repro`` module in ``sys.modules``.
* The entry points default to ``device="cuda"``: without a CUDA device they
  raise instead of running on the CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.certainty import device_fold_init
from repro_torch.models import model as TM
from repro_torch.serving.token_engine import SlotEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               'repro_torch.')]
for n in names:
    importlib.import_module(n)
import chip_smoke
# the train launcher on the SSM, MoE and hybrid arch ids (one CPU step)
import contextlib, io
from repro_torch.launch import train
for arch in ('falcon-mamba-7b', 'qwen2-moe-a2.7b', 'jamba-v0.1-52b'):
    with contextlib.redirect_stdout(io.StringIO()):
        train.main(['--arch', arch, '--smoke', '--device', 'cpu',
                    '--steps', '1', '--batch', '1', '--seq', '8'])
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
# importing the distributed layer starts no process group
import torch.distributed as td
if td.is_available() and td.is_initialized():
    bad.append('process-group-started')
# the numpy layers copied last must be among the modules imported above
for n in NEW_MODULES:
    if n not in names:
        bad.append('missing:' + n)
print(len(names), ' '.join(bad))
"""
# the serving layer's numpy copies (baselines, admission, scenarios, the
# elastic fleet), the mixture-of-experts FFN, the training path
# (optimizer, train step, synthetic data, checkpoints, shape cells, the
# train launcher), the distributed layer and the dry-run (its launcher,
# cost counter and roofline)
NEW_MODULES = ("repro_torch.core.admission", "repro_torch.core.scenarios",
               "repro_torch.serving.baselines", "repro_torch.distributed",
               "repro_torch.distributed.fault_tolerance",
               "repro_torch.models.moe", "repro_torch.training",
               "repro_torch.training.optimizer",
               "repro_torch.training.train_step",
               "repro_torch.training.data", "repro_torch.checkpoint",
               "repro_torch.checkpoint.manager", "repro_torch.configs.shapes",
               "repro_torch.launch.train", "repro_torch.tree",
               "repro_torch.distributed.context",
               "repro_torch.distributed.compat",
               "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
               "repro_torch.launch.steps", "repro_torch.launch.dryrun",
               "repro_torch.profiling.trace_cost",
               "repro_torch.profiling.roofline")


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"), ROOT])
    probe = f"NEW_MODULES = {NEW_MODULES!r}\n" + _PROBE
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, *bad = out.stdout.split()
    assert int(n_modules) >= 64
    assert bad == []


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_fold_init(2)
    params = TM.init_params(cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlotEngine("m", params, cfg, n_slots=2, max_len=16)
    # the CPU is used when asked for
    eng = SlotEngine("m", params, cfg, n_slots=2, max_len=16, device="cpu")
    slots, toks, gaps = eng.prefill_batch([np.arange(5, dtype=np.int32)])
    assert slots == [0] and toks.shape == (1,) and np.isfinite(gaps).all()


def test_classifier_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The one-shot classifier path (tiny family, engine, serve) defaults
    to the card too, and never moves to the CPU on its own."""
    from repro_torch.launch import serve
    from repro_torch.serving import tinymodels as TT
    from repro_torch.serving.engine import InferenceEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TT.TINY_FAMILY[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_tiny(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.train_tiny_family(n_train=8, n_val=8, steps_scale=0.001)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine("stub", lambda p, t: t, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--artifact", str(tmp_path / "none.npz")])
    # the CPU when asked: params on the CPU keep the engine there
    eng = InferenceEngine(cfg.name, lambda p, t: TT.apply_tiny(cfg, p, t),
                          TT.init_tiny(cfg, device="cpu"))
    assert eng.device.type == "cpu"
    assert eng.infer(np.zeros((3, 32), np.int32)).shape == (3, 2)


def test_chip_smoke_refuses_without_cuda():
    """Without a card the script exits non-zero and prints no result."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("extra", [
    ["--tenants", "a:latency:0.3:600", "--workload", "qwen"],
    ["--metrics-out", "m.jsonl", "--workload", "qwen"],
    ["--tenants", "a:latency:0.3:600", "--stress-replay"]])
def test_serve_modes_raise_without_cuda(monkeypatch, tmp_path, extra):
    """The multi-tenant and metrics modes of the serve CLI default to the
    card like every other mode, even where no model runs (the cost-model
    workload): without one they raise before any work."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--artifact", str(tmp_path / "none.npz")] + extra)
    assert not (tmp_path / "m.jsonl").exists()


def test_train_launcher_raises_without_cuda(monkeypatch, tmp_path, capsys):
    """``repro_torch.launch.train`` defaults to the card: without one it
    raises before any work; ``--device cpu`` trains on the CPU."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--arch", "qwen2-0.5b", "--smoke", "--steps", "1", "--batch",
            "2", "--seq", "8", "--log-every", "1", "--ckpt-every", "1",
            "--ckpt-dir", str(tmp_path / "ck")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(args)
    assert not (tmp_path / "ck").exists()
    train.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     1 loss=" in out and out.rstrip().endswith("done")
    assert (tmp_path / "ck" / "LATEST").read_text() == "step_000000001"


def test_train_module_refuses_without_cuda_in_a_fresh_interpreter():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-0.5b", "--smoke", "--steps", "1"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "step" not in out.stdout
