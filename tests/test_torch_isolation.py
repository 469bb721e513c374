"""The port stands alone: no jax, nothing of the JAX package, and no silent
move to the CPU.

* In a fresh interpreter, importing every ``repro_torch`` module and
  ``chip_smoke`` leaves neither ``jax`` (nor ``jaxlib``) nor any ``repro``
  module in ``sys.modules``.
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
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
print(len(names), ' '.join(bad))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"), ROOT])
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, *bad = out.stdout.split()
    assert int(n_modules) >= 44
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
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
