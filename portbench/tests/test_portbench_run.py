"""A run of a tiny cell on the CPU, end to end: the logical steps, the
result line, the files found by name, the isolation from JAX, and the
comparison that decides ``correct`` against its control and planted
faults."""
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import bench
from portbench.cell import System, correctness, run, serve_window
from portbench.record import Record
from portbench.recorder import Recorder
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 4242


def _run(config, trace=False, seconds=0.3, cell=None):
    cell = cell or tiny.cell(config)
    return run(cell, SEED, seconds, trace, CPU, time.perf_counter())[0]


# ---------------------------------------------------------------- steps

def test_steps_match_the_engines_own():
    """Every decode call's reconstructed logical step is the step the
    engine was in when it made the call (read from its own decode phase),
    and every request's token times fall inside its burst."""
    cell = tiny.cell(tiny.DENSE)
    system = System(cell, SEED, CPU)
    system.warm(SEED)
    system.calibrate(SEED)
    truth = []
    token_engine = system.token_engine

    def token_engine_t(thresholds):
        te = token_engine(thresholds)
        fused = te._step_fused

        def fused_t(si, eng, waiting, act, step):
            truth.append((si, step))
            return fused(si, eng, waiting, act, step)
        te._step_fused = fused_t
        return te

    system.token_engine = token_engine_t
    rec = Recorder(system.engines)
    for _ in range(2):
        serve_window(system, SEED, 0.0, rec)
    assert len(rec.bursts) == 2
    assert [(c.stage, c.step) for c in rec.calls if c.kind == "decode"] \
        == truth
    for b in rec.bursts:
        for first, last in rec.request_times(b).values():
            assert b.t_sub <= first <= last <= b.t_end


def test_steps_of_a_scripted_two_stage_loop():
    """A fake two-stage loop with known steps: prefill a, decode a, decode
    a, prefill b, decode b, decode a, decode b."""

    class Fake:
        def __init__(self, name):
            self.name = name
            self.pos = np.zeros(2, np.int32)
            self.active = np.zeros(2, bool)

        def prefill_batch(self, prompts):
            return [0], np.zeros(1, np.int32), np.zeros(1, np.float32)

        def decode_fused(self, k=1, mode="ewma", beta=0.35):
            z = np.zeros((k, 2))
            return z.astype(np.int32), z.astype(np.float32), z

        def release(self, slot):
            return None

    a, b = Fake("a"), Fake("b")
    rec = Recorder([a, b])

    class Req:
        def __init__(self, rid):
            self.rid, self.prompt = rid, np.zeros(3, np.int32)

    rec.begin_burst([Req(0)])
    script = [(a.prefill_batch, [np.zeros(3)]), (a.decode_fused, None),
              (a.decode_fused, None), (b.prefill_batch, [np.zeros(3)]),
              (b.decode_fused, None), (a.decode_fused, None),
              (b.decode_fused, None), (b.prefill_batch, [np.zeros(3)]),
              (b.decode_fused, None)]
    for fn, arg in script:
        fn(arg) if arg is not None else fn(1)
    assert [(c.stage, c.kind, c.step) for c in rec.calls] == [
        (0, "prefill", 0), (0, "decode", 0), (0, "decode", 1),
        (1, "prefill", 1), (1, "decode", 1), (0, "decode", 2),
        (1, "decode", 2), (1, "prefill", 3), (1, "decode", 3)]


# ----------------------------------------------------------------- line

def test_result_line_keys_untraced_and_traced():
    line = _run(tiny.DENSE)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"tokens_per_s", "ttft_p95_ms",
                                    "tpot_p95_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] % tiny.TRAFFIC["burst"] == 0
    traced = _run(tiny.DENSE, trace=True, seconds=6.0)
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "useful_token_share" in traced["metrics"]
    assert "mfu" in traced["metrics"]
    json.dumps(line), json.dumps(traced)


def test_files_found_by_name_in_a_copy(tmp_path):
    """A configuration, a traffic mix and a metric added as files (and
    entries of BENCHMARK.json) in a copy are found, no file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(bench.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench.load()
    (root / "portbench" / "configs" / "tiny-ssm.json").write_text(
        json.dumps(tiny.SSM))
    tr = dict(tiny.TRAFFIC, escalate_share=0.3)
    (root / "portbench" / "traffic" / "tiny-ssm.burst.json").write_text(
        json.dumps(tr))
    (root / "portbench" / "metrics" / "requests_per_s.py").write_text(
        "def read(rec):\n"
        "    return sum(len(b.requests) for b in rec.bursts) / rec.window_s\n")
    b["configs"].append({"name": "tiny-ssm", "source": "test",
                         "file": "portbench/configs/tiny-ssm.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny-ssm.burst", "config": "tiny-ssm",
                           "traffic": "tiny-ssm.burst", "chips": 1,
                           "why": "test"})
    b["end_to_end"].append({"name": "requests_per_s", "unit": "1/s",
                            "better": "higher", "bound": 0.1,
                            "source": "host_clock",
                            "workloads": ["tiny-ssm.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    before = {p: p.read_bytes() for p in bench.PKG.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    cell = bench.cell(bench.load(root), "tiny-ssm.burst", root)
    assert cell.config["name"] == "tiny-ssm-cascade"
    assert cell.traffic["escalate_share"] == 0.3
    line = _run(None, cell=cell)
    assert line["metrics"]["requests_per_s"]["value"] > 0
    assert {p: p.read_bytes() for p in before} == before


def test_no_jax_after_a_run_and_none_imported():
    """A run loads no module named jax, jaxlib, flax or repro; no source of
    the benchmark imports them, chip_smoke or benchmarks."""
    code = ("import sys, time, torch\n"
            "from portbench.tests import tiny\n"
            "from portbench.cell import run\n"
            "from portbench.run import loaded_forbidden\n"
            "run(tiny.cell(tiny.SSM), 7, 0.2, False, torch.device('cpu'),"
            " time.perf_counter())\n"
            "print(loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": str(bench.ROOT),
                              "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    banned = ("jax", "jaxlib", "flax", "repro", "chip_smoke", "benchmarks")
    for path in bench.PKG.rglob("*.py"):
        for ln in path.read_text().splitlines():
            words = ln.split()
            if words[:1] == ["import"] or (words[:1] == ["from"]
                                           and "import" in words):
                top = words[1].split(".")[0].rstrip(",")
                assert top not in banned, f"{path}: {ln}"
    assert "benchmarks/" not in "".join(
        p.read_text() for p in bench.PKG.rglob("*.py")
        if p.name != Path(__file__).name)


def test_without_a_card_the_command_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "cascade-qwen3-32b.chat", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=bench.ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""


# ------------------------------------------------- control and faults

@pytest.mark.parametrize("config", [tiny.DENSE, tiny.SSM],
                         ids=["dense", "ssm"])
def test_control_fails_where_the_port_passes(config):
    """The float8 control, read on the same prompts and served tokens,
    lies beyond each of the tiny cell's limits on the reference; the port
    lies within them."""
    cell = tiny.cell(config)
    limits = cell.traffic["check"]["limits"]
    system = System(cell, SEED, CPU)
    system.warm(SEED)
    system.calibrate(SEED)
    rec = Recorder(system.engines)
    serve_window(system, SEED, 0.3, rec)
    numbers = correctness(system, Record(system.models, system.names,
                                         cell.traffic, rec, 0.0, 0.0),
                          SEED, control=True)
    for name in ("token_gap", "gap_err", "gap_rank_loss"):
        assert numbers[name] <= limits[name]
        assert numbers["control_" + name] > limits[name]


def _state_unchanged(monkeypatch, config):
    """A decode step that leaves the cache or the scan state unchanged."""
    from repro_torch.models import attention, mamba
    if config is tiny.SSM:
        real = mamba.mamba_decode

        def decode(p, cfg, x, cache):
            kept = {k: v.clone() for k, v in cache.items()}
            out, _ = real(p, cfg, x, kept)
            return out, cache
        monkeypatch.setattr(mamba, "mamba_decode", decode)
    else:
        real = attention.decode_attention

        def decode(p, cfg, x, cache, cache_index):
            kept = {k: v.clone() for k, v in cache.items()}
            out, _ = real(p, cfg, x, kept, cache_index)
            return out, cache
        monkeypatch.setattr(attention, "decode_attention", decode)


def _half_batch(monkeypatch, config):
    """Half of each decode batch left out: its rows take the other half's
    logits."""
    from repro_torch.models import model as model_lib
    real = model_lib.decode_step

    def step(params, cfg, tokens, cache, cache_index):
        logits, cache = real(params, cfg, tokens, cache, cache_index)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:] = logits[:logits.shape[0] - half]
        return logits, cache
    monkeypatch.setattr(model_lib, "decode_step", step)


def _token_altered(monkeypatch, config):
    """One token of every decode step altered where it is produced."""
    from repro_torch.models import model as model_lib
    real = model_lib.argmax_gap

    def argmax_gap(logits):
        tok, gap = real(logits)
        tok = tok.clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok, gap
    monkeypatch.setattr(model_lib, "argmax_gap", argmax_gap)


def _wrap_gaps(monkeypatch, change):
    """Every top-2 gap the stages return (prefill and decode) changed by
    ``change(logits, gap)`` where it is produced."""
    from repro_torch.models import model as model_lib
    from repro_torch.serving import token_engine
    for mod in (model_lib, token_engine):
        def argmax_gap(logits, real=mod.argmax_gap):
            tok, gap = real(logits)
            return tok, change(logits, gap).to(gap.dtype)
        monkeypatch.setattr(mod, "argmax_gap", argmax_gap)


def _gap_altered(monkeypatch, config):
    """Every top-2 gap taken as the top-1 logit less the third."""
    def top1_less_top3(logits, gap):
        top = torch.topk(logits.float(), 3, dim=-1).values
        return top[..., 0] - top[..., 2]
    _wrap_gaps(monkeypatch, top1_less_top3)


def _gap_of_the_next_row(monkeypatch, config):
    """Every row of a batch given the top-2 gap of the row after it."""
    _wrap_gaps(monkeypatch, lambda logits, gap: gap.roll(-1, dims=0))


@pytest.mark.parametrize("config", [tiny.DENSE, tiny.SSM],
                         ids=["dense", "ssm"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered, _gap_altered,
                                   _gap_of_the_next_row],
                         ids=["state-unchanged", "half-batch",
                              "token-altered", "gap-altered",
                              "gap-of-the-next-row"])
def test_a_fault_underneath_makes_the_run_incorrect(monkeypatch, config,
                                                    fault):
    assert _run(config)["correct"] is True
    fault(monkeypatch, config)
    line = _run(config)
    assert line["correct"] is False, line["checks"]


def test_tiny_cells_on_the_card():
    """On a CUDA device the kernels' path passes the same checks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for config in (tiny.DENSE, tiny.SSM):
        line = run(tiny.cell(config), SEED, 0.5, False, dev,
                   time.perf_counter())[0]
        assert line["correct"] is True, line["checks"]


test_tiny_cells_on_the_card = pytest.mark.cuda(test_tiny_cells_on_the_card)
