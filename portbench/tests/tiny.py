"""Tiny cells for the CPU tests: the same files and code paths as the
chip's cells, at widths the CPU serves in seconds."""
from __future__ import annotations

import copy

from portbench import bench

DENSE = {
    "name": "tiny-cascade",
    "stages": [
        {"name": "a", "source": "test", "reference": "dense_gqa",
         "model": {"name": "tiny-qwen2", "family": "dense", "num_layers": 2,
                   "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
                   "head_dim": 16, "d_ff": 128, "vocab_size": 256,
                   "qkv_bias": True, "qk_norm": False, "rope_theta": 10000.0,
                   "norm_type": "rmsnorm", "norm_eps": 1e-6,
                   "activation": "silu", "tie_embeddings": True}},
        {"name": "b", "source": "test", "reference": "dense_gqa",
         "model": {"name": "tiny-qwen3", "family": "dense", "num_layers": 2,
                   "d_model": 96, "num_heads": 4, "num_kv_heads": 2,
                   "head_dim": 32, "d_ff": 192, "vocab_size": 256,
                   "qkv_bias": False, "qk_norm": True,
                   "rope_theta": 1000000.0, "norm_type": "rmsnorm",
                   "norm_eps": 1e-6, "activation": "silu",
                   "tie_embeddings": False}}],
    "init": {"matrix_std": 0.1, "bias_std": 0.1, "norm": [0.9, 1.1]},
}

SSM_MODEL = {"name": "tiny-mamba", "family": "ssm", "num_layers": 2,
             "d_model": 64, "num_heads": 1, "num_kv_heads": 1, "head_dim": 1,
             "d_ff": 0, "vocab_size": 256, "norm_type": "rmsnorm",
             "norm_eps": 1e-5, "tie_embeddings": False,
             "ssm": {"d_state": 4, "d_conv": 4, "expand": 2, "dt_rank": 4}}

SSM = {
    "name": "tiny-ssm-cascade",
    "stages": [{"name": "a", "source": "test", "reference": "mamba1",
                "model": SSM_MODEL},
               {"name": "b", "source": "test", "reference": "mamba1",
                "model": SSM_MODEL}],
    "init": {"matrix_std": 0.1, "bias_std": 0.1, "conv_std": 0.5,
             "norm": [0.9, 1.1], "dt_bias": [-4.0, -2.0],
             "A_log": [0.0, 1.1], "D": [0.9, 1.1]},
}

TRAFFIC = {
    "burst": 6,
    "calibrated_bursts": 2,
    "prompt": {"median": 12, "sigma": 0.5, "min": 4, "max": 24},
    "output": {"median": 8, "sigma": 0.4, "min": 5, "max": 12},
    "slots": {"a": 4, "b": 2},
    "max_len": 48,
    "escalate_share": 0.5,
    "spec_k": 4, "min_tokens": 4, "early_margin": 0.5,
    "stream_mode": "ewma", "beta": 0.35,
    "check": {"sample": 32,
              "limits": {"unfinished": 0, "stream_mismatch": 0,
                         "decision_mismatch": 0, "token_gap": 0.05,
                         "gap_err": 0.025, "gap_rank_loss": 0.02}},
}


def cell(config: dict, **traffic) -> bench.Cell:
    """A cell of ``config`` under the tiny traffic, reporting every metric
    of the repository's BENCHMARK.json."""
    tr = copy.deepcopy(TRAFFIC)
    tr.update(traffic)
    b = bench.load()
    metrics = [dict(m, kind=k) for k in ("end_to_end", "per_layer")
               for m in b[k]]
    return bench.Cell("tiny", 1, copy.deepcopy(config), tr, metrics)
