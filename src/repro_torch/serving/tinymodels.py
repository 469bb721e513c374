"""Tiny transformer classifier family for the REAL serving path
(port of ``repro/serving/tinymodels.py``).

The paper's BERT workload is a family of five fine-tuned BERT sizes on
Sentiment-140. The reference recreates its *structure*: a synthetic
text-classification task with an easy/hard split (easy samples carry a
strong lexical signal any model learns; hard samples encode the label in
token ORDER, which only higher-capacity models pick up) and a family of
tiny transformers trained to different accuracies in seconds. The port
trains the same family with autograd, on the card unless the caller asks
for the CPU.

Params keep the reference's layout: a dict of float32 tensors ``embed``,
``pos``, ``head`` and ``blocks``, a list of ``{wq, wk, wv, wo, w1, w2}``,
so ``repro_torch.convert.tiny_params_from_numpy`` carries JAX params
across unchanged. ``jax.random`` cannot be reproduced in torch, so
``init_tiny`` draws from its own ``torch.Generator``; the training loop
draws its batch indices from ``np.random.default_rng(seed)`` exactly as the
reference does, and the ``.npz`` artifact stores the leaves in the
reference's ``jax.tree_util.tree_flatten`` order, so artifacts load both
ways. Attention is computed in plain torch, as the reference computes it in
jnp (hd 8-24 is outside the flash kernel's head sizes); the only kernel on
this path is top2gap, in ``EngineBackend.execute``.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.execution import resolve_estimator
from repro_torch.core.profiles import ValidationRecord

__all__ = ["TinyClassifierConfig", "TINY_FAMILY",
           "synthetic_classification_data", "init_tiny", "apply_tiny",
           "tiny_loss", "sgd_step", "train_tiny", "train_tiny_family",
           "save_tiny_family", "load_tiny_family", "make_engine_backend",
           "validation_record_from_scores"]


@dataclass(frozen=True)
class TinyClassifierConfig:
    name: str
    d_model: int
    num_layers: int
    num_heads: int
    vocab: int = 64
    n_classes: int = 2
    seq_len: int = 32
    d_ff_mult: int = 2


TINY_FAMILY: Tuple[TinyClassifierConfig, ...] = (
    TinyClassifierConfig("t-tiny", 16, 1, 2),
    TinyClassifierConfig("t-mini", 32, 1, 2),
    TinyClassifierConfig("t-small", 48, 2, 4),
    TinyClassifierConfig("t-medium", 64, 3, 4),
    TinyClassifierConfig("t-base", 96, 4, 4),
)


# ---------------------------------------------------------------------------
# Synthetic task: easy (lexical) + hard (positional) samples
# ---------------------------------------------------------------------------

def synthetic_classification_data(n: int, seq_len: int = 32, vocab: int = 64,
                                  hard_frac: float = 0.35, seed: int = 0
                                  ) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """Returns (tokens (N, L), labels (N,), is_hard (N,)).

    Easy: 3 tokens from the class's signal set {2,3,4} / {5,6,7} planted.
    Hard: one marker pair (8, 9); label = which comes first.
    """
    rng = np.random.default_rng(seed)
    tokens = rng.integers(10, vocab, size=(n, seq_len)).astype(np.int32)
    labels = rng.integers(0, 2, size=n).astype(np.int32)
    is_hard = rng.random(n) < hard_frac
    for i in range(n):
        pos = rng.choice(seq_len, size=4, replace=False)
        if not is_hard[i]:
            sig = [2, 3, 4] if labels[i] == 0 else [5, 6, 7]
            tokens[i, pos[:3]] = rng.choice(sig, size=3)
        else:
            a, b = sorted(pos[:2])
            first, second = (8, 9) if labels[i] == 0 else (9, 8)
            tokens[i, a] = first
            tokens[i, b] = second
    return tokens, labels, is_hard


# ---------------------------------------------------------------------------
# Model: embeddings + transformer blocks + mean-pool + linear head
# ---------------------------------------------------------------------------

def init_tiny(cfg: TinyClassifierConfig, seed: int = 0,
              device="cuda") -> Dict:
    """Random params in the reference's layout and scales (normal * 0.05
    embeddings, normal / sqrt(fan_in) projections), every leaf drawn in
    turn from one ``torch.Generator`` seeded with ``seed``."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    d = cfg.d_model

    def normal(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float32)

    def dense(i, o):
        return normal(i, o) * (i ** -0.5)

    params = {
        "embed": normal(cfg.vocab, d) * 0.05,
        "pos": normal(cfg.seq_len, d) * 0.05,
        "head": dense(d, cfg.n_classes),
        "blocks": [],
    }
    for _ in range(cfg.num_layers):
        params["blocks"].append({
            "wq": dense(d, d), "wk": dense(d, d),
            "wv": dense(d, d), "wo": dense(d, d),
            "w1": dense(d, cfg.d_ff_mult * d),
            "w2": dense(cfg.d_ff_mult * d, d),
        })
    return _tree_map(params, lambda t: t.to(device))


def apply_tiny(cfg: TinyClassifierConfig, params: Dict, tokens: torch.Tensor
               ) -> torch.Tensor:
    """tokens (B, L) int -> class scores (B, C) f32."""
    b, l = tokens.shape
    x = params["embed"][tokens] + params["pos"][None, :l]
    h = cfg.num_heads
    hd = cfg.d_model // h
    for blk in params["blocks"]:
        q = (x @ blk["wq"]).reshape(b, l, h, hd)
        k = (x @ blk["wk"]).reshape(b, l, h, hd)
        v = (x @ blk["wv"]).reshape(b, l, h, hd)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        att = torch.softmax(att, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, l,
                                                           cfg.d_model)
        x = x + o @ blk["wo"]
        x = x + torch.relu(x @ blk["w1"]) @ blk["w2"]
    pooled = x.mean(dim=1)
    return pooled @ params["head"]


def tiny_loss(cfg: TinyClassifierConfig, params: Dict, tokens: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the class scores (the reference's loss)."""
    logp = torch.log_softmax(apply_tiny(cfg, params, tokens), dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None]).mean()


def sgd_step(cfg: TinyClassifierConfig, params: Dict, mom: List,
             tokens: torch.Tensor, labels: torch.Tensor, lr: float
             ) -> torch.Tensor:
    """One step of SGD with momentum in the reference's order
    (``m = 0.9 m + g``, then ``p -= lr m``), in place on ``params`` (leaves
    that require grad) and ``mom`` (one buffer per leaf, in ``_leaves``
    order). Returns the loss before the step."""
    leaves = _leaves(params)
    loss = tiny_loss(cfg, params, tokens, labels)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        torch._foreach_mul_(mom, 0.9)
        torch._foreach_add_(mom, grads)
        torch._foreach_sub_(leaves, torch._foreach_mul(mom, lr))
    return loss.detach()


def train_tiny(cfg: TinyClassifierConfig, tokens: np.ndarray,
               labels: np.ndarray, steps: int = 300, batch: int = 128,
               lr: float = 3e-3, seed: int = 0, device="cuda") -> Dict:
    """``steps`` of ``sgd_step`` from ``init_tiny(cfg, seed)`` on
    ``device``, batch indices from ``np.random.default_rng(seed)`` as the
    reference draws them."""
    params = _tree_map(init_tiny(cfg, seed, device),
                       lambda t: t.requires_grad_(True))
    mom = [torch.zeros_like(t) for t in _leaves(params)]
    dev = mom[0].device
    tok = torch.from_numpy(np.ascontiguousarray(tokens)).to(dev)
    lab = torch.from_numpy(np.ascontiguousarray(labels)).to(dev)
    rng = np.random.default_rng(seed)
    n = len(tokens)
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, batch)).to(dev)
        sgd_step(cfg, params, mom, tok[idx], lab[idx], lr)
    return _tree_map(params, lambda t: t.detach())


# per-size training budgets: capacity x steps is what separates the family
# on the hard (positional) half of the task — the Fig. 1 accuracy spread
_FAMILY_STEPS = (400, 500, 700, 1000, 1400)
_FAMILY_LR = (2e-2, 2e-2, 1e-2, 8e-3, 5e-3)


def train_tiny_family(n_train: int = 3072, n_val: int = 1024,
                      seed: int = 0, cache_path: str = "",
                      family: Tuple[TinyClassifierConfig, ...] = TINY_FAMILY,
                      steps_scale: float = 1.0, device="cuda"
                      ) -> Tuple[Dict[str, Dict], Dict[str, np.ndarray],
                                 np.ndarray, np.ndarray]:
    """Train the family on ``device``; returns (params_by_name,
    val_scores_by_name, val_tokens, val_labels). With ``cache_path``,
    loads/saves an .npz artifact (the reference's format) so later runs
    don't retrain."""
    device = resolve_device(device)
    if cache_path and os.path.exists(cache_path):
        return load_tiny_family(cache_path, family, device)
    tok_tr, lab_tr, _ = synthetic_classification_data(n_train, seed=seed)
    tok_va, lab_va, _ = synthetic_classification_data(n_val, seed=seed + 1)
    params_by, scores_by = {}, {}
    tok_va_dev = torch.from_numpy(tok_va).to(device)
    for i, cfg in enumerate(family):
        params = train_tiny(
            cfg, tok_tr, lab_tr,
            steps=max(1, int(_FAMILY_STEPS[i % 5] * steps_scale)),
            lr=_FAMILY_LR[i % 5], batch=64, seed=seed + i, device=device)
        params_by[cfg.name] = params
        with torch.no_grad():
            scores_by[cfg.name] = apply_tiny(cfg, params,
                                             tok_va_dev).cpu().numpy()
    if cache_path:
        save_tiny_family(cache_path, params_by, scores_by, tok_va, lab_va)
    return params_by, scores_by, tok_va, lab_va


# ---------------------------------------------------------------------------
# The .npz artifact, in the reference's leaf order
# ---------------------------------------------------------------------------

def _leaves(params: Dict) -> List:
    """Leaves in ``jax.tree_util.tree_flatten`` order for these dicts (keys
    sorted at every level): every block's ``w1, w2, wk, wo, wq, wv`` in
    block order, then ``embed``, ``head``, ``pos``."""
    out = []
    for blk in params["blocks"]:
        out += [blk[k] for k in sorted(blk)]
    return out + [params[k] for k in sorted(params) if k != "blocks"]


def _unflatten(template: Dict, leaves: List) -> Dict:
    """Inverse of ``_leaves`` over ``template``'s structure."""
    it = iter(leaves)
    blocks = [{k: next(it) for k in sorted(blk)}
              for blk in template["blocks"]]
    out = {k: next(it) for k in sorted(template) if k != "blocks"}
    out["blocks"] = blocks
    return out


def _tree_map(params: Dict, fn) -> Dict:
    return _unflatten(params, [fn(t) for t in _leaves(params)])


def _template(cfg: TinyClassifierConfig) -> Dict:
    """The params' structure (leaf values unused)."""
    return {"embed": None, "pos": None, "head": None,
            "blocks": [dict.fromkeys(("wq", "wk", "wv", "wo", "w1", "w2"))
                       for _ in range(cfg.num_layers)]}


def save_tiny_family(path: str, params_by: Dict, scores_by: Dict,
                     tok_va: np.ndarray, lab_va: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat: Dict[str, np.ndarray] = {"val_tokens": tok_va, "val_labels": lab_va}
    for name, params in params_by.items():
        for i, leaf in enumerate(_leaves(params)):
            flat[f"p::{name}::{i}"] = leaf.detach().cpu().numpy()
        flat[f"s::{name}"] = scores_by[name]
    np.savez_compressed(path, **flat)


def load_tiny_family(path: str,
                     family: Tuple[TinyClassifierConfig, ...] = TINY_FAMILY,
                     device="cuda"
                     ) -> Tuple[Dict, Dict, np.ndarray, np.ndarray]:
    device = resolve_device(device)
    with np.load(path) as data:
        tok_va, lab_va = data["val_tokens"], data["val_labels"]
        params_by, scores_by = {}, {}
        for cfg in family:
            template = _template(cfg)
            loaded = [torch.from_numpy(data[f"p::{cfg.name}::{i}"]).to(device)
                      for i in range(len(_leaves(template)))]
            params_by[cfg.name] = _unflatten(template, loaded)
            scores_by[cfg.name] = data[f"s::{cfg.name}"]
    return params_by, scores_by, tok_va, lab_va


def make_engine_backend(params_by: Dict, scores_by: Dict,
                        tok_va: np.ndarray, lab_va: np.ndarray,
                        family: Tuple[TinyClassifierConfig, ...]
                        = TINY_FAMILY,
                        batch_sizes: Tuple[int, ...] = (1, 4, 16, 64),
                        seq_len: int = 32, repeats: int = 3):
    """EngineBackend over a trained tiny family with measured profiles
    attached via the unified ``profile_backend`` entry point — the ONE
    assembly of engines + token/label pools + profiles (the argument order
    matches ``train_tiny_family``/``load_tiny_family`` returns, so
    ``make_engine_backend(*train_tiny_family(...))`` works). The engines
    run where the params lie."""
    from repro_torch.core.execution import EngineBackend, profile_backend
    from repro_torch.serving.engine import InferenceEngine
    engines = {cfg.name: InferenceEngine(
        cfg.name, lambda p, t, c=cfg: apply_tiny(c, p, t),
        params_by[cfg.name]) for cfg in family}
    backend = EngineBackend(engines, tokens=tok_va, labels=lab_va)
    backend.profiles = {
        cfg.name: profile_backend(
            backend, cfg.name, batch_sizes=batch_sizes, seq_len=seq_len,
            repeats=repeats,
            validation=validation_record_from_scores(
                scores_by[cfg.name], lab_va))
        for cfg in family}
    return backend


def validation_record_from_scores(scores: np.ndarray, labels: np.ndarray,
                                  estimator: str = "top2_gap"
                                  ) -> ValidationRecord:
    """Host scores -> the planner's validation record; the estimator
    reduces the numpy scores on the host (bit-equal to the reference's
    ``top2_gap``)."""
    est = resolve_estimator(estimator)
    certs = np.asarray(est(scores))
    correct = scores.argmax(-1) == labels
    return ValidationRecord(certs=certs, correct=correct,
                            preds=scores.argmax(-1))
