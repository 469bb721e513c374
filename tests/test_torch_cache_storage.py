"""Every cache tensor a prefill returns owns its storage: none is a view of
a larger activation, which would keep that activation alive as long as
the cache lives (a decode cache lives for a whole serve).

* ``mamba_prefill`` at B 1 and B 2: the conv tail (K - 1 positions of the
  (B, S, 2 Di) projection) and the SSM state.
* All ten smoke archs: ``prefill`` with every call of ``_apply_block``
  recorded, so each layer kind the arch's prefill uses (attention, the
  SSM mixer, MoE and dense FFNs after them, cross attention) is checked
  on the cache leaves it returns before the caches are stacked, and
  so are the encoder-decoder's cross K/V.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TM

SEQ = 16


def _owns_storage(t: torch.Tensor) -> bool:
    return t.untyped_storage().nbytes() <= t.nbytes


def _batch(cfg, b, s):
    rng = np.random.default_rng(7)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int64))}
    if cfg.is_encoder_decoder:
        batch["source_frames"] = torch.from_numpy(rng.standard_normal(
            (b, 8, cfg.frontend.frontend_dim or cfg.d_model))
            .astype(np.float32))
    if cfg.frontend.kind == "vision":
        batch["prefix_embeddings"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.frontend.num_prefix_embeddings,
             cfg.frontend.frontend_dim)).astype(np.float32))
    return batch


@pytest.mark.parametrize("b", [1, 2])
def test_mamba_prefill_conv_tail_owns_its_storage(b):
    cfg = get_smoke_config("falcon-mamba-7b")
    params = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    p = {k: v[0] for k, v in params["blocks"][0]["mamba"].items()}
    x = torch.randn(b, SEQ, cfg.d_model, generator=torch.Generator()
                    .manual_seed(b))
    with torch.no_grad():
        _, cache = TMB.mamba_prefill(p, cfg, x)
    d_inner = cfg.ssm.expand * cfg.d_model
    assert cache["conv"].shape == (b, cfg.ssm.d_conv - 1, d_inner)
    for name, leaf in cache.items():
        assert leaf.untyped_storage().nbytes() == leaf.nbytes, name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_cache_leaves_own_their_storage(arch, monkeypatch):
    cfg = get_smoke_config(arch)
    params = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    seen, apply = [], TM._apply_block

    def recording(spec, *args, **kwargs):
        x, new_cache, aux = apply(spec, *args, **kwargs)
        for name, leaf in (new_cache or {}).items():
            seen.append((spec.mixer, spec.ffn, name, _owns_storage(leaf)))
        return x, new_cache, aux
    monkeypatch.setattr(TM, "_apply_block", recording)
    with torch.no_grad():
        _, cache = TM.prefill(params, cfg, _batch(cfg, 2, SEQ), 24)
    kinds = {(mixer, ffn) for mixer, ffn, _, _ in seen}
    assert kinds == {(s.mixer, s.ffn) for s in TM.block_pattern(cfg)}
    assert [s for s in seen if not s[-1]] == []
    for blk in cache.get("cross", []):
        for name, leaf in blk.items():
            assert _owns_storage(leaf), ("cross", name)
