"""PyTorch and CUDA port of CascadeServe: the token-cascade serving path
and the one-shot classifier cascade (profile, plan, serve).

The package mirrors ``repro`` (the JAX/Pallas reference) module by module;
each module names its counterpart in its docstring. It imports torch and
numpy only: never jax and nothing of ``repro``. Where it needs one of the
reference's framework-free modules it keeps its own copy.

Entry points take an explicit ``device`` that defaults to ``"cuda"``; the
CPU is used only when the caller asks for it (the tests do), and then every
kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The entry points' device check: a CUDA device must exist when one
    is asked for (there is no silent move to the CPU); ``"cuda"`` resolves
    to the current CUDA device with its index. On the card, fp32
    matrix products are kept strict: TF32 is switched off for matmuls and
    cuDNN, so fp32 runs compare with the plain versions at fp32 accuracy."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
