"""Hand-written CUDA kernels for the serving path, with their plain
PyTorch versions (port of ``repro/kernels``).

top2gap          — the paper's Eq. 5 certainty gap and the greedy argmax
decode_attention — one-token GQA attention over the model's KV cache
flash_attention  — causal / windowed prefill attention with GQA
flash_attention_bwd — its backward (dq, dk, dv), behind the forward's
                   autograd Function; no TPU counterpart
mamba_scan       — the Mamba-1 selective scan of an SSM prefill or
                   training step
mamba_scan_bwd   — its backward (ddt, dA, dB, dC, dD, dx, dh0), behind
                   the forward's autograd Function; no TPU counterpart
mamba_conv_step  — the Mamba-1 decode step's conv, its state shifted in
                   place; no TPU counterpart
mamba_ssm_step   — the decode step's SSM recurrence, its state written in
                   place, and the gate; no TPU counterpart

Each wrapper runs its plain version (``ref``) for a CPU tensor and its
kernel for a CUDA tensor, and counts the kernel's launches in its
``launches`` attribute (``counts``); a replay of a CUDA graph that holds
the kernel counts too, once per launch it replays. ``build`` compiles
``csrc/*.cu`` with nvcc.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import counts as _counts
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import mamba_step as _step
from repro_torch.kernels import top2gap as _top2gap

__all__ = ["WRAPPERS", "launch_counts", "reset_launch_counts"]

# kernel name -> wrapper (each carries an integer ``launches`` count)
WRAPPERS = {
    "top2gap": _top2gap.top2gap,
    "decode_attention": _decode.decode_attention,
    "flash_attention": _flash.flash_attention,
    "flash_attention_bwd": _flash.flash_attention_bwd,
    "mamba_scan": _mamba.mamba_scan,
    "mamba_scan_bwd": _mamba.mamba_scan_bwd,
    "mamba_conv_step": _step.mamba_conv_step,
    "mamba_ssm_step": _step.mamba_ssm_step,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    _counts.reset(WRAPPERS.values())
