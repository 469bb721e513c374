"""The counting functions against figures worked out by hand."""
import numpy as np
import pytest

from portbench import counting, weights

# a dense model small enough to count by hand
DENSE = {"family": "dense", "num_layers": 2, "d_model": 8, "num_heads": 2,
         "num_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab_size": 32,
         "qkv_bias": True, "qk_norm": True, "tie_embeddings": False}
SSM = {"family": "ssm", "num_layers": 2, "d_model": 8, "num_heads": 1,
       "num_kv_heads": 1, "head_dim": 1, "d_ff": 0, "vocab_size": 32,
       "tie_embeddings": False,
       "ssm": {"d_state": 4, "d_conv": 4, "expand": 2, "dt_rank": 2}}


def test_dense_param_bytes():
    # per layer: wq 8x8, wk 8x4, wv 8x4, wo 8x8 = 192; biases 8 + 4 + 4 =
    # 16; ffn 3 x 8 x 16 = 384 -> 592 bf16; norms 8 + 8 + 4 + 4 = 24 f32
    per_layer = 592 * 2 + 24 * 4
    head = 2 * 32 * 8 * 2          # embedding and lm_head
    assert weights.param_bytes(DENSE) == 2 * per_layer + head + 8 * 4


def test_dense_decode_call():
    # two active rows at depths 3 and 5, one step
    flops, nbytes = counting.decode_call(DENSE, [3, 5], 1)
    matmul = 2 * 2 * (8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16)
    attn = 4 * 2 * 2 * 4 * (4 + 6)          # L H hd x keys (4 and 6)
    assert flops == 2 * (matmul + 2 * 8 * 32) + attn
    weights_read = weights.param_bytes(DENSE) - 32 * 8 * 2 + 2 * 8 * 2
    kv = 2 * 2 * 1 * 4 * 2                  # L x (k, v) x KV x hd x bf16
    assert nbytes == weights_read + (4 + 6 + 2) * kv


def test_dense_prefill_call():
    flops, nbytes = counting.prefill_call(DENSE, [3, 5])
    matmul = 2 * 2 * (8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16)
    pairs = 3 * 4 / 2 + 5 * 6 / 2           # causal query-key pairs
    assert flops == 8 * matmul + 2 * (2 * 8 * 32) + 4 * 2 * 2 * 4 * pairs
    weights_read = weights.param_bytes(DENSE) - 32 * 8 * 2 + 8 * 8 * 2
    assert nbytes == weights_read + 8 * 2 * 2 * 1 * 4 * 2


def test_ssm_calls():
    # per layer: in_proj 8x32, x_proj 16x(2+8), dt_proj 2x16, out 16x8
    per = 8 * 32 + 16 * 10 + 2 * 16 + 16 * 8
    tok = 2 * (2 * per + 2 * 4 * 16 + 5 * 16 * 4)
    state = 2 * (3 * 16 * 2 + 16 * 4 * 4)
    flops, nbytes = counting.decode_call(SSM, [7, 9, 11], 2)
    w = weights.param_bytes(SSM) - 32 * 8 * 2 + 3 * 8 * 2
    assert flops == 2 * 3 * (tok + 2 * 8 * 32)
    assert nbytes == 2 * (w + 3 * 2 * state)
    flops, nbytes = counting.prefill_call(SSM, [5])
    assert flops == 5 * tok + 2 * 8 * 32
    assert nbytes == weights.param_bytes(SSM) - 32 * 8 * 2 + 5 * 8 * 2 \
        + state


def test_kernel_launches_match_the_kernel_tables_figures():
    # the decode kernel at qwen3-32b's heads, B 8, valid lengths summing
    # to 2,194, and the scan at B 1, S 200, Di 8,192, N 16: the byte
    # counts of the port's kernel table
    qwen3 = {"family": "dense", "num_layers": 64, "d_model": 5120,
             "num_heads": 64, "num_kv_heads": 8, "head_dim": 128,
             "d_ff": 25600, "vocab_size": 151936}
    valid = np.array([1, 64, 128, 200, 300, 400, 589, 512])
    assert valid.sum() == 2194
    flops, nbytes = counting.decode_attention_launch(qwen3, valid)
    assert nbytes == 9_248_800
    assert flops == 4 * 64 * 128 * 2194
    mamba = {"family": "ssm", "num_layers": 64, "d_model": 4096,
             "num_heads": 1, "num_kv_heads": 1, "head_dim": 1,
             "vocab_size": 65024,
             "ssm": {"d_state": 16, "d_conv": 4, "expand": 2,
                     "dt_rank": 256}}
    exps, nbytes = counting.mamba_scan_launch(mamba, 200)
    assert nbytes == 17_490_944 and exps == 26_214_400
    assert counting.bound_s(nbytes=nbytes, exps=exps) == \
        pytest.approx(0.00627e-3, rel=2e-3)
