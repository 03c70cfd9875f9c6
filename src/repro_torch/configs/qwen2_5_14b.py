"""qwen2.5-14b: 48L d5120 40H (GQA kv=8) d_ff=13824 vocab=152064, QKV bias."""

import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40, n_kv=8,
    d_ff=13824, vocab=152064, head_dim=128, qkv_bias=True,
    rope_base=1_000_000.0, dtype=torch.bfloat16, grad_accum=8,
)


def smoke():
    return LMConfig(
        name="qwen2.5-14b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_ff=96, vocab=256, head_dim=16, qkv_bias=True,
        dtype=torch.float32, q_block=16, kv_block=16, loss_chunk=16,
    )


ARCH = ArchSpec(
    arch_id="qwen2.5-14b", family="lm", config=CONFIG, smoke=smoke,
    describe="GQA dense transformer with QKV bias",
)
