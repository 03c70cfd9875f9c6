"""yi-9b: 48L d4096 32H (GQA kv=4) d_ff=11008 vocab=64000 [arXiv:2403.04652]."""

import functools

import torch

from repro_torch.configs.base import ArchSpec, lm_cell
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="yi-9b", n_layers=48, d_model=4096, n_heads=32, n_kv=4,
    d_ff=11008, vocab=64000, head_dim=128, qkv_bias=False,
    rope_base=5_000_000.0, dtype=torch.bfloat16, grad_accum=8,
)


def smoke():
    return LMConfig(
        name="yi-9b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_ff=128, vocab=256, head_dim=16, qkv_bias=False,
        dtype=torch.float32, q_block=16, kv_block=16, loss_chunk=16,
    )


ARCH = ArchSpec(
    arch_id="yi-9b", family="lm", config=CONFIG,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    build_cell=functools.partial(lm_cell, CONFIG),
    smoke=smoke,
    describe="llama-arch GQA dense transformer",
)
