"""deepseek-moe-16b: 28L d2048 16H MoE 2 shared + 64 routed top-6
(d_ff_expert=1408), vocab=102400 [arXiv:2401.06066]."""

import functools

import torch

from repro_torch.configs.base import ArchSpec, lm_cell
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16, n_kv=16,
    d_ff=10944,  # layer-0 dense FFN
    vocab=102400, head_dim=128,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  capacity_factor=1.25),
    first_k_dense=1,
    dtype=torch.bfloat16, grad_accum=8,
)


def smoke():
    return LMConfig(
        name="deepseek-moe-smoke", n_layers=3, d_model=64, n_heads=4, n_kv=4,
        d_ff=128, vocab=256, head_dim=16,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=2,
                      capacity_factor=2.0),
        first_k_dense=1,
        dtype=torch.float32, q_block=16, kv_block=16, loss_chunk=16,
    )


ARCH = ArchSpec(
    arch_id="deepseek-moe-16b", family="lm", config=CONFIG,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    build_cell=functools.partial(lm_cell, CONFIG),
    smoke=smoke,
    describe="fine-grained MoE (2 shared + 64 routed top-6), MHA",
)
