"""deepseek-v2-236b: 60L d5120 128H MLA kv_lora=512, MoE 2 shared + 160
routed top-6 (d_ff_expert=1536), vocab=102400 [arXiv:2405.04434]."""

import functools

import torch

from repro_torch.configs.base import ArchSpec, lm_cell
from repro_torch.models.attention import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128, n_kv=128,
    d_ff=12288,  # layer-0 dense FFN (first_k_dense_replace=1)
    vocab=102400, head_dim=128,
    attn="mla",
    mla=MLAConfig(d_model=5120, n_heads=128, q_lora_rank=1536,
                  kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2,
                  capacity_factor=1.25, shard_ff_over_data=True),
    first_k_dense=1,
    dtype=torch.bfloat16, grad_accum=16, accum_dtype=torch.bfloat16,
)


def smoke():
    return LMConfig(
        name="deepseek-v2-smoke", n_layers=3, d_model=64, n_heads=4, n_kv=4,
        d_ff=128, vocab=256,
        attn="mla",
        mla=MLAConfig(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=2,
                      capacity_factor=2.0),
        first_k_dense=1,
        dtype=torch.float32, q_block=16, kv_block=16, loss_chunk=16,
    )


ARCH = ArchSpec(
    arch_id="deepseek-v2-236b", family="lm", config=CONFIG,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    build_cell=functools.partial(lm_cell, CONFIG),
    smoke=smoke,
    describe="MLA + fine-grained MoE (2 shared + 160 routed top-6)",
)
