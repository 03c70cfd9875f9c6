"""bst: Behavior Sequence Transformer (Alibaba): embed 32, seq_len 20,
1 block, 8 heads, MLP 1024-512-256 [arXiv:1905.06874].

Fields: item (target, shares the behavior-sequence table), user, category,
context slot — Taobao-scale vocabularies.
"""

import functools

from repro_torch.configs.base import ArchSpec, recsys_cell
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="bst", kind="bst", n_dense=0, n_sparse=4, embed_dim=32,
    vocab_sizes=(4_000_000, 1_000_000, 10_000, 128),  # item, user, category, slot
    seq_len=20, n_blocks=1, n_heads=8, top_mlp=(1024, 512, 256),
    item_field=0,
)


def smoke():
    return RecsysConfig(
        name="bst-smoke", kind="bst", n_dense=0, n_sparse=3, embed_dim=16,
        vocab_sizes=(100, 20, 10),
        seq_len=5, n_blocks=1, n_heads=4, top_mlp=(64, 32),
        dedup_capacity=512,
    )


ARCH = ArchSpec(
    arch_id="bst", family="recsys", config=CONFIG,
    shapes=("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"),
    build_cell=functools.partial(recsys_cell, CONFIG),
    smoke=smoke,
    describe="Behavior Sequence Transformer over user click history",
)
