"""dlrm-mlperf: MLPerf DLRM (Criteo 1TB): 13 dense + 26 sparse, embed 128,
bot 512-256-128, top 1024-1024-512-256-1, dot interaction [arXiv:1906.00091]."""

import functools

from repro_torch.configs.base import ArchSpec, recsys_cell
from repro_torch.models.recsys import CRITEO_1TB_VOCABS, RecsysConfig

CONFIG = RecsysConfig(
    name="dlrm-mlperf", kind="dlrm", n_dense=13, n_sparse=26, embed_dim=128,
    vocab_sizes=CRITEO_1TB_VOCABS,
    bot_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1),
)


def smoke():
    return RecsysConfig(
        name="dlrm-smoke", kind="dlrm", n_dense=13, n_sparse=6, embed_dim=16,
        vocab_sizes=(64, 32, 100, 16, 8, 40),
        bot_mlp=(32, 16), top_mlp=(64, 32, 1), dedup_capacity=512,
    )


ARCH = ArchSpec(
    arch_id="dlrm-mlperf", family="recsys", config=CONFIG,
    shapes=("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"),
    build_cell=functools.partial(recsys_cell, CONFIG),
    smoke=smoke,
    describe="MLPerf DLRM on Criteo-1TB vocabularies (dot interaction)",
)
