"""dcn-v2: 13 dense + 26 sparse, embed 16, 3 cross layers, deep 1024-1024-512
[arXiv:2008.13535]."""

from repro_torch.configs import ArchSpec
from repro_torch.models.recsys import CRITEO_1TB_VOCABS, RecsysConfig

CONFIG = RecsysConfig(
    name="dcn-v2", kind="dcnv2", n_dense=13, n_sparse=26, embed_dim=16,
    vocab_sizes=CRITEO_1TB_VOCABS,
    n_cross_layers=3, top_mlp=(1024, 1024, 512),
)


def smoke():
    return RecsysConfig(
        name="dcnv2-smoke", kind="dcnv2", n_dense=13, n_sparse=6, embed_dim=8,
        vocab_sizes=(64, 32, 100, 16, 8, 40),
        n_cross_layers=3, top_mlp=(64, 32), dedup_capacity=512,
    )


ARCH = ArchSpec(
    arch_id="dcn-v2", family="recsys", config=CONFIG, smoke=smoke,
    describe="DCN-v2 cross network (full-rank crosses) + deep tower",
)
