"""autoint: 39 sparse fields (13 bucketized dense + 26 categorical), embed 16,
3 self-attention layers, 2 heads, d_attn=32 [arXiv:1810.11921].

AutoInt was evaluated on Criteo-Kaggle; vocabularies follow that scale
(frequency-thresholded), with the 13 dense features bucketized to 100 bins.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models.recsys import CRITEO_1TB_VOCABS, RecsysConfig

# 13 bucketized dense (100 bins) + 26 categorical capped at Kaggle scale
VOCABS = tuple([100] * 13) + tuple(min(v, 100_000) for v in CRITEO_1TB_VOCABS)

CONFIG = RecsysConfig(
    name="autoint", kind="autoint", n_dense=0, n_sparse=39, embed_dim=16,
    vocab_sizes=VOCABS,
    n_attn_layers=3, n_heads=2, d_attn=32,
)


def smoke():
    return RecsysConfig(
        name="autoint-smoke", kind="autoint", n_dense=0, n_sparse=8, embed_dim=8,
        vocab_sizes=(30,) * 8,
        n_attn_layers=2, n_heads=2, d_attn=8, dedup_capacity=256,
    )


ARCH = ArchSpec(
    arch_id="autoint", family="recsys", config=CONFIG, smoke=smoke,
    describe="AutoInt field self-attention interaction",
)
