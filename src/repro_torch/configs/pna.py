"""pna: Principal Neighbourhood Aggregation, 4 layers d_hidden=75,
aggregators mean/max/min/std, scalers id/amp/atten [arXiv:2004.05718].

d_in / n_classes are per-dataset (per shape); see configs.base.GNN_SHAPES.
``CONFIG`` is the published width at the ``full_graph_sm`` shape (Cora).
"""

import functools

from repro_torch.configs.base import ArchSpec, gnn_cell, gnn_config_for
from repro_torch.models.gnn import PNAConfig

CONFIG = gnn_config_for("pna", "full_graph_sm")


def smoke():
    return PNAConfig(name="pna-smoke", n_layers=2, d_in=16, d_hidden=24,
                     n_classes=5)


ARCH = ArchSpec(
    arch_id="pna", family="gnn", config=CONFIG,
    shapes=("full_graph_sm", "minibatch_lg", "ogb_products", "molecule"),
    build_cell=functools.partial(gnn_cell, "pna"),
    smoke=smoke,
    describe="PNA multi-aggregator message passing (segment ops)",
)
