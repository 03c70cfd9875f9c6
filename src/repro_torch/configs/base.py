"""The GNN shapes of the JAX package's ``configs/base.py``.

Only ``GNN_SHAPES`` and :func:`gnn_config_for` are ported: the ``pna`` arch
picks its per-dataset widths from them. The JAX module's dry-run cell
machinery (``Cell``, ``lm_cell``, ``recsys_cell``, ``gnn_cell``, the
shardings and the abstract inputs) goes with the dry run (ROADMAP A item
4(c)).
"""

from __future__ import annotations

from repro_torch.models import gnn as G

# =============================================================== GNN family
GNN_SHAPES = {
    "full_graph_sm": {"kind": "full", "n_nodes": 2708, "n_edges": 10556,
                      "d_feat": 1433, "n_classes": 7},
    "minibatch_lg": {"kind": "sampled", "seeds": 1024, "fanout": (15, 10),
                     "d_feat": 602, "n_classes": 41},
    "ogb_products": {"kind": "full", "n_nodes": 2449029, "n_edges": 61859140,
                     "d_feat": 100, "n_classes": 47},
    "molecule": {"kind": "graphs", "n_graphs": 128, "nodes_per": 30,
                 "edges_per": 64, "d_feat": 28, "n_classes": 2},
}


def gnn_config_for(base_name: str, shape: str, *, n_layers=4, d_hidden=75) -> G.PNAConfig:
    info = GNN_SHAPES[shape]
    return G.PNAConfig(
        name=f"{base_name}", n_layers=n_layers, d_in=info["d_feat"],
        d_hidden=d_hidden, n_classes=info["n_classes"],
        graph_level=(info["kind"] == "graphs"),
    )
