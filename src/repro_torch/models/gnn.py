"""PNA (Principal Neighbourhood Aggregation, arXiv:2004.05718).

A port of the JAX package's ``models/gnn.py`` for one device. Message
passing is segment ops over an edge index (src -> dst): sums with
``index_add_``, the max and min with ``scatter_reduce`` (``amax``/``amin``,
the target's own values excluded) masked to 0 where a node has no in-edge,
as the JAX ``segment_max``/``segment_min`` are. A max or min's gradient is
split evenly over tied messages in both frameworks.

PNA layer (degree-general):
  m_ij   = M([h_i ; h_j])                      per-edge message (pre-MLP)
  agg    = [mean | max | min | std]_j m_ij     4 aggregators
  scaled = [agg ; agg*amp(d_i) ; agg*att(d_i)] 3 degree scalers
  h_i'   = U([h_i ; scaled])                   post-MLP update

Shapes served: full-graph training (Cora scale), fanout-sampled
mini-batching (Reddit scale; :class:`NeighborSampler` is a host op) and
batched small molecule graphs (graph-level mean-pool readout).

:func:`param_specs` declares the params replicated; edges are the sharded
quantity. The node-sharded form (``mesh=``/``node_axes=``, the JAX
``shard_map`` one): :func:`partition_edges` splits the edges by their
destination's node range on the host, and :func:`forward_sharded` runs on
each rank of ``node_axes`` its rows of every node tensor. Per layer (one
checkpoint each) the rank all-gathers ``h`` (the halo exchange; in bf16
on the wire with ``halo_bf16``), then :func:`_pna_layer_local` (the rank
body) computes its edge shard's messages and aggregates them into its own
node range only. The segment ops of the body get one spare row that
collects the padding edges (``dst`` = the local row count) and is cut
off, where JAX's ``segment_*`` drop an out-of-range id: ``index_add_`` and
``scatter_reduce`` raise on the CPU and assert on the card for one
(ROADMAP C32). JAX's ``forward(mesh=, node_axes=)`` node constraint (a
``with_sharding_constraint``) is a layout hint to XLA with no eager
counterpart: :func:`forward` runs the global program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sharding import P
from repro_torch.launch import mesh as M
from repro_torch.models.common import fold_in, he_init, softmax_xent

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str
    n_layers: int
    d_in: int
    d_hidden: int
    n_classes: int
    delta: float = 2.5          # avg log-degree normalizer (dataset statistic)
    graph_level: bool = False   # molecule: mean-pool readout + graph labels
    dtype: Any = torch.float32
    halo_bf16: bool = False     # compress the halo all-gather to bf16


N_AGG = 4     # mean, max, min, std
N_SCALE = 3   # identity, amplification, attenuation


def param_shapes(c: PNAConfig) -> Dict[str, Tuple[int, ...]]:
    shapes: Dict[str, Tuple[int, ...]] = {"in_w": (c.d_in, c.d_hidden), "in_b": (c.d_hidden,)}
    for i in range(c.n_layers):
        shapes[f"l{i}_msg_w"] = (2 * c.d_hidden, c.d_hidden)
        shapes[f"l{i}_msg_b"] = (c.d_hidden,)
        shapes[f"l{i}_upd_w"] = (c.d_hidden * (1 + N_AGG * N_SCALE), c.d_hidden)
        shapes[f"l{i}_upd_b"] = (c.d_hidden,)
    shapes["out_w"] = (c.d_hidden, c.n_classes)
    shapes["out_b"] = (c.n_classes,)
    return shapes


def abstract_params(c: PNAConfig) -> Params:
    """The params as ``meta`` tensors of ``c.dtype`` (no memory)."""
    return {k: torch.empty(s, dtype=c.dtype, device="meta") for k, s in param_shapes(c).items()}


def init_params(c: PNAConfig, generator: torch.Generator) -> Params:
    """Params on ``generator``'s device: He-normal matrices, zero biases.
    Param ``i`` of ``param_shapes`` draws from a generator seeded from
    ``generator``'s seed and ``i`` (JAX's ``fold_in(key, i)``; the bits are
    not JAX's)."""
    dev, seed = generator.device, generator.initial_seed()
    params = {}
    for i, (name, shape) in enumerate(param_shapes(c).items()):
        if name.endswith("_b"):
            params[name] = torch.zeros(shape, dtype=c.dtype, device=dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(fold_in(seed, i))
            params[name] = he_init(gen, shape, c.dtype)
    return params


def params_from_jax(np_params: Mapping[str, Any], device) -> Params:
    """Carry JAX PNA params (arrays or numpy) over to ``device``, bit for bit."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in np_params.items()}


# ------------------------------------------------------------ segment ops
def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((n,) + data.shape[1:], dtype=data.dtype,
                       device=data.device).index_add_(0, ids, data)


def _segment_extreme(data: torch.Tensor, ids: torch.Tensor, n: int, reduce: str) -> torch.Tensor:
    """``amax``/``amin`` of each segment's rows; a segment with no row
    keeps 0 (its rows are masked by the caller as JAX's are)."""
    idx = ids[:, None].expand_as(data)
    return torch.zeros((n,) + data.shape[1:], dtype=data.dtype, device=data.device
                       ).scatter_reduce(0, idx, data, reduce, include_self=False)


# ------------------------------------------------------------------ model
def pna_layer(params: Params, i: int, h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              c: PNAConfig, n_nodes: int) -> torch.Tensor:
    """One PNA layer over edge lists (src -> dst, int64)."""
    msg_in = torch.cat([h[dst], h[src]], dim=-1)                 # (E, 2D)
    m = torch.relu(msg_in @ params[f"l{i}_msg_w"] + params[f"l{i}_msg_b"])

    deg = segment_sum(torch.ones((m.shape[0],), dtype=m.dtype, device=m.device), dst, n_nodes)
    deg_safe = torch.clamp_min(deg, 1.0)
    has = (deg > 0)[:, None]

    s = segment_sum(m, dst, n_nodes)
    mean = s / deg_safe[:, None]
    mx = torch.where(has, _segment_extreme(m, dst, n_nodes, "amax"), 0.0)
    mn = torch.where(has, _segment_extreme(m, dst, n_nodes, "amin"), 0.0)
    sq = segment_sum(m * m, dst, n_nodes) / deg_safe[:, None]
    var = sq - mean * mean
    # jnp.maximum's gradient: split evenly where var is exactly 0 (a node of
    # one in-edge, or of equal messages), as torch.maximum's and not clamp's
    std = torch.sqrt(torch.maximum(var, torch.zeros_like(var)) + 1e-5)

    agg = torch.cat([mean, mx, mn, std], dim=-1)                 # (N, 4D)
    logd = torch.log1p(deg)[:, None]
    amp = logd / c.delta
    att = c.delta / torch.clamp_min(logd, 1e-5)
    scaled = torch.cat([agg, agg * amp, agg * att], dim=-1)      # (N, 12D)

    upd_in = torch.cat([h, scaled], dim=-1)
    return torch.relu(upd_in @ params[f"l{i}_upd_w"] + params[f"l{i}_upd_b"])


def forward(params: Params, c: PNAConfig, batch: Mapping[str, Any]) -> torch.Tensor:
    """batch: features (N, d_in), edge src/dst (E,), [graph_ids (N,),
    n_graphs (int)]. Returns per-node logits (N, n_classes), or per-graph
    logits with ``c.graph_level``. Under grad each layer is checkpointed.
    JAX's ``forward(mesh=, node_axes=)`` adds a node-sharding constraint, a
    layout hint to XLA with no eager counterpart: this is the global
    program, and :func:`forward_sharded` the node-sharded one."""
    feats = batch["features"]
    src, dst = batch["src"].to(torch.int64), batch["dst"].to(torch.int64)
    n_nodes = feats.shape[0]
    remat = torch.is_grad_enabled()
    h = torch.relu(feats.to(c.dtype) @ params["in_w"] + params["in_b"])
    for i in range(c.n_layers):
        args = (params, i, h, src, dst, c, n_nodes)
        h = checkpoint(pna_layer, *args, use_reentrant=False) if remat else pna_layer(*args)
    if c.graph_level:
        gid = batch["graph_ids"].to(torch.int64)
        n_graphs = int(batch["n_graphs"])
        pooled = segment_sum(h, gid, n_graphs)
        cnt = segment_sum(torch.ones((n_nodes,), dtype=h.dtype, device=h.device), gid, n_graphs)
        h = pooled / torch.clamp_min(cnt, 1.0)[:, None]
    return h @ params["out_w"] + params["out_b"]


def _sharded(c: PNAConfig, mesh, node_axes) -> bool:
    return mesh is not None and node_axes is not None and not c.graph_level


def loss_fn(params: Params, c: PNAConfig, batch: Mapping[str, Any], *, mesh=None,
            node_axes=None) -> torch.Tensor:
    """Mean cross entropy; with ``label_mask`` the mean over its rows.
    Node-sharded (``mesh`` and ``node_axes``, per-node logits): the global
    mean from this rank's rows (:func:`forward_sharded`), summed over the
    ranks; each rank's backward gives its rows' share of the gradient."""
    if not _sharded(c, mesh, node_axes):
        ce = softmax_xent(forward(params, c, batch), batch["labels"])
        mask = batch.get("label_mask")
        if mask is not None:
            return (ce * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        return ce.mean()
    rows = _local_rows(batch["features"].shape[0], mesh, node_axes)
    ce = softmax_xent(forward_sharded(params, c, batch, mesh=mesh, node_axes=node_axes),
                      batch["labels"][rows])
    mask = batch.get("label_mask")
    if mask is not None:
        den = M.psum(mask[rows].sum().detach(), mesh, node_axes)
        return M.psum((ce * mask[rows]).sum(), mesh, node_axes) / torch.clamp_min(den, 1.0)
    return M.psum(ce.sum(), mesh, node_axes) / batch["features"].shape[0]


def make_train_step(c: PNAConfig, optimizer, *, mesh=None, node_axes=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss"})``, the params and state updated in place and returned.
    Node-sharded, every rank takes the global batch and holds the whole
    (replicated) params: the ranks' gradients are summed over
    ``node_axes`` before the update, so every rank updates alike."""
    sharded = _sharded(c, mesh, node_axes)

    def train_step(params: Params, opt_state: Any, batch: Mapping[str, Any]):
        names = sorted(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        with torch.enable_grad():
            loss = loss_fn(leaves, c, batch, mesh=mesh, node_axes=node_axes)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        del leaves
        if sharded:
            grads = [M.psum(g, mesh, node_axes) for g in grads]
        params, opt_state = optimizer.update(params, dict(zip(names, grads)), opt_state)
        return params, opt_state, {"loss": loss.detach()}
    return train_step


def param_specs(c: PNAConfig, *, dp=("data",), tp: str = "model") -> Dict[str, P]:
    """Small model: replicate params; edges are the sharded quantity."""
    return {k: P(*(None,) * len(s)) for k, s in param_shapes(c).items()}


# ------------------------------------------------- distributed (node-sharded)
def partition_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                    n_shards: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Partition edges by dst node range (host-side, part of the FE pipeline).

    Shard k receives edges whose dst lies in [k*rows, (k+1)*rows); every
    shard is padded to the max shard size with OOB edges (dst = n_nodes)
    that the segment ops drop. Returns (src_p, dst_p, per_shard).
    """
    rows = (n_nodes + n_shards - 1) // n_shards
    owner = dst // rows
    order = np.argsort(owner, kind="stable")
    src_s, dst_s, owner_s = src[order], dst[order], owner[order]
    counts = np.bincount(owner_s, minlength=n_shards)
    per_shard = int(counts.max())
    src_p = np.zeros((n_shards, per_shard), src.dtype)
    dst_p = np.full((n_shards, per_shard), n_nodes, dst.dtype)  # OOB padding
    start = 0
    for k in range(n_shards):
        cnt = counts[k]
        src_p[k, :cnt] = src_s[start:start + cnt]
        dst_p[k, :cnt] = dst_s[start:start + cnt]
        start += cnt
    return src_p.reshape(-1), dst_p.reshape(-1), per_shard


def local_dst(dst: torch.Tensor, shard: int, local_rows: int) -> torch.Tensor:
    """Shard ``shard``'s edge destinations as its local rows; any outside
    its range (the padding) -> ``local_rows``, the spare row."""
    d = dst.to(torch.int64) - shard * local_rows
    return torch.where((d >= 0) & (d < local_rows), d, torch.full_like(d, local_rows))


def _pna_layer_local(params_i: Mapping[str, torch.Tensor], h_full: torch.Tensor,
                     h_local: torch.Tensor, src: torch.Tensor, dst_local: torch.Tensor,
                     c: PNAConfig, local_rows: int) -> torch.Tensor:
    """The rank body: one PNA layer over a local edge shard (``src`` global
    rows of ``h_full``, ``dst_local`` from :func:`local_dst`), writing the
    local node range of ``h_local``. ``params_i``: ``msg_w``, ``msg_b``,
    ``upd_w``, ``upd_b`` of the layer."""
    n = local_rows + 1                                             # + the spare row
    h_dst = h_local[torch.clamp_max(dst_local, local_rows - 1)]
    m = torch.relu(torch.cat([h_dst, h_full[src]], dim=-1) @ params_i["msg_w"]
                   + params_i["msg_b"])
    ones = (dst_local < local_rows).to(m.dtype)
    m = m * ones[:, None]
    deg = segment_sum(ones, dst_local, n)[:local_rows]
    deg_safe = torch.clamp_min(deg, 1.0)
    has = (deg > 0)[:, None]
    mean = segment_sum(m, dst_local, n)[:local_rows] / deg_safe[:, None]
    mx = torch.where(has, _segment_extreme(m, dst_local, n, "amax")[:local_rows], 0.0)
    mn = torch.where(has, _segment_extreme(m, dst_local, n, "amin")[:local_rows], 0.0)
    sq = segment_sum(m * m, dst_local, n)[:local_rows] / deg_safe[:, None]
    var = sq - mean * mean
    std = torch.sqrt(torch.maximum(var, torch.zeros_like(var)) + 1e-5)
    agg = torch.cat([mean, mx, mn, std], dim=-1)
    logd = torch.log1p(deg)[:, None]
    scaled = torch.cat([agg, agg * logd / c.delta, agg * c.delta / torch.clamp_min(logd, 1e-5)],
                       dim=-1)
    upd_in = torch.cat([h_local, scaled], dim=-1)
    return torch.relu(upd_in @ params_i["upd_w"] + params_i["upd_b"])


def layer_params(params: Mapping[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s params under the body's names (``msg_w`` ...)."""
    return {k.split("_", 1)[1]: v for k, v in params.items() if k.startswith(f"l{i}_")}


def halo(h_local: torch.Tensor, c: PNAConfig, mesh, node_axes) -> torch.Tensor:
    """Every rank's ``h`` rows, gathered (bf16 on the wire with
    ``c.halo_bf16``)."""
    if c.halo_bf16:
        return M.all_gather(h_local.to(torch.bfloat16), mesh, node_axes).to(h_local.dtype)
    return M.all_gather(h_local, mesh, node_axes)


def _local_rows(n_nodes: int, mesh, node_axes) -> slice:
    n = n_nodes // M.axis_size(mesh, node_axes)
    i = M.axis_index(mesh, node_axes)
    return slice(i * n, (i + 1) * n)


def forward_sharded(params: Params, c: PNAConfig, batch: Mapping[str, Any], *, mesh,
                    node_axes: Tuple[str, ...]) -> torch.Tensor:
    """Node-sharded PNA: per-node logits of this rank's node rows.

    ``batch`` is the global one: ``features`` (N, d_in) with N a multiple
    of the rank count over ``node_axes``, ``src``/``dst`` from
    :func:`partition_edges` (shard k's edges at ``[k * per, (k+1) * per)``).
    The rank computes ``h`` for its N / n rows only; per layer (under a
    checkpoint, as JAX's ``jax.checkpoint`` of the layer) it all-gathers
    ``h`` and runs :func:`_pna_layer_local` on its edges.
    """
    feats = batch["features"]
    n_nodes = feats.shape[0]
    n_shards = M.axis_size(mesh, node_axes)
    idx = M.axis_index(mesh, node_axes)
    local_rows = n_nodes // n_shards
    per = batch["src"].shape[0] // n_shards
    src = batch["src"][idx * per:(idx + 1) * per].to(torch.int64)
    dst_local = local_dst(batch["dst"][idx * per:(idx + 1) * per], idx, local_rows)
    x = feats[idx * local_rows:(idx + 1) * local_rows]
    h = torch.relu(x.to(c.dtype) @ params["in_w"] + params["in_b"])
    remat = torch.is_grad_enabled()

    def layer(i, h_loc):
        return _pna_layer_local(layer_params(params, i), halo(h_loc, c, mesh, node_axes),
                                h_loc, src, dst_local, c, local_rows)

    for i in range(c.n_layers):
        h = checkpoint(layer, i, h, use_reentrant=False) if remat else layer(i, h)
    return h @ params["out_w"] + params["out_b"]


# ----------------------------------------------------------- host sampler
class NeighborSampler:
    """Fanout neighbor sampler over a CSR adjacency (host op, numpy).

    GraphSAGE-style [arXiv:1706.02216]: for each seed, sample ``fanout[0]``
    neighbors, then ``fanout[1]`` of each of those, etc. Returns the union
    subgraph with node ids remapped densely — note the remap IS a dedup
    (the FeatureBox working-set construction applied to graph nodes).
    """

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, *, seed: int = 0):
        self.indptr = indptr
        self.indices = indices
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def from_edges(n_nodes: int, src: np.ndarray, dst: np.ndarray, **kw) -> "NeighborSampler":
        order = np.argsort(dst, kind="stable")
        src_sorted = src[order]
        counts = np.bincount(dst, minlength=n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        return NeighborSampler(indptr.astype(np.int64), src_sorted.astype(np.int64), **kw)

    def sample(self, seeds: np.ndarray, fanout: Tuple[int, ...]):
        """Returns (node_ids, src_local, dst_local, seed_local)."""
        nodes = list(seeds)
        node_set = {int(n): i for i, n in enumerate(seeds)}
        src_l: List[int] = []
        dst_l: List[int] = []
        frontier = list(seeds)
        for f in fanout:
            nxt: List[int] = []
            for u in frontier:
                lo, hi = self.indptr[u], self.indptr[u + 1]
                neigh = self.indices[lo:hi]
                if len(neigh) == 0:
                    continue
                take = neigh if len(neigh) <= f else self.rng.choice(neigh, f, replace=False)
                for v in take:
                    v = int(v)
                    if v not in node_set:
                        node_set[v] = len(nodes)
                        nodes.append(v)
                        nxt.append(v)
                    src_l.append(node_set[v])
                    dst_l.append(node_set[int(u)])
            frontier = nxt
        return (np.asarray(nodes, np.int64), np.asarray(src_l, np.int32),
                np.asarray(dst_l, np.int32),
                np.arange(len(seeds), dtype=np.int32))


def random_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
                 *, seed: int = 0) -> Dict[str, np.ndarray]:
    """Synthetic graph batch for smokes/benches."""
    rng = np.random.default_rng(seed)
    return {
        "features": rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
        "src": rng.integers(0, n_nodes, n_edges).astype(np.int32),
        "dst": rng.integers(0, n_nodes, n_edges).astype(np.int32),
        "labels": rng.integers(0, n_classes, n_nodes).astype(np.int32),
    }
