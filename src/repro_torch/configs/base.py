"""Config substrate: per-(arch x shape) dry-run cells.

A port of the JAX package's ``configs/base.py``. Each architecture file
exports an :class:`ArchSpec`; its ``build_cell(shape, mesh, variant=)``
turns an (arch, shape, mesh) triple into a :class:`Cell`: the step
function, its inputs as ``meta`` tensors (the port's ``ShapeDtypeStruct``:
shape and dtype, no memory) and their shardings over the mesh
(:mod:`repro_torch.core.sharding`), consumed by ``launch/dryrun.py``.

The cells, their inputs, their sharding trees, the exact per-device state
bytes those imply and the analytic model FLOPs are the JAX package's. A
cell's ``fn`` is the port's single-device step of the same function (the
LM ``make_train_step``, ``prefill`` and ``serve_step``; the recsys
``make_train_step``/``make_sparse_train_step``, ``serve_step`` and
``retrieval_score``; ``gnn.make_train_step``) on the whole arguments: the
global program. Beside it, ``per_device`` builds what one device of the
mesh runs where the JAX cell passes ``mesh=`` into a model-parallel form:
the LM cells' ``make_train_step``/``prefill``/``serve_step`` with
``mesh=, dp=, tp=`` (JAX's, ``puredp`` included) and the node-sharded
``gnn.make_train_step(mesh=, node_axes=)`` of the gnn shapes past 100,000
nodes (``ogb_products`` and ``minibatch_lg``'s 169,984, as JAX shards
them), on rank 0's arguments: its params cut by
``shard_params`` under the cell's specs, the optimizer state of those
shards, the decode cache's ``cache_specs`` block (``make_cache(mesh=)``),
and the global batch,
which the mesh forms take and cut themselves. The other cells (recsys;
gnn ``full_graph_sm`` and ``molecule``) have no per-device
call: their JAX ``fn`` is the global program that GSPMD partitions by
``in_shardings``, and where the mesh reaches the model it is a
``with_sharding_constraint`` layout hint; eager PyTorch has no
partitioner, so there is no rank program to run (``per_device_note``
says so). ``hierdedup``'s ``fn`` runs its two-stage dedup over the mesh's
row blocks in one process (``fn_mesh``).

Variants (``--variant``, combined with ``+``) select paper-faithful vs
optimized configurations: LM ``puredp``, ``accumN``, ``lchunkN``, ``qbN``,
``cfN``; recsys ``nodedup``, ``cap_expected``, ``batchall``,
``hierdedup``; gnn ``halo_bf16``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sharding import Mesh, NamedSharding, P
from repro_torch.launch import mesh as M
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass
class Cell:
    """One dry-run unit: fn + abstract args + shardings + roofline metadata.

    JAX's ``out_shardings``, ``donate_argnums`` and ``static_argnames`` are
    left out: they are directions to ``jax.jit``, and the port's steps
    update their state in place. ``config`` is the model config the cell
    was built with (its variants applied), from which
    :func:`repro_torch.launch.dryrun.materialize` draws inputs in range;
    ``fn_mesh`` is the ``{axis: size}`` ``fn`` itself was built over
    (``hierdedup``), else None. ``per_device(mesh) -> (fn, args)``, given a
    ``DeviceMesh`` of the cell's mesh shape (:func:`repro_torch.launch.mesh.
    fake_mesh`), builds the call one rank of it runs and that rank's meta
    arguments; None where the cell has no rank program. ``per_device_note``
    says why not, or what the rank's arguments hold that the cell's
    shardings do not."""

    arch_id: str
    shape_name: str
    fn: Optional[Callable]
    args: Tuple[Any, ...]
    in_shardings: Any
    model_flops: float = 0.0          # analytic 6·N·D (train) / 2·N·D (serve)
    skip: Optional[str] = None
    config: Any = None
    fn_mesh: Optional[Dict[str, int]] = None
    per_device: Optional[Callable[[Any], Tuple[Callable, Tuple[Any, ...]]]] = None
    per_device_note: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                        # "lm" | "recsys" | "gnn"
    config: Any                        # the published full-width config
    shapes: Tuple[str, ...]
    build_cell: Callable[..., Cell]    # (shape, mesh, variant=) -> Cell
    smoke: Callable[[], Any]           # a small config of the same shape class
    describe: str = ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _shard_tree(mesh: Mesh, spec_tree):
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    return {k: _shard_tree(mesh, v) for k, v in spec_tree.items()}


def leaves_by_path(tree, prefix: str = "") -> Dict[str, Any]:
    """``{dotted path: leaf}`` of a nest of dicts (keys sorted, JAX's order;
    a key may itself be dotted, as the optimizers' flat state is), with a
    lone leaf at path ``""``."""
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        out.update(leaves_by_path(tree[k], f"{prefix}.{k}" if prefix else str(k)))
    return out


def map_by_path(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    """The same nest of dicts with each leaf replaced by ``fn(path, leaf)``
    (paths as :func:`leaves_by_path` names them)."""
    if not isinstance(tree, Mapping):
        return fn(prefix, tree)
    return {k: map_by_path(v, fn, f"{prefix}.{k}" if prefix else str(k)) for k, v in tree.items()}


def dp_axes_for(mesh: Mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def count_params(tree) -> int:
    return int(sum(np.prod(leaf.shape) for leaf in leaves_by_path(tree).values()))


# =============================================================== LM family
def lm_active_params(cfg: T.LMConfig) -> float:
    """Active (per-token) parameter count for 6·N·D (MoE counts top-k only)."""
    total = 0.0
    for group, v in T.param_shapes(cfg).items():
        if isinstance(v, dict):
            for name, s in v.items():
                n = float(np.prod(s))
                if name.startswith("moe_w") and cfg.moe:
                    n *= cfg.moe.top_k / cfg.moe.n_experts
                total += n
        elif group != "embed":  # the embedding is a lookup, not a matmul
            total += float(np.prod(v))
    return total


LM_SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "long_decode", "seq": 524288, "batch": 1},
}


def lm_cell(cfg: T.LMConfig, shape: str, mesh: Mesh, *, variant: str = "base") -> Cell:
    info = LM_SHAPES[shape]
    dp = dp_axes_for(mesh)
    tp = "model"
    for v in variant.split("+"):
        if v == "puredp":
            # pure ZeRO-DP mapping of the same mesh: batch over ALL axes,
            # no TP (dense models only; the whole layer fits one chip)
            if cfg.moe is not None:
                raise ValueError("puredp applies to dense LMs only")
            tp = None
            cfg = dataclasses.replace(cfg, grad_accum=1)
        elif v.startswith("accum"):
            cfg = dataclasses.replace(cfg, grad_accum=int(v[len("accum"):]))
        elif v.startswith("lchunk"):
            cfg = dataclasses.replace(cfg, loss_chunk=int(v[len("lchunk"):]))
        elif v.startswith("qb"):
            qb = int(v[2:])
            cfg = dataclasses.replace(cfg, q_block=qb, kv_block=qb)
        elif v.startswith("cf"):
            assert cfg.moe, "capacity-factor variant needs MoE"
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(v[2:]) / 100))
        elif v != "base":
            raise ValueError(f"unknown LM variant {v!r}")
    if info["kind"] == "long_decode":
        return Cell(arch_id=cfg.name, shape_name=shape, fn=None, args=(), in_shardings=None,
                    config=cfg,
                    skip=("full-attention architecture: 524k decode requires "
                          "sub-quadratic attention (DESIGN.md §4)"))

    if tp is None:
        if info["kind"] == "decode":
            # puredp targets train/prefill; decode keeps the standard
            # mapping (its cache shards head_dim over 'model')
            tp = "model"
        else:
            dp = dp + ("model",)  # flatten: batch/weights over every axis
    params = T.abstract_params(cfg)
    specs = T.param_specs(cfg, dp=dp, tp=tp)
    psh = _shard_tree(mesh, specs)
    seq, batch = info["seq"], info["batch"]
    n_active = lm_active_params(cfg)
    rows = NamedSharding(mesh, P(dp, None))
    global_batch = "the batch is the global one: the mesh form cuts each rank's rows itself"
    per_call = batch // cfg.grad_accum if info["kind"] == "train" else batch
    n_dp = int(np.prod([mesh.shape[a] for a in dp]))
    if per_call % n_dp:
        global_batch += (f"; {per_call} rows a call over {n_dp} data ranks: rank 0 holds "
                         f"{T.dp_block(per_call, n_dp)}, the last ranks padding, as GSPMD pads")
        if cfg.moe is not None:
            global_batch += ("; the MoE's token block reaches each rank by the port's own "
                             "all-to-all (GSPMD's reshard in JAX is implicit), so those bytes "
                             "are held to real gloo ranks, not to JAX's compiled bytes")

    if info["kind"] == "train":
        huge = count_params(params) > 5e10
        reduced = torch.bfloat16 if huge else torch.float32
        optimizer = opt_lib.adamw(1e-4, moment_dtype=reduced, compute_dtype=reduced)
        batch_sds = {"tokens": _meta((batch, seq), torch.int32),
                     "labels": _meta((batch, seq), torch.int32)}

        def per_device(dmesh):
            shards = M.shard_params(params, specs, dmesh)
            return (T.make_train_step(cfg, optimizer, mesh=dmesh, dp=dp, tp=tp),
                    (shards, optimizer.abstract_state(shards), batch_sds))

        return Cell(
            arch_id=cfg.name, shape_name=shape, fn=T.make_train_step(cfg, optimizer),
            args=(params, optimizer.abstract_state(params), batch_sds),
            in_shardings=(psh, {"m": psh, "v": psh, "step": NamedSharding(mesh, P())},
                          {"tokens": rows, "labels": rows}),
            model_flops=6.0 * n_active * batch * seq, config=cfg,
            per_device=per_device, per_device_note=global_batch)

    if info["kind"] == "prefill":
        tokens = _meta((batch, seq), torch.int32)
        return Cell(
            arch_id=cfg.name, shape_name=shape,
            fn=lambda params, tokens: T.prefill(params, tokens, cfg),
            args=(params, tokens),
            in_shardings=(psh, rows),
            model_flops=2.0 * n_active * batch * seq, config=cfg,
            per_device=lambda dmesh: (
                lambda p, t: T.prefill(p, t, cfg, mesh=dmesh, dp=dp, tp=tp),
                (M.shard_params(params, specs, dmesh), tokens)),
            per_device_note=global_batch)

    # decode: one new token against a seq-long cache
    token, cache_len = _meta((batch, 1), torch.int32), _meta((), torch.int32)
    return Cell(
        arch_id=cfg.name, shape_name=shape,
        fn=lambda params, token, cache, cache_len: T.serve_step(params, token, cache,
                                                                 cache_len, cfg),
        args=(params, token, T.make_cache(cfg, batch, seq, abstract=True), cache_len),
        in_shardings=(psh, rows, _shard_tree(mesh, T.cache_specs(cfg, dp=dp)),
                      NamedSharding(mesh, P())),
        model_flops=2.0 * n_active * batch,  # one token per sequence
        config=cfg,
        per_device=lambda dmesh: (
            lambda p, t, ca, n: T.serve_step(p, t, ca, n, cfg, mesh=dmesh, dp=dp),
            (M.shard_params(params, specs, dmesh), token,
             T.make_cache(cfg, batch, seq, abstract=True, mesh=dmesh, dp=dp, tp=tp), cache_len)),
        per_device_note=global_batch)


# ============================================================ RecSys family
RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "serve", "batch": 262144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1, "candidates": 1_000_000},
}


def recsys_dedup_cap(c: R.RecsysConfig, n_rows_per_field: int, seq_rows: int = 0) -> int:
    """Exact upper bound on unique ids: sum over fields of min(B, vocab)."""
    cap = sum(min(n_rows_per_field, v) for v in c.vocab_sizes)
    cap += min(seq_rows, c.vocab_sizes[c.item_field])
    return int(cap)


def recsys_batch_sds(c: R.RecsysConfig, batch: int) -> Dict[str, torch.Tensor]:
    sds = {"sparse": _meta((batch, c.n_sparse), torch.int32),
           "label": _meta((batch,), torch.float32)}
    if c.n_dense:
        sds["dense"] = _meta((batch, c.n_dense), torch.float32)
    if c.kind == "bst":
        sds["seq"] = _meta((batch, c.seq_len), torch.int32)
    return sds


def recsys_dense_flops(c: R.RecsysConfig) -> float:
    """Per-example dense-net forward FLOPs (2·params of the towers)."""
    n = 0.0
    for name, s in R.param_shapes(c).items():
        if name != "embed" and len(s) == 2:
            n += float(np.prod(s))
    return 2.0 * n


def _rows_sharding(mesh: Mesh, axes, sds: Mapping[str, torch.Tensor]) -> Dict[str, NamedSharding]:
    return {k: NamedSharding(mesh, P(axes) if v.dim() == 1 else P(axes, None))
            for k, v in sds.items()}


GLOBAL_ONLY = ("no per-device call: JAX's fn is the global program, which GSPMD partitions "
               "by in_shardings (the mesh reaches the model at most as a "
               "with_sharding_constraint layout hint), and eager PyTorch has no partitioner")


def recsys_cell(cfg: R.RecsysConfig, shape: str, mesh: Mesh, *, variant: str = "base") -> Cell:
    info = RECSYS_SHAPES[shape]
    dp = dp_axes_for(mesh)
    all_axes = dp + ("model",)
    flags = set(variant.split("+"))
    unknown = flags - {"base", "nodedup", "cap_expected", "batchall", "hierdedup"}
    if unknown:
        raise ValueError(f"unknown recsys variant parts {unknown}")
    if "nodedup" in flags:
        cfg = dataclasses.replace(cfg, dedup_lookup=False)
    batch_axes = all_axes if "batchall" in flags else dp

    batch = info.get("batch", 1)
    seq_rows = batch * (cfg.seq_len + 1) if cfg.kind == "bst" else 0
    if "cap_expected" in flags:
        # expected-unique capacity (x1.15 safety) instead of the worst-case
        # sum(min(B, v)) — the same E[unique] model the streaming driver's
        # dedup_capacity_hint(mode="expected") uses
        from repro_torch.embedding.dedup import expected_unique
        exp = sum(expected_unique(batch, v) for v in cfg.vocab_sizes)
        if cfg.kind == "bst":
            exp += expected_unique(seq_rows, cfg.vocab_sizes[cfg.item_field])
        cap = int(exp * 1.15)
    else:
        cap = recsys_dedup_cap(cfg, batch, seq_rows)
    # round capacity to device-count multiple for clean sharding
    nd = mesh.size
    cap = (cap + nd - 1) // nd * nd
    cfg = dataclasses.replace(cfg, dedup_capacity=cap)

    params = R.abstract_params(cfg)
    psh = _shard_tree(mesh, R.param_specs(cfg, dp=dp))
    flops1 = recsys_dense_flops(cfg)

    if info["kind"] == "train":
        sds = recsys_batch_sds(cfg, batch)
        fn_mesh = None
        if "nodedup" in flags:
            # pre-FeatureBox baseline: dense embedding grads + full-table
            # optimizer state/update (what [37]'s working-set scheme removes)
            optimizer = opt_lib.adamw(1e-3)
            step = R.make_train_step(cfg, optimizer)
            opt_state = optimizer.abstract_state(params)
            osh = {"m": psh, "v": psh, "step": NamedSharding(mesh, P())}
        else:
            dense_opt = opt_lib.adamw(1e-3)
            hier_kw = {}
            if "hierdedup" in flags:
                fn_mesh = mesh.shape
                n_shards = int(np.prod([fn_mesh[a] for a in batch_axes]))
                b_loc = batch // n_shards
                seq_loc = b_loc * (cfg.seq_len + 1) if cfg.kind == "bst" else 0
                hier_kw = {"mesh": fn_mesh, "batch_axes": batch_axes,
                           "local_dedup_capacity": recsys_dedup_cap(cfg, b_loc, seq_loc)}
            step, _ = R.make_sparse_train_step(cfg, dense_opt, **hier_kw)
            opt_state = R.sparse_abstract_state(params, dense_opt)
            dense_psh = {k: v for k, v in psh.items() if k != "embed"}
            osh = {"dense": {"m": dense_psh, "v": dense_psh, "step": NamedSharding(mesh, P())},
                   "embed_accum": NamedSharding(mesh, P(all_axes))}
        return Cell(
            arch_id=cfg.name, shape_name=shape, fn=step, args=(params, opt_state, sds),
            in_shardings=(psh, osh, _rows_sharding(mesh, batch_axes, sds)),
            model_flops=6.0 * flops1 / 2.0 * batch,  # 3x fwd cost, fwd=2*p
            config=cfg, fn_mesh=fn_mesh, per_device_note=GLOBAL_ONLY)

    if info["kind"] == "serve":
        sds = recsys_batch_sds(cfg, batch)
        sds.pop("label")
        return Cell(
            arch_id=cfg.name, shape_name=shape,
            fn=lambda params, batch_: R.serve_step(params, cfg, batch_),
            args=(params, sds), in_shardings=(psh, _rows_sharding(mesh, batch_axes, sds)),
            model_flops=flops1 * batch, config=cfg, per_device_note=GLOBAL_ONLY)

    # retrieval: one user, 10^6 candidates (candidate axis sharded over dp)
    n_cand = info["candidates"]
    cfg = dataclasses.replace(
        cfg, dedup_capacity=recsys_dedup_cap(cfg, 1, seq_rows) + min(
            n_cand, cfg.vocab_sizes[cfg.item_field]))
    user = recsys_batch_sds(cfg, 1)
    user.pop("label")
    ush = {k: NamedSharding(mesh, P(None) if v.dim() == 1 else P(None, None))
           for k, v in user.items()}
    return Cell(
        arch_id=cfg.name, shape_name=shape,
        fn=lambda params, user_, cands_: R.retrieval_score(params, cfg, user_, cands_),
        args=(params, user, _meta((n_cand,), torch.int32)),
        in_shardings=(psh, ush, NamedSharding(mesh, P(dp))),
        model_flops=flops1 * n_cand, config=cfg, per_device_note=GLOBAL_ONLY)


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


def gnn_cell(base_name: str, shape: str, mesh: Mesh, *, variant: str = "base") -> Cell:
    info = GNN_SHAPES[shape]
    dp = dp_axes_for(mesh)
    all_axes = dp + ("model",)
    cfg = gnn_config_for(base_name, shape)
    if variant == "halo_bf16":
        cfg = dataclasses.replace(cfg, halo_bf16=True)
    elif variant != "base":
        raise ValueError(f"unknown gnn variant {variant!r}")
    params = G.abstract_params(cfg)
    psh = _shard_tree(mesh, G.param_specs(cfg))

    if info["kind"] == "sampled":
        n_nodes = info["seeds"] * (1 + info["fanout"][0] * (1 + info["fanout"][1]))
        n_edges = info["seeds"] * info["fanout"][0] * (1 + info["fanout"][1])
    elif info["kind"] == "graphs":
        n_nodes = info["n_graphs"] * info["nodes_per"]
        n_edges = info["n_graphs"] * info["edges_per"]
    else:
        n_nodes, n_edges = info["n_nodes"], info["n_edges"]
    # pad the edge list to a device-count multiple (JAX's padding edges
    # carry dst = n_nodes, which its segment ops drop)
    nd = mesh.size
    n_edges = (n_edges + nd - 1) // nd * nd

    # node tensors: replicate small graphs; shard (and pad) big ones —
    # the (N, 12D) PNA aggregates replicated are ~9 GB/layer at ogb scale
    shard_nodes = n_nodes > 100_000
    node_axes = all_axes if shard_nodes else None
    if shard_nodes:
        n_nodes = (n_nodes + nd - 1) // nd * nd
    node_spec = P(all_axes, None) if shard_nodes else P(None, None)
    node_spec1 = P(all_axes) if shard_nodes else P(None)

    sds = {"features": _meta((n_nodes, info["d_feat"]), torch.float32),
           "src": _meta((n_edges,), torch.int32),
           "dst": _meta((n_edges,), torch.int32)}
    bsh = {"features": NamedSharding(mesh, node_spec),
           "src": NamedSharding(mesh, P(all_axes)),          # edges sharded
           "dst": NamedSharding(mesh, P(all_axes))}
    if info["kind"] == "graphs":
        sds["graph_ids"] = _meta((n_nodes,), torch.int32)
        sds["labels"] = _meta((info["n_graphs"],), torch.int32)
        bsh["graph_ids"] = NamedSharding(mesh, P(None))
        bsh["labels"] = NamedSharding(mesh, P(None))
    else:
        sds["labels"] = _meta((n_nodes,), torch.int32)
        bsh["labels"] = NamedSharding(mesh, node_spec1)
        if shard_nodes:  # padded nodes are masked out of the loss
            sds["label_mask"] = _meta((n_nodes,), torch.float32)
            bsh["label_mask"] = NamedSharding(mesh, node_spec1)

    optimizer = opt_lib.adamw(1e-3)
    step_fn = G.make_train_step(cfg, optimizer)
    if info["kind"] == "graphs":
        def fn(params, opt_state, batch):
            batch = dict(batch)
            batch["n_graphs"] = info["n_graphs"]
            return step_fn(params, opt_state, batch)
    else:
        fn = step_fn

    per_device, note = None, GLOBAL_ONLY
    if shard_nodes:
        # params replicated (param_specs), so every rank's are whole
        def per_device(dmesh):
            return (G.make_train_step(cfg, optimizer, mesh=dmesh, node_axes=node_axes),
                    (params, optimizer.abstract_state(params), sds))
        note = ("the batch is the global one: forward_sharded cuts the rank's node rows and "
                "its partition_edges shard of the edges itself")

    # model flops: messages/updates dominate — 2 flops per weight per unit
    per_edge = 2.0 * 2 * cfg.d_hidden * cfg.d_hidden          # msg MLP
    per_node = 2.0 * (cfg.d_hidden * 13) * cfg.d_hidden       # update MLP
    fwd = cfg.n_layers * (per_edge * n_edges + per_node * n_nodes)
    return Cell(
        arch_id=base_name, shape_name=shape, fn=fn,
        args=(params, optimizer.abstract_state(params), sds),
        in_shardings=(psh, {"m": psh, "v": psh, "step": NamedSharding(mesh, P())}, bsh),
        model_flops=3.0 * fwd, config=cfg, per_device=per_device, per_device_note=note)
