"""Multi-rank cases of the port's model-parallel forms, over gloo on the CPU,
and the same forms' rank bodies run in turn on one device.

JAX-free: ``tests/test_torch_model_parallel.py`` spawns ranks that import
only this module and the port, and ``chip_smoke.py`` (phase 21) runs the
in-turn bodies on the card. :func:`run` starts one process per rank
(``torch.multiprocessing``, spawn, a ``FileStore``); each joins the process
group, builds the ``('data', 'model')`` mesh, runs :func:`case_all` and
saves what it computed to ``<out>/rank<r>.npz``. Params come in from JAX's
init (the test's JAX subprocess writes them); the other inputs come from
the numpy generators below, which the JAX side uses too.

``run(case="cost")`` runs :func:`case_cost` instead: the dry run's
per-device calls (:func:`cost_calls`) under ``launch/hlo_stats.step_cost``
over the real group (``tests/test_torch_dryrun_device.py`` holds the fake
group's pass to rank 0's counts).
"""

import dataclasses
import os
import tempfile

import numpy as np

SHAPE = (2, 2)                          # (data, model)
NODE_AXES = ("data", "model")
AUX_W = 0.37                            # the aux loss's weight in the MoE objective

# tests/test_sharding.py's MoE (d 32, 64 tokens, 8 experts top 2, 1 shared),
# at the published capacity factor and at the no-drop one (E / k)
D_MOE, T_MOE = 32, 64
_MOE = dict(n_experts=8, top_k=2, d_ff_expert=16, n_shared=1)
MOE_VARIANTS = {
    "cf1.25": dict(_MOE, capacity_factor=1.25),
    "cf1.25-ff": dict(_MOE, capacity_factor=1.25, shard_ff_over_data=True),
    "nodrop": dict(_MOE, capacity_factor=4.0),
    "nodrop-ff": dict(_MOE, capacity_factor=4.0, shard_ff_over_data=True),
    "routed": dict(_MOE, capacity_factor=1.25, n_shared=0),
}

# tests/test_sharding.py's PNA: 64 nodes (16 per rank of 2x2), 256 edges
PNA = dict(name="t", n_layers=2, d_in=8, d_hidden=16, n_classes=3)
PNA_GRAPH = (64, 256, 8, 3)
PNA_VARIANTS = {"plain": {}, "halo_bf16": {"halo_bf16": True}, "mask": {}}

# LM smokes on the mesh: (arch, LMConfig overrides, shard_ff_over_data)
LM_CASES = {
    "yi": ("yi-9b", {"grad_accum": 2}, False),
    "moe16b": ("deepseek-moe-16b", {}, False),
    "v2ff": ("deepseek-v2-236b", {}, True),
    "yi-kv1": ("yi-9b", {"n_kv": 1}, False),          # one KV head read by both model ranks
    "yi-h3": ("yi-9b", {"n_heads": 3, "n_kv": 1}, False),   # heads do not split: replicated
    # pure ZeRO-DP (tp=None): rows over both axes, the matrices of 2**16+ elements gathered
    "yi-puredp": ("yi-9b", {"d_model": 256, "d_ff": 512}, False),
    # a microbatch of 1 row over 2 data ranks (LM_B rows, grad_accum LM_B): padded rows, and
    # the MoE's token block cuts the row in two (ROADMAP C33)
    "yi-uneven": ("yi-9b", {"grad_accum": 4}, False),
    "moe16b-uneven": ("deepseek-moe-16b", {"grad_accum": 4}, False),
}
LM_MESH = {"yi-puredp": {"dp": ("data", "model"), "tp": None}}
LM_SERVED = ("yi", "moe16b", "v2ff", "yi-kv1", "yi-h3")
POD_VARIANTS = ("cf1.25", "cf1.25-ff")  # moe_ffn on the ('pod', 'data', 'model') mesh of 2x1x2
LM_B, LM_S, LM_DECODE, LM_SLOTS = 4, 24, 3, 8
LM_UNEVEN = ("yi-uneven", "moe16b-uneven")
LM_ODD_B = 3                            # their prefill and decode: 3 rows over 2 data ranks
LM_LAYER_LEN = 5                        # the decode layer of the in-turn check: cache_len


def moe_inputs():
    r = np.random.default_rng(11)
    return (r.normal(size=(T_MOE, D_MOE)).astype(np.float32) * 0.5,
            r.normal(size=(T_MOE, D_MOE)).astype(np.float32))


def pna_mask():
    return (np.arange(PNA_GRAPH[0]) % 3 != 0).astype(np.float32)


def lm_config(get_arch, name):
    """The case's config, from either package's registry."""
    arch, kw, ff = LM_CASES[name]
    cfg = dataclasses.replace(get_arch(arch).smoke(), **kw)
    if ff:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, shard_ff_over_data=True))
    return cfg


def lm_tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (LM_B, LM_S)).astype(np.int32)


def lm_decode_inputs(cfg, seed=4):
    """One decode layer's input ``x`` (LM_B, 1, d) and a global one-layer
    cache (``make_cache``'s names, every slot drawn), float32 numpy."""
    from repro_torch.models import transformer as T

    r = np.random.default_rng(seed)
    shapes = {k: (1,) + tuple(v.shape[1:]) for k, v in T.make_cache(
        cfg, LM_B, LM_SLOTS, abstract=True).items()}
    cache = {k: r.normal(size=s).astype(np.float32) for k, s in sorted(shapes.items())}
    x = r.normal(size=(LM_B, 1, cfg.d_model)).astype(np.float32)
    return x, cache


class Capture:
    """An optimizer whose update returns the gradients as the params, so a
    train step shows its gradients; with a mesh step's ``sq_norm`` it
    keeps the global squared norm it gives."""

    def __init__(self):
        self.sq = None

    def update(self, params, grads, state, *, sq_norm=None):
        if sq_norm is not None:
            import torch

            from repro_torch.train.optimizer import flatten
            self.sq = float(sq_norm({k: torch.sum(g.to(torch.float32) ** 2)
                                     for k, g in flatten(grads).items()}))
        return grads, state


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------ in turn
def moe_in_turn(params, x, c, shape, mutate=None):
    """``moe_ffn(mesh=)`` on a ``{'data': D, 'model': n}`` mesh as its rank
    bodies run one after another: per data shard the routing once, then
    each model rank's experts and its shared-expert columns, the partials
    added in rank order (the psum). With ``c.shard_ff_over_data`` each
    rank's expert shards are cut over ``data`` too, and the ZeRO-3 gather
    of the hidden dim is the concatenation of the ``D`` ranks' shards.
    ``params`` global; returns the shards' outputs and auxes, in data
    order. ``mutate(m, lp, offset) -> (lp, offset, keep)`` plants a fault in
    model rank ``m``'s body (rehearsals)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.launch import mesh as M
    from repro_torch.models import moe as MO
    from repro_torch.models.common import dense

    n_dp, n_tp = shape["data"], shape["model"]
    specs = MO.param_specs(c)

    def rank_params(m):
        shards = [M.shard_params(params, specs, M.RankView(shape, (d, m))) for d in range(n_dp)]
        if not c.shard_ff_over_data:
            return shards[0]
        gathered = {k: torch.cat([s[k] for s in shards], dim=2) for k in ("w1", "w3")}
        return dict(shards[0], w2=torch.cat([s["w2"] for s in shards], dim=1), **gathered)

    rows = x.shape[0] // n_dp
    outs, auxes = [], []
    for d in range(n_dp):
        xs = x[d * rows:(d + 1) * rows]
        top_e, top_p, aux = MO._route(xs, params["router"], c)
        total = None
        for m in range(n_tp):
            lp = rank_params(m)
            offset, keep = m, True
            if mutate:
                lp, offset, keep = mutate(m, lp, offset)
            part = MO._experts_local(xs, top_e, top_p, lp["w1"], lp["w3"], lp["w2"], c,
                                     n_local=c.n_experts // n_tp, local_offset=offset)
            if c.n_shared:
                h = F.silu(dense(xs, lp["sw1"])) * dense(xs, lp["sw3"])
                part = part + dense(h, lp["sw2"])
            if keep:
                total = part if total is None else total + part
        outs.append(total)
        auxes.append(aux)
    return outs, auxes


def pna_in_turn(params, c, batch, n_shards):
    """``forward_sharded`` as its ``n_shards`` rank bodies run in turn: per
    layer every shard's ``h`` is computed from the previous layer's whole
    ``h`` (the halo gather a concatenation, in bf16 with ``halo_bf16``).
    Returns the logits of all nodes."""
    import torch

    from repro_torch.models import gnn as G

    feats = batch["features"]
    n = feats.shape[0] // n_shards
    per = batch["src"].shape[0] // n_shards
    h = torch.relu(feats.to(c.dtype) @ params["in_w"] + params["in_b"])
    for i in range(c.n_layers):
        lp = G.layer_params(params, i)
        wire = h.to(torch.bfloat16).to(h.dtype) if c.halo_bf16 else h
        h = torch.cat([G._pna_layer_local(
            lp, wire, h[k * n:(k + 1) * n], batch["src"][k * per:(k + 1) * per].to(torch.int64),
            G.local_dst(batch["dst"][k * per:(k + 1) * per], k, n), c, n)
            for k in range(n_shards)])
    return h @ params["out_w"] + params["out_b"]


def _in_order(parts):
    """The ranks' parts added in rank order (a psum run in turn)."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def _tp_ranks(layer, c, n_tp, mutate=None, decode=False):
    """Each model rank's (HeadSplit, params) of one dense layer (``layer``:
    its global params, unstacked): its TP shards, and whole the weights of
    ``model_gathered`` (the split decode's with ``decode``), after
    ``mutate``."""
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T

    specs = {k: type(s)(*tuple(s)[1:]) for k, s in T.param_specs(c)["dense_layers"].items()}
    out = []
    for m in range(n_tp):
        hs = T.head_split(c, m, n_tp)
        full = T.model_gathered(c, hs, decode)
        lp = M.shard_params(layer, specs, M.RankView({"data": 1, "model": n_tp}, (0, m)))
        lp = {k: (layer[k] if k in full else v) for k, v in lp.items()}
        out.append(mutate(m, hs, lp) if mutate else (hs, lp))
    return out


def _ffn_in_turn(ranks, layer, h):
    from repro_torch.models.common import rms_norm, swiglu

    hn = rms_norm(h, layer["norm2"])
    return h + _in_order([swiglu(hn, lp["ffn_w1"], lp["ffn_w3"], lp["ffn_w2"])
                          for _, lp in ranks])


def tp_layer_in_turn(layer, x, c, n_tp, mutate=None):
    """One dense transformer layer (``layer``: its global params, unstacked)
    as the ``n_tp`` model ranks' column/row bodies in turn: the attention
    partials added in rank order onto the residual, then the FFN's.
    ``mutate(m, hs, lp) -> (hs, lp)`` plants a fault in rank ``m``'s
    bodies (rehearsals)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.common import rms_norm

    ranks = _tp_ranks(layer, c, n_tp, mutate)
    xn = rms_norm(x, layer["norm1"])
    h = x + _in_order([T._attn_block(lp, xn, c, hs) for hs, lp in ranks])
    return _ffn_in_turn(ranks, layer, h)


def run_in_turn(bodies):
    """Rank bodies (``transformer._decode_attn_body`` generators, in rank
    order) one after another: each collective they yield together run as a
    concatenation (gather) or a sum in rank order (psum), its result sent
    to every body. Returns their results, in rank order."""
    import torch

    sent = [None] * len(bodies)
    while True:
        ops, done = [], []
        for body, x in zip(bodies, sent):
            try:
                ops.append(body.send(x))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            assert len(done) == len(bodies), "the bodies yielded different collectives"
            return done
        assert len({op[0] for op in ops}) == 1, ops
        if ops[0][0] == "gather":
            result = torch.cat([op[1] for op in ops], dim=ops[0][2])
        else:
            result = _in_order([op[1] for op in ops])
        sent = [result] * len(bodies)


def cache_blocks(cache, c, n_tp):
    """Each model rank's ``cache_specs`` block (one data rank) of a global
    cache, in rank order."""
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T

    specs = T.cache_specs(c)
    return [{k: M.shard_tensor(v, specs[k], M.RankView({"data": 1, "model": n_tp}, (0, m)))
             for k, v in cache.items()} for m in range(n_tp)]


def tp_decode_in_turn(layer, x, blocks, cache_len, c, n_tp, mutate=None):
    """One dense layer's decode step of ``x`` (B, 1, d) as the ``n_tp``
    model ranks' bodies in turn (``transformer._decode_attn_body`` under
    :func:`run_in_turn`), each against its ``cache_specs`` block
    (``blocks[m]``, one layer: written in place), the attention parts added
    in rank order onto the residual, then the FFN's as in
    :func:`tp_layer_in_turn`. ``mutate`` as there."""
    from repro_torch.models import transformer as T
    from repro_torch.models.common import rms_norm

    ranks = _tp_ranks(layer, c, n_tp, mutate, decode=True)
    xn = rms_norm(x, layer["norm1"])
    parts = run_in_turn([T._decode_attn_body(lp, xn, blocks[m], 0, cache_len, c, hs)
                         for m, (hs, lp) in enumerate(ranks)])
    return _ffn_in_turn(ranks, layer, x + _in_order(parts))


# ------------------------------------------------------------------ cases
def _mesh(shape):
    from repro_torch.launch.mesh import make_model_mesh

    return make_model_mesh(*shape, device="cpu")


def case_moe(rank, mesh, inputs):
    """moe_ffn(mesh=) per variant: out, aux, the gradients of
    ``sum(out * R) + AUX_W * aux`` and of the aux alone (params and x),
    gathered; and ``moe_ffn`` of the global params on the rank's shard."""
    import torch

    from repro_torch.core.sharding import P
    from repro_torch.launch import mesh as M
    from repro_torch.models import moe as MO

    x_g = torch.from_numpy(moe_inputs()[0])
    rows = slice(M.axis_index(mesh, "data") * (T_MOE // 2), (M.axis_index(mesh, "data") + 1)
                 * (T_MOE // 2))
    out = {}
    for name, kw in MOE_VARIANTS.items():
        c = MO.MoEConfig(**kw)
        gp = {k: torch.from_numpy(inputs[f"moe/{name}/param/{k}"]) for k in MO.param_specs(c)}
        for objective in ("full", "aux"):
            out.update(_moe_mesh_run(mesh, ("data",), c, gp, objective, f"moe/{name}"))
        with torch.no_grad():
            so, sa = MO.moe_ffn(gp, x_g[rows], c)
        out[f"moe/{name}/shard_out"] = _np(M.unshard_tensor(so, P("data"), mesh))
        out[f"moe/{name}/shard_aux"] = _np(M.unshard_tensor(sa[None], P("data"), mesh))
    try:
        MO.moe_ffn(gp, x_g[rows], MO.MoEConfig(**dict(_MOE, n_experts=7)), mesh=mesh)
    except ValueError as e:
        out["moe/divisibility"] = np.asarray(str(e))
    return out


def _moe_mesh_run(mesh, dp, c, gp, objective, prefix):
    """``moe_ffn(mesh=, dp_axes=dp)`` from the global params ``gp``: out,
    aux and the gradients (params and x, gathered) of ``AUX_W * aux``
    (``objective`` "aux") or of ``sum(out * R) + AUX_W * aux`` ("full")."""
    import torch

    from repro_torch.core.sharding import P
    from repro_torch.launch import mesh as M
    from repro_torch.models import moe as MO

    x_g, cot = (torch.from_numpy(a) for a in moe_inputs())
    n = T_MOE // M.axis_size(mesh, dp)
    rows = slice(M.axis_index(mesh, dp) * n, (M.axis_index(mesh, dp) + 1) * n)
    specs = MO.param_specs(c)
    lp = {k: v.requires_grad_(True) for k, v in M.shard_params(gp, specs, mesh).items()}
    x = x_g[rows].clone().requires_grad_(True)
    o, aux = MO.moe_ffn(lp, x, c, mesh=mesh, dp_axes=dp)
    obj = AUX_W * aux if objective == "aux" else (o * cot[rows]).sum() + AUX_W * aux
    obj.backward()
    tag, out = f"{prefix}/{objective}", {}
    for k, s in specs.items():
        g = lp[k].grad if lp[k].grad is not None else torch.zeros_like(lp[k])
        rep = tuple(a for a in dp if a not in M.spec_axes(s))     # the rows' axes it spans
        if rep:
            g = M.psum(g, mesh, rep)
        out[f"{tag}/grad/{k}"] = _np(M.unshard_tensor(g, s, mesh))
    out[f"{tag}/gx"] = _np(M.unshard_tensor(x.grad, P(dp), mesh))
    out[f"{tag}/out"] = _np(M.unshard_tensor(o.detach(), P(dp), mesh))
    out[f"{tag}/aux"] = _np(aux)
    return out


def case_pods(rank, inputs):
    """The ``('pod', 'data', 'model')`` mesh of 2x1x2 (the rows over
    ``('pod', 'data')``): the MoE runs of :func:`case_moe` for the
    ``POD_VARIANTS``, which lay the ranks out as the 2x2 mesh does."""
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.models import moe as MO

    mesh = make_model_mesh(1, 2, pods=2, device="cpu")
    idx = torch.tensor([M.axis_index(mesh, ("pod", "data"))])
    out = {"pods/index": _np(M.all_gather(idx, mesh, ("pod", "data", "model")))}
    for name in POD_VARIANTS:
        c = MO.MoEConfig(**MOE_VARIANTS[name])
        gp = {k: torch.from_numpy(inputs[f"moe/{name}/param/{k}"]) for k in MO.param_specs(c)}
        out.update(_moe_mesh_run(mesh, ("pod", "data"), c, gp, "full", f"pods/{name}"))
    return out


def case_pna(rank, mesh, inputs):
    """The node-sharded train step (loss, gradients) and forward per
    variant, and the raw body on a graph whose padding is the spare row."""
    import torch

    from repro_torch.core.sharding import P
    from repro_torch.launch import mesh as M
    from repro_torch.models import gnn as G

    out = {}
    for name, kw in PNA_VARIANTS.items():
        c = G.PNAConfig(**PNA, **kw)
        params = {k[len("pna/param/"):]: torch.from_numpy(v.copy())
                  for k, v in inputs.items() if k.startswith("pna/param/")}
        batch = {k: torch.from_numpy(inputs[f"pna/batch/{k}"])
                 for k in ("features", "src", "dst", "labels")}
        if name == "mask":
            batch["label_mask"] = torch.from_numpy(pna_mask())
        cap = Capture()
        grads, _, m = G.make_train_step(c, cap, mesh=mesh, node_axes=NODE_AXES)(
            {k: v.clone() for k, v in params.items()}, {}, batch)
        out[f"pna/{name}/loss"] = _np(m["loss"])
        for k, g in grads.items():
            out[f"pna/{name}/grad/{k}"] = _np(g)
        with torch.no_grad():
            logits = G.forward_sharded(params, c, batch, mesh=mesh, node_axes=NODE_AXES)
        out[f"pna/{name}/logits"] = _np(M.unshard_tensor(logits, P(NODE_AXES), mesh))
    return out


def case_lm(rank, mesh, inputs):
    """Per LM case: ``shard_params`` then ``unshard_params`` (the identity),
    one ``make_train_step(mesh=)`` step's loss and gradients (gathered) and
    its global gradient norm; ``prefill(mesh=)`` and ``LM_DECODE``
    ``serve_step(mesh=)`` steps (logits, the rank's cache); one dense layer
    of the mesh form on the rank's rows."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.sharding import P
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import flatten, unflatten

    out = {}
    for name in LM_CASES:
        cfg = lm_config(get_arch, name)
        kw = LM_MESH.get(name, {})
        gp = unflatten({k[len(f"lm/{name}/param/"):]: torch.from_numpy(v.copy())
                        for k, v in inputs.items() if k.startswith(f"lm/{name}/param/")})
        specs = T.param_specs(cfg, **kw)
        lp = M.shard_params(gp, specs, mesh)
        back = flatten(M.unshard_params(lp, specs, mesh))
        out[f"lm/{name}/roundtrip"] = np.asarray(all(torch.equal(back[k], v)
                                                     for k, v in flatten(gp).items()))
        tok = torch.from_numpy(lm_tokens(cfg))
        cap = Capture()
        grads, _, m = T.make_train_step(cfg, cap, mesh=mesh, **kw)(
            M.shard_params(gp, specs, mesh), {}, {"tokens": tok, "labels": tok})
        out[f"lm/{name}/loss"] = _np(m["loss"])
        out[f"lm/{name}/sq_norm"] = np.asarray(cap.sq)
        for k, g in flatten(M.unshard_params(grads, specs, mesh)).items():
            out[f"lm/{name}/grad/{k}"] = _np(g)
        if name in LM_UNEVEN:
            out.update(_lm_odd_rows(name, cfg, lp, tok, mesh))
        if name not in LM_SERVED:
            continue
        out[f"lm/{name}/prefill"] = _np(T.prefill(lp, tok, cfg, mesh=mesh))
        cache = T.make_cache(cfg, LM_B, LM_SLOTS, device="cpu", mesh=mesh)
        # LM_B + 1 rows over 2 data ranks: the padded cache block, and the MoE
        # decode's refusal of 5 tokens (JAX's shard_map refuses them too)
        odd = T.make_cache(cfg, LM_B + 1, LM_SLOTS, device="cpu", mesh=mesh)
        out[f"lm/{name}/cache_split"] = np.asarray([v.shape[1] for v in odd.values()])
        if cfg.moe:
            try:
                T.serve_step(lp, torch.cat([tok, tok[:1]])[:, :1], odd, 0, cfg, mesh=mesh)
            except ValueError as e:
                out[f"lm/{name}/decode_split"] = np.asarray(str(e))
        for t in range(LM_DECODE):
            logits, cache = T.serve_step(lp, tok[:, t:t + 1], cache, t, cfg, mesh=mesh)
            out[f"lm/{name}/decode/{t}"] = _np(logits)
        for k, v in cache.items():
            out[f"lm/{name}/cache/{k}"] = _np(v)
        # one dense layer's decode on the rank's rows and cache_specs block,
        # for the in-turn bodies
        mp = T._mesh_ctx(cfg, mesh, ("data",), "model")
        layer = T._layer_gather({k: v[0] for k, v in lp["dense_layers"].items()},
                                "dense_layers", cfg, mp, decode=True)
        rows = T._dp_rows(LM_B, mesh, ("data",))[0]
        x, gcache = lm_decode_inputs(cfg)
        specs = T.cache_specs(cfg)
        block = {k: M.shard_tensor(torch.from_numpy(v), specs[k], mesh) for k, v in gcache.items()}
        y = T._decode_layer(layer, torch.from_numpy(x)[rows], block, 0, LM_LAYER_LEN, cfg, mp)
        out[f"lm/{name}/decode_layer"] = _np(M.unshard_tensor(y, P("data"), mesh))
        for k, v in block.items():
            out[f"lm/{name}/decode_layer/cache/{k}"] = _np(v)
        if name == "yi":
            # one dense layer of the mesh form, for the in-turn bodies
            x = torch.from_numpy(np.random.default_rng(3).normal(
                size=(LM_B, LM_S, cfg.d_model)).astype(np.float32))
            mp = T._mesh_ctx(cfg, mesh, ("data",), "model")
            layer = T._layer_gather({k: v[0] for k, v in lp["dense_layers"].items()},
                                    "dense_layers", cfg, mp)
            rows = T._dp_rows(LM_B, mesh, ("data",))[0]
            with torch.no_grad():
                y, _ = T._dense_block_mesh(layer, x[rows], cfg, mp)
            out[f"lm/{name}/layer"] = _np(M.unshard_tensor(y, P("data"), mesh))
    return out


def _lm_odd_rows(name, cfg, lp, tok, mesh):
    """``prefill(mesh=)`` and ``LM_DECODE`` ``serve_step(mesh=)`` steps of
    ``LM_ODD_B`` rows (the rank's cache block: its padded rows), or the
    decode's refusal."""
    from repro_torch.models import transformer as T

    tok = tok[:LM_ODD_B]
    out = {f"lm/{name}/odd/prefill": _np(T.prefill(lp, tok, cfg, mesh=mesh))}
    cache = T.make_cache(cfg, LM_ODD_B, LM_SLOTS, device="cpu", mesh=mesh)
    try:
        for t in range(LM_DECODE):
            logits, cache = T.serve_step(lp, tok[:, t:t + 1], cache, t, cfg, mesh=mesh)
            out[f"lm/{name}/odd/decode/{t}"] = _np(logits)
    except ValueError as e:
        out[f"lm/{name}/odd/decode_error"] = np.asarray(str(e))
    for k, v in cache.items():
        out[f"lm/{name}/odd/cache/{k}"] = _np(v)
    return out


# ----------------------------------------------------- the dry run's calls
COST_LM = {"kind": "train", "seq": LM_S, "batch": LM_B}   # the yi case's tokens


def small_lm_cell(name="yi"):
    """``configs.base.lm_cell`` of an LM case's config (the yi case's:
    ``grad_accum`` 2) on the 2x2 mesh, its ``train_4k`` shape cut to
    ``COST_LM``."""
    from repro_torch.configs import base as B
    from repro_torch.configs import get_arch
    from repro_torch.core.sharding import Mesh

    saved = B.LM_SHAPES["train_4k"]
    B.LM_SHAPES["train_4k"] = COST_LM
    try:
        return B.lm_cell(lm_config(get_arch, name), "train_4k",
                         Mesh(dict(zip(("data", "model"), SHAPE))))
    finally:
        B.LM_SHAPES["train_4k"] = saved


def pna_cost_call(mesh):
    """The node-sharded PNA train step (AdamW, the ``plain`` case) on the
    smoke graph, and its meta arguments: replicated params, their state,
    the global batch."""
    import torch

    from repro_torch.models import gnn as G
    from repro_torch.train.optimizer import adamw

    c = G.PNAConfig(**PNA)
    n, e, d_in, _ = PNA_GRAPH
    opt = adamw(1e-3)
    params = G.abstract_params(c)
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")  # noqa: E731
    batch = {"features": meta((n, d_in), torch.float32), "src": meta((e,), torch.int32),
             "dst": meta((e,), torch.int32), "labels": meta((n,), torch.int32)}
    return (G.make_train_step(c, opt, mesh=mesh, node_axes=NODE_AXES),
            (params, opt.abstract_state(params), batch))


def cost_calls(mesh):
    """``{name: (fn, meta args)}``: the yi cell's per-device train step, the
    ``moe16b-uneven`` cell's (a microbatch of 1 row over 2 data ranks: the
    padded rows and the MoE's token exchange) and PNA's node-sharded one on
    ``mesh``."""
    return {"lm": small_lm_cell().per_device(mesh),
            "lm-uneven": small_lm_cell("moe16b-uneven").per_device(mesh),
            "pna": pna_cost_call(mesh)}


def case_cost(rank, mesh):
    """Each of :func:`cost_calls` once under ``hlo_stats.step_cost`` and
    ``PeakMode`` on meta copies of its arguments (as the dry run counts
    it), over this real group: with the backward's reduce-scatter in the
    card's form (``_scatter_sum``) and in gloo's own (``_sum_slice``)."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.hlo_stats import PeakMode, step_cost

    out, default = {}, M._reduce_scatter
    for name, (fn, args) in cost_calls(mesh).items():
        for form, rs in (("card", M._scatter_sum), ("gloo", M._sum_slice)):
            M._reduce_scatter = rs
            peak = PeakMode("meta")
            try:
                totals = step_cost(fn, *args, peak=peak)
            finally:
                M._reduce_scatter = default
            tag = f"cost/{name}/{form}"
            out.update({f"{tag}/flops": np.asarray(totals.flops),
                        f"{tag}/op_bytes": np.asarray(totals.op_bytes),
                        f"{tag}/peak": np.asarray([peak.peak_bytes, peak.live_at_peak,
                                                   peak.max_live, peak.max_live_large])})
            for kind, b in totals.collective.items():
                out[f"{tag}/collective/{kind}"] = np.asarray(b)
    return out


def case_all(rank, shape, inputs):
    mesh = _mesh(shape)
    out = {}
    for case in (case_moe, case_pna, case_lm):
        out.update(case(rank, mesh, inputs))
    if shape == SHAPE:
        out.update(case_pods(rank, inputs))
    return out


# ------------------------------------------------------------------ spawn
def _rank(rank, world, store, shape, inputs, out_dir, case):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    # the ranks share two cores: the suite's timing tests share the machine (C12)
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        got = (case_all(rank, shape, inputs) if case == "all"
               else case_cost(rank, _mesh(shape)))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    finally:
        dist.destroy_process_group()


def run(inputs, shape=SHAPE, out_dir=None, case="all"):
    """Every case (``case="all"``), or :func:`case_cost` (``"cost"``), on a
    ``shape`` mesh, one spawned process per rank; returns every rank's
    saved arrays, in rank order."""
    import torch.multiprocessing as mp

    world = shape[0] * shape[1]
    out_dir = out_dir or tempfile.mkdtemp(prefix="model_parallel_")
    store = os.path.join(tempfile.mkdtemp(prefix="store_"), "store")
    mp.spawn(_rank, args=(world, store, shape, dict(inputs), out_dir, case), nprocs=world,
             join=True)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]
