"""The port's PNA (``repro_torch.models.gnn``), its configs and the driver's
gnn branch against the JAX package, on the CPU, JAX under ``jax.jit`` (the
form its driver runs).

* ``param_shapes``, ``GNN_SHAPES`` and ``gnn_config_for`` for all four
  shapes field for field; ``init_params`` draws He-normal matrices and zero
  biases; ``abstract_params`` is meta.
* ``random_graph`` and ``NeighborSampler`` (the same seed, CSR and
  fanouts) bit for bit, and ``synthetic_batch("gnn")`` is the JAX driver's.
* ``pna_layer``, node-level and graph-level ``forward`` and ``loss_fn``
  with and without ``label_mask``, from the same params and graph (isolated
  nodes and repeated edges among them): each output within 1e-5 of its
  largest |value| (XLA's CPU code turns ``logd / delta`` into a multiply by
  fp32 0.4 and may take ``log1p`` 2 ulp off, both amplified by the 12D
  update GEMM), the loss to rtol 1e-5; each gradient within 2e-4 of its
  largest |value|, of JAX's and of the port's own float64 gradient: the
  std aggregator's ``sq - mean**2`` cancels, and ``1/(2 std)`` carries the
  rounding into the first layers' gradients, so JAX's fp32 gradients
  themselves read up to 3.4e-5 from float64, the port's up to 4.9e-5, and
  the two 6.9e-5 from each other (my CPU run).
* Ties: a max's or min's gradient is split evenly over tied messages in
  both frameworks (``[1, 3, 3]`` -> ``[0, .5, .5]``), and the ReLU's zeros
  tie in every layer.
* The driver: the in-memory chain from JAX's params against the JAX
  driver's (rtol 1e-5, AdamW over 6 steps); the CLI trains ``pna`` and
  ``--metrics`` costs its step; the recsys-only flags are refused.
"""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JB  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch import train as JD  # noqa: E402
from repro.models import gnn as JG  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402

from repro_torch.configs import base as B  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import train as D  # noqa: E402
from repro_torch.models import gnn as G  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402

CPU = torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pair(cfg_kw=None, seed=0):
    jcfg = jax_get_arch("pna").smoke()
    cfg = get_arch("pna").smoke()
    if cfg_kw:
        jcfg, cfg = dataclasses.replace(jcfg, **cfg_kw), dataclasses.replace(cfg, **cfg_kw)
    jparams = JG.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, G.params_from_jax(jax.tree.map(np.asarray, jparams), CPU)


def _graph(n=60, e=240, d=16, classes=5, seed=3, graphs=0):
    """A random graph; its last 5 nodes get no in-edge, and 10 edges repeat."""
    g = JG.random_graph(n, e, d, classes, seed=seed)
    g["dst"] = np.where(g["dst"] >= n - 5, g["dst"] - 5, g["dst"]).astype(np.int32)
    g["src"][-10:], g["dst"][-10:] = g["src"][:10], g["dst"][:10]
    if graphs:
        g["graph_ids"] = np.repeat(np.arange(graphs), n // graphs).astype(np.int32)
        g["labels"] = np.random.default_rng(seed).integers(0, classes, graphs).astype(np.int32)
    return g


def _batches(g):
    jb = {k: jnp.asarray(v) for k, v in g.items()}
    tb = {k: torch.from_numpy(v) for k, v in g.items()}
    return jb, tb


# ---------------------------------------------------------------- configs
def test_configs_and_shapes_match_jax():
    spec, jspec = get_arch("pna"), jax_get_arch("pna")
    assert spec.family == jspec.family == "gnn" and spec.describe == jspec.describe
    assert B.GNN_SHAPES == JB.GNN_SHAPES
    for shape in JB.GNN_SHAPES:
        got, want = B.gnn_config_for("pna", shape), JB.gnn_config_for("pna", shape)
        for f in dataclasses.fields(got):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if f.name == "dtype":
                assert str(g).split(".")[-1] == jnp.dtype(w).name
            else:
                assert g == w, (shape, f.name)
        assert G.param_shapes(got) == JG.param_shapes(want)
    assert spec.config == B.gnn_config_for("pna", "full_graph_sm")
    smoke, jsmoke = spec.smoke(), jspec.smoke()
    assert [f.name for f in dataclasses.fields(smoke)] == \
        [f.name for f in dataclasses.fields(jsmoke)]
    assert G.param_shapes(smoke) == JG.param_shapes(jsmoke)


def test_init_and_abstract_params():
    cfg = get_arch("pna").config
    p = G.init_params(cfg, torch.Generator().manual_seed(0))
    again = G.init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == G.param_shapes(cfg)
    for k, v in p.items():
        assert v.dtype == torch.float32 and torch.equal(v, again[k])
        if k.endswith("_b"):
            assert not v.any()
        elif v.numel() > 4000:
            assert abs(float(v.std()) / np.sqrt(2.0 / v.shape[0]) - 1) < 0.05, k
    ab = G.abstract_params(cfg)
    assert all(v.device.type == "meta" for v in ab.values())


# ---------------------------------------------------------------- host ops
def test_random_graph_and_sampler_are_jaxs_bit_for_bit():
    for args in ((200, 1000, 8, 4), (2708, 10556, 1433, 7)):
        got, want = G.random_graph(*args, seed=5), JG.random_graph(*args, seed=5)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    g = G.random_graph(500, 4000, 8, 4, seed=1)
    src, dst = g["src"].astype(np.int64), g["dst"].astype(np.int64)
    mine = G.NeighborSampler.from_edges(500, src, dst, seed=3)
    theirs = JG.NeighborSampler.from_edges(500, src, dst, seed=3)
    np.testing.assert_array_equal(mine.indptr, theirs.indptr)
    np.testing.assert_array_equal(mine.indices, theirs.indices)
    for seeds, fanout in ((np.asarray([0, 5, 9]), (4, 3)), (np.arange(40), (15, 10)),
                          (np.asarray([7]), (2, 2, 2))):
        for a, b in zip(mine.sample(seeds, fanout), theirs.sample(seeds, fanout)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_synthetic_gnn_batch_is_the_jax_drivers():
    cfg, jcfg = get_arch("pna").smoke(), jax_get_arch("pna").smoke()
    for step in (0, 3):
        got = D.synthetic_batch("gnn", cfg, 64, step, device=CPU)
        want = JD.synthetic_batch("gnn", jcfg, 64, step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------------------------------------------ model
def test_segment_extremes_split_tied_gradients_as_jax():
    ids = np.asarray([0, 0, 0, 1, 1], np.int32)
    x = np.asarray([1.0, 3.0, 3.0, -2.0, -2.0], np.float32)
    for jfn, reduce, split in ((jax.ops.segment_max, "amax", [0.0, 0.5, 0.5, 0.5, 0.5]),
                               (jax.ops.segment_min, "amin", [1.0, 0.0, 0.0, 0.5, 0.5])):
        want = jax.grad(lambda v: jfn(v, jnp.asarray(ids), num_segments=3).sum())(jnp.asarray(x))
        t = torch.from_numpy(x).requires_grad_(True)
        G._segment_extreme(t[:, None], torch.from_numpy(ids).long(), 3, reduce).sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
        np.testing.assert_array_equal(np.asarray(want), split)


def test_pna_layer_matches_jax():
    jcfg, cfg, jparams, params = _pair()
    g = _graph()
    h = np.random.default_rng(4).normal(size=(60, cfg.d_hidden)).astype(np.float32)
    for i in range(cfg.n_layers):
        want = jax.jit(lambda p, h, s, d, i=i: JG.pna_layer(p, i, h, s, d, jcfg, 60))(
            jparams, jnp.asarray(h), jnp.asarray(g["src"]), jnp.asarray(g["dst"]))
        got = G.pna_layer(params, i, torch.from_numpy(h), torch.from_numpy(g["src"]).long(),
                          torch.from_numpy(g["dst"]).long(), cfg, 60)
        assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("level", ["node", "node_masked", "graph"])
def test_forward_loss_and_grads_match_jax(level):
    graphs = 6 if level == "graph" else 0
    jcfg, cfg, jparams, params = _pair({"graph_level": True} if graphs else None)
    g = _graph(graphs=graphs)
    if level == "node_masked":
        g["label_mask"] = (np.arange(60) < 17).astype(np.float32)
    jb, tb = _batches(g)
    if graphs:
        tb["n_graphs"] = graphs

    def jfwd(p, b):
        if graphs:
            b = dict(b, n_graphs=graphs)       # a static count, as the JAX cell passes it
        return JG.forward(p, jcfg, b), jax.value_and_grad(JG.loss_fn)(p, jcfg, b)

    jlogits, (jloss, jgrads) = jax.jit(jfwd)(jparams, jb)
    with torch.no_grad():
        logits = G.forward(params, cfg, tb)
    assert logits.shape == ((graphs, cfg.n_classes) if graphs else (60, cfg.n_classes))
    assert _rel(logits.numpy(), jlogits) <= 1e-5
    grads, loss = _port_grads(params, cfg, tb)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    grads64, _ = _port_grads({k: v.double() for k, v in params.items()},
                             dataclasses.replace(cfg, dtype=torch.float64),
                             dict(tb, features=tb["features"].double()))
    for k in jgrads:
        assert _rel(grads[k], jgrads[k]) <= 2e-4, k
        assert _rel(grads[k], grads64[k]) <= 2e-4, k


def _port_grads(params, cfg, batch):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = G.loss_fn(leaves, cfg, batch)
    loss.backward()
    return {k: v.grad.numpy() for k, v in leaves.items()}, float(loss.detach())


def test_the_comparison_catches_a_param_off_by_1e_3():
    jcfg, cfg, jparams, params = _pair()
    g = _graph()
    jb, tb = _batches(g)
    jlogits = jax.jit(lambda p, b: JG.forward(p, jcfg, b))(jparams, jb)
    params["l0_upd_w"] *= 1 + 1e-3
    with torch.no_grad():
        assert _rel(G.forward(params, cfg, tb).numpy(), jlogits) > 1e-5


# ----------------------------------------------------------------- driver
def test_driver_chain_matches_the_jax_drivers():
    """Six AdamW steps of ``run_in_memory`` (``make_train_step`` over
    ``synthetic_batch("gnn")``) from JAX's params against the JAX driver's
    gnn branch."""
    from repro.train.loop import LoopConfig, run_training

    jcfg, cfg, jparams, params = _pair()
    opt = O.adamw(1e-3)
    state = {"params": params, "opt": opt.init(params)}
    args = D.parse_args(["--arch", "pna", "--steps", "6", "--device", "cpu"])
    _, losses = D.run_in_memory(args, get_arch("pna"), cfg, state, opt)
    jopt = JO.adamw(1e-3)
    jstep = jax.jit(JG.make_train_step(jcfg, jopt))

    def wrapper(st, b):
        p, o, m = jstep(st["params"], st["opt"], b)
        return {"params": p, "opt": o}, m

    _, stats = run_training(cfg=LoopConfig(n_steps=6),
                            state={"params": jparams, "opt": jopt.init(jparams)},
                            train_step=wrapper,
                            batch_source=lambda s: JD.synthetic_batch("gnn", jcfg, 64, s))
    np.testing.assert_allclose(losses, stats.losses, rtol=1e-5)
    assert losses[-1] < losses[0]


def test_cli_trains_pna_with_metrics_and_refuses_the_recsys_flags(tmp_path, capsys):
    stats, losses = D.main(["--arch", "pna", "--steps", "6", "--device", "cpu", "--metrics"])
    assert stats.steps == 6 and losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert "arch=pna steps=6" in out
    flops = float(out.split("hlo/step: ")[1].split(" GFLOP")[0]) * 1e9
    # the step's products: 3 GEMMs a weight use (forward and both gradients,
    # the input layer's gradient of the features excepted) over 200 nodes and
    # 800 edges, the checkpointed layers' forward once more
    cfg = get_arch("pna").smoke()
    n, e, dh = 200, 800, cfg.d_hidden
    layer = 2 * e * 2 * dh * dh + 2 * n * 13 * dh * dh
    fwd = 2 * n * cfg.d_in * dh + cfg.n_layers * layer + 2 * n * dh * cfg.n_classes
    assert 2 * fwd <= flops <= 4 * fwd, (flops, fwd)
    for extra, msg in ((["--data-dir", str(tmp_path)], "--data-dir streaming runs"),
                       (["--embedding", "hierarchy"], "--embedding hierarchy is a recsys"),
                       (["--mesh", "1x1"], "--mesh data-parallel training shards"),
                       (["--check"], "--check verifies the FE feed pipeline"),
                       (["--vocab-scale", "2"], "--vocab-scale only applies to recsys archs")):
        with pytest.raises(SystemExit, match=re.escape(msg)):
            D.main(["--arch", "pna", "--steps", "1", "--device", "cpu"] + extra)
