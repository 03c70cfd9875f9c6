"""BST, ``retrieval_score``, the ``bst`` spec and ``fe/pipeline_graph.py`` of
the port against the JAX package, on the CPU.

* ``layer_norm``: JAX's formula, held per element within
  ``LAYER_NORM_UNITS`` x 2**-24 x ((1 + |mu| / sigma) max(|x_hat|, 1) |w| + |b|)
  of the jitted JAX function: the row's mean is summed in another order
  (its error, a few ulp of |mu|, reaches x_hat divided by sigma), and XLA's
  CPU ``rsqrt`` and the fused affine step round once more.
  ``tests/rehearse_bst.py`` reads up to 7.25 over 1,058,256 rows; an ulp
  count of the output alone is meaningless where ``x_hat w + b`` cancels.
* ``retrieval_score`` of each recsys kind at its smoke config: rtol 1e-4 /
  atol 1e-5, as ``serve_step``; the user batch is left as it was, and a
  candidate scored alone gets its score in the batch.
* The ``bst`` spec's ``ModelFeed`` (packed and split): bit for bit (a
  dense block that DLRM derives from the ids by ``log1p``: 2 ulp).
* ``fe/pipeline_graph.py``: both graphs have JAX's operators, placements,
  costs and schedule; the legacy graph's outputs equal JAX's (``log1p``
  columns to 2 ulp, as ``test_torch_fe.py``) and the compiled ``ads_ctr``
  plan's bit for bit.
* The streaming driver with ``--arch bst --spec bst`` under ``--device-feed
  arena``, ``on``, ``off`` and ``--embedding hierarchy`` against the JAX
  driver's own ``run_streaming`` from JAX's init params on the same shards:
  the first loss within rtol 1e-6, the others within rtol 1e-4 (fp32 sums
  in another order, compounded; ROADMAP C6).
* Three hierarchy steps of BST, each from the JAX chain's state: the loss
  (rtol 1e-6), the working-row gradients (rtol 1e-5 / atol 1e-6), the
  updated rows and Adagrad accumulators (atol 1e-6).
* ``launch/serve.py --arch bst`` scores raw views through the ``bst`` spec.
"""

import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import build_schedule as jax_build_schedule  # noqa: E402
from repro.core import compile_layers as jax_compile_layers  # noqa: E402
from repro.core import run_layers as jax_run_layers  # noqa: E402
from repro.embedding.hierarchy import HierarchicalPS as JaxHierarchicalPS  # noqa: E402
from repro.embedding.psfeed import HierarchyFeed as JaxHierarchyFeed  # noqa: E402
from repro.fe import featureplan as jax_featureplan  # noqa: E402
from repro.fe import get_spec as jax_get_spec  # noqa: E402
from repro.fe import pipeline_graph as JPG  # noqa: E402
from repro.fe.datagen import gen_views as jax_gen_views  # noqa: E402
from repro.fe.modelfeed import ModelFeed as JaxModelFeed  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.models.common import layer_norm as jax_layer_norm  # noqa: E402
from repro.train.optimizer import adamw as jax_adamw  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.metakernel import compile_layers, run_layers  # noqa: E402
from repro_torch.core.scheduler import build_schedule  # noqa: E402
from repro_torch.embedding.hierarchy import HierarchicalPS  # noqa: E402
from repro_torch.embedding.psfeed import WS_SLOTS, HierarchyFeed  # noqa: E402
from repro_torch.fe import featureplan, get_spec  # noqa: E402
from repro_torch.fe import pipeline_graph as PG  # noqa: E402
from repro_torch.fe.compiler import field_slot  # noqa: E402
from repro_torch.fe.datagen import gen_views, write_log_shards  # noqa: E402
from repro_torch.fe.modelfeed import ModelFeed  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.models.common import layer_norm  # noqa: E402
from repro_torch.train.optimizer import adamw  # noqa: E402

CPU = torch.device("cpu")
LR = 1e-3
LAYER_NORM_UNITS = 16
BATCH_KEYS = ("batch_dense", "batch_sparse", "batch_seq_ids", "batch_seq_mask", "batch_label")
LOG1P_ULP = 2                 # XLA's CPU log1p against torch's (test_torch_fe.py)


# --------------------------------------------------------------- layer_norm
@pytest.mark.parametrize("shape", [(64, 21, 32), (512, 6, 16), (300, 7, 128)])
@pytest.mark.parametrize("seed", [0, 1])
def test_layer_norm_matches_jax(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10) + rng.uniform(-3, 3)
         ).astype(np.float32)
    x64 = x.astype(np.float64)
    mu, sd = x64.mean(-1, keepdims=True), x64.std(-1, keepdims=True)
    x_hat = (x64 - mu) / np.sqrt(sd ** 2 + 1e-5)
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    b = rng.standard_normal(shape[-1:]).astype(np.float32)
    for ww, bb in ((np.ones_like(w), np.zeros_like(b)), (w, b)):
        want = np.asarray(jax.jit(jax_layer_norm)(x, ww, bb)).astype(np.float64)
        got = layer_norm(*(torch.from_numpy(a) for a in (x, ww, bb)))
        assert got.dtype == torch.float32 and got.shape == shape
        bound = 2.0 ** -24 * ((1 + np.abs(mu) / sd) * np.maximum(np.abs(x_hat), 1) * np.abs(ww)
                              + np.abs(bb))
        ratio = np.abs(got.numpy().astype(np.float64) - want) / bound
        assert ratio.max() <= LAYER_NORM_UNITS, ratio.max()


# ---------------------------------------------------------- retrieval_score
@pytest.mark.parametrize("arch", ["dlrm-mlperf", "dcn-v2", "autoint", "bst"])
def test_retrieval_score_matches_jax(arch):
    cfg, jcfg = get_arch(arch).smoke(), jax_get_arch(arch).smoke()
    jparams = JR.init_params(jcfg, jax.random.PRNGKey(5))
    params = R.params_from_jax(jparams, CPU)
    user = T.synthetic_batch("recsys", cfg, 1, 3, device=CPU)
    juser = {k: jnp.asarray(v.numpy()) for k, v in user.items()}
    before = {k: v.clone() for k, v in user.items()}
    cand = np.random.default_rng(1).integers(0, cfg.vocab_sizes[cfg.item_field], 96
                                            ).astype(np.int32)
    got = R.retrieval_score(params, cfg, user, torch.from_numpy(cand))
    want = np.asarray(JR.retrieval_score(jparams, jcfg, juser, jnp.asarray(cand)))
    assert got.shape == (96,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert all(torch.equal(user[k], before[k]) for k in user)       # not written through
    alone = R.retrieval_score(params, cfg, user, torch.from_numpy(cand[7:8]))
    np.testing.assert_allclose(alone.numpy(), got.numpy()[7:8], rtol=1e-6, atol=1e-7)


# ------------------------------------------------- the bst spec's ModelFeed
@pytest.mark.parametrize("split", [False, True])
def test_bst_model_feed_matches_jax(split):
    jplan = jax_featureplan.compile(jax_get_spec("bst"))
    tplan = featureplan.compile(get_spec("bst"))
    for arch in ("bst", "dlrm-mlperf"):         # the scenario's own arch, and one it tiles
        jmf = jplan.model_feed(jax_get_arch(arch).smoke(), split_sparse_fields=split)
        mf = tplan.model_feed(get_arch(arch).smoke(), split_sparse_fields=split)
        assert mf.slots == jmf.slots and mf.seq_from == jmf.seq_from
        env = {k: np.asarray(v) for k, v in jplan.run(jax_gen_views(80, seed=2)).items()
               if k.startswith("batch_")}
        if split:
            for i in range(env["batch_sparse"].shape[1]):
                env[field_slot(i)] = env["batch_sparse"][:, i]
            del env["batch_sparse"]
        want = jmf.apply(jmf.select(env))
        got = mf.apply(mf.select({k: torch.from_numpy(v.copy()) for k, v in env.items()}))
        assert set(got) == set(want)
        for k in want:
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
            if k == "dense":        # log1p of the packed ids (no dense block in the spec)
                np.testing.assert_array_max_ulp(got[k].numpy(), np.asarray(want[k]),
                                                maxulp=LOG1P_ULP)
            else:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert ("seq" in got) == (arch == "bst")


# ----------------------------------------------------- fe/pipeline_graph.py
def _graph_table(g):
    return [(op.name, op.inputs, op.outputs, op.device.value, op.cost.bytes_touched,
             op.pre_calls, op.post_calls) for op in g.ops.values()]


def _layer_shape(schedule):
    return [(len(lay.host_ops), len(lay.device_ops)) for lay in schedule.layers]


@pytest.mark.parametrize("which", ["build_fe_graph", "build_fe_graph_legacy"])
def test_pipeline_graphs_match_jax(which):
    g, jg = getattr(PG, which)(), getattr(JPG, which)()
    assert _graph_table(g) == _graph_table(jg)
    assert g.external_inputs == jg.external_inputs
    s, js = build_schedule(g), jax_build_schedule(jg)
    assert s.n_layers == js.n_layers and _layer_shape(s) == _layer_shape(js)
    assert [[p.op.name for p in lay.host_ops + lay.device_ops] for lay in s.layers] == \
        [[p.op.name for p in lay.host_ops + lay.device_ops] for lay in js.layers]
    assert (s.n_device_dispatches, s.n_unfused_dispatches) == \
        (js.n_device_dispatches, js.n_unfused_dispatches)
    assert (PG.FIELD_SIZE, PG.N_CROSS, PG.SEQ_LEN, PG.DENSE_DIM, PG.N_SPARSE_FIELDS,
            PG.N_DENSE_FEATS) == (JPG.FIELD_SIZE, JPG.N_CROSS, JPG.SEQ_LEN, JPG.DENSE_DIM,
                                  JPG.N_SPARSE_FIELDS, JPG.N_DENSE_FEATS)
    out = run_layers(compile_layers(s), dict(gen_views(192, seed=4)), device=CPU)
    jout = jax_run_layers(jax_compile_layers(js), dict(jax_gen_views(192, seed=4)))
    for k in BATCH_KEYS:
        got, want = out[k].numpy(), np.asarray(jout[k])
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k == "batch_dense":              # columns 0, 1: log1p
            np.testing.assert_array_equal(got[:, 2:], want[:, 2:])
            np.testing.assert_array_max_ulp(got[:, :2], want[:, :2], maxulp=LOG1P_ULP)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_ads_spec_schedule_equivalent_to_legacy():
    """The port's half of ``tests/test_spec.py``'s equivalence: the compiled
    ``ads_ctr`` spec has the hand-wired graph's layers, placements and
    dispatch counts, and the same outputs bit for bit."""
    s_new, s_old = build_schedule(PG.build_fe_graph()), build_schedule(PG.build_fe_graph_legacy())
    assert s_new.n_layers == s_old.n_layers
    assert _layer_shape(s_new) == _layer_shape(s_old)
    assert s_new.n_device_dispatches == s_old.n_device_dispatches
    assert s_new.n_unfused_dispatches == s_old.n_unfused_dispatches
    plan = featureplan.compile(get_spec("ads_ctr"))
    lay = plan.layout
    assert (lay.n_sparse_fields, lay.n_dense_feats, lay.seq_len) == \
        (PG.N_SPARSE_FIELDS, PG.N_DENSE_FEATS, 3 * PG.SEQ_LEN)
    views = gen_views(256, seed=3)
    a = plan.run(dict(views), device=CPU)
    b = run_layers(compile_layers(s_old), dict(views), device=CPU)
    for k in BATCH_KEYS:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


# -------------------------------------------------------- the driver's chain
@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("bst_shards")
    write_log_shards(str(d), n_shards=4, rows_per_shard=64, seed=0)
    return d


def _jax_driver_losses(monkeypatch, argv):
    """The JAX driver's ``main`` on ``argv`` (its own init from PRNGKey(0)),
    with the loss of each step recorded at ``ModelFeed.make_step``'s step."""
    losses = []
    real = JaxModelFeed.make_step

    def make_step(self, raw_step, **kw):
        fused = real(self, raw_step, **kw)

        def step(params, opt_state, env):
            p, o, m = fused(params, opt_state, env)
            losses.append(float(m["loss"]))
            return p, o, m

        step.__dict__.update(fused.__dict__)
        return step

    monkeypatch.setattr(JaxModelFeed, "make_step", make_step)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jax_train.main()
    return losses


@pytest.mark.parametrize("feed", ["arena", "on", "off", "hierarchy"])
def test_bst_driver_chain_matches_the_jax_driver(shards, tmp_path, monkeypatch, capsys, feed):
    steps = 4
    argv = ["--arch", "bst", "--data-dir", str(shards), "--spec", "bst", "--fault-tolerant",
            "--steps", str(steps), "--device-feed", "on" if feed == "hierarchy" else feed]
    hier = feed == "hierarchy"
    jlosses = _jax_driver_losses(monkeypatch, argv + (
        ["--embedding", "hierarchy", "--ps-dir", str(tmp_path / "jax"),
         "--host-cache-rows", "64"] if hier else []))
    spec, cfg = get_arch("bst"), get_arch("bst").smoke()
    jparams = JR.init_params(jax_get_arch("bst").smoke(), jax.random.PRNGKey(0),
                             include_embed=not hier)
    params = R.params_from_jax(jparams, CPU)
    opt = adamw(LR)
    make = R.make_hierarchy_train_step if hier else R.make_sparse_train_step
    state = {"params": params, "opt": make(cfg, opt)[1](params)}
    args = T.parse_args(argv + ["--device", "cpu"] + (
        ["--embedding", "hierarchy", "--ps-dir", str(tmp_path / "port"),
         "--host-cache-rows", "64"] if hier else []))
    stats, losses = T.run_streaming(args, spec, cfg, state, opt)
    capsys.readouterr()
    assert len(losses) == len(jlosses) == steps and all(np.isfinite(losses))
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-6)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert stats.batches == steps and stats.train_feed.steps == steps
    if hier:
        assert stats.ps.stats.completed == steps
        jtable = np.fromfile(tmp_path / "jax" / "bst.bst.ps.f32", np.float32)
        table = np.fromfile(tmp_path / "port" / "bst.bst.ps.f32", np.float32)
        touched = jtable.reshape(-1, cfg.embed_dim + 1)[:, -1] != np.float32(0.1)
        assert touched.any() and np.array_equal(
            touched, table.reshape(-1, cfg.embed_dim + 1)[:, -1] != np.float32(0.1))


# -------------------------------------------------------- hierarchy steps
def test_three_bst_hierarchy_steps_match_jax(tmp_path):
    """Three BST hierarchy steps through each package's ``HierarchyFeed``
    and hierarchy step, each from the JAX chain's state before it (dense
    params, Adam moments and the PS rows): the loss, the working-row
    gradients (against JAX's gradient of the full table at the pulled
    rows), and the rows and accumulators the step writes back."""
    cfg, jcfg = get_arch("bst").smoke(), jax_get_arch("bst").smoke()
    key = jax.random.PRNGKey(2)
    jfull = JR.init_params(jcfg, key)
    jdense = {k: v for k, v in jfull.items() if k != "embed"}
    rows = int(cfg.multi_table().total_rows)
    table = np.concatenate([np.asarray(jfull["embed"])[:rows],
                            np.full((rows, 1), 0.1, np.float32)], axis=1)
    jraw, jinit, _ = JR.make_hierarchy_train_step(jcfg, jax_adamw(LR))
    jstep = jax.jit(jraw)
    raw, _ = R.make_hierarchy_train_step(cfg, adamw(LR))
    jst = jinit(jdense)
    feed_args = dict(config=cfg, slots=("batch_label", "batch_sparse"), split=False,
                     n_spec_fields=cfg.n_sparse, field_sources=np.arange(cfg.n_sparse),
                     vocab=np.asarray(cfg.vocab_sizes, np.int32), dense_from=None,
                     seq_from="sparse", dedup_capacity=cfg.dedup_capacity)
    mf, jmf = ModelFeed(**feed_args), JaxModelFeed(**dict(feed_args, config=jcfg))
    for i in range(3):
        rng = np.random.default_rng(60 + i)
        env = {"batch_sparse": rng.integers(0, 1 << 30, (48, cfg.n_sparse)).astype(np.int64),
               "batch_label": (rng.random(48) < 0.3).astype(np.float32)}
        d = tmp_path / str(i)
        d.mkdir()
        table.tofile(d / "port.bin")
        table.tofile(d / "jax.bin")
        ps = HierarchicalPS(str(d / "port.bin"), total_rows=rows, dim=table.shape[1],
                            host_cache_rows=16)
        jps = JaxHierarchicalPS(str(d / "jax.bin"), total_rows=rows, dim=table.shape[1],
                                host_cache_rows=16)
        hfeed, jhfeed = HierarchyFeed(ps, mf, device="cpu"), JaxHierarchyFeed(jps, jmf)
        penv = hfeed.prepare({k: torch.from_numpy(v) for k, v in env.items()})
        jpenv = jhfeed.prepare(dict(env))
        batch = mf.apply(mf.select(penv))
        batch.update({k: penv[k] for k in WS_SLOTS})
        jbatch = jmf.apply(jmf.select(jpenv))
        jbatch.update({k: jpenv[k] for k in WS_SLOTS})
        for k in ("_ws_unique", "_ws_inverse"):
            np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jbatch[k]), err_msg=k)
        np.testing.assert_array_equal(batch["_ws_rows"].numpy(), np.asarray(jbatch["_ws_rows"]))

        # working-row gradients against JAX's full-table gradient at the rows
        unique = batch["_ws_unique"].numpy()
        n = int((unique != R.FILL).sum())
        params = R.params_from_jax(jdense, CPU)
        ws = R.working_set_grads(params, cfg, batch, batch["_ws_rows"], batch["_ws_unique"],
                                 torch.tensor(n), batch["_ws_inverse"],
                                 R.gid_site_shapes(cfg, batch))
        jtab = dict(jdense, embed=jnp.asarray(
            np.pad(table[:, :-1], ((0, cfg.padded_rows - rows), (0, 0)))))
        jloss, jgrads = jax.value_and_grad(JR.loss_fn)(
            jtab, jcfg, {k: jbatch[k] for k in ("sparse", "seq", "label")})
        np.testing.assert_allclose(float(ws.loss), float(jloss), rtol=1e-6)
        np.testing.assert_allclose(ws.working_grad.numpy()[:n],
                                   np.asarray(jgrads["embed"])[unique[:n]],
                                   rtol=1e-5, atol=1e-6)
        assert (ws.working_grad[:n].abs().amax(dim=1) > 0).all()

        opt = {"dense": {"m": R.params_from_jax(jst["dense"]["m"], CPU),
                         "v": R.params_from_jax(jst["dense"]["v"], CPU),
                         "step": int(jst["dense"]["step"])}}
        _, _, m = raw(params, opt, batch)
        jdense, jst, jm = jstep(jdense, jst, jbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-6)
        assert int(m["unique"]) == int(jm["unique"]) == n
        np.testing.assert_allclose(m["ws_rows"].numpy()[:n], np.asarray(jm["ws_rows"])[:n],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(m["ws_accum"].numpy()[:n], np.asarray(jm["ws_accum"])[:n],
                                   rtol=1e-6, atol=1e-6)
        table[unique[:n], :-1] = np.asarray(jm["ws_rows"])[:n]       # the JAX chain's rows
        table[unique[:n], -1] = np.asarray(jm["ws_accum"])[:n]
        hfeed.close()
        jhfeed.close()


# ------------------------------------------------------------------ serving
def test_serve_main_scores_bst_through_the_bst_spec(capsys):
    bst = get_arch("bst")
    assert serve.spec_for(bst.config) == serve.spec_for(bst.smoke()) == "bst"
    assert {serve.spec_for(get_arch(a).config)
            for a in ("dlrm-mlperf", "dcn-v2", "autoint")} == {"dlrm"}
    serve.main(["--arch", "bst", "--requests", "64", "--batch", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=bst device=cpu batches=2 batch=32" in out and "fe_dispatches=2" in out
    mean = float(out.split("mean_score=")[1].split()[0])
    assert 0.0 < mean < 1.0


def test_cli_streams_bst_through_the_bst_plan(shards, capsys):
    """The CLI's streaming run of ``--arch bst --spec bst --device-feed
    arena`` prints its loss line; the plan has JAX's layout and one device
    dispatch (the ``feature_hash`` layer)."""
    T.main(["--arch", "bst", "--data-dir", str(shards), "--spec", "bst", "--device-feed",
            "arena", "--steps", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "plan 'bst':" in out and "1 coalesced device dispatches" in out
    line = next(ln for ln in out.splitlines() if "mode=streaming" in ln)
    assert line.startswith("arch=bst spec=bst mode=streaming steps=4 loss ")
    plan = featureplan.compile(get_spec("bst"))
    assert dataclasses.asdict(plan.layout) == dataclasses.asdict(
        jax_featureplan.compile(jax_get_spec("bst")).layout)
