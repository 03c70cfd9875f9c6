"""The port's hierarchical parameter server (``--embedding hierarchy``) on
the CPU, against the JAX package and against the port's in-memory step.

* The PS file the driver creates is byte for byte the JAX driver's;
  ``pull``/``push``/``read_rows`` and ``TierStats`` agree with JAX under a
  thrashing host cache; the host twins (``dedup_np``, ``collect_gids_np``,
  ``model_ids_np``) are bit-equal; the sparse-update and EmbeddingBag
  helpers of ``embedding/table.py`` agree with JAX (f32 sums in the same
  order: exact; the Adagrad rows to 1 ulp, ROADMAP C5).
* ``HierarchyFeed`` + ``make_hierarchy_train_step`` are bit for bit the
  port's in-memory ``make_sparse_train_step`` over 5 steps (losses, dense
  params, final table and accumulators): the port of
  ``tests/test_hierarchy.py``'s tentpole test. The same 5 losses agree with
  JAX's hierarchy step from the same params and PS file to rtol 1e-4, as
  the 5-step chains of ``test_torch_train.py`` and ``test_torch_driver.py``.
* The runner's ``ps_feed`` stage is bit for bit the serial loop; a prefetch
  sees a concurrent push; a missing extra slot and an overflow raise.
* The driver trains ``--embedding hierarchy`` with ``--device-feed on`` and
  ``off`` (``dlrm`` and ``ads_ctr``), refuses ``arena``, and matches its
  ``--embedding table`` run from the same rows bit for bit.
* The lockset audit of the port's six thread-owning modules is clean.
"""

import dataclasses
import importlib
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.embedding.hierarchy import HierarchicalPS as JaxHierarchicalPS  # noqa: E402
from repro.embedding.psfeed import HierarchyFeed as JaxHierarchyFeed  # noqa: E402
from repro.embedding.psfeed import collect_gids_np as jax_collect_gids_np  # noqa: E402
from repro.fe.modelfeed import ModelFeed as JaxModelFeed  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.train.optimizer import adamw as jax_adamw  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.pipeline import PipelinedRunner  # noqa: E402
from repro_torch.embedding import dedup as D  # noqa: E402
from repro_torch.embedding import table as TB  # noqa: E402
from repro_torch.embedding.hierarchy import HierarchicalPS  # noqa: E402
from repro_torch.embedding.psfeed import (  # noqa: E402
    WS_META,
    WS_SLOTS,
    HierarchyFeed,
    HierarchyFeedError,
    collect_gids_np,
)
from repro_torch.fe.datagen import write_log_shards  # noqa: E402
from repro_torch.fe.modelfeed import ModelFeed, ModelFeedError  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.train.optimizer import adamw  # noqa: E402

# the JAX package's embedding/__init__ re-exports functions named like
# these modules
jax_dedup = importlib.import_module("repro.embedding.dedup")
jax_table = importlib.import_module("repro.embedding.table")

CPU = torch.device("cpu")
LR = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ helpers
def _feed_args(cfg):
    return dict(config=cfg, slots=("batch_label", "batch_sparse"), split=False,
                n_spec_fields=cfg.n_sparse, field_sources=np.arange(cfg.n_sparse),
                vocab=np.asarray(cfg.vocab_sizes[:cfg.n_sparse], np.int32),
                dense_from="sparse" if cfg.n_dense else None,
                seq_from="sparse" if cfg.kind == "bst" else None,
                dedup_capacity=cfg.dedup_capacity)


def _feed(cfg) -> ModelFeed:
    """Direct ModelFeed over packed synthetic envs (no FE plan needed)."""
    return ModelFeed(**_feed_args(cfg))


def _ps_from_table(path, embed, accum, *, cls=HierarchicalPS, host_cache_rows=1 << 20):
    """PS file seeded with a table's rows + Adagrad column."""
    arr = np.concatenate([np.asarray(embed, np.float32),
                          np.asarray(accum, np.float32)[:, None]], axis=1)
    arr.tofile(path)
    return cls(str(path), total_rows=arr.shape[0], dim=arr.shape[1],
               host_cache_rows=host_cache_rows)


def _envs(cfg, n, batch=16, seed=0):
    """Packed synthetic envs as numpy arrays (the JAX feed's input)."""
    rng = np.random.default_rng(seed)
    return [{"batch_sparse": rng.integers(0, 1 << 30, (batch, cfg.n_sparse)).astype(np.int64),
             "batch_label": (rng.random(batch) < 0.25).astype(np.float32)}
            for _ in range(n)]


def _tensors(env):
    return {k: torch.from_numpy(v) for k, v in env.items()}


def _bounded(fn, timeout=60.0):
    """Run ``fn`` in a thread; fail (not hang) if it does not finish."""
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:  # re-raised in the test thread
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"run did not finish within {timeout} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


# ------------------------------------------------------------- the PS tier
class _Stop(Exception):
    pass


def _stop_at_feed(*args, **kwargs):
    raise _Stop


def test_driver_ps_file_is_byte_equal_to_jax(tmp_path, monkeypatch):
    """Both drivers create the PS file of ``--embedding hierarchy`` (each
    stopped right after, before any step writes to it). 4,000x the smoke
    vocabularies: 1,040,000 rows, two chunks of the chunked init."""
    import repro.embedding.psfeed as jax_psfeed
    import repro.launch.train as jax_train
    import repro_torch.embedding.psfeed as psfeed

    data = tmp_path / "shards"
    write_log_shards(str(data), n_shards=1, rows_per_shard=16, seed=0)
    common = ["--arch", "dlrm-mlperf", "--data-dir", str(data), "--spec", "dlrm",
              "--embedding", "hierarchy", "--vocab-scale", "4000", "--steps", "1"]
    monkeypatch.setattr(jax_psfeed, "HierarchyFeed", _stop_at_feed)
    monkeypatch.setattr(sys, "argv", ["train"] + common + ["--ps-dir", str(tmp_path / "jax")])
    with pytest.raises(_Stop):
        jax_train.main()
    monkeypatch.setattr(psfeed, "HierarchyFeed", _stop_at_feed)
    with pytest.raises(_Stop):
        T.main(common + ["--ps-dir", str(tmp_path / "port"), "--device", "cpu"])
    name = "dlrm-mlperf.dlrm.ps.f32"
    want = (tmp_path / "jax" / name).read_bytes()
    got = (tmp_path / "port" / name).read_bytes()
    assert len(got) == 1_040_000 * 17 * 4 and got == want
    rows = np.frombuffer(got, np.float32).reshape(-1, 17)
    assert (rows[:, -1] == np.float32(0.1)).all() and np.abs(rows[:, :-1]).max() <= 0.25


def test_default_init_is_byte_equal_to_jax(tmp_path):
    """The uniform default init (no init_fn), over two chunks of 2,048 rows."""
    for cls, name in ((JaxHierarchicalPS, "jax.bin"), (HierarchicalPS, "port.bin")):
        cls(str(tmp_path / name), total_rows=2100, dim=8192, seed=3)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    with pytest.raises(ValueError, match="does not match shape"):
        HierarchicalPS(str(tmp_path / "port.bin"), total_rows=2101, dim=8192)


def test_pull_push_read_rows_and_tier_stats_match_jax(tmp_path):
    """The same pulls, pushes and reads through a host cache of 8 rows
    (hits, misses, evictions, working sets larger than the cache) give the
    same rows, ids, inverse and TierStats in both packages."""
    rows, dim = 64, 5
    rng = np.random.default_rng(1)
    init = rng.normal(size=(rows, dim)).astype(np.float32)
    ps = {}
    for cls, name in ((JaxHierarchicalPS, "jax"), (HierarchicalPS, "port")):
        init.tofile(tmp_path / name)
        ps[name] = cls(str(tmp_path / name), total_rows=rows, dim=dim, host_cache_rows=8)
    for step in range(30):
        ids = rng.integers(0, rows, rng.integers(1, 20))
        (jr, ju, ji), (pr, pu, pi) = ps["jax"].pull(ids), ps["port"].pull(ids)
        np.testing.assert_array_equal(pr, jr)
        np.testing.assert_array_equal(pu, ju)
        np.testing.assert_array_equal(pi, ji)
        assert pu.dtype == ju.dtype and pi.dtype == ji.dtype
        for p in ps.values():
            p.push(ju, jr + np.float32(step + 1))
        probe = np.unique(rng.integers(0, rows, 6))
        np.testing.assert_array_equal(ps["port"].read_rows(probe), ps["jax"].read_rows(probe))
        assert dataclasses.asdict(ps["port"].stats) == dataclasses.asdict(ps["jax"].stats)
        assert ps["port"].host_cache_size == ps["jax"].host_cache_size
    s = ps["port"].stats
    assert s.evictions > 0 and s.host_hits > 0 and s.ssd_reads > 0
    assert ps["port"].stats.host_hit_rate == ps["jax"].stats.host_hit_rate
    for p in ps.values():
        p.flush()
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    with pytest.raises(ValueError, match="out of range"):
        ps["port"].read_rows(np.array([rows]))


# ---------------------------------------------------------- the host twins
def test_dedup_np_matches_jax():
    rng = np.random.default_rng(2)
    for ids in (rng.integers(0, 100, (7, 5)), rng.integers(0, D.MAX_ID, 300),
                np.array([0, D.MAX_ID - 1, 0]), np.zeros((0,), np.int64)):
        (u, inv), (ju, jinv) = D.dedup_np(ids), jax_dedup.dedup_np(ids)
        np.testing.assert_array_equal(u, ju)
        np.testing.assert_array_equal(inv, jinv)
        assert u.dtype == ju.dtype == np.int64 and inv.dtype == jinv.dtype == np.int32
    assert D.MAX_ID == jax_dedup.MAX_ID
    for bad in ([0, 2**31], [D.MAX_ID], [-1, 5]):
        with pytest.raises(ValueError) as port_err:
            D.dedup_np(np.array(bad, np.int64))
        with pytest.raises(ValueError) as jax_err:
            jax_dedup.dedup_np(np.array(bad, np.int64))
        assert str(port_err.value) == str(jax_err.value)
    u, _ = D.dedup_np(np.array([-5], np.int64), check_bounds=False)
    assert u[0] == -5


@pytest.mark.parametrize("split", [False, True], ids=["packed", "split"])
def test_collect_gids_np_and_model_ids_np_match_jax(split):
    """dlrm-mlperf through the real plan's ModelFeed (packed and per-field
    feeds): the ids the PS pulls, bit for bit, and in the device step's
    site shapes."""
    from repro.fe import featureplan as jax_featureplan
    from repro.fe import get_spec as jax_get_spec
    from repro.fe.datagen import gen_views as jax_gen_views
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import gen_views

    cfg, jcfg = get_arch("dlrm-mlperf").smoke(), jax_get_arch("dlrm-mlperf").smoke()
    plan, jplan = (featureplan.compile(get_spec("dlrm")),
                   jax_featureplan.compile(jax_get_spec("dlrm")))
    mf = plan.model_feed(cfg, split_sparse_fields=split)
    jmf = jplan.model_feed(jcfg, split_sparse_fields=split)
    if split:
        env = plan.arena_binding(split_sparse_fields=True).make_feeder(
            rows_hint=96, device="cpu").stage(plan.run(gen_views(96, seed=4), device="cpu"))
        jenv = jplan.arena_binding(split_sparse_fields=True).make_feeder(
            rows_hint=96).stage(jplan.run(jax_gen_views(96, seed=4)))
    else:
        env = plan.run(gen_views(96, seed=4), device="cpu")
        jenv = jplan.run(jax_gen_views(96, seed=4))
    (sparse, seq), (jsparse, jseq) = mf.model_ids_np(env), jmf.model_ids_np(jenv)
    np.testing.assert_array_equal(sparse, jsparse)
    assert sparse.dtype == jsparse.dtype == np.int32 and seq is None and jseq is None
    # the host twin equals the device path's ids
    batch = mf.apply(mf.select(env))
    np.testing.assert_array_equal(batch["sparse"].numpy(), sparse)
    gids, jgids = collect_gids_np(cfg, sparse), jax_collect_gids_np(jcfg, jsparse)
    assert gids.keys() == jgids.keys() == {"sparse"}
    np.testing.assert_array_equal(gids["sparse"], jgids["sparse"])
    np.testing.assert_array_equal(gids["sparse"], R.collect_gids(cfg, batch)["sparse"].numpy())
    assert R.gid_site_shapes(cfg, batch) == {"sparse": gids["sparse"].shape}


# ------------------------------------------------------- table.py helpers
def test_sparse_update_and_bag_lookups_match_jax():
    """scatter_unique_grads, the EmbeddingBag sums and sparse_grad_update
    (FILL slots dropped, an overflowing inverse dropped) against JAX. The
    sums add in the same order (exact); the Adagrad rows go through XLA's
    CPU float rewrites, held to 1 ulp (ROADMAP C5)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    v, d = 40, 8
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, 30).astype(np.int32)
    grads = rng.normal(size=(30, d)).astype(np.float32)
    for cap in (64, 10):      # 10 < the unique count: the inverse overflows
        _, inv, _ = jax_dedup.dedup(jnp.asarray(ids), capacity=cap)
        got = D.scatter_unique_grads(torch.from_numpy(grads),
                                     torch.from_numpy(np.array(inv)), cap)
        want = jax_dedup.scatter_unique_grads(jnp.asarray(grads), inv, cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    seg = np.sort(rng.integers(0, 6, 30)).astype(np.int32)
    np.testing.assert_array_equal(
        TB.bag_lookup_segment(torch.from_numpy(table), torch.from_numpy(ids),
                              torch.from_numpy(seg), 6).numpy(),
        np.asarray(jax_table.bag_lookup_segment(jnp.asarray(table), jnp.asarray(ids),
                                                jnp.asarray(seg), 6)))
    bag_ids = ids.reshape(5, 6)
    mask = rng.random((5, 6)) < 0.7
    np.testing.assert_allclose(
        TB.bag_lookup_padded(torch.from_numpy(table), torch.from_numpy(bag_ids),
                             torch.from_numpy(mask)).numpy(),
        np.asarray(jax_table.bag_lookup_padded(jnp.asarray(table), jnp.asarray(bag_ids),
                                               jnp.asarray(mask))), rtol=0, atol=1e-6)

    ids[:3] = 0               # row 0 in the batch beside padded slots
    p = torch.from_numpy(table.copy())
    st = TB.init_sparse_adagrad(v, device=CPU)
    jp, jst = jnp.asarray(table), jax_table.init_sparse_adagrad(v)
    for _ in range(2):
        p, st = TB.sparse_grad_update(p, st, torch.from_numpy(ids), torch.from_numpy(grads),
                                      capacity=64, lr=0.05)
        jp, jst = jax_table.sparse_grad_update(jp, jst, jnp.asarray(ids), jnp.asarray(grads),
                                               capacity=64, lr=0.05)
    np.testing.assert_array_max_ulp(p.numpy(), np.asarray(jp), maxulp=1)
    np.testing.assert_array_max_ulp(st.accum.numpy(), np.asarray(jst.accum), maxulp=1)
    untouched = np.setdiff1d(np.arange(v), ids)
    np.testing.assert_array_equal(p.numpy()[untouched], table[untouched])


# -------------------------------------------------------- init and steps
def test_dense_init_is_the_same_with_and_without_embed():
    cfg = get_arch("dlrm-mlperf").smoke()
    full = R.init_params(cfg, torch.Generator().manual_seed(7))
    dense = R.init_params(cfg, torch.Generator().manual_seed(7), include_embed=False)
    assert "embed" not in dense and set(full) == set(dense) | {"embed"}
    for k in dense:
        assert torch.equal(full[k], dense[k]), k
    other = R.init_params(cfg, torch.Generator().manual_seed(8), include_embed=False)
    assert not torch.equal(other["bot_w0"], dense["bot_w0"])
    assert not torch.equal(full["bot_w0"], full["top_w0"][:full["bot_w0"].shape[0],
                                                         :full["bot_w0"].shape[1]])


def _hierarchy_chain(tmp_path, cfg, params_dense, embed, accum, envs, *, host_cache_rows=8):
    """The port's hierarchy chain over ``envs`` (serial prepare / step /
    complete): losses, unique counts, dense params, PS table."""
    opt = adamw(LR)
    raw_h, init_h = R.make_hierarchy_train_step(cfg, opt)
    st_h = init_h(params_dense)
    ps = _ps_from_table(tmp_path / "ps.bin", embed, accum, host_cache_rows=host_cache_rows)
    mf = _feed(cfg)
    hier = HierarchyFeed(ps, mf, device="cpu")
    fused = mf.make_step(raw_h, extra_slots=WS_SLOTS)
    losses, uniques = [], []
    for env in envs:
        ps_env = hier.prepare(_tensors(env))
        params_dense, st_h, m = fused(params_dense, st_h, ps_env)
        hier.complete(ps_env[WS_META], m["ws_rows"], m["ws_accum"])
        losses.append(float(m["loss"]))
        uniques.append(int(m["unique"]))
    hier.drain()
    assert hier.error is None
    assert hier.stats.completed == len(envs) and ps.stats.pushes == len(envs)
    return losses, uniques, params_dense, np.asarray(ps._ssd).copy()


def test_hierarchy_step_bitwise_vs_in_memory(tmp_path):
    """5 steps through HierarchyFeed + make_hierarchy_train_step produce
    the SAME losses, dense params, and final table rows and accumulators
    as the in-memory make_sparse_train_step, bit for bit."""
    _hierarchy_bitwise_vs_in_memory(tmp_path, "dlrm-mlperf")


@pytest.mark.parametrize("arch", ["dcn-v2", "autoint", "bst"])
def test_hierarchy_step_of_the_new_forwards_bitwise_vs_in_memory(tmp_path, arch):
    """The DCN-v2 and AutoInt forwards read the working set's rows from
    ``_rows_sparse`` as DLRM's does, and BST's from ``_rows_seq`` and
    ``_rows_other``, so the hierarchy step needs no change for them: the
    same bit-for-bit check."""
    _hierarchy_bitwise_vs_in_memory(tmp_path, arch)


def _hierarchy_bitwise_vs_in_memory(tmp_path, arch):
    cfg = get_arch(arch).smoke()
    opt = adamw(LR)
    params_full = R.init_params(cfg, torch.Generator().manual_seed(0))
    params_dense = R.init_params(cfg, torch.Generator().manual_seed(0), include_embed=False)
    raw_s, init_s = R.make_sparse_train_step(cfg, opt)
    st_s = init_s(params_full)
    rows = int(cfg.multi_table().total_rows)
    embed0 = params_full["embed"][:rows].numpy().copy()
    accum0 = st_s["embed_accum"][:rows].numpy().copy()
    envs = _envs(cfg, 5)
    losses_h, uniques_h, dense_h, table = _hierarchy_chain(
        tmp_path, cfg, params_dense, embed0, accum0, envs)   # tiny cache: SSD traffic

    fused_s = _feed(cfg).make_step(raw_s)
    for env, loss_h, unique_h in zip(envs, losses_h, uniques_h):
        params_full, st_s, m_s = fused_s(params_full, st_s, _tensors(env))
        assert loss_h == float(m_s["loss"])
        assert unique_h == int(m_s["unique"])
    for k in dense_h:
        assert torch.equal(dense_h[k], params_full[k]), k
    np.testing.assert_array_equal(table[:, :-1], params_full["embed"][:rows].numpy())
    np.testing.assert_array_equal(table[:, -1], st_s["embed_accum"][:rows].numpy())
    assert not np.array_equal(table[:, :-1], embed0)


def test_hierarchy_losses_match_jax(tmp_path):
    """The same 5 steps in JAX (its HierarchyFeed and hierarchy step) and in
    the port, from JAX's params (``params_from_jax``) and the same PS
    bytes: losses to rtol 1e-4 (XLA's CPU float rewrites, ROADMAP C5),
    unique counts exact."""
    jcfg, cfg = jax_get_arch("dlrm-mlperf").smoke(), get_arch("dlrm-mlperf").smoke()
    key = jax.random.PRNGKey(0)
    jfull = JR.init_params(jcfg, key)
    jdense = JR.init_params(jcfg, key, include_embed=False)
    rows = int(cfg.multi_table().total_rows)
    embed0 = np.asarray(jfull["embed"])[:rows]
    accum0 = np.full((rows,), 0.1, np.float32)
    envs = _envs(cfg, 5, seed=3)
    losses, uniques, _, table = _hierarchy_chain(
        tmp_path, cfg, R.params_from_jax(jdense, CPU), embed0, accum0, envs)

    jraw, jinit, _ = JR.make_hierarchy_train_step(jcfg, jax_adamw(LR))
    (tmp_path / "jax").mkdir()
    jps = _ps_from_table(tmp_path / "jax" / "ps.bin", embed0, accum0, cls=JaxHierarchicalPS,
                         host_cache_rows=8)
    jmf = JaxModelFeed(**_feed_args(jcfg))
    jhier = JaxHierarchyFeed(jps, jmf)
    jfused = jmf.make_step(jraw, donate=False, extra_slots=WS_SLOTS)
    jst, jlosses, juniques = jinit(jdense), [], []
    for env in envs:
        ps_env = jhier.prepare(dict(env))
        jdense, jst, m = jfused(jdense, jst, ps_env)
        jhier.complete(ps_env[WS_META], m["ws_rows"], m["ws_accum"])
        jlosses.append(float(m["loss"]))
        juniques.append(int(m["unique"]))
    jhier.drain()
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert uniques == juniques and all(np.isfinite(losses))
    touched = np.asarray(jps._ssd)[:, -1] != np.float32(0.1)
    assert (touched == (table[:, -1] != np.float32(0.1))).all() and touched.any()


# ---------------------------------------------------- runner and protocol
def test_threaded_runner_bitwise_vs_serial(tmp_path):
    """The pipelined (prefetch + async write-back) execution is bit for bit
    the serial pull-train-push: the fixup protocol hides latency, not
    determinism."""
    cfg = get_arch("dlrm-mlperf").smoke()
    envs = _envs(cfg, 6, seed=7)
    rows = int(cfg.multi_table().total_rows)
    embed = R.init_params(cfg, torch.Generator().manual_seed(0))["embed"][:rows].numpy()

    def run(threaded: bool):
        params = R.init_params(cfg, torch.Generator().manual_seed(0), include_embed=False)
        raw_h, init_h = R.make_hierarchy_train_step(cfg, adamw(LR))
        d = tmp_path / ("t" if threaded else "s")
        d.mkdir(exist_ok=True)
        ps = _ps_from_table(d / "ps.bin", embed, np.full((rows,), 0.1, np.float32),
                            host_cache_rows=16)
        mf = _feed(cfg)
        hier = HierarchyFeed(ps, mf, device="cpu")
        fused = mf.make_step(raw_h, extra_slots=WS_SLOTS)
        losses = []

        def step_fn(state, e):
            p, o, m = fused(state["params"], state["opt"], e)
            hier.complete(e[WS_META], m["ws_rows"], m["ws_accum"])
            losses.append(float(m["loss"]))
            return {"params": p, "opt": o}

        state = {"params": params, "opt": init_h(params)}
        if threaded:
            runner = PipelinedRunner([], step_fn, ps_feed=hier, device="cpu")
            _bounded(lambda: runner.run(state, [_tensors(e) for e in envs]))
            assert runner.stats.ps is hier and runner.stats.batches == len(envs)
            assert runner.stats.ps_seconds > 0
        else:
            for e in envs:
                state = step_fn(state, hier.prepare(_tensors(e)))
        hier.drain()
        return losses, np.asarray(ps._ssd).copy(), hier.stats

    losses_t, table_t, stats_t = run(threaded=True)
    losses_s, table_s, _ = run(threaded=False)
    assert losses_t == losses_s
    np.testing.assert_array_equal(table_t, table_s)
    assert stats_t.batches == stats_t.completed == len(envs)


def test_prefetch_fixup_sees_concurrent_push(tmp_path):
    """A pull issued before the previous step's write-back is fixed up to
    the post-push rows before release."""
    cfg = get_arch("dlrm-mlperf").smoke()
    rows = int(cfg.multi_table().total_rows)
    ps = _ps_from_table(tmp_path / "ps.bin", np.zeros((rows, cfg.embed_dim), np.float32),
                        np.full((rows,), 0.1, np.float32))
    hier = HierarchyFeed(ps, _feed(cfg), device="cpu")
    env = _tensors(_envs(cfg, 1, seed=3)[0])

    out0 = hier.prepare(dict(env))
    seq0, unique0 = out0[WS_META]
    n0 = len(unique0)
    box = {}

    def prefetch():
        box["out"] = hier.prepare(dict(env))  # same ids: all become stale

    t = threading.Thread(target=prefetch)
    t.start()
    deadline = time.time() + 10
    while hier.stats.batches < 2:             # the prefetch PULLED, then waits
        assert time.time() < deadline, "prefetch never pulled"
        time.sleep(0.005)
    assert t.is_alive()
    pushed_rows = np.full((n0, cfg.embed_dim), 7.5, np.float32)
    pushed_accum = np.full((n0,), 2.25, np.float32)
    hier.complete((seq0, unique0), torch.from_numpy(pushed_rows), torch.from_numpy(pushed_accum))
    t.join(timeout=10)
    assert not t.is_alive()
    assert hier.stats.fixups == 1 and hier.stats.fixup_rows == n0

    out1 = box["out"]
    n1 = len(out1[WS_META][1])
    np.testing.assert_array_equal(out1["_ws_rows"][:n1].numpy(), pushed_rows)
    np.testing.assert_array_equal(out1["_ws_accum"][:n1].numpy(), pushed_accum)
    assert (out1["_ws_unique"][n1:] == D.MAX_ID).all() and (out1["_ws_rows"][n1:] == 0).all()
    hier.complete(out1[WS_META], out1["_ws_rows"], out1["_ws_accum"])
    hier.drain()


def test_make_step_missing_extra_slot_errors():
    cfg = get_arch("dlrm-mlperf").smoke()
    raw_h, _ = R.make_hierarchy_train_step(cfg, adamw(LR))
    step = _feed(cfg).make_step(raw_h, extra_slots=WS_SLOTS)
    with pytest.raises(ModelFeedError, match="extra slot '_ws_rows'"):
        step({}, {}, _tensors(_envs(cfg, 1)[0]))   # no _ws_* slots: prefetch not wired


def test_working_set_overflow_and_write_back_errors_surface(tmp_path):
    cfg = dataclasses.replace(get_arch("dlrm-mlperf").smoke(), dedup_capacity=4)
    rows = int(cfg.multi_table().total_rows)
    ps = _ps_from_table(tmp_path / "ps.bin", np.zeros((rows, cfg.embed_dim), np.float32),
                        np.zeros((rows,), np.float32))
    hier = HierarchyFeed(ps, _feed(cfg), device="cpu")
    with pytest.raises(HierarchyFeedError, match="overflow"):
        hier.prepare(_tensors(_envs(cfg, 1)[0]))
    hier.drain()
    # a failed write-back is kept, poisons the feed and surfaces
    hier = HierarchyFeed(ps, _feed(dataclasses.replace(cfg, dedup_capacity=512)), device="cpu")
    out = hier.prepare(_tensors(_envs(cfg, 1)[0]))
    hier.complete(out[WS_META], torch.zeros((2, 3)), torch.zeros((2,)))   # wrong width
    hier.drain()
    assert isinstance(hier.error, ValueError)
    with pytest.raises(HierarchyFeedError, match="write-back failed"):
        hier.complete(out[WS_META], out["_ws_rows"], out["_ws_accum"])


def test_ps_metrics_tier_registered(tmp_path):
    """runner.stats.ps feeds the 'ps' tier and rollup keys of the registry."""
    from repro_torch.obs.metrics import MetricsRegistry

    cfg = get_arch("dlrm-mlperf").smoke()
    rows = int(cfg.multi_table().total_rows)
    embed = R.init_params(cfg, torch.Generator().manual_seed(0))["embed"][:rows].numpy()
    ps = _ps_from_table(tmp_path / "ps.bin", embed, np.full((rows,), 0.1, np.float32))
    mf = _feed(cfg)
    hier = HierarchyFeed(ps, mf, device="cpu")
    raw_h, init_h = R.make_hierarchy_train_step(cfg, adamw(LR))
    params = R.init_params(cfg, torch.Generator().manual_seed(0), include_embed=False)
    fused = mf.make_step(raw_h, extra_slots=WS_SLOTS)

    def step_fn(state, e):
        p, o, m = fused(state["params"], state["opt"], e)
        hier.complete(e[WS_META], m["ws_rows"], m["ws_accum"])
        return {"params": p, "opt": o}

    runner = PipelinedRunner([], step_fn, ps_feed=hier, device="cpu")
    _bounded(lambda: runner.run({"params": params, "opt": init_h(params)},
                                [_tensors(e) for e in _envs(cfg, 3)]))
    hier.drain()
    snap = MetricsRegistry.from_pipeline(runner.stats).snapshot()
    assert snap["ps.pulls"] == 3 and snap["ps.pushes"] == 3
    assert snap["ps.batches"] == 3 and snap["ps.completed"] == 3
    assert snap["rollup.ps_pull_seconds"] >= 0
    assert 0 <= snap["rollup.ps_host_hit_rate"] <= 1
    assert snap["pipeline.ps_seconds"] > 0


# ------------------------------------------------------------- the driver
@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    write_log_shards(str(d), n_shards=4, rows_per_shard=64, seed=0)
    return d


@pytest.mark.parametrize("feed,spec", [("on", "dlrm"), ("off", "dlrm"), ("on", "ads_ctr")])
def test_driver_trains_hierarchy(shards, tmp_path, capsys, feed, spec):
    T.main(["--arch", "dlrm-mlperf", "--data-dir", str(shards), "--spec", spec,
            "--device-feed", feed, "--embedding", "hierarchy", "--ps-dir", str(tmp_path),
            "--host-cache-rows", "64", "--device-budget-mb", "0.01", "--steps", "4",
            "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    table = next(ln for ln in out if ln.startswith("ps: table"))
    assert "(260 rows x 17 f32), host cache 64 rows" in table and "EXCEEDS" in table
    assert (tmp_path / f"dlrm-mlperf.{spec}.ps.f32").stat().st_size == 260 * 17 * 4
    summary = next(ln for ln in out if ln.startswith("ps: pulls="))
    assert "pulls=4 pushes=4" in summary and "ps_stage=" in summary
    line = next(ln for ln in out if "mode=streaming" in ln)
    assert f"spec={spec}" in line and "steps=4 loss" in line
    assert any(ln.startswith("device-feed: batches=4") for ln in out) == (feed == "on")


def test_driver_refuses_hierarchy_with_the_arena(shards, tmp_path):
    with pytest.raises(SystemExit, match="incompatible with --device-feed arena"):
        T.main(["--arch", "dlrm-mlperf", "--data-dir", str(shards), "--spec", "dlrm",
                "--device-feed", "arena", "--embedding", "hierarchy", "--ps-dir",
                str(tmp_path), "--steps", "1", "--device", "cpu"])
    assert not os.listdir(tmp_path)


def test_driver_hierarchy_matches_the_table_run_from_the_same_rows(shards, tmp_path):
    """``run_streaming`` with ``--embedding hierarchy`` against
    ``--embedding table`` started from the PS file's rows and the same
    dense params (``--device-feed on``, shards in plan order): losses, dense
    params, and the PS file against the table and accumulators, bit for
    bit — the claim ``chip_smoke.py`` holds on the card to a tolerance."""
    spec = get_arch("dlrm-mlperf")
    cfg = spec.smoke()
    common = ["--arch", "dlrm-mlperf", "--data-dir", str(shards), "--spec", "dlrm",
              "--device-feed", "on", "--fault-tolerant", "--steps", "4", "--device", "cpu",
              "--ps-dir", str(tmp_path), "--host-cache-rows", "32"]
    args_h = T.parse_args(common + ["--embedding", "hierarchy"])
    ps = T.open_ps(args_h, cfg)
    rows = ps.total_rows
    init = np.asarray(ps._ssd).copy()
    del ps
    gen = torch.Generator().manual_seed(0)
    dense = R.init_params(cfg, gen, include_embed=False)
    params = {k: v.clone() for k, v in dense.items()}
    params["embed"] = torch.zeros((cfg.padded_rows, cfg.embed_dim))
    params["embed"][:rows] = torch.from_numpy(init[:, :-1])
    opt = adamw(LR)
    st_t = {"params": params, "opt": R.make_sparse_train_step(cfg, opt)[1](params)}
    st_t["opt"]["embed_accum"][:rows] = torch.from_numpy(init[:, -1])
    st_h = {"params": dense, "opt": R.make_hierarchy_train_step(cfg, opt)[1](dense)}

    stats_h, losses_h = T.run_streaming(args_h, spec, cfg, st_h, opt)
    _, losses_t = T.run_streaming(T.parse_args(common), spec, cfg, st_t, adamw(LR))
    assert len(losses_h) == 4 and losses_h == losses_t
    for k, v in st_h["params"].items():
        assert torch.equal(v, st_t["params"][k]), k
    table = np.fromfile(tmp_path / "dlrm-mlperf.dlrm.ps.f32", np.float32).reshape(rows, -1)
    np.testing.assert_array_equal(table[:, :-1], st_t["params"]["embed"][:rows].numpy())
    np.testing.assert_array_equal(table[:, -1], st_t["opt"]["embed_accum"][:rows].numpy())
    assert stats_h.ps.stats.completed == 4 and (table != init).any()


# ------------------------------------------------------- the lockset audit
def test_lockset_audit_of_the_port_is_clean():
    """The copied AST audit over the port's six thread-owning modules
    (``DEFAULT_FILES``, ``embedding/psfeed.py`` among them): 0 findings."""
    from repro_torch.check.lockset import DEFAULT_FILES, audit_default

    assert "embedding/psfeed.py" in DEFAULT_FILES and len(DEFAULT_FILES) == 6
    findings = audit_default(root=os.path.join(ROOT, "src", "repro_torch"))
    assert findings == [], "\n".join(f.render() for f in findings)
