"""The port's ModelFeed and DLRM serving step against the JAX package.

``ModelFeed.apply`` is integer remap + floor-mod + tiling, so it must match
bit for bit. ``serve_step`` runs the same fp32 math in another summation
order (matmuls and the interaction), so logits are compared to rtol 1e-4 /
atol 1e-5 with JAX's parameters carried across by ``params_from_jax``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs.dlrm_mlperf import CONFIG as JAX_CONFIG  # noqa: E402
from repro.fe import featureplan as jax_featureplan  # noqa: E402
from repro.fe import get_spec as jax_get_spec  # noqa: E402
from repro.fe.compiler import OutputLayout as JaxOutputLayout  # noqa: E402
from repro.fe.datagen import gen_views as jax_gen_views  # noqa: E402
from repro.fe.modelfeed import dedup_capacity_hint as jax_capacity_hint  # noqa: E402
from repro.models import recsys as JR  # noqa: E402

from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.fe import featureplan, get_spec  # noqa: E402
from repro_torch.fe.compiler import OutputLayout, field_slot  # noqa: E402
from repro_torch.fe.modelfeed import ModelFeedError, dedup_capacity_hint  # noqa: E402
from repro_torch.fe import modelfeed  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402

NARROW = dict(name="dlrm-narrow", kind="dlrm", n_dense=13, n_sparse=26, embed_dim=16,
              vocab_sizes=tuple(40 + 17 * i for i in range(26)),
              bot_mlp=(32, 16), top_mlp=(64, 32, 1))
CONFIGS = {"smoke": (get_arch("dlrm-mlperf").smoke(), jax_get_arch("dlrm-mlperf").smoke()),
           "narrow": (R.RecsysConfig(**NARROW), JR.RecsysConfig(**NARROW))}


def _assert_batches_equal(ref, got):
    assert set(ref) == set(got)
    for k in ref:
        r, g = np.asarray(ref[k]), got[k].cpu().numpy()
        assert r.dtype == g.dtype, k
        np.testing.assert_array_equal(g, r, err_msg=k)


def test_registry_and_configs_match_jax():
    assert list_archs() == ["dlrm-mlperf"]
    arch, jarch = get_arch("dlrm-mlperf"), jax_get_arch("dlrm-mlperf")
    assert arch.family == jarch.family == "recsys"
    for cfg, jcfg in [(arch.config, JAX_CONFIG), (arch.smoke(), jarch.smoke())]:
        assert R.param_shapes(cfg) == JR.param_shapes(jcfg)
        assert cfg.padded_rows == jcfg.padded_rows
    assert sum(R.CRITEO_1TB_VOCABS) == 187_767_399
    with pytest.raises(KeyError):
        get_arch("yi-9b")


@pytest.mark.parametrize("split", [False, True])
def test_model_feed_apply_matches_jax(split):
    jplan = jax_featureplan.compile(jax_get_spec("dlrm"))
    tplan = featureplan.compile(get_spec("dlrm"))
    jcfg, cfg = jax_get_arch("dlrm-mlperf").smoke(), get_arch("dlrm-mlperf").smoke()
    env = jplan.run(jax_gen_views(40, seed=7))
    jmf = jplan.model_feed(jcfg, split_sparse_fields=split)
    mf = tplan.model_feed(cfg, split_sparse_fields=split)
    assert mf.slots == jmf.slots
    np.testing.assert_array_equal(mf.field_sources, jmf.field_sources)
    np.testing.assert_array_equal(mf.vocab, jmf.vocab)
    # negative and large ids pin floor-mod (torch.remainder, never fmod)
    sparse = np.asarray(env["batch_sparse"]).copy()
    sparse[:4, :3] = [[-7, -1, -64], [2**31 - 1, -(2**31), 99], [-33, 5, -100], [0, -32, 31]]
    jenv = {k: np.asarray(v) for k, v in env.items() if k.startswith("batch_")}
    jenv["batch_sparse"] = sparse
    if split:
        for i in range(sparse.shape[1]):
            jenv[field_slot(i)] = sparse[:, i]
        del jenv["batch_sparse"]
    tenv = {k: torch.from_numpy(v.copy()) for k, v in jenv.items()}
    _assert_batches_equal(jmf.apply(jmf.select(jenv)), mf.apply(mf.select(tenv)))


def test_model_feed_compile_contract():
    cfg = get_arch("dlrm-mlperf").smoke()
    untuned = dataclasses.replace(cfg, dedup_capacity=0)
    plan = featureplan.compile(get_spec("dlrm"))
    mf = plan.model_feed(untuned, rows_hint=512)
    assert mf.dedup_capacity == mf.config.dedup_capacity == dedup_capacity_hint(cfg, 512)
    assert plan.model_feed(cfg, rows_hint=512).dedup_capacity == 512   # tuned stays
    for rows, mode in [(64, "worst"), (512, "expected"), (7, "worst")]:
        assert dedup_capacity_hint(cfg, rows, mode=mode) == \
            jax_capacity_hint(jax_get_arch("dlrm-mlperf").smoke(), rows, mode=mode)
    with pytest.raises(ModelFeedError):
        dedup_capacity_hint(cfg, 0)
    with pytest.raises(ModelFeedError):
        modelfeed.compile(OutputLayout(0, 13, 0, 1 << 20), cfg)
    with pytest.raises(ModelFeedError):
        mf.select({"batch_label": torch.zeros(4)})
    bad = {"batch_label": torch.zeros(4), "batch_sparse": torch.zeros((4, 3), dtype=torch.int32),
           "batch_dense": torch.zeros((4, 13))}
    with pytest.raises(ModelFeedError, match="shape mismatch"):
        mf.select(bad)
    layout = JaxOutputLayout(26, 13, 16, 1 << 20)
    assert OutputLayout(26, 13, 16, 1 << 20).feed_slots() == layout.feed_slots()


def _batch(cfg, rows, seed):
    rng = np.random.default_rng(seed)
    return {
        "sparse": np.stack([rng.integers(0, v, rows) for v in cfg.vocab_sizes[:cfg.n_sparse]],
                           axis=1).astype(np.int32),
        "dense": rng.exponential(1.0, (rows, cfg.n_dense)).astype(np.float32),
    }


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("dedup_lookup", [True, False])
def test_serve_step_matches_jax(name, dedup_lookup):
    cfg, jcfg = CONFIGS[name]
    cfg = dataclasses.replace(cfg, dedup_lookup=dedup_lookup)
    jcfg = dataclasses.replace(jcfg, dedup_lookup=dedup_lookup)
    jparams = JR.init_params(jcfg, jax.random.PRNGKey(3))
    params = R.params_from_jax(jparams, "cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == R.param_shapes(cfg)
    b = _batch(cfg, 48, seed=4)
    want_logit = np.asarray(JR.forward(jparams, jcfg, {k: jnp.asarray(v) for k, v in b.items()}))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    got_logit = R.forward(params, cfg, tb).numpy()
    np.testing.assert_allclose(got_logit, want_logit, rtol=1e-4, atol=1e-5)
    want = np.asarray(JR.serve_step(jparams, jcfg, {k: jnp.asarray(v) for k, v in b.items()}))
    got = R.serve_step(params, cfg, tb).numpy()
    assert got.shape == (48,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_collect_gids_matches_jax():
    cfg, jcfg = CONFIGS["narrow"]
    b = _batch(cfg, 16, seed=9)
    got = R.collect_gids(cfg, {k: torch.from_numpy(v) for k, v in b.items()})
    want = JR.collect_gids(jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    bst = R.RecsysConfig(name="b", kind="bst", n_dense=0, n_sparse=3, embed_dim=8,
                         vocab_sizes=(50, 20, 30), seq_len=5)
    jbst = JR.RecsysConfig(name="b", kind="bst", n_dense=0, n_sparse=3, embed_dim=8,
                           vocab_sizes=(50, 20, 30), seq_len=5)
    rng = np.random.default_rng(1)
    bb = {"sparse": np.stack([rng.integers(0, v, 6) for v in (50, 20, 30)], 1).astype(np.int32),
          "seq": rng.integers(0, 50, (6, 5)).astype(np.int32)}
    got = R.collect_gids(bst, {k: torch.from_numpy(v) for k, v in bb.items()})
    want = JR.collect_gids(jbst, {k: jnp.asarray(v) for k, v in bb.items()})
    for k in ("seq", "other"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_init_params_distributions():
    cfg = CONFIGS["narrow"][0]
    g = torch.Generator().manual_seed(0)
    p = R.init_params(cfg, g)
    assert {k: tuple(v.shape) for k, v in p.items()} == R.param_shapes(cfg)
    lim = 1.0 / np.sqrt(cfg.embed_dim)
    assert p["embed"].abs().max() <= lim and p["embed"].std() > 0.5 * lim / np.sqrt(3)
    assert all(float(p[k].abs().sum()) == 0.0 for k in p if "_b" in k)
    w = p["top_w0"]
    assert abs(float(w.std()) - np.sqrt(2.0 / w.shape[0])) < 0.1 * np.sqrt(2.0 / w.shape[0])
    again = R.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)


@pytest.mark.parametrize("kind", ["dcnv2", "autoint", "bst"])
def test_unported_forwards_raise(kind):
    cfg = dataclasses.replace(CONFIGS["narrow"][0], kind=kind)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        R.forward({}, cfg, {})
