"""The port's FE plan against the JAX plan on the dlrm, ads_ctr and bst
specs: same schedule, same dispatch accounting, and the same ``batch_*``
outputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ExecutionStats as JaxExecutionStats  # noqa: E402
from repro.fe import featureplan as jax_featureplan  # noqa: E402
from repro.fe import get_spec as jax_get_spec  # noqa: E402
from repro.fe.datagen import gen_views as jax_gen_views  # noqa: E402
from repro.fe.ops import ragged_to_padded as jax_ragged_to_padded  # noqa: E402
from repro.fe.ops import tokenize_hash as jax_tokenize_hash  # noqa: E402

from repro_torch.core.metakernel import ExecutionStats  # noqa: E402
from repro_torch.fe import featureplan, get_spec  # noqa: E402
from repro_torch.fe import ops as F  # noqa: E402
from repro_torch.fe.datagen import gen_views  # noqa: E402

EXACT_SLOTS = ("batch_sparse", "batch_label", "batch_seq_ids", "batch_seq_mask")
LOGNORM_COLS = (0, 1)   # d_dwell, d_bid in both specs
SPECS = ("dlrm", "ads_ctr", "bst")
# log1p implementations differ: on exponential inputs XLA's CPU log1p is up to
# 2 ulp from the correctly rounded float64 value (about 1% of values), torch's
# within 1, so the two are held to 2 ulp.
LOG1P_ULP = 2


def _plans(field_size=1 << 20, spec="dlrm"):
    return (jax_featureplan.compile(jax_get_spec(spec), field_size=field_size),
            featureplan.compile(get_spec(spec), field_size=field_size))


def test_datagen_copy_matches_jax():
    a, b = jax_gen_views(64, seed=5), gen_views(64, seed=5)
    assert a.keys() == b.keys()
    for view in a:
        assert a[view].keys() == b[view].keys()
        for col in a[view]:
            x, y = a[view][col], b[view][col]
            if hasattr(x, "values"):
                np.testing.assert_array_equal(x.values, y.values)
                np.testing.assert_array_equal(x.lengths, y.lengths)
            else:
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("spec", SPECS)
def test_same_schedule_and_dispatch_accounting(spec):
    jplan, tplan = _plans(spec=spec)
    assert tplan.summary() == jplan.summary()
    assert tplan.required_columns == jplan.required_columns
    assert tplan.output_slots == jplan.output_slots
    assert tplan.layout == tplan.layout.__class__(**vars(jplan.layout))
    names = [([p.op.name for p in lay.host_ops], [p.op.name for p in lay.device_ops],
              lay.device_input_slots, lay.layer_indices) for lay in tplan.layers]
    jnames = [([p.op.name for p in lay.host_ops], [p.op.name for p in lay.device_ops],
               lay.device_input_slots, lay.layer_indices) for lay in jplan.layers]
    assert names == jnames
    s = tplan.schedule
    assert s.n_coalesced_dispatches == s.n_host_barriers + 1
    st, jst = ExecutionStats(), JaxExecutionStats()
    tplan.run(gen_views(32, seed=0), device="cpu", stats=st)
    jplan.run(jax_gen_views(32, seed=0), stats=jst)
    assert st.n_device_dispatches == jst.n_device_dispatches == s.n_host_barriers + 1
    assert spec != "dlrm" or st.n_device_dispatches == 1
    assert (st.n_layers, st.n_source_layers, st.n_host_ops) == \
        (jst.n_layers, jst.n_source_layers, jst.n_host_ops)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("field_size", [1000, 1 << 20])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_outputs_match_jax(seed, field_size, spec):
    jplan, tplan = _plans(field_size, spec)
    n = 96 + 37 * seed
    want = jplan.outputs(jplan.run(jax_gen_views(n, seed=seed)))
    got = tplan.outputs(tplan.run(gen_views(n, seed=seed), device="cpu"))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].device.type == "cpu"
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        assert got[k].shape == want[k].shape, k
    for k in EXACT_SLOTS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    if spec == "bst":                   # no dense block
        assert "batch_dense" not in got
        return
    dense, jdense = got["batch_dense"].numpy(), np.asarray(want["batch_dense"])
    exact = [c for c in range(dense.shape[1]) if c not in LOGNORM_COLS]
    np.testing.assert_array_equal(dense[:, exact], jdense[:, exact])
    np.testing.assert_array_max_ulp(dense[:, list(LOGNORM_COLS)],
                                    jdense[:, list(LOGNORM_COLS)], maxulp=LOG1P_ULP)


def test_device_ops_match_jax_fe_ops():
    from repro.fe import ops as JF
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    x = rng.exponential(3.0, 500).astype(np.float32)
    x[:5] = [-1.0, 0.0, 0.5, 1.0, 16.0]
    bounds = (0.5, 1, 2, 4, 8, 16)
    np.testing.assert_array_equal(F.bucketize(torch.from_numpy(x), bounds).numpy(),
                                  np.asarray(JF.bucketize(jnp.asarray(x), bounds)))
    np.testing.assert_array_max_ulp(F.log_norm(torch.from_numpy(x)).numpy(),
                                    np.asarray(JF.log_norm(jnp.asarray(x))), maxulp=LOG1P_ULP)
    h = rng.integers(-(2**31), 2**31, 500).astype(np.int32)
    np.testing.assert_array_equal(
        F.sparse_id(torch.from_numpy(h), field_index=3, field_size=1000).numpy(),
        np.asarray(JF.sparse_id(jnp.asarray(h), field_index=3, field_size=1000)))


def test_host_string_ops_match_jax():
    strings = np.asarray(["cheap flights", "", "best  price near me", "x\x00y z"], object)
    got = F.tokenize_hash(strings, field_size=1 << 20, ngrams=2)
    want = jax_tokenize_hash(strings, field_size=1 << 20, ngrams=2)
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    ids, mask = F.ragged_to_padded(got, max_len=3)
    jids, jmask = jax_ragged_to_padded(want, max_len=3)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    rids, rmask = F.ragged_to_padded_ref(got, max_len=3)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(mask, rmask)


@pytest.mark.parametrize("max_len", [3, 5, 8])      # truncate, keep, pad
@pytest.mark.parametrize("pad_id", [0, -1])
def test_clip_seq_matches_jax(max_len, pad_id):
    from repro.fe import ops as JF
    import jax.numpy as jnp

    ids = np.random.default_rng(max_len).integers(-(2**31), 2**31, (4, 5)).astype(np.int32)
    got = F.clip_seq(torch.from_numpy(ids), max_len=max_len, pad_id=pad_id)
    want = np.asarray(JF.clip_seq(jnp.asarray(ids), max_len=max_len, pad_id=pad_id))
    assert got.dtype == torch.int32 and got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_ragged_to_bag_matches_jax():
    from repro.fe import ops as JF

    strings = np.asarray(["cheap flights", "", "best  price near me", "x\x00y z", ""], object)
    col = F.tokenize_hash(strings, field_size=1 << 20, ngrams=2)
    jcol = jax_tokenize_hash(strings, field_size=1 << 20, ngrams=2)
    for got, want in zip(F.ragged_to_bag(col), JF.ragged_to_bag(jcol)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


MODEL_ARCHS = ("dlrm-mlperf", "bst", "dcn-v2", "autoint")


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_batch_ref_matches_jax_and_apply(spec, arch):
    """The port's ``fe_env_to_model_batch_ref`` against JAX's (bit for bit;
    a dense block synthesised by log1p, where the spec has none, within
    ``LOG1P_ULP``: ROADMAP C5) and against the port's own
    ``ModelFeed.apply``, packed and split, bit for bit (as
    ``tests/test_modelfeed.py`` holds JAX's)."""
    from repro.configs import get_arch as jax_get_arch
    from repro.fe.compiler import field_slot
    from repro.fe.modelfeed import fe_env_to_model_batch_ref as jax_ref

    from repro_torch.configs import get_arch
    from repro_torch.fe.modelfeed import fe_env_to_model_batch_ref

    jplan, tplan = _plans(spec=spec)
    env = {k: np.asarray(v) for k, v in jplan.run(jax_gen_views(24, seed=7)).items()
           if k.startswith("batch_")}
    cfg = get_arch(arch).smoke()
    want = jax_ref(env, jax_get_arch(arch).smoke())
    tenv = {k: torch.from_numpy(v.copy()) for k, v in env.items()}
    ref = fe_env_to_model_batch_ref(tenv, cfg)
    assert set(ref) == set(want)
    for k in want:
        assert ref[k].numpy().dtype == np.asarray(want[k]).dtype, k
        if k == "dense" and "batch_dense" not in env:
            np.testing.assert_array_max_ulp(ref[k].numpy(), np.asarray(want[k]),
                                            maxulp=LOG1P_ULP)
        else:
            np.testing.assert_array_equal(ref[k].numpy(), np.asarray(want[k]), err_msg=k)
    split = {k: v for k, v in tenv.items() if k != "batch_sparse"}
    split.update({field_slot(i): tenv["batch_sparse"][:, i]
                  for i in range(tenv["batch_sparse"].shape[1])})
    for s, feed_env in ((False, tenv), (True, split)):
        mf = tplan.model_feed(cfg, split_sparse_fields=s)
        got = mf.apply(mf.select(feed_env))
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            assert torch.equal(got[k], ref[k]), (s, k)
