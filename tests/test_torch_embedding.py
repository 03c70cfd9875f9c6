"""The port's working-set dedup and table lookups against the JAX package,
bit for bit, including FILL padding and working-set overflow."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.embedding.dedup import FILL as JAX_FILL  # noqa: E402
from repro.embedding.dedup import dedup as jax_dedup  # noqa: E402
from repro.embedding.dedup import expected_unique as jax_expected_unique  # noqa: E402
from repro.embedding.table import MultiTable as JaxMultiTable  # noqa: E402
from repro.embedding.table import TableSpec as JaxTableSpec  # noqa: E402
from repro.embedding.table import lookup as jax_lookup  # noqa: E402
from repro.embedding.table import lookup_dedup as jax_lookup_dedup  # noqa: E402

from repro_torch.embedding.dedup import FILL, MAX_ID, dedup, expected_unique  # noqa: E402
from repro_torch.embedding.table import MultiTable, TableSpec, lookup, lookup_dedup  # noqa: E402


def _ids(seed, shape, hi):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(np.int32)


def test_constants_match():
    assert FILL == int(JAX_FILL) == MAX_ID


# (shape, id range, capacity): padded, exact, and overflowing working sets
CASES = [((8, 4), 50, 64), ((8, 4), 10, 10), ((16, 6), 1000, 40),
         ((3, 5), 7, 3), ((1, 1), 5, 4), ((64, 26), 2**31 - 2, 512)]


@pytest.mark.parametrize("shape,hi,cap", CASES)
def test_dedup_matches_jax(shape, hi, cap):
    ids = _ids(sum(shape) + cap, shape, hi)
    u, inv, c = dedup(torch.from_numpy(ids), capacity=cap)
    ju, jinv, jc = jax_dedup(jnp.asarray(ids), capacity=cap)
    assert u.dtype == inv.dtype == c.dtype == torch.int32
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    assert int(c) == int(jc)


@pytest.mark.parametrize("shape,hi,cap", CASES[:5])
def test_lookup_dedup_matches_jax_including_overflow(shape, hi, cap):
    ids = _ids(sum(shape), shape, hi)
    table = np.random.default_rng(1).normal(size=(max(hi, 2), 4)).astype(np.float32)
    got = lookup_dedup(torch.from_numpy(table), torch.from_numpy(ids), capacity=cap).numpy()
    want = np.asarray(jax_lookup_dedup(jnp.asarray(table), jnp.asarray(ids), capacity=cap))
    np.testing.assert_array_equal(got, want)   # NaN rows where the working set overflowed
    n_unique = len(np.unique(ids))
    assert np.isnan(got).any() == (n_unique > cap)


def test_lookup_out_of_range_matches_jax_take():
    table = np.arange(40, dtype=np.float32).reshape(10, 4)
    ids = np.asarray([[12, -1, 3], [0, 9, -11]], np.int32)
    np.testing.assert_array_equal(
        lookup(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
        np.asarray(jax_lookup(jnp.asarray(table), jnp.asarray(ids))))


def test_multitable_global_ids_and_lookup():
    vocabs = (64, 32, 100, 16)
    mt = MultiTable.build([TableSpec(f"f{i}", v, 8) for i, v in enumerate(vocabs)])
    jmt = JaxMultiTable.build([JaxTableSpec(f"f{i}", v, 8) for i, v in enumerate(vocabs)])
    np.testing.assert_array_equal(mt.offsets, jmt.offsets)
    assert mt.total_rows == jmt.total_rows
    rng = np.random.default_rng(2)
    field_ids = np.stack([rng.integers(0, v, 32) for v in vocabs], 1).astype(np.int32)
    table = rng.normal(size=(mt.total_rows, 8)).astype(np.float32)
    np.testing.assert_array_equal(mt.global_ids(torch.from_numpy(field_ids)).numpy(),
                                  np.asarray(jmt.global_ids(jnp.asarray(field_ids))))
    np.testing.assert_array_equal(
        mt.lookup_dedup(torch.from_numpy(table), torch.from_numpy(field_ids), capacity=70).numpy(),
        np.asarray(jmt.lookup_dedup(jnp.asarray(table), jnp.asarray(field_ids), capacity=70)))
    with pytest.raises(ValueError):
        MultiTable.build([TableSpec("a", 4, 8), TableSpec("b", 4, 16)])


@pytest.mark.parametrize("rows,vocab", [(0, 5), (512, 3), (512, 10_000_000), (64, 64)])
def test_expected_unique_matches_jax(rows, vocab):
    assert expected_unique(rows, vocab) == jax_expected_unique(rows, vocab)


@pytest.mark.parametrize("dtype,scale", [(torch.float32, None), (torch.bfloat16, 0.5)])
def test_multitable_init_shape_dtype_and_range(dtype, scale):
    """``MultiTable.init`` draws the port's own bits (ROADMAP C18), so it is
    held by shape, dtype and range, not by JAX's draw."""
    import jax

    specs = [TableSpec("a", 7, 8), TableSpec("b", 300, 8), TableSpec("c", 1, 8)]
    mt, jmt = MultiTable.build(specs), JaxMultiTable.build(
        [JaxTableSpec(s.name, s.vocab, s.dim) for s in specs])
    table = mt.init(torch.Generator().manual_seed(0), dtype=dtype, scale=scale)
    jtable = jmt.init(jax.random.PRNGKey(0), scale=scale)
    assert tuple(table.shape) == tuple(jtable.shape) == (308, 8) and table.dtype == dtype
    lim = scale if scale is not None else 1.0 / np.sqrt(8)
    t = table.float()
    assert float(t.abs().max()) <= lim and float(t.std()) > 0.4 * lim
    again = mt.init(torch.Generator().manual_seed(0), dtype=dtype, scale=scale)
    assert torch.equal(table, again)
