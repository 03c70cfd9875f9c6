"""The port's kernels against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX kernels (Pallas in interpret mode, as tests/test_kernels.py
runs them), the JAX oracles and the JAX plan's jitted call sites. The tests
in tests/test_torch_gpu.py hold each CUDA kernel against its plain version
on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.fe import featureplan as jax_featureplan  # noqa: E402
from repro.fe import get_spec as jax_get_spec  # noqa: E402
from repro.fe.ops import fmix32_np, hash_combine_np  # noqa: E402
from repro.kernels.feature_hash.ops import run_hash_layer as jax_run_hash_layer  # noqa: E402
from repro.kernels.feature_hash.ref import hash_layer_ref as jax_hash_layer_ref  # noqa: E402
from repro.kernels.interaction_dot.ops import pairwise_dots as jax_pairwise_dots  # noqa: E402
from repro.kernels.interaction_dot.ref import dot_interaction_ref as jax_dot_ref  # noqa: E402
from repro.kernels.mempool_alloc.kernel import alloc_offsets as jax_alloc_kernel  # noqa: E402
from repro.kernels.mempool_alloc.ops import plan_allocation as jax_plan_allocation  # noqa: E402
from repro.kernels.mempool_alloc.ops import plan_block as jax_plan_block  # noqa: E402
from repro.kernels.mempool_alloc.ref import alloc_offsets_ref as jax_alloc_ref  # noqa: E402
from repro.kernels.embedding_bag.ops import bag_lookup as jax_bag_lookup  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_bag_ref  # noqa: E402
from repro.kernels.embedding_bag.ref import (  # noqa: E402
    embedding_bag_segment_ref as jax_bag_segment_ref,
)

from repro_torch.fe import featureplan, get_spec  # noqa: E402
from repro_torch.fe import ops as F  # noqa: E402
from repro_torch.kernels.feature_hash.ops import run_hash_layer, validate_program  # noqa: E402
from repro_torch.core.mempool import ArenaPool  # noqa: E402
from repro_torch.kernels.interaction_dot.ops import (  # noqa: E402
    pairwise_dots,
    pairwise_dots_backward,
)
from repro_torch.kernels.interaction_dot.ref import (  # noqa: E402
    dot_interaction_bwd_ref,
    dot_interaction_ref,
)
from repro_torch.kernels.mempool_alloc.ops import (  # noqa: E402
    alloc_offsets,
    plan_allocation,
    plan_block,
)
from repro_torch.kernels.embedding_bag.ops import bag_lookup  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    embedding_bag_ref,
    embedding_bag_segment_ref,
)

PROG = (("cross", 0, 1, 1 << 20), ("cross", 2, 3, 1 << 18),
        ("hash", 0, 0, 1 << 16), ("mod", 4, 0, 997))
# int64 ids that part the three readings of `mod` for a field size that is
# not a power of two: int32 floor-mod of the narrowed id (the plan under
# jit), int64 floor-mod, and the TPU kernel's uint32 mod.
SPECIAL_IDS = np.array([5, -7, 2**31 + 5, 2**32 + 3], np.int64)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------- feature_hash
@pytest.mark.parametrize("n", [1, 5, 1024, 3000])
def test_feature_hash_plain_matches_jax_kernel_and_oracle(n):
    rng = np.random.default_rng(n)
    cols = rng.integers(0, 1 << 30, (5, n)).astype(np.int32)
    got = _np(run_hash_layer(torch.from_numpy(cols), PROG))
    assert got.dtype == np.int32 and got.shape == (len(PROG), n)
    np.testing.assert_array_equal(got, np.asarray(jax_run_hash_layer(jnp.asarray(cols), PROG)))
    np.testing.assert_array_equal(got, np.asarray(jax_hash_layer_ref(jnp.asarray(cols), program=PROG)))


def test_fmix32_and_hash_combine_match_numpy():
    rng = np.random.default_rng(3)
    a = rng.integers(-(2**31), 2**31, 4096).astype(np.int32)
    b = rng.integers(-(2**31), 2**31, 4096).astype(np.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(_np(F.fmix32(ta)), fmix32_np(a).astype(np.int64))
    np.testing.assert_array_equal(_np(F.hash_combine(ta, tb)), hash_combine_np(a, b).astype(np.int64))
    want = (hash_combine_np(a, b) % np.uint32(1000)).astype(np.int32)
    np.testing.assert_array_equal(_np(F.cross_feature(ta, tb, field_size=1000)), want)


def test_narrow_int32_keeps_low_bits_signed():
    x = torch.tensor([5, -7, 2**31 + 5, 2**32 + 3, -(2**33) - 1, 2**31 - 1], dtype=torch.int64)
    got = F.narrow_int32(x)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), _np(x).astype(np.int32))


def _jax_op_outputs(op, kwargs):
    return jax.jit(lambda kw: op.fn(**kw))(kwargs)


@pytest.mark.parametrize("field_size", [1000, 1 << 20])
@pytest.mark.parametrize("op_name", ["cross_features", "sparse_ids"])
def test_plan_hash_ops_match_jax_jit(op_name, field_size):
    """The port's hash ops equal the JAX plan's jitted ops on int64 columns
    that hold negatives and values >= 2**31 (narrowed like JAX's x64-off jit)."""
    jop = jax_featureplan.compile(jax_get_spec("dlrm"), field_size=field_size).graph.ops[op_name]
    top = featureplan.compile(get_spec("dlrm"), field_size=field_size).graph.ops[op_name]
    assert jop.inputs == top.inputs and jop.outputs == top.outputs
    rng = np.random.default_rng(field_size)
    n = 64
    kw = {}
    for s in top.inputs:
        if s.endswith("_col"):
            col = rng.integers(-(2**40), 2**40, n).astype(np.int64)
            col[:4] = SPECIAL_IDS
        else:  # a cross output feeding sparse_ids
            col = rng.integers(0, field_size, n).astype(np.int32)
        kw[s] = col
    want = _jax_op_outputs(jop, kw)
    got = top.fn(**{k: torch.from_numpy(v) for k, v in kw.items()})
    for slot in top.outputs:
        assert _np(got[slot]).dtype == np.int32
        np.testing.assert_array_equal(_np(got[slot]), np.asarray(want[slot]), err_msg=slot)


def test_sparse_ids_mod_semantics_pinned():
    """mod fields are a signed int32 floor-mod of the narrowed id: 5, 993,
    357, 3 for field size 1000 (not 653 for 2**31+5, not 289 for -7)."""
    plan = featureplan.compile(get_spec("dlrm"), field_size=1000)
    op = plan.graph.ops["sparse_ids"]
    kw = {s: torch.from_numpy(SPECIAL_IDS.copy()) if s.endswith("_col")
          else torch.zeros(4, dtype=torch.int32) for s in op.inputs}
    ids = _np(op.fn(**kw)["sparse_ids"])
    mod_fields = [i for i, f in enumerate(get_spec("dlrm").outputs[1].fields)
                  if f in ("f_adv", "f_camp", "f_slot", "f_geo", "f_dev", "f_hour",
                           "f_age", "f_gender")]
    for i in mod_fields:
        np.testing.assert_array_equal(ids[:, i] - i * 1000, [5, 993, 357, 3])


def test_plan_hash_programs_are_one_launch_each():
    plan = featureplan.compile(get_spec("dlrm"))
    slots, prog = plan.graph.ops["cross_features"].fn.hash_layer
    assert len(slots) == 8 and len(prog) == 16 and {k for k, *_ in prog} == {"cross"}
    slots, prog = plan.graph.ops["sparse_ids"].fn.hash_layer
    kinds = [k for k, *_ in prog]
    assert len(slots) == 10 and kinds.count("hash") == 2 and kinds.count("mod") == 8


def test_feature_hash_program_validation():
    with pytest.raises(ValueError):
        validate_program([("nope", 0, 0, 10)], 2)
    with pytest.raises(ValueError):
        validate_program([("cross", 0, 5, 10)], 2)
    with pytest.raises(ValueError):
        validate_program([("hash", 0, 0, 0)], 2)
    with pytest.raises(ValueError):
        validate_program([("mod", 0, 0, 2**31)], 2)


def test_feature_hash_wrapper_rejects_bad_inputs():
    with pytest.raises(TypeError):
        run_hash_layer(torch.zeros((2, 4), dtype=torch.int64), PROG[:1])
    with pytest.raises(ValueError):
        run_hash_layer(torch.zeros((8,), dtype=torch.int32), PROG[:1])
    # no silent plain path off the CPU: a non-CPU, non-CUDA tensor raises
    with pytest.raises(ValueError, match="unsupported device"):
        run_hash_layer(torch.zeros((5, 4), dtype=torch.int32, device="meta"), PROG)


def test_plain_path_counts_no_launch():
    before = run_hash_layer.launches
    run_hash_layer(torch.zeros((5, 4), dtype=torch.int32), PROG)
    assert run_hash_layer.launches == before


# ---------------------------------------------------------- interaction_dot
@pytest.mark.parametrize("shape", [
    (4, 3, 8), (130, 27, 128), (64, 16, 32), (7, 2, 16), (128, 27, 16),
])
def test_interaction_dot_plain_matches_jax(shape):
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    got = _np(pairwise_dots(torch.from_numpy(x)))
    b, f, _ = shape
    assert got.shape == (b, f * (f - 1) // 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jax_pairwise_dots(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_dot_ref(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_interaction_dot_pair_order_is_tril():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 5, 3)).astype(np.float32))
    rows, cols = np.tril_indices(5, -1)
    want = np.einsum("bpd,bpd->bp", _np(x)[:, rows], _np(x)[:, cols])
    np.testing.assert_allclose(_np(dot_interaction_ref(x)), want, rtol=1e-6, atol=1e-6)


def test_interaction_dot_bad_inputs():
    with pytest.raises(ValueError):
        pairwise_dots(torch.zeros((4, 8)))
    with pytest.raises(ValueError):
        pairwise_dots(torch.zeros((4, 1, 8)))
    with pytest.raises(TypeError):
        pairwise_dots(torch.zeros((4, 3, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="unsupported device"):
        pairwise_dots(torch.zeros((4, 3, 8), device="meta"))


# ------------------------------------------------- interaction_dot backward
def _jax_tril_dots(x):
    """The interaction exactly as ``_dlrm_forward`` writes it (einsum, then
    the strictly-lower triangle)."""
    f = x.shape[1]
    scores = jnp.einsum("bfd,bgd->bfg", x, x)
    rows, cols = np.tril_indices(f, k=-1)
    return scores[:, rows, cols]


@pytest.mark.parametrize("shape", [(4, 3, 8), (130, 27, 128), (7, 2, 16), (64, 16, 32)])
def test_interaction_dot_backward_plain_matches_jax_grad(shape):
    """The plain backward (the formula, not autograd) against jax.vjp of the
    JAX oracle and of the einsum in _dlrm_forward; within 1e-5."""
    rng = np.random.default_rng(sum(shape) + 1)
    x = rng.normal(size=shape).astype(np.float32)
    b, f, _ = shape
    dy = rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32)
    got = _np(pairwise_dots_backward(torch.from_numpy(x), torch.from_numpy(dy)))
    assert got.shape == shape and got.dtype == np.float32
    for fn in (jax_dot_ref, _jax_tril_dots):
        _, vjp = jax.vjp(fn, jnp.asarray(x))
        (want,) = vjp(jnp.asarray(dy))
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_pairwise_dots_autograd_uses_the_plain_backward():
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(9, 6, 16)).astype(np.float32))
    dy = torch.from_numpy(np.random.default_rng(6).normal(size=(9, 15)).astype(np.float32))
    x.requires_grad_(True)
    y = pairwise_dots(x)
    assert y.grad_fn is not None
    (got,) = torch.autograd.grad(y, x, dy)
    assert torch.equal(got, dot_interaction_bwd_ref(x.detach(), dy))
    (ref,) = torch.autograd.grad(dot_interaction_ref(x), x, dy)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_interaction_dot_backward_bad_inputs():
    x = torch.zeros((4, 3, 8))
    with pytest.raises(ValueError, match="dy shape"):
        pairwise_dots_backward(x, torch.zeros((4, 2)))
    with pytest.raises(TypeError):
        pairwise_dots_backward(x, torch.zeros((4, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="unsupported device"):
        pairwise_dots_backward(x.to("meta"), torch.zeros((4, 3), device="meta"))
    before = pairwise_dots_backward.launches
    pairwise_dots_backward(x, torch.zeros((4, 3)))
    assert pairwise_dots_backward.launches == before  # the plain path launches nothing


# ------------------------------------------------------------ mempool_alloc
def _sizes(n, seed):
    sizes = np.random.default_rng(seed).integers(0, 3000, n).astype(np.int32)
    sizes[::7] = 0                 # zero-size requests
    sizes[1::5] = 128 * (sizes[1::5] // 128)  # some exact multiples of 128
    return sizes


@pytest.mark.parametrize("n", [0, 1, 5, 1023, 1024, 1025, 5000])
def test_alloc_offsets_plain_matches_jax(n):
    """Exact against alloc_offsets_ref, the JAX host entry and (N > 0) the
    Pallas kernel in interpret mode, with its tail lanes masked."""
    sizes = _sizes(n, n)
    offsets, head = alloc_offsets(torch.from_numpy(sizes))
    assert offsets.dtype == head.dtype == torch.int32 and head.shape == (1,)
    wants = [jax_alloc_ref(jnp.asarray(sizes)), jax_plan_allocation(jnp.asarray(sizes))]
    if n:
        wants.append(jax_alloc_kernel(jnp.asarray(sizes), interpret=True))
    for want_offsets, want_head in wants:
        np.testing.assert_array_equal(_np(offsets), np.asarray(want_offsets))
        np.testing.assert_array_equal(_np(head), np.asarray(want_head))
    got_o, got_h = plan_allocation(torch.from_numpy(sizes.astype(np.int64)))
    assert torch.equal(got_o, offsets) and torch.equal(got_h, head)


def test_alloc_offsets_plain_wraps_like_jax_int32():
    sizes = np.array([2**31 - 1, -5, -200, 2**30, 2**30, -(2**31), 77], np.int32)
    offsets, head = alloc_offsets(torch.from_numpy(sizes))
    want_offsets, want_head = jax_alloc_ref(jnp.asarray(sizes))
    np.testing.assert_array_equal(_np(offsets), np.asarray(want_offsets))
    np.testing.assert_array_equal(_np(head), np.asarray(want_head))


@pytest.mark.parametrize("sizes", [[5], [4, 8192 * 13 * 4, 8192 * 26 * 4, 0, 129],
                                   list(range(0, 3000, 7)), []])
def test_plan_block_matches_jax_and_arena_pool(sizes):
    offsets, total = plan_block(sizes, device="cpu")
    want_offsets, want_total = jax_plan_block(sizes)
    np.testing.assert_array_equal(offsets, want_offsets)
    assert offsets.dtype == np.int64 and total == want_total
    pool = ArenaPool(1 << 24)
    assert offsets.tolist() == [a.offset for a in pool.alloc_block(sizes)]
    assert total == pool.head


def test_plan_block_guards_before_any_launch():
    before = alloc_offsets.launches
    for bad, err in [([2**31], OverflowError), ([2**30, 2**30, 2**30], OverflowError),
                     ([4, -1], ValueError)]:
        with pytest.raises(err):
            plan_block(bad, device="cpu")
        with pytest.raises(err):
            jax_plan_block(bad)
    with pytest.raises(OverflowError, match="int32"):
        plan_block([2**31 - 1])  # raises on the host even where no card is
    assert alloc_offsets.launches == before


def test_alloc_offsets_wrapper_rejects_bad_inputs(monkeypatch):
    with pytest.raises(ValueError):
        alloc_offsets(torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(TypeError):
        alloc_offsets(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        alloc_offsets(torch.zeros(3, dtype=torch.int32), align=0)
    with pytest.raises(ValueError, match="unsupported device"):
        alloc_offsets(torch.zeros(3, dtype=torch.int32, device="meta"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plan_block([1, 2])  # the card by default, no quiet CPU path


# ------------------------------------------------------------ embedding_bag
# the JAX package's test shapes (tests/test_kernels.py): (B, L, U, D)
BAG_SHAPES = [(4, 3, 10, 8), (300, 16, 700, 64), (256, 48, 512, 128),
              (33, 5, 1, 16), (1, 1, 2, 8), (1024, 4, 2000, 32)]


@pytest.mark.parametrize("shape", BAG_SHAPES)
def test_embedding_bag_plain_matches_jax(shape):
    """The plain version against the Pallas kernel (interpret mode) and the
    jnp oracle, within 1e-5, with 20 % of the slots disabled by weight 0."""
    b, l, u, d = shape
    rng = np.random.default_rng(b * l + u)
    ids = rng.integers(0, u, (b, l)).astype(np.int32)
    w = ((rng.random((b, l)) < 0.8) * rng.random((b, l))).astype(np.float32)
    table = rng.normal(size=(u, d)).astype(np.float32)
    got = bag_lookup(torch.from_numpy(ids), torch.from_numpy(w), torch.from_numpy(table))
    assert got.shape == (b, d) and got.dtype == torch.float32
    kernel = jax_bag_lookup(jnp.asarray(ids), jnp.asarray(w), jnp.asarray(table))
    oracle = jax_bag_ref(jnp.asarray(ids), jnp.asarray(w), jnp.asarray(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5, atol=1e-5)
    plain = bag_lookup(torch.from_numpy(ids), torch.from_numpy(w), torch.from_numpy(table),
                       use_kernel=False)
    assert torch.equal(plain, got)


def test_embedding_bag_zero_weight_ignores_garbage_ids():
    table = np.random.default_rng(0).normal(size=(6, 4)).astype(np.float32)
    ids = np.array([[0, 5], [2**31 - 1, -(2**31)]], np.int32)
    w = np.array([[1.0, 0.0], [0.0, 0.0]], np.float32)
    got = bag_lookup(torch.from_numpy(ids), torch.from_numpy(w), torch.from_numpy(table))
    want = np.asarray(jax_bag_lookup(jnp.asarray(ids), jnp.asarray(w), jnp.asarray(table)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.stack([table[0], np.zeros(4, np.float32)]))


def test_embedding_bag_out_of_range_ids_follow_the_pallas_kernel():
    """An id outside [0, U) with a non-zero weight: the Pallas kernel (and
    the port) add 0; the jnp oracle gives NaN for id >= U and wraps a
    negative id (ROADMAP C7)."""
    table = np.random.default_rng(1).normal(size=(6, 4)).astype(np.float32)
    w = np.ones((1, 2), np.float32)

    def three(ids):
        ids = np.array([ids], np.int32)
        args = jnp.asarray(ids), jnp.asarray(w), jnp.asarray(table)
        return (bag_lookup(torch.from_numpy(ids), torch.from_numpy(w),
                           torch.from_numpy(table)).numpy()[0],
                np.asarray(jax_bag_lookup(*args))[0], np.asarray(jax_bag_ref(*args))[0])

    port, pallas, oracle = three([7, 2])          # id 7 >= U = 6
    np.testing.assert_array_equal(port, table[2])
    np.testing.assert_allclose(pallas, table[2], rtol=1e-6)
    assert np.isnan(oracle).all()
    port, pallas, oracle = three([-1, 2])         # a negative id
    np.testing.assert_array_equal(port, table[2])
    np.testing.assert_allclose(pallas, table[2], rtol=1e-6)
    np.testing.assert_allclose(oracle, table[5] + table[2], rtol=1e-6)
    port, pallas, oracle = three([1, 2])          # in range: all three agree
    np.testing.assert_allclose(port, table[1] + table[2], rtol=1e-6)
    np.testing.assert_allclose(pallas, port, rtol=1e-6)
    np.testing.assert_allclose(oracle, port, rtol=1e-6)


def test_embedding_bag_segment_plain_matches_jax():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    flat = rng.integers(0, 50, 200).astype(np.int32)
    seg = np.sort(rng.integers(0, 17, 200)).astype(np.int32)
    got = embedding_bag_segment_ref(torch.from_numpy(flat), torch.from_numpy(seg),
                                    torch.from_numpy(table), 17)
    want = jax_bag_segment_ref(jnp.asarray(flat), jnp.asarray(seg), jnp.asarray(table), 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_embedding_bag_bad_shapes():
    with pytest.raises(ValueError):
        bag_lookup(torch.zeros(2, dtype=torch.int32), torch.zeros(2), torch.zeros(4, 4))
    with pytest.raises(ValueError):
        bag_lookup(torch.zeros(2, 3, dtype=torch.int32), torch.zeros(2, 2), torch.zeros(4, 4))
    with pytest.raises(ValueError):
        bag_lookup(torch.zeros(2, 3, dtype=torch.int32), torch.zeros(2, 3), torch.zeros(4))
    with pytest.raises(ValueError):
        jax_bag_lookup(jnp.zeros((2,), jnp.int32), jnp.zeros((2,)), jnp.zeros((4, 4)))


def test_embedding_bag_plain_is_differentiable_and_empty_tables_add_nothing():
    table = torch.randn(5, 3, generator=torch.Generator().manual_seed(0), requires_grad=True)
    ids = torch.tensor([[0, 4, 4]], dtype=torch.int32)
    w = torch.tensor([[1.0, 2.0, 0.0]])
    bag_lookup(ids, w, table).sum().backward()
    want = torch.zeros(5, 3)
    want[0], want[4] = 1.0, 2.0
    assert torch.equal(table.grad, want)
    empty = embedding_bag_ref(ids, w, torch.zeros(0, 3))
    assert torch.equal(empty, torch.zeros(1, 3))
