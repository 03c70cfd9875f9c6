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

from repro_torch.fe import featureplan, get_spec  # noqa: E402
from repro_torch.fe import ops as F  # noqa: E402
from repro_torch.kernels.feature_hash.ops import run_hash_layer, validate_program  # noqa: E402
from repro_torch.kernels.interaction_dot.ops import pairwise_dots  # noqa: E402
from repro_torch.kernels.interaction_dot.ref import dot_interaction_ref  # noqa: E402

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
