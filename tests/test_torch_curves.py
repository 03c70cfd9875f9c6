"""The committed JAX loss curves (``tests/data/jax_loss_curves.npz``, written
by ``tests/jax_curves.py``, read by ``tests/curve_fixture.py``) and the
port's chains held to them, on the CPU.

* The fixture is current: regenerated with JAX here, its params are bit for
  bit the committed ones and its losses within rtol 1e-6 (XLA's CPU code
  may sum in another order from one JAX version to the next); its lr,
  batch, step count and shard sizes are equal. It stays under 1 MB.
* The port's four chains (the streaming driver over the shards the port's
  ``write_log_shards`` writes, and the in-memory driver for each arch) from
  the fixture's params reach every JAX loss within rtol 1e-4: the
  comparison ``chip_smoke.py`` makes on the card (fp32 sums in another
  order, compounded over 24 steps; Adam-updated params are not compared,
  ROADMAP C6).
* That comparison catches an in-memory chain whose dense params are all
  1e-3 (relative) off: the mutant the card's chain test must fail on the
  loss comparison alone.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import curve_fixture as C  # noqa: E402
import jax_curves  # noqa: E402

CURVE_RTOL = 1e-4


def test_fixture_is_current_and_small():
    assert C.FIXTURE.stat().st_size < 1 << 20
    committed = C.load()
    assert sorted(committed) == sorted(C.CURVES)
    fresh = jax_curves.generate()
    assert sorted(fresh) == sorted(np.load(C.FIXTURE).files)
    for key, value in fresh.items():
        curve, field = key.split("/", 2)[:2], key.split("/", 2)[2]
        entry = committed["/".join(curve)]
        if field.startswith("params/"):
            got = entry["params"][field.split("/", 1)[1]]
            assert got.dtype == value.dtype and got.shape == value.shape, key
            assert np.array_equal(got.view(np.uint32), value.view(np.uint32)), key
        elif field == "losses":
            assert len(value) == C.STEPS and np.isfinite(value).all()
            np.testing.assert_allclose(entry["losses"], value, rtol=1e-6, err_msg=key)
        else:
            assert entry[field] == value, key


@pytest.mark.parametrize("curve", C.CURVES)
def test_port_chain_reaches_the_jax_curve(curve):
    entry = C.load()[curve]
    losses = C.port_losses(curve, entry, torch.device("cpu"))
    assert len(losses) == int(entry["steps"]) == C.STEPS
    np.testing.assert_allclose(losses, entry["losses"], rtol=CURVE_RTOL)


@pytest.mark.parametrize("curve", [c for c in C.CURVES if c.startswith("loop/")])
def test_the_curve_comparison_catches_dense_params_off_by_1e_3(curve):
    from repro_torch.models.recsys import params_from_jax

    entry = C.load()[curve]
    params = params_from_jax(entry["params"], torch.device("cpu"))
    for k, v in params.items():
        if k != "embed":
            v.mul_(1 + 1e-3)
    losses = C.port_losses(curve, entry, torch.device("cpu"), params=params)
    deviation = np.max(np.abs(np.asarray(losses) - entry["losses"]) / np.abs(entry["losses"]))
    assert deviation > CURVE_RTOL, deviation
