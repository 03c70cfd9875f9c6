"""The committed JAX loss curves (``tests/data/jax_loss_curves.npz``, written
by ``tests/jax_curves.py``, read by ``tests/curve_fixture.py``) and the
port's chains held to them, on the CPU.

* The fixture is current: regenerated with JAX here, its params are bit for
  bit the committed ones, the sums of the numpy params of ``full/bst``,
  ``full/pna`` and the LM curves are equal and its losses within rtol 1e-6
  (XLA's CPU code may sum in another order from one JAX version to the
  next); its lr, batch, step count, seeds and
  shard sizes are equal. It stays under 1 MB.
* The port's eleven smoke chains (the streaming driver over the shards the
  port's ``write_log_shards`` writes, and the in-memory driver for each
  arch, the LM and PNA archs among them) from the fixture's params reach
  every JAX loss within rtol 1e-4: the comparison ``chip_smoke.py`` makes on the card (fp32 sums in another
  order, compounded over 24 steps; Adam-updated params are not compared,
  ROADMAP C6). ``loop/pna`` and ``full/pna`` (published PNA on a Cora-size
  graph, 5 steps) are chaotic: their first loss within rtol 1e-5, every
  loss within ``curve_fixture.PNA_RTOL`` (from ``tests/rehearse_pna.py``).
* ``full/bst`` (published BST, 8 steps of 8,192 rows): the first loss
  within rtol ``FULL_FIRST_RTOL`` = 1e-5 and every loss within
  ``FULL_RTOL`` = 2e-3. ``tests/rehearse_bst.py`` reads, with 1 thread
  and with 8: the first loss equal, then 1.5e-5 at step 2 growing to
  3.64e-4 (steps of Adam on gradients summed in another order; the same
  with either thread count). A dense param 1e-3 off moves the first loss
  by 2.6e-5 or more, and with all dense params off a later loss by
  8.25e-3.
* That comparison catches an in-memory chain whose dense params are all
  1e-3 (relative) off, and each BST smoke chain with its largest dense
  param (``top_w0``) alone 1e-3 off: the mutants the card's chain tests
  must fail on the loss comparison alone.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import curve_fixture as C  # noqa: E402
import jax_curves  # noqa: E402

CURVE_RTOL = 1e-4
FULL_FIRST_RTOL = 1e-5
FULL_RTOL = 2e-3


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
        elif field.startswith("sums/"):
            assert entry["sums"][field.split("/", 1)[1]] == value, key
        elif field == "losses":
            assert len(value) == entry["steps"] and np.isfinite(value).all()
            np.testing.assert_allclose(entry["losses"], value, rtol=1e-6, err_msg=key)
        else:
            assert np.array_equal(entry[field], value), key


@pytest.mark.parametrize("curve", C.SMOKE_CURVES)
def test_port_chain_reaches_the_jax_curve(curve):
    entry = C.load()[curve]
    losses = C.port_losses(curve, entry, torch.device("cpu"))
    assert len(losses) == int(entry["steps"]) == C.STEPS
    if curve in C.PNA_RTOL:
        np.testing.assert_allclose(losses[0], entry["losses"][0], rtol=C.PNA_FIRST_RTOL)
    np.testing.assert_allclose(losses, entry["losses"], rtol=C.PNA_RTOL.get(curve, CURVE_RTOL))


def test_full_pna_chain_reaches_the_jax_curve():
    """Published PNA, full-graph training on the Cora-size graph, from
    ``gnn_numpy_params``."""
    entry = C.load()["full/pna"]
    assert entry["params"] == {} and tuple(entry["graph"]) == C.FULL_PNA["graph"]
    losses = C.port_losses("full/pna", entry, torch.device("cpu"))
    assert len(losses) == int(entry["steps"]) == C.FULL_PNA["steps"]
    np.testing.assert_allclose(losses[0], entry["losses"][0], rtol=C.PNA_FIRST_RTOL)
    np.testing.assert_allclose(losses, entry["losses"], rtol=C.PNA_RTOL["full/pna"])
    assert losses[-1] < losses[0]


def test_full_bst_chain_reaches_the_jax_curve():
    """The port's ``full/bst`` chain on the CPU from ``numpy_params``: the
    step-2 jump of the full-width loss (0.63 to 3.31) is JAX's own."""
    entry = C.load()["full/bst"]
    assert entry["params"] == {} and int(entry["batch"]) == C.FULL["batch"]
    losses = C.port_losses("full/bst", entry, torch.device("cpu"))
    want = entry["losses"]
    assert len(losses) == int(entry["steps"]) == C.FULL["steps"]
    np.testing.assert_allclose(losses[0], want[0], rtol=FULL_FIRST_RTOL)
    np.testing.assert_allclose(losses, want, rtol=FULL_RTOL)
    assert losses[1] > 2 * losses[0] and want[1] > 2 * want[0]


@pytest.mark.parametrize("curve", [c for c in C.SMOKE_CURVES if c.startswith("loop/")])
def test_the_curve_comparison_catches_dense_params_off_by_1e_3(curve):
    from repro_torch.train.optimizer import flatten

    entry = C.load()[curve]
    params = C.start_params(curve, entry, torch.device("cpu"))
    for k, v in flatten(params).items():
        if k != "embed":
            v.mul_(1 + 1e-3)
    losses = C.port_losses(curve, entry, torch.device("cpu"), params=params)
    deviation = np.max(np.abs(np.asarray(losses) - entry["losses"]) / np.abs(entry["losses"]))
    assert deviation > C.PNA_RTOL.get(curve, CURVE_RTOL), deviation


@pytest.mark.parametrize("curve", ["loop/bst", "stream/bst"])
def test_the_curve_comparison_catches_one_bst_dense_param_off_by_1e_3(curve):
    from repro_torch.models.recsys import params_from_jax

    entry = C.load()[curve]
    params = params_from_jax(entry["params"], torch.device("cpu"))
    params["top_w0"].mul_(1 + 1e-3)
    losses = C.port_losses(curve, entry, torch.device("cpu"), params=params)
    deviation = np.max(np.abs(np.asarray(losses) - entry["losses"]) / np.abs(entry["losses"]))
    assert deviation > CURVE_RTOL, deviation
