"""The generator and the weights are fixed by the seed, and the ids keep
to the mix's law."""

import pytest
import torch
from conftest import CELLS, tiny

from portbench import traffic, weights

SEED = 2**31 + 12345     # the driver's seeds pass 32 signed bits


@pytest.mark.parametrize("name", CELLS)
def test_batches_follow_the_seed(name, cpu):
    cell = tiny(name)
    a = traffic.make_batches(cell.config, cell.mix, SEED, cpu)
    b = traffic.make_batches(cell.config, cell.mix, SEED, cpu)
    c = traffic.make_batches(cell.config, cell.mix, SEED + 1, cpu)
    assert len(a) == cell.mix["batches"]
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(a[0]["sparse"], c[0]["sparse"])
    assert ("label" in a[0]) == (cell.mix["kind"] == "train")
    vocab = torch.tensor(cell.config["vocab_sizes"])
    for x in a:
        assert x["sparse"].dtype == torch.int32 and x["sparse"].shape[0] == cell.mix["rows"]
        assert bool((x["sparse"] >= 0).all()) and bool((x["sparse"] < vocab).all())
        assert bool((x["dense"] >= 0).all())


@pytest.mark.parametrize("name", CELLS)
def test_weights_follow_the_seed(name, cpu):
    cell = tiny(name)
    a = weights.make(cell.config, cell.model, SEED, cpu)
    b = weights.make(cell.config, cell.model, SEED, cpu)
    c = weights.make(cell.config, cell.model, SEED + 1, cpu)
    assert a.keys() == b.keys() == cell.model.param_shapes(cell.config).keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert a["embed"].shape[0] % cell.config["row_align"] == 0


def test_power_law_ranks():
    gen = torch.Generator().manual_seed(3)
    n, vocab, s = 400_000, 1_000_000, 1.05
    ranks = traffic.power_law_ranks(n, vocab, s, gen, "cpu")
    assert int(ranks.min()) >= 0 and int(ranks.max()) < vocab
    counts = torch.bincount(ranks, minlength=vocab).double()
    # the continuous law's mass on [k + 1, k + 2) against rank 0's
    a = 1 - s
    mass = [((k + 2) ** a - (k + 1) ** a) / ((vocab + 1) ** a - 1) for k in range(3)]
    for k in range(3):
        assert counts[k] / n == pytest.approx(mass[k], rel=0.03)
    # heavy-tailed: the first 1% of ranks draws far more than 1% of the ids
    assert counts[:vocab // 100].sum() / n > 0.5
    assert traffic.power_law_ranks(5, 7, 1.0, gen, "cpu").max() < 7
