"""Where the PNA bounds come from: the curves' (``curve_fixture.PNA_RTOL``,
used by ``tests/test_torch_curves.py``, the card's chain tests and
``chip_smoke.py`` phase 12) and phase 19's first steps
(``chip_smoke.PNA_FIRST_*``).

PNA trains chaotically from its He init: the logits start in the hundreds
(a first loss of 61 at the smoke config, 86 at full width), and the std
aggregator's ``sq - mean**2`` cancels, its ``1/(2 std)`` carrying the fp32
rounding into the gradients. So two fp32 runs of one chain part within a
few steps, and the parting grows step by step: a property of the
trajectory, as ROADMAP C24 says of a drift. This script reads, on the CPU,
each PNA curve of the fixture (JAX's fp32 losses) and the port's chains
from the same params and graphs:

* ``jax32-p64``: JAX's fp32 losses against the port's float64 chain;
* ``p32-p64``: the port's fp32 chains (torch's default threads, three runs:
  threaded sums do not repeat, ROADMAP C16) against it;
* ``p32-1thr``: the port's fp32 chain on one thread against the first run;
* ``p32-jax32``: the port's fp32 chains against JAX's (the tests' reading);
* mutants against JAX's losses: every param 1e-3 (relative) off, and one
  matrix (``l0_upd_w``) 1e-3 off.

Each reading is the largest ``|a - b| / |b|`` over the curve's steps. The
bound is 4x the largest correct reading. The check is the first loss
within ``PNA_FIRST_RTOL`` and every loss within the bound; each mutant
must fail it, and the script says which part catches it.

Then phase 19's first steps, through ``chip_smoke``'s own helpers
(``pna_graph_batches``, ``pna_first_step_against_fp64``): PNA at its
published width on ``full_graph_sm``, ``molecule`` and ``minibatch_lg``
(the synthetic Reddit-size graph), params drawn as the phase draws them,
the loss and each gradient norm in fp32 against float64; the card's check
allows 4x the largest reading of each.

  PYTHONPATH=src python tests/rehearse_pna.py          # about 1 min, 3 GB
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "src")]

import curve_fixture as C  # noqa: E402

CURVES = ("loop/pna", "full/pna")


def chain(curve, entry, dtype, threads=None, mutate=None):
    """The port's chain of ``curve`` in ``dtype`` (params, features and
    the model's compute dtype), through ``curve_fixture.port_losses``."""
    from repro_torch import configs
    from repro_torch.launch import train

    cpu = torch.device("cpu")
    params = {k: v.to(dtype) for k, v in C.start_params(curve, entry, cpu).items()}
    if mutate:
        mutate(params)
    spec = configs.get_arch("pna")
    real_graph, real_batch, real_get = C.full_pna_graph, train.synthetic_batch, configs.get_arch

    def cast(b):
        return dict(b, features=b["features"].astype(np.float64) if dtype == torch.float64
                    else b["features"])

    def batch64(*a, **kw):
        b = real_batch(*a, **kw)
        return dict(b, features=b["features"].to(dtype))

    def arch(arch_id):
        s = real_get(arch_id)
        return dataclasses.replace(s, smoke=lambda: dataclasses.replace(s.smoke(), dtype=dtype),
                                   config=dataclasses.replace(s.config, dtype=dtype))

    old_threads = torch.get_num_threads()
    try:
        if threads:
            torch.set_num_threads(threads)
        C.full_pna_graph = lambda: cast(real_graph())
        train.synthetic_batch = batch64
        configs.get_arch = arch
        return np.asarray(C.port_losses(curve, entry, cpu, params=params))
    finally:
        C.full_pna_graph, train.synthetic_batch, configs.get_arch = real_graph, real_batch, real_get
        torch.set_num_threads(old_threads)


def rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))))


def all_off(params):
    for v in params.values():
        v.mul_(1 + 1e-3)


def one_off(params):
    params["l0_upd_w"].mul_(1 + 1e-3)


def main():
    fixture = C.load()
    bounds = {}
    for curve in CURVES:
        entry = fixture[curve]
        jax32 = entry["losses"]
        runs = [chain(curve, entry, torch.float32) for _ in range(3)]
        p64 = chain(curve, entry, torch.float64)
        p32_1 = chain(curve, entry, torch.float32, threads=1)
        correct = {"jax32-p64": rel(jax32, p64), "p32-p64": max(rel(r, p64) for r in runs),
                   "p32-1thr": rel(p32_1, runs[0]),
                   "p32-jax32": max(rel(r, jax32) for r in runs + [p32_1])}
        bound = 4 * max(correct.values())
        bounds[curve] = float(f"{bound:.3g}")
        first = max(abs(r[0] - jax32[0]) / jax32[0] for r in runs + [p32_1])
        print(f"{curve} ({len(jax32)} steps): " + ", ".join(
            f"{k} {v:.3e}" for k, v in correct.items())
            + f"; bound 4x {max(correct.values()):.3e} = {bound:.3e}; first loss p32-jax32 "
            f"{first:.3e} (PNA_FIRST_RTOL {C.PNA_FIRST_RTOL})", flush=True)
        for name, mutate in (("every param 1e-3 off", all_off), ("l0_upd_w 1e-3 off", one_off)):
            m = chain(curve, entry, torch.float32, mutate=mutate)
            m_first, m_all = abs(m[0] - jax32[0]) / jax32[0], rel(m, jax32)
            caught = [part for part, hit in (("first loss", m_first > C.PNA_FIRST_RTOL),
                                              ("curve", m_all > bound)) if hit]
            print(f"  mutant {name}: first loss {m_first:.3e}, every loss {m_all:.3e} "
                  f"({m_all / bound:.2f}x the bound); caught by {caught or 'NOTHING'}")
    first = {"loss": 0.0, "norm": 0.0}
    import chip_smoke as S
    from repro_torch.configs.base import gnn_config_for
    from repro_torch.models import gnn as G

    for shape in S.PNA_SHAPES:
        cfg = gnn_config_for("pna", shape)
        params = G.init_params(cfg, torch.Generator().manual_seed(0))
        batch, _ = S.pna_graph_batches(torch, shape, torch.device("cpu"))(0)
        loss, norm, worst = S.pna_first_step_against_fp64(torch, params, cfg, batch)
        first = {"loss": max(first["loss"], loss), "norm": max(first["norm"], norm)}
        print(f"first step, {shape}: fp32 against float64 loss {loss:.3e}, worst gradient norm "
              f"{norm:.3e} ({worst})", flush=True)
    bounds["PNA_FIRST_LOSS_RTOL"] = float(f"{4 * first['loss']:.3g}")
    bounds["PNA_FIRST_NORM_RTOL"] = float(f"{4 * first['norm']:.3g}")
    print("bounds: " + json.dumps(bounds))


if __name__ == "__main__":
    main()
