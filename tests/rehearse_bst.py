"""Rehearses the BST tolerances of ``chip_smoke.py`` phase 14 and
``tests/test_torch_curves.py`` on the CPU, and prints what they rest on:

1. the port's ``full/bst`` chain (published BST, 8 steps of 8,192 rows from
   ``curve_fixture.numpy_params``) with 1 intra-op thread and with the
   default count: the relative deviation of each loss from the fixture's
   JAX losses (ROADMAP C16);
2. the same chain with dense params 1e-3 (relative) off, all of them or one
   at a time: what the first-loss and every-loss tolerances must catch;
3. the BST smoke chains (``loop/bst``, ``stream/bst``) as they are and with
   ``top_w0`` 1e-3 off, against ``CURVE_RTOL``;
4. ``layer_norm`` against JAX's jitted function, per element over
   2**-24 x ((1 + |mu| / sigma) max(|x_hat|, 1) |w| + |b|).

  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/rehearse_bst.py

About two minutes and 4 GB. Parts 1-3 import nothing of JAX.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import curve_fixture as C

CPU = torch.device("cpu")


def _deviation(losses, entry):
    want = np.asarray(entry["losses"])
    return np.abs(np.asarray(losses) - want) / np.abs(want)


def _fmt(rel):
    return "[" + ", ".join(f"{x:.2e}" for x in rel) + "]"


def full_chain() -> None:
    from repro_torch.models.recsys import params_from_jax

    entry = C.load()["full/bst"]
    default = torch.get_num_threads()
    for threads in (1, default):
        torch.set_num_threads(threads)
        t0 = time.perf_counter()
        rel = _deviation(C.port_losses("full/bst", entry, CPU), entry)
        print(f"full/bst, {threads} thread(s), {time.perf_counter() - t0:.1f} s: relative "
              f"deviation per step {_fmt(rel)}")
    torch.set_num_threads(default)
    cfg = C.curve_config("full/bst")
    for which in ("all dense", "top_w0", "blk0_wq", "top_w3"):
        params = params_from_jax(C.numpy_params(cfg, int(entry["seed"])), CPU)
        for k, v in params.items():
            if k != "embed" and which in ("all dense", k):
                v.mul_(1 + 1e-3)
        rel = _deviation(C.port_losses("full/bst", entry, CPU, params=params), entry)
        print(f"full/bst, {which} 1e-3 off: first {rel[0]:.2e}, largest {rel.max():.2e}")


def smoke_chains() -> None:
    from repro_torch.models.recsys import params_from_jax

    fixture = C.load()
    for curve in ("loop/bst", "stream/bst"):
        entry = fixture[curve]
        honest = _deviation(C.port_losses(curve, entry, CPU), entry).max()
        params = params_from_jax(entry["params"], CPU)
        params["top_w0"].mul_(1 + 1e-3)
        off = _deviation(C.port_losses(curve, entry, CPU, params=params), entry).max()
        print(f"{curve}: largest relative deviation {honest:.2e}; with top_w0 1e-3 off "
              f"{off:.2e}")


def layer_norm_units() -> None:
    import jax

    from repro.models.common import layer_norm as jax_layer_norm
    from repro_torch.models.common import layer_norm

    worst, rows = 0.0, 0
    for shape in ((64, 21, 32), (512, 6, 16), (4096, 21, 32), (8192, 21, 32), (300, 7, 128)):
        for seed in range(4):
            rng = np.random.default_rng(seed)
            x = (rng.standard_normal(shape) * rng.uniform(0.01, 10) + rng.uniform(-3, 3)
                 ).astype(np.float32)
            x64 = x.astype(np.float64)
            mu, sd = x64.mean(-1, keepdims=True), x64.std(-1, keepdims=True)
            x_hat = (x64 - mu) / np.sqrt(sd ** 2 + 1e-5)
            w = rng.standard_normal(shape[-1:]).astype(np.float32)
            b = rng.standard_normal(shape[-1:]).astype(np.float32)
            want = np.asarray(jax.jit(jax_layer_norm)(x, w, b)).astype(np.float64)
            got = layer_norm(*(torch.from_numpy(a) for a in (x, w, b))).numpy()
            unit = 2.0 ** -24 * ((1 + np.abs(mu) / sd) * np.maximum(np.abs(x_hat), 1) * np.abs(w)
                                 + np.abs(b))
            worst = max(worst, float((np.abs(got - want) / unit).max()))
            rows += int(np.prod(shape[:-1]))
    print(f"layer_norm: largest |port - JAX| over the unit {worst:.2f} over {rows:,} rows")


if __name__ == "__main__":
    full_chain()
    smoke_chains()
    layer_norm_units()
