"""The general generator of pre-extracted batches, driven by a traffic mix.

A mix file gives ``rows`` a batch, ``batches`` distinct batches, the law of
the sparse ids, the law of the dense features and, for training, the label
rate. Every draw is made on the run's device from the seed, in one call a
field, and the batches are then held in host memory (pinned when the
device is a card), from which the run copies each one to the device as the
program asks for it.

Sparse ids: each field draws ranks from a power law of exponent ``s``
bounded to its vocabulary ``V`` (the floor of a continuous draw with
density proportional to ``x^-s`` on ``[1, V + 1)``, so rank ``k`` has
probability close to ``(k + 1)^-s``), and maps them through a random
permutation of its ids drawn from the seed, so the hot rows lie anywhere in
the table. Ads ids are heavy-tailed; the mixes' ``s = 1.05`` is an
assumed exponent, not a measured property of Criteo 1TB (each mix's
``assumed`` says so).
Dense features: exponential with mean ``scale``. Labels: Bernoulli of
``label_rate``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.seeds import substream


def power_law_ranks(n: int, vocab: int, exponent: float, gen: torch.Generator,
                    device) -> torch.Tensor:
    """int64[n] ranks in ``[0, vocab)``, the floor of a bounded power law."""
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    if exponent == 1.0:
        x = torch.pow(float(vocab + 1), u)
    else:
        a = 1.0 - exponent
        x = torch.pow(((vocab + 1) ** a - 1.0) * u + 1.0, 1.0 / a)
    return (x.floor().to(torch.int64) - 1).clamp_(0, vocab - 1)


def _sparse(cfg, mix, n: int, seed: int, device) -> torch.Tensor:
    law = mix["ids"]
    if law["law"] != "power":
        raise ValueError(f"unknown id law {law['law']!r}")
    out = torch.empty((n, cfg["n_sparse"]), dtype=torch.int32, device=device)
    gen = torch.Generator(device=device)
    for f, vocab in enumerate(cfg["vocab_sizes"]):
        gen.manual_seed(substream(seed, f"traffic.ids.{f}"))
        ranks = power_law_ranks(n, vocab, float(law["exponent"]), gen, device)
        if law.get("permute", True):
            ranks = torch.randperm(vocab, generator=gen, device=device)[ranks]
        out[:, f] = ranks.to(torch.int32)
    return out


def make_batches(cfg, mix, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``mix["batches"]`` batches of ``mix["rows"]`` rows: ``sparse``
    int32[rows, n_sparse] (each field's own ids), ``dense`` f32[rows,
    n_dense], and ``label`` f32[rows] where the mix has a ``label_rate``;
    host tensors, pinned when ``device`` is a card."""
    device = torch.device(device)
    rows, count = int(mix["rows"]), int(mix["batches"])
    n = rows * count
    cols = {"sparse": _sparse(cfg, mix, n, seed, device)}
    gen = torch.Generator(device=device)
    if cfg["n_dense"]:
        law = mix["dense"]
        if law["law"] != "exponential":
            raise ValueError(f"unknown dense law {law['law']!r}")
        gen.manual_seed(substream(seed, "traffic.dense"))
        cols["dense"] = torch.empty((n, cfg["n_dense"]), dtype=torch.float32,
                                    device=device).exponential_(1.0 / law["scale"],
                                                                generator=gen)
    if "label_rate" in mix:
        gen.manual_seed(substream(seed, "traffic.label"))
        cols["label"] = (torch.rand(n, generator=gen, device=device)
                         < mix["label_rate"]).to(torch.float32)
    pin = device.type == "cuda"
    host = {}
    for k, v in cols.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
        host[k].copy_(v)
    del cols
    return [{k: v[i * rows:(i + 1) * rows] for k, v in host.items()} for i in range(count)]


def global_ids(cfg, sparse: torch.Tensor, offsets) -> torch.Tensor:
    """int64[B, F] packed-table rows of each field's ids."""
    offs = torch.as_tensor(offsets, dtype=torch.int64, device=sparse.device)
    return sparse.to(torch.int64) + offs[None, :]
