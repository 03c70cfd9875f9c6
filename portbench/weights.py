"""The parameters both sides start from, made on the device from the seed.

The packed embedding table holds every sparse field's rows one after the
other (field ``f`` starts at the sum of the vocabularies before it), padded
to a multiple of ``row_align`` rows. The table is drawn uniform in
``[-1/sqrt(D), 1/sqrt(D))`` in one call; every 2-D weight is He-normal,
``N(0, 2 / fan_in)``, all of them cut from one ``randn`` call; every bias
is zero. The names and shapes are the model module's ``param_shapes``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.seeds import substream


def offsets(cfg) -> np.ndarray:
    """Row offset of each field in the packed table."""
    sizes = np.asarray(cfg["vocab_sizes"], np.int64)
    return np.concatenate([[0], np.cumsum(sizes)[:-1]])


def table_rows(cfg) -> int:
    """Rows of the packed table, padded to a multiple of ``row_align``."""
    rows = int(sum(cfg["vocab_sizes"]))
    align = int(cfg["row_align"])
    return (rows + align - 1) // align * align


def dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def make(cfg, model, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` on ``device`` for the configuration ``cfg`` of the
    model module ``model``; the same seed gives the same bits on the same
    kind of device."""
    dt = dtype(cfg)
    shapes = model.param_shapes(cfg)
    gen = torch.Generator(device=device)
    params: Dict[str, torch.Tensor] = {}
    gen.manual_seed(substream(seed, "weights.embed"))
    scale = 1.0 / math.sqrt(cfg["embed_dim"])
    params["embed"] = torch.empty(shapes["embed"], dtype=dt, device=device).uniform_(
        -scale, scale, generator=gen)
    mats = [(k, s) for k, s in shapes.items() if k != "embed" and len(s) == 2]
    gen.manual_seed(substream(seed, "weights.dense"))
    flat = torch.randn(sum(math.prod(s) for _, s in mats), generator=gen, dtype=dt,
                       device=device)
    at = 0
    for name, shape in mats:
        n = math.prod(shape)
        params[name] = flat[at:at + n].view(shape).mul_(math.sqrt(2.0 / shape[0]))
        at += n
    for name, shape in shapes.items():
        if name not in params:
            params[name] = torch.zeros(shape, dtype=dt, device=device)
    return params
