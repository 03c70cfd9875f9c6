"""The program's configuration object, built from a configuration file.

The kinds call the program under test, ``repro_torch``, by name
(``models.recsys``, ``train.loop``, ``train.optimizer``), always inside
functions, so this package imports without it."""

from __future__ import annotations

import dataclasses

import torch


def recsys_config(cfg):
    """The program's ``RecsysConfig`` of a configuration file: every key of
    the file that names a field of it, lists as tuples, ``dtype`` as the
    torch dtype."""
    from repro_torch.models.recsys import RecsysConfig

    fields = {f.name for f in dataclasses.fields(RecsysConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in fields}
    kw["dtype"] = getattr(torch, cfg["dtype"])
    return RecsysConfig(**kw)

