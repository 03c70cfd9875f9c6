"""Thread-contract annotations (a copy of the JAX package's
``repro.check.annotations``); the JAX package's static analyzers are not
ported (ROADMAP A10)."""

from repro_torch.check.annotations import guarded_by, shared_entry, single_writer

__all__ = ["guarded_by", "shared_entry", "single_writer"]
