"""Thread-contract annotations and the lockset audit that verifies them.

:mod:`repro_torch.check.annotations`, :mod:`repro_torch.check.findings` and
:mod:`repro_torch.check.lockset` are copies of the JAX package's modules
(AST only, no execution): ``lockset.audit_default(root="src/repro_torch")``
audits the port's six thread-owning modules. The plan, arena and effects
analyzers and ``python -m repro.check`` are not ported (ROADMAP A10).
This ``__init__`` stays import-light: ``core`` modules import the
decorators from here."""

from repro_torch.check.annotations import guarded_by, shared_entry, single_writer

__all__ = ["guarded_by", "shared_entry", "single_writer"]
