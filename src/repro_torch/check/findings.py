"""Finding/report model shared by every ``repro.check`` analyzer.

Mirrors the shape of :mod:`repro.obs.validate`'s trace report — a typed
result object with a JSON form and a CLI exit contract — generalized to
many analyzers:

* a :class:`Finding` is one violation: rule id, severity, location,
  message, and a fix hint;
* a :class:`Report` collects findings across analyzers, remembers which
  analyzers ran and which crashed, and maps the whole run onto the same
  0/1/2 exit contract as ``benchmarks/run.py --compare``:

  - ``0`` — every analyzer ran and no error-severity finding;
  - ``1`` — an analyzer itself crashed (tooling failure; takes precedence
    over findings so a broken checker is never mistaken for a clean run);
  - ``2`` — error-severity findings (the gated outcome).

Severities: ``error`` gates the exit code; ``warning`` is reported but
non-gating (advisory invariants); ``info`` is context. All three appear in
the JSON payload and the :meth:`Report.as_metrics` counters, so the
:class:`repro.obs.MetricsRegistry` can track finding counts per run.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Tuple

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis violation."""

    rule: str       # stable rule id, e.g. "PV102" / "AL201" / "LK402"
    severity: str   # "error" | "warning" | "info"
    location: str   # where: "plan ads_ctr/final_batch", "devicefeed.py:123"
    message: str    # what is wrong
    hint: str = ""  # how to fix it

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {self.severity!r}")

    def to_dict(self) -> Dict[str, str]:
        return {"rule": self.rule, "severity": self.severity,
                "location": self.location, "message": self.message,
                "hint": self.hint}

    def render(self) -> str:
        line = f"{self.severity.upper()} {self.rule} [{self.location}] {self.message}"
        if self.hint:
            line += f"  (fix: {self.hint})"
        return line


@dataclasses.dataclass
class Report:
    """Findings from one ``repro.check`` run, with the exit-code contract."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    analyzers_run: List[str] = dataclasses.field(default_factory=list)
    # analyzer name -> one-line crash description (exception repr)
    crashed: Dict[str, str] = dataclasses.field(default_factory=dict)

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def record_analyzer(self, name: str, findings: Iterable[Finding]) -> None:
        self.analyzers_run.append(name)
        self.extend(findings)

    def record_crash(self, name: str, exc: BaseException) -> None:
        self.analyzers_run.append(name)
        self.crashed[name] = f"{type(exc).__name__}: {exc}"

    # ------------------------------------------------------------- rollups
    def by_severity(self, severity: str) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == severity)

    @property
    def errors(self) -> Tuple[Finding, ...]:
        return self.by_severity("error")

    @property
    def warnings(self) -> Tuple[Finding, ...]:
        return self.by_severity("warning")

    @property
    def exit_code(self) -> int:
        """0 clean / 1 analyzer crashed (takes precedence) / 2 errors —
        the same contract as ``benchmarks/run.py --compare``."""
        if self.crashed:
            return 1
        if self.errors:
            return 2
        return 0

    # --------------------------------------------------------------- output
    def to_dict(self) -> Dict[str, object]:
        return {
            "analyzers": list(self.analyzers_run),
            "crashed": dict(self.crashed),
            "n_findings": len(self.findings),
            "n_errors": len(self.errors),
            "n_warnings": len(self.warnings),
            "exit_code": self.exit_code,
            "findings": [f.to_dict() for f in self.findings],
        }

    def to_json(self, *, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def as_metrics(self) -> Dict[str, float]:
        """Finding counters for :class:`repro.obs.MetricsRegistry`."""
        out: Dict[str, float] = {
            "analyzers": len(self.analyzers_run),
            "crashed": len(self.crashed),
            "findings": len(self.findings),
            "exit_code": self.exit_code,
        }
        for sev in SEVERITIES:
            out[f"{sev}s"] = len(self.by_severity(sev))
        return out

    def render(self) -> str:
        """Human-readable multi-line summary (findings first, then totals)."""
        lines = [f.render() for f in self.findings]
        for name, why in self.crashed.items():
            lines.append(f"CRASH {name}: {why}")
        lines.append(
            f"repro.check: {len(self.analyzers_run)} analyzers, "
            f"{len(self.errors)} errors, {len(self.warnings)} warnings, "
            f"{len(self.by_severity('info'))} info -> exit {self.exit_code}")
        return "\n".join(lines)
