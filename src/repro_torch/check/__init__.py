"""repro_torch.check — static analysis over compiled plans, arenas, steps
and threads.

Four analyzers behind one :class:`~repro_torch.check.findings.Finding`-based
report, run as a driver preflight (``launch/train.py --check``) and CI gate
(``python -m repro_torch.check --preset ... --arch ...``), with NO execution
of the plan on data:

* :mod:`repro_torch.check.planverify` — abstract dtype/shape flow over the
  compiled OpGraph/Schedule on meta tensors, placement-boundary legality,
  OutputLayout contract, projection completeness, ModelFeed remap bounds
  (PV1xx);
* :mod:`repro_torch.check.aliasing`   — arena block-plan interference
  (interval disjointness, alignment, int32 safety, planner-oracle agreement,
  the ``mempool_alloc`` kernel among the planners) and ring/donation
  lifetime safety (AL2xx);
* :mod:`repro_torch.check.effects`    — host-sync scan of every fused
  super-layer and the boundary train steps on meta tensors, plus the
  in-place update check (EF3xx);
* :mod:`repro_torch.check.lockset`    — AST lockset audit of the pipeline's
  thread-shared state against the :mod:`repro_torch.check.annotations`
  convention (LK4xx).

This ``__init__`` stays import-light on purpose: :mod:`repro_torch.core`
modules import the annotation decorators from here, so pulling the
analyzers in eagerly would create an import cycle through
:mod:`repro_torch.fe`. Analyzers load lazily inside :func:`run_check`.
"""

from repro_torch.check.annotations import guarded_by, shared_entry, single_writer
from repro_torch.check.findings import SEVERITIES, Finding, Report

__all__ = [
    "ANALYZERS",
    "SEVERITIES",
    "Finding",
    "Report",
    "guarded_by",
    "run_check",
    "shared_entry",
    "single_writer",
]

ANALYZERS = ("plan", "aliasing", "effects", "lockset")


def run_check(preset: str, arch: str, *, rows: int = 8, analyzers=ANALYZERS,
              device=None) -> Report:
    """Run the static analyzers against one FE preset x model arch pair.

    Compiles the ``preset`` FeatureSpec and the ``arch``'s smoke config
    exactly the way ``launch/train.py`` streaming mode wires them, then
    audits the compiled artifacts without executing a batch. The kernel
    planner of the aliasing pass and the mesh scan's process group run on
    ``device``: the card unless the caller asks for ``"cpu"``. Returns a
    :class:`Report` whose ``exit_code`` follows the 0/1/2 contract (0
    clean, 1 analyzer crashed, 2 error findings).
    """
    report = Report()

    if "lockset" in analyzers:
        try:
            from repro_torch.check import lockset
            report.record_analyzer("lockset", lockset.audit_default())
        except Exception as e:  # noqa: BLE001 - crash IS the report payload
            report.record_crash("lockset", e)

    plan = mf = None
    try:
        from repro_torch.configs import get_arch
        from repro_torch.fe import featureplan, get_spec

        spec = get_spec(preset)
        plan = featureplan.compile(spec)
        cfg = get_arch(arch).smoke()
        mf = plan.model_feed(cfg, split_sparse_fields=True)
    except Exception as e:  # noqa: BLE001
        report.record_crash("compile", e)
        return report

    if "plan" in analyzers:
        try:
            from repro_torch.check import planverify
            findings = planverify.verify_plan(plan, rows=rows)
            findings += planverify.verify_model_feed(
                mf, plan.feed_layout(split_sparse_fields=mf.split))
            report.record_analyzer("plan", findings)
        except Exception as e:  # noqa: BLE001
            report.record_crash("plan", e)

    if "aliasing" in analyzers:
        try:
            from repro_torch.check import aliasing
            findings = []
            for split in (False, True):
                layout = plan.feed_layout(split_sparse_fields=split)
                where = (f"{preset}/feed_layout"
                         f"{'[split]' if split else '[packed]'}")
                findings += aliasing.check_feed_layout(layout, rows, location=where,
                                                       device=device)
                findings += aliasing.check_ring(layout, rows, buffers=3,
                                                location=where)
            report.record_analyzer("aliasing", findings)
        except Exception as e:  # noqa: BLE001
            report.record_crash("aliasing", e)

    if "effects" in analyzers:
        try:
            from repro_torch.check import effects
            report.record_analyzer(
                "effects", effects.scan_preset(plan, mf, rows=rows, device=device))
        except Exception as e:  # noqa: BLE001
            report.record_crash("effects", e)

    return report
