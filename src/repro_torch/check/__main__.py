"""CLI for the static pipeline checks: ``python -m repro_torch.check``.

Runs all four analyzers (plan verifier, arena/donation aliasing, host-sync
effects, lockset audit) against one FE preset x model arch pair, without
executing a batch. On the card unless ``--device cpu``: the aliasing pass
runs the ``mempool_alloc`` kernel as one of its planners. Exit contract: 0
clean, 1 an analyzer crashed, 2 error findings. ``--json`` emits the
machine-readable report (the same shape ``MetricsRegistry`` records under
the ``check`` namespace).

Examples::

    python -m repro_torch.check --preset ads_ctr --arch dlrm-mlperf
    python -m repro_torch.check --preset bst --arch bst --json --device cpu
    python -m repro_torch.check --preset dlrm --arch dlrm-mlperf \\
        --analyzers plan,aliasing
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.check import ANALYZERS, run_check


def main(argv: Sequence[str] = None) -> int:
    import argparse

    from repro_torch.configs import list_archs
    from repro_torch.fe import list_specs

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="static plan/arena/effects/lockset checks (no execution)")
    ap.add_argument("--preset", required=True, choices=list_specs(),
                    help="FE preset spec to compile and verify")
    ap.add_argument("--arch", required=True, choices=list_archs(),
                    help="model arch whose smoke config consumes the feed")
    ap.add_argument("--rows", type=int, default=8, metavar="N",
                    help="abstract batch rows for shape flow (default 8)")
    ap.add_argument("--analyzers", default=",".join(ANALYZERS),
                    metavar="A,B", help="comma-separated subset of "
                    f"{'/'.join(ANALYZERS)} (default: all)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the kernel planner and the mesh scan's process "
                         "group run (default: the card; the CPU only on request)")
    args = ap.parse_args(argv)

    analyzers = tuple(a for a in args.analyzers.split(",") if a)
    unknown = sorted(set(analyzers) - set(ANALYZERS))
    if unknown:
        ap.error(f"unknown analyzers: {unknown} (choose from {ANALYZERS})")

    report = run_check(args.preset, args.arch, rows=args.rows,
                       analyzers=analyzers, device=args.device)
    print(report.to_json() if args.json else report.render())
    return report.exit_code


if __name__ == "__main__":
    raise SystemExit(main())
