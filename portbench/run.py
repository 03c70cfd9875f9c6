"""Run one cell of BENCHMARK.json against the port, on the card.

    python3 -m portbench.run --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout. The run makes its inputs and weights from
``--seed``, warms up the cell's shapes (set-up), measures for ``--seconds``,
then checks the program's results against the plain reference and prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, ``breakdown`` (traced
runs) and ``check`` (each number compared, with its limit). The card's
state (``nvidia-smi``) at set-up and after the window is printed on the
line before it; the numbers compared are also the last lines of standard
error.

Exit codes: 0 with a result; 2 for a cell or a program that is not there;
3 without a card or with fewer cards than the cell asks for; 4 when JAX or
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()       # set-up is timed from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})
CARD_FIELDS = ("name,clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu,"
               "clocks_throttle_reasons.active")


def card_state() -> str:
    """One line of ``nvidia-smi``'s reading of the card (name, clocks, power,
    temperature, throttle reasons)."""
    queries = (CARD_FIELDS, CARD_FIELDS.replace("throttle", "event"), "name,power.limit")
    for query in queries:
        try:
            r = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv"],
                               capture_output=True, text=True, timeout=60)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"unavailable ({e})"
        if r.returncode == 0:
            return " / ".join(line.strip() for line in r.stdout.splitlines() if line.strip())
    return f"unavailable (nvidia-smi exit {r.returncode}: {r.stdout.strip()[:200]})"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's, the JAX
    package's or the JAX benchmarks' (whole names: ``repro_torch`` is not
    ``repro``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader sees."""

    cell: object
    result: object


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """Run ``cell`` and return ``(result line, card readings, the check's
    detail)``."""
    import torch

    from portbench import judge, spec

    tf32 = bool(cell.config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    cards = []
    t = time.perf_counter()
    cards.append(f"set-up: {card_state()}")
    card_s = time.perf_counter() - t
    res = cell.kind.run(cell, seed, seconds, trace, device,
                        lambda: cards.append(f"after the window: {card_state()}"))
    setup_s = res.setup_end - t_start - res.excluded_s - card_s
    correct, shown = judge.verdict(res.numbers, cell.limits)
    metrics = {}
    if trace:
        ctx = Context(cell, res)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else res.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": res.memory_peak_bytes}
    line = {"correct": bool(correct and res.failed == 0), "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics, "device": dev}
    if trace and res.trace is not None:
        dev["busy_s"] = res.trace.busy_s
        dev["window_s"] = res.trace.window_s
        line["breakdown"] = res.trace.breakdown()
    line["check"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                     for k, v in shown.items()}
    before = res.setup_end - t_start - sum(res.setup_parts.values())
    parts = " ".join(f"{k}={v:.3f}" for k, v in res.setup_parts.items())
    detail = f"set-up parts (s): before the kind={before:.3f} {parts}"
    return line, cards, "\n".join(x for x in (detail, res.detail) if x)


def check_lines(line) -> str:
    return "\n".join(f"check {k}: {v['value']!r} limit {v['limit']!r}"
                     for k, v in line["check"].items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import spec

    try:
        cell = spec.load_cell(args.workload, spec.load_benchmark(ROOT))
    except (KeyError, FileNotFoundError) as e:
        print(f"portbench: no cell {args.workload!r} ({e!r})", file=sys.stderr)
        return 2
    if args.seed < 0:
        print(f"portbench: --seed must be >= 0, got {args.seed}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"portbench: the program is not in this checkout ({ROOT / 'src' / 'repro_torch'})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # every build and kernel cache at a fixed place inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 3
    line, cards, detail = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                   torch.device("cuda", 0), T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}; no result", file=sys.stderr)
        return 4
    print("card " + "; ".join(cards))
    sys.stdout.flush()
    if detail:
        print(detail, file=sys.stderr)
    print(check_lines(line), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
