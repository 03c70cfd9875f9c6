"""Rehearse ``chip_smoke.phase_mesh``: where its drift bounds come from
(ROADMAP C21: a bound is derived from a committed CPU rehearsal, never
from a chip run), and, on the card, where the card's drift comes from.

Runs the phase at its widths (full-width ``dlrm-mlperf``, 8,192 rows a
step, 10 shards, the same turns and codec runs) with every vocabulary
capped at ``--cap`` rows (default 50,000; the card's phase caps at
10,000,000), the phase's checks printed instead of raised. On the CPU
(the default) it runs over gloo in place of NCCL, with the profiler on the
CPU; the NCCL check fails there by design. Prints the 1x1 mesh step
against the sparse step and, per codec, each drift from the uncompressed
run beside the uncompressed run's own step (the numbers the
``MESH_DRIFT_BOUND`` of ``chip_smoke.py`` rests on) and the absolute
drifts. About 4 minutes and 3 GB on the CPU at the default cap; with
``--threads 1`` the CPU's reductions are deterministic and the 1x1 mesh
step equals the sparse step bit for bit at this width too (ROADMAP C16),
in about 10 minutes:

  PYTHONPATH=src python tests/rehearse_mesh.py [--cap N] [--threads T] [--seed S]
      [--host-init] [--device cuda]

``--seed`` (default 0, the card's) draws other params, for the spread of
the drift over inits; ``--mutant`` puts a wrong codec in, to show the
one-step check fails it; ``--host-init`` draws them with the host's generator
and copies them to the device, so a run on the card starts from the
params the CPU rehearsal starts from at the same cap (on the CPU it
changes nothing).
"""

import argparse
import math
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cap", type=int, default=50_000)
    ap.add_argument("--threads", type=int, default=0, help="0 keeps torch's default")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host-init", action="store_true")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--mutant", choices=("bf16", "int8"),
                    help="a codec whose wire is 2^-6 (bf16) or 2^-4 (int8) off, which the "
                         "one-step check must fail")
    a = ap.parse_args()
    from repro_torch.train import compression
    if a.mutant == "bf16":
        compression._bf16_encode = lambda x: (x * (1 + 2.0 ** -6)).to(torch.bfloat16)
    elif a.mutant == "int8":
        real = compression._int8_encode
        compression._int8_encode = lambda x: (lambda q, s: (q, s * (1 + 2.0 ** -4)))(*real(x))
    C.VOCAB_CAP, C.MESH_SEED, C.MESH_HOST_INIT = a.cap, a.seed, a.host_init
    if a.threads:
        torch.set_num_threads(a.threads)
    C.MESH_DRIFT_BOUND = {c: math.inf for c in ("bf16", "int8")}
    C.check = lambda ok, what: print(f"check {'ok' if ok else 'FAILED'}: {what}")
    dev = torch.device(a.device)
    print(f"rehearse_mesh: cap {a.cap} seed {a.seed} host-init {a.host_init} device {dev} "
          f"threads {torch.get_num_threads()} mutant {a.mutant}", flush=True)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build()
        build.library()
        print(f"launches: {C.phase_mesh(torch, dev)}")
        return
    real_profile = torch.profiler.profile
    with mock.patch.object(torch.cuda, "synchronize", lambda *a: None), \
            mock.patch.object(torch.cuda, "empty_cache", lambda *a: None), \
            mock.patch.object(torch.profiler, "profile", lambda activities: real_profile(
                activities=[torch.profiler.ProfilerActivity.CPU])):
        print(f"launches: {C.phase_mesh(torch, dev)}")


if __name__ == "__main__":
    main()
