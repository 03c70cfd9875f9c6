"""Quickstart: declarative features -> compiled plan -> training, in ~60 lines.

Generates raw ads views, compiles the bundled ``ads_ctr`` FeatureSpec into a
FeaturePlan (operator graph -> layered schedule -> fused meta-kernels), runs
one batch through the plan, and trains a tiny CTR model on the output (the
port of ``examples/quickstart.py``; the model is
:mod:`repro_torch.examples.serve_ctr`'s, as the two JAX examples share it).

Swap the spec name for ``dlrm`` or ``bst`` to change the whole feature
pipeline in one line.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.examples.serve_ctr import make_model, train
from repro_torch.fe import featureplan, get_spec
from repro_torch.fe.datagen import gen_views


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Run the quickstart; returns the 30 training losses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. raw logs: three views + materialized basic features --------------
    views = gen_views(n_instances=2048, seed=0)

    # 2. declarative feature definitions, compiled into a plan -------------
    plan = featureplan.compile(get_spec("ads_ctr"))
    print(plan.summary())
    print("columns read:", {v: len(c) for v, c in plan.required_columns.items()})

    # 3. run the pipeline: views -> training batch -------------------------
    batch = plan.outputs(plan.run(views, device=dev))
    print("batch:", {k: tuple(v.shape) for k, v in batch.items()})

    # 4. a tiny CTR model over the extracted features ----------------------
    params = make_model(torch.Generator(device=dev).manual_seed(0), plan.layout)
    params, losses = train(params, batch, 30, log_every=10)
    print(f"final loss {losses[-1]:.4f}")
    assert losses[-1] < 0.7, "training should reduce loss below chance"
    print("quickstart OK")
    return losses


if __name__ == "__main__":
    main()
