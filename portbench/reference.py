"""The plain reference that decides ``correct``: fp32 PyTorch, TF32 off,
written from the formulas, importing nothing of the program.

Training follows the program's first steps on the same batches from the
same starting weights: the working set is ``torch.unique`` of the batch's
packed rows, the loss is the mean binary cross entropy of the logits, the
dense params take AdamW after clipping the dense gradient's global norm,
and each touched row takes row-wise Adagrad (one accumulator a row, which
adds the sum of the row's squared gradient). Scoring runs the forward over
the batch in blocks of rows and takes the sigmoid.

The reference works on the rows the steps touch (``union``, sorted), cut
from the table made again from the seed, so it never holds a second table.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.traffic import global_ids
from portbench.weights import offsets

# Row-wise Adagrad's accumulators start at 0.1 in the program under test
# (its documented start, which it takes from no setting): frozen here, so
# no traffic mix can state a start that the timed run would not use.
ADAGRAD_INIT = 0.1


@dataclasses.dataclass
class TrainReadings:
    """What a training run is judged by: each step's loss, each leaf's
    norm of the first step's gradient as its optimizer took it (read from
    the state after the step, :func:`grad_from_state`), and each leaf's
    norm of its change over the steps. ``embed`` is the table."""

    losses: List[float]
    grad: Dict[str, float]
    change: Dict[str, float]


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 matrix products in TF32 (``tf32``) or in full fp32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def norm(x: torch.Tensor) -> float:
    """The 2-norm, summed in float64."""
    return float(torch.linalg.vector_norm(x.to(torch.float64)))


def grad_from_state(adam_m: Dict[str, torch.Tensor], b1: float, rows0: torch.Tensor,
                    rows1: torch.Tensor, accum1: torch.Tensor, lr: float,
                    eps: float) -> Dict[str, float]:
    """Each leaf's norm of the first step's gradient as its optimizer took
    it, worked out from the state after that step, the same way for the
    program and for the reference. AdamW's first moment is ``(1 - b1) g``
    of the clipped dense gradient. Row-wise Adagrad moved each of the first
    batch's rows from ``rows0`` to ``rows1`` by ``lr g / (sqrt(accum1) +
    eps)``, ``accum1`` its accumulator after the step. (The accumulator's
    growth alone would lose every row whose squared gradient is under half
    an ulp of its start.)"""
    out = {k: norm(v) / (1 - b1) for k, v in adam_m.items()}
    f64 = torch.float64
    scale = (torch.sqrt(accum1.to(f64)) + eps) / lr
    out["embed"] = norm((rows0.to(f64) - rows1.to(f64)) * scale[:, None])
    return out


def half_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The first half of a batch's rows (a planted fault: half left out)."""
    n = next(iter(batch.values())).shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}


def train(model, cfg, opt, dense0: Dict[str, torch.Tensor], rows0: torch.Tensor,
          union: torch.Tensor, batches, device, *, tf32: bool = False,
          fault: str = "") -> TrainReadings:
    """Follow ``len(batches)`` steps from ``dense0`` and the rows ``rows0``
    (the table's rows ``union``). ``fault="half"`` trains on each batch's
    first half: a fault the check has to catch."""
    od, oe = opt["dense"], opt["embed"]
    if od["name"] != "adamw" or oe["name"] != "rowwise_adagrad":
        raise ValueError(f"no reference for optimizers {od['name']!r}, {oe['name']!r}")
    dense = {k: v.detach().clone() for k, v in dense0.items()}
    rows = rows0.detach().clone()
    acc = torch.full((rows.shape[0],), ADAGRAD_INIT, dtype=torch.float32, device=device)
    m = {k: torch.zeros_like(v) for k, v in dense.items()}
    v2 = {k: torch.zeros_like(v) for k, v in dense.items()}
    names = sorted(dense)
    offs = offsets(cfg)
    losses, grad = [], {}
    for t, host in enumerate(batches, 1):
        b = {k: x.to(device) for k, x in host.items()}
        if fault == "half":
            b = half_batch(b)
        local = torch.searchsorted(union, global_ids(cfg, b["sparse"], offs))
        uniq, inv = torch.unique(local, return_inverse=True)
        with precision(tf32), torch.enable_grad():
            leaves = {k: dense[k].detach().requires_grad_(True) for k in names}
            work = rows[uniq].detach().requires_grad_(True)
            logits = model.forward(leaves, cfg, b["dense"], work[inv])
            loss = F.binary_cross_entropy_with_logits(logits, b["label"])
            gs = torch.autograd.grad(loss, [leaves[k] for k in names] + [work])
        with torch.no_grad():
            g_dense, g_rows = dict(zip(names, gs[:-1])), gs[-1]
            total = torch.sqrt(sum(torch.sum(g * g) for g in g_dense.values()))
            scale = torch.clamp(od["clip_norm"] / total, max=1.0) if od["clip_norm"] else 1.0
            bc1, bc2 = 1 - od["b1"] ** t, 1 - od["b2"] ** t
            for k in names:
                g = g_dense[k] * scale
                m[k] = od["b1"] * m[k] + (1 - od["b1"]) * g
                v2[k] = od["b2"] * v2[k] + (1 - od["b2"]) * g * g
                step = (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + od["eps"])
                dense[k] -= od["lr"] * (step + od["weight_decay"] * dense[k])
            acc[uniq] += torch.sum(g_rows * g_rows, dim=1)
            rows[uniq] -= oe["lr"] * g_rows / (torch.sqrt(acc[uniq]) + oe["eps"])[:, None]
            if t == 1:
                grad = grad_from_state(m, od["b1"], rows0[uniq], rows[uniq], acc[uniq],
                                       oe["lr"], oe["eps"])
        losses.append(float(loss.detach()))
    change = {k: norm(dense[k] - dense0[k]) for k in names}
    change["embed"] = norm(rows - rows0)
    return TrainReadings(losses=losses, grad=grad, change=change)


@torch.no_grad()
def score(model, cfg, params: Dict[str, torch.Tensor], batch, device, *, tf32: bool = False,
          block: int = 65536) -> torch.Tensor:
    """pCTR f32[B] of one batch, ``block`` rows at a time."""
    offs = offsets(cfg)
    out = []
    with precision(tf32):
        for lo in range(0, batch["sparse"].shape[0], block):
            sparse = batch["sparse"][lo:lo + block].to(device)
            emb = params["embed"][global_ids(cfg, sparse, offs)]
            logits = model.forward(params, cfg, batch["dense"][lo:lo + block].to(device), emb)
            out.append(torch.sigmoid(logits))
    return torch.cat(out)

