"""Host-sync scan (EF3xx): prove the hot path never waits on the device
and updates its state in place.

Runs every fused super-layer dispatch and the boundary train step on
``meta`` tensors (shapes and dtypes, no storage) under
:class:`SyncRecorder`, a ``TorchDispatchMode`` that records every op which
brings device data back to the host: ``aten._local_scalar_dense``
(``.item()``, ``int(t)``, ``float(t)``, indexing with a 0-d tensor),
``nonzero``, ``unique`` in its forms, ``masked_select``, and a copy to the
CPU. Nothing is executed on data, so this is a static proof, not a smoke
run. The kernels run through their wrappers' meta branches. Two properties
of the paper's pipeline depend on it:

* **No host sync inside coalesced layers.** In the JAX package a
  ``jax.debug.print`` or ``io_callback`` in a device op makes XLA break the
  fused dispatch with a host barrier; in eager torch the same barrier is
  any op that reads device data back, which stalls the FE worker's stream
  every batch. Such an op is the finding, and so is a dispatch that cannot
  run on meta tensors at all.
* **The step updates in place.** The port's form of the JAX step's buffer
  donation is the in-place update: the boundary step
  (``ModelFeed.make_step(...).boundary``) returns the params and optimizer
  tensors it was given, updated. The finding, as in JAX, is raised only
  when *nothing* is: no returned param or optimizer leaf is its input
  tensor, by identity or by shared storage. The JAX scan reads donation
  from the lowered StableHLO's ``tf.aliasing_output`` markers; eager torch
  lowers nothing, so that part has no torch form.

The step scanned is the boundary step (``apply`` + the raw train step). Its
two deliberate host reads, the loss and the working-set count, sit outside
it: in ``ModelFeed._record`` and in the driver's step function, after the
fence of the step has been recorded.

The mesh step is scanned at 1x1 on meta tensors too: the ``c10d``
collectives have meta kernels, so they run shape-only on a process group
of one (gloo on the CPU, NCCL on the card) that the scan starts and stops
when the caller has none.

Rules
-----
``EF301`` (error)   — a coalesced super-layer's fused dispatch forces a host
    sync (or cannot run on meta tensors).
``EF302`` (error)   — the train step was built to update in place, but none
    of its returned params or optimizer tensors is its input updated in
    place: every step copies the model and its optimizer state.
``EF303`` (error)   — the train step itself forces a host sync (or cannot
    run on meta tensors).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.check.findings import Finding
from repro_torch.device import DeviceLike, resolve_device

# ops whose result depends on device data the host must first read back
_SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::nonzero", "aten::_unique",
    "aten::_unique2", "aten::unique_dim", "aten::unique_consecutive",
    "aten::unique_dim_consecutive", "aten::masked_select",
})
_PLACEHOLDER = {torch.bool: False}


def _host_copy(name: str, args, kwargs) -> bool:
    """A copy of a non-CPU tensor to the CPU."""
    if name == "aten::_to_copy":
        dst = kwargs.get("device")
        return (dst is not None and torch.device(dst).type == "cpu"
                and args[0].device.type != "cpu")
    if name == "aten::copy_":
        return args[0].device.type == "cpu" and args[1].device.type != "cpu"
    return False


class SyncRecorder(TorchDispatchMode):
    """Record every op that reads device data back to the host.

    On a meta tensor ``aten._local_scalar_dense`` has no value to give; the
    recorder answers it with a placeholder (``0``, ``0.0`` or ``False``) so
    that the run goes on and every sync of the function is listed."""

    def __init__(self) -> None:
        super().__init__()
        self.syncs: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if name in _SYNC_OPS or _host_copy(name, args, kwargs):
            self.syncs.append(name.removeprefix("aten::") + (
                " (copy to the host)" if name in ("aten::_to_copy", "aten::copy_") else ""))
            if name == "aten::_local_scalar_dense" and args[0].device.type == "meta":
                dt = args[0].dtype
                return _PLACEHOLDER.get(dt, 0.0 if dt.is_floating_point else 0)
        return func(*args, **kwargs)


def run_recorded(fn: Callable, *args) -> Tuple[Any, Tuple[str, ...], Optional[str]]:
    """``(result, syncs, error)`` of ``fn(*args)`` under :class:`SyncRecorder`:
    the distinct host syncs in the order first met, and the exception the
    run raised (``"Type: message"``; the result is then ``None``)."""
    rec = SyncRecorder()
    out, err = None, None
    try:
        with rec:
            out = fn(*args)
    except Exception as e:  # noqa: BLE001 - a failed abstract run IS the finding
        err = f"{type(e).__name__}: {e}"
    return out, tuple(dict.fromkeys(rec.syncs)), err


def scan_executables(layers: Sequence, env: Dict[str, torch.Tensor],
                     *, location: str = "plan") -> List[Finding]:
    """EF301 over every fused super-layer dispatch in ``layers``.

    ``env`` maps slot names to meta tensors for every device input slot
    (:func:`repro_torch.check.planverify.abstract_flow` produces it).
    """
    findings: List[Finding] = []
    for ex in layers:
        if ex.fused_fn is None:
            continue
        where = f"{location}/layer {ex.index}"
        missing = [s for s in ex.device_input_slots if s not in env]
        if missing:
            findings.append(Finding(
                rule="EF301", severity="error", location=where,
                message=f"cannot trace fused dispatch: no abstract value "
                        f"for input slots {missing}",
                hint="run the plan verifier first; its PV103 finding is the "
                     "root cause"))
            continue
        _, syncs, err = run_recorded(
            ex.fused_fn, {s: env[s] for s in ex.device_input_slots})
        if syncs:
            findings.append(Finding(
                rule="EF301", severity="error", location=where,
                message=(f"coalesced dispatch over layers "
                         f"{ex.layer_indices} forces host syncs "
                         f"{list(syncs)}: the FE stream waits for the "
                         f"device every batch"),
                hint="keep device ops on device values (no .item(), "
                     "nonzero, unique or .cpu()), or mark the op "
                     "host-placed so the scheduler splits the layer"))
        elif err is not None:
            findings.append(Finding(
                rule="EF301", severity="error", location=where,
                message=f"fused dispatch fails abstract tracing: {err}",
                hint="see the plan verifier's PV103 output"))
    return findings


def _storages(tree) -> Dict[int, torch.Tensor]:
    return {t.untyped_storage()._cdata: t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


def updated_in_place(inputs, outputs) -> bool:
    """Whether some tensor of ``outputs`` is a tensor of ``inputs``, by
    identity or by shared storage (the port's donation)."""
    ids = {id(t) for t in tree_leaves(inputs) if isinstance(t, torch.Tensor)}
    if any(id(t) in ids for t in tree_leaves(outputs) if isinstance(t, torch.Tensor)):
        return True
    return bool(_storages(inputs).keys() & _storages(outputs).keys())


def check_step(step: Callable, args: Tuple, *, expect_donation: bool,
               location: str = "train-step") -> List[Finding]:
    """EF302/EF303 on one boundary step ``(params, opt_state, feed) ->
    (params, opt_state, metrics)``, run on the meta tensors ``args``."""
    findings: List[Finding] = []
    out, syncs, err = run_recorded(step, *args)
    if syncs:
        findings.append(Finding(
            rule="EF303", severity="error", location=location,
            message=f"train step forces host syncs {list(syncs)}",
            hint="a host read inside the step stalls the train stream "
                 "every batch; read metrics after the step's fence"))
    if err is not None:
        if not syncs:
            findings.append(Finding(
                rule="EF303", severity="error", location=location,
                message=f"train step fails abstract tracing: {err}",
                hint="the model feed's slot shapes diverge from the train "
                     "step's batch contract"))
        return findings

    if expect_donation and not updated_in_place(args[:2], out[:2]):
        findings.append(Finding(
            rule="EF302", severity="error", location=location,
            message=("step was built to update in place but returns no "
                     "param or optimizer tensor it was given: params and "
                     "opt state are copied every batch"),
            hint="update params and optimizer state in place "
                 "(torch.no_grad + in-place ops) and return them"))
    return findings


def abstract_step_args(plan, mf, *, rows: int = 8,
                       init: Optional[Callable] = None) -> Tuple:
    """Meta ``(params, opt_state, feed)`` for ``mf``'s boundary step.

    Everything is derived without allocating: params from
    :func:`~repro_torch.models.recsys.param_shapes` on ``device="meta"``
    (not drawn), optimizer state from the step factory's ``init`` run on
    them (pass ``init=`` for a non-default step family, e.g. the mesh
    step's codec residual), and the feed from the staging layout's slot
    specs (what :meth:`DeviceFeeder.claim_views` stages).
    """
    from repro_torch.check.planverify import abstract
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw

    cfg = mf.config
    params = {k: abstract(s, cfg.dtype) for k, s in R.param_shapes(cfg).items()}
    if init is None:
        _, init = R.make_sparse_train_step(cfg, adamw(1e-3))
    opt_state = init(params)

    layout = plan.feed_layout(split_sparse_fields=mf.split)
    by_name = {s.name: s for s in layout.slots}
    feed = {slot: abstract(by_name[slot].shape(rows), by_name[slot].torch_dtype)
            for slot in mf.slots}
    return params, opt_state, feed


def scan_preset(plan, mf, *, rows: int = 8, device: DeviceLike = None) -> List[Finding]:
    """Full scan of one compiled preset: every super-layer dispatch plus
    the null, the sparse and the 1x1 mesh boundary steps, at ``rows``
    rows. The mesh step's process group of one is for ``device`` (the card
    unless the caller asks for ``"cpu"``)."""
    import torch.distributed as dist

    from repro_torch.check import planverify
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw

    env, flow_findings = planverify.abstract_flow(plan, rows)
    findings: List[Finding] = []
    if not flow_findings:  # PV103 already reports broken flow
        findings += scan_executables(plan.layers, env,
                                     location=f"plan {plan.name!r}")

    cfg = mf.config
    args = abstract_step_args(plan, mf, rows=rows)
    findings += check_step(
        mf.make_step(_null_train_step).boundary, args, expect_donation=True,
        location=f"train-step {cfg.name!r}[null]")

    raw, _ = R.make_sparse_train_step(cfg, adamw(1e-3))
    findings += check_step(
        mf.make_step(raw).boundary, abstract_step_args(plan, mf, rows=rows),
        expect_donation=True, location=f"train-step {cfg.name!r}")

    # The mesh step must survive the same scan: its collectives and its
    # sharded write-back could smuggle in a host read or a copy of the
    # state. One process, so the 1x1 mesh: the shape the bitwise
    # equivalence with the sparse step covers.
    owned = not dist.is_initialized()
    try:
        mesh = make_train_mesh(1, 1, device=resolve_device(device))
        raw_mesh, mesh_init = R.make_mesh_train_step(
            cfg, adamw(1e-3), mesh=mesh, compress="bf16")
        params, opt_state, feed = abstract_step_args(plan, mf, rows=rows, init=mesh_init)
        params, opt_state = R.shard_train_state(mesh, params, opt_state)
        findings += check_step(
            mf.make_step(raw_mesh).boundary, (params, opt_state, feed),
            expect_donation=True, location=f"train-step {cfg.name!r}[mesh 1x1]")
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    return findings


def _null_train_step(params, opt_state, batch):
    """In-place-shaped identity step: same (params, opt, metrics) contract
    as the real step, zero model math — isolates the model feed's own
    adaptation in the sync/donation scan."""
    metrics = {"loss": torch.zeros((), dtype=torch.float32,
                                   device=batch["label"].device)}
    return params, opt_state, metrics
