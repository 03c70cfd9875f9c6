"""``repro_torch.launch.hlo_stats`` against the JAX package's and by hand,
on the CPU.

* FLOPs of the ``dlrm-mlperf`` smoke step equal JAX's ``step_cost`` by the
  stated rule (below);
* a Python loop of 8 counts 8 times its body (the torch form of
  ``tests/test_hlo_stats.py``'s scan test), nested loops multiply, batched
  products count their batch dims;
* op bytes of a small function equal a hand count;
* the kernels' meta branches charge their formulas, launch nothing and
  count no launch; a hash program past one launch's ops charges each
  launch;
* the keys of ``Totals`` are JAX's with the stated renames;
* the mesh step's collective bytes are those of its ``CommPlan``;
* ``step_cost`` reads and allocates nothing of its arguments.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch.hlo_stats import Totals as JaxTotals  # noqa: E402
from repro.launch.hlo_stats import step_cost as jax_step_cost  # noqa: E402
from repro.launch.train import synthetic_batch as jax_synthetic_batch  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.train.optimizer import adamw as jax_adamw  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.feature_hash.ops import OPS_PER_LAUNCH, run_hash_layer  # noqa: E402
from repro_torch.kernels.interaction_dot import ops as interaction_ops  # noqa: E402
from repro_torch.launch.hlo_stats import Totals, abstractify, step_cost  # noqa: E402
from repro_torch.launch.train import synthetic_batch  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.train.optimizer import adamw  # noqa: E402

CPU = torch.device("cpu")


def test_python_loop_of_8_counts_8_bodies():
    d = 64
    w = torch.zeros(d, d)

    def body(c):
        return torch.tanh(c @ w)

    def looped(x):
        for _ in range(8):
            x = body(x)
        return x

    x = torch.zeros(4, d)
    one, eight = step_cost(body, x), step_cost(looped, x)
    assert one.flops == 2 * 4 * d * d
    assert eight.flops == 8 * one.flops and eight.op_bytes == 8 * one.op_bytes


def test_nested_loops_multiply():
    d = 32
    w = torch.zeros(d, d)

    def fn(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x

    assert step_cost(fn, torch.zeros(2, d)).flops == 5 * 3 * 2 * 2 * d * d


def test_dot_flops_with_batch_dims():
    a, b = torch.zeros(8, 16, 32), torch.zeros(8, 32, 24)
    assert step_cost(lambda a, b: torch.einsum("bik,bkj->bij", a, b), a, b).flops == \
        2 * 8 * 16 * 24 * 32


def test_op_bytes_are_a_hand_count():
    """``relu(a @ b + c)`` runs mm, add and relu, each reading its operands
    and writing its output once; the transposed view moves nothing."""
    a, b, c = torch.zeros(8, 16), torch.zeros(32, 16), torch.zeros(8, 32)
    t = step_cost(lambda a, b, c: torch.relu(a @ b.t() + c), a, b, c)
    f32 = 4
    mm = (8 * 16 + 16 * 32 + 8 * 32) * f32
    add = (8 * 32 + 8 * 32 + 8 * 32) * f32
    relu = (8 * 32 + 8 * 32) * f32
    assert t.op_bytes == mm + add + relu
    assert t.flops == 2 * 8 * 32 * 16 and t.collective == {}


def test_indexed_reads_and_writes_count_the_addressed_rows():
    """A gather counts its index, its output and the rows it reads; an
    in-place scatter its index, its values and the rows it writes (read
    first when it accumulates); neither the 1000-row table whole."""
    table, idx, vals = torch.zeros(1000, 8), torch.tensor([1, 5, 7, 9]), torch.ones(4, 8)
    rows, index = 4 * 8 * 4, 4 * 8
    assert step_cost(lambda t, i: t.index_select(0, i), table, idx).op_bytes == index + 2 * rows
    assert step_cost(lambda t, i: t[i], table, idx).op_bytes == index + 2 * rows
    assert step_cost(lambda t, i, v: t.index_copy_(0, i, v), table, idx, vals).op_bytes == \
        index + 2 * rows
    assert step_cost(lambda t, i, v: t.index_add_(0, i, v), table, idx, vals).op_bytes == \
        index + 3 * rows
    assert step_cost(lambda t, i, v: t.index_put_((i,), v, accumulate=True),
                     table, idx, vals).op_bytes == index + 3 * rows


def test_kernel_meta_branches_charge_their_formulas():
    b, f, d = 64, 7, 16
    p = f * (f - 1) // 2
    before = (interaction_ops.pairwise_dots.launches,
              interaction_ops.pairwise_dots_backward.launches, run_hash_layer.launches)
    x = torch.zeros(b, f, d)
    fwd = step_cost(interaction_ops.pairwise_dots, x)
    assert fwd.flops == 2 * b * p * d and fwd.op_bytes == 4 * (b * f * d + b * p)

    def fwd_bwd(x):
        x = x.requires_grad_(True)
        return torch.autograd.grad(interaction_ops.pairwise_dots(x).sum(), x)

    both = step_cost(fwd_bwd, x)
    assert both.flops == 2 * b * p * d + 4 * b * p * d
    prog = (("cross", 0, 1, 1000), ("hash", 2, 0, 97))
    cols = torch.zeros(3, 512, dtype=torch.int32)
    h = step_cost(lambda c: run_hash_layer(c, prog), cols)
    assert h.flops == 0 and h.op_bytes == 4 * (3 + 2) * 512
    meta = run_hash_layer(cols.to("meta"), prog)
    assert meta.shape == (2, 512) and meta.dtype == torch.int32 and meta.device.type == "meta"
    after = (interaction_ops.pairwise_dots.launches,
             interaction_ops.pairwise_dots_backward.launches, run_hash_layer.launches)
    assert after == before                       # a meta call launches nothing


def test_hash_program_past_one_launch_charges_each_launch():
    """65 ops are two launches (64 + 1): the output holds 65 rows, and
    each launch reads the columns once and writes its own rows."""
    k, n = 3, 256
    prog = tuple(("mod", i % k, 0, 7 + i) for i in range(OPS_PER_LAUNCH + 1))
    cols = torch.zeros(k, n, dtype=torch.int32)
    before = run_hash_layer.launches
    out = run_hash_layer(cols.to("meta"), prog)
    assert (out.shape, out.dtype) == ((OPS_PER_LAUNCH + 1, n), torch.int32)
    tot = step_cost(lambda c: run_hash_layer(c, prog), cols)
    assert tot.flops == 0
    assert tot.op_bytes == 4 * (k + OPS_PER_LAUNCH) * n + 4 * (k + 1) * n
    assert run_hash_layer.launches == before


def test_charges_go_to_the_one_active_sink_only_while_counting():
    seen = []
    cost.charge("k", flops=1, nbytes=2)          # no sink: dropped
    with cost.counting(lambda *a: seen.append(a)):
        cost.charge("k", flops=3, nbytes=4)
        with pytest.raises(RuntimeError, match="already active"):
            with cost.counting(lambda *a: None):
                pass
        cost.charge("k", flops=5, nbytes=6)
        other = threading.Thread(target=cost.charge, args=("k",),
                                 kwargs={"flops": 7, "nbytes": 8})
        other.start()
        other.join()                             # another thread: no sink
    cost.charge("k", flops=9, nbytes=10)         # the block is over: dropped
    assert seen == [("k", 3.0, 4.0), ("k", 5.0, 6.0)]


def test_step_cost_reads_and_allocates_nothing():
    cfg = get_arch("dlrm-mlperf").smoke()
    params = R.init_params(cfg, torch.Generator().manual_seed(0))
    raw, init = R.make_sparse_train_step(cfg, adamw(1e-3))
    opt = init(params)
    batch = synthetic_batch("recsys", cfg, 32, 0, device=CPU)
    saved = {k: v.clone() for k, v in params.items()}
    tot = step_cost(raw, params, opt, batch)     # the step updates in place: on the copies
    assert tot.flops > 0 and tot.op_bytes > 0
    assert all(torch.equal(params[k], saved[k]) for k in params)
    assert opt["dense"]["step"] == 0
    meta = abstractify({"a": params["embed"], "n": 3})
    assert meta["a"].device.type == "meta" and meta["n"] == 3


# keys of JAX's Totals the port renames or leaves out, each with its reason
TOTALS_RENAMED = {"bytes": "op_bytes"}    # eager ops are unfused: not the card's HBM traffic
TOTALS_LEFT_OUT = {
    "artifact_bytes": "XLA's CPU promotion copies; eager torch runs none",
    "bytes_tpu_corrected": "bytes less those copies: a TPU figure with no torch source",
}


def test_totals_keys_are_jaxs_with_the_stated_renames():
    jax_keys = set(JaxTotals().as_metrics())
    want = {TOTALS_RENAMED.get(k, k) for k in jax_keys - set(TOTALS_LEFT_OUT)}
    assert set(Totals().as_metrics()) == want
    assert set(TOTALS_RENAMED) | set(TOTALS_LEFT_OUT) <= jax_keys


def test_dlrm_step_flops_equal_jaxs_by_the_stated_rule():
    """Every matrix product of the step is counted by both, except:

    * the interaction: JAX's ``einsum("bfd,bgd->bfg")`` computes all F*F
      pairs, 2*B*F*F*D FLOPs forward and two such dots backward; the
      port's kernels compute the F(F-1)/2 lower pairs, 2*B*P*D forward and
      4*B*P*D backward (their meta branches' formulas);
    * the top MLP's last layer (width 1): XLA's CPU compiler fuses its
      forward and its weight-gradient matrix-vector products into loop
      fusions, which the JAX analyzer does not look inside, and turns its
      input gradient (a contraction over 1) into a multiply, so JAX counts
      none of its three products, 2*B*W each (W its input width).
    """
    b = 64
    cfg = get_arch("dlrm-mlperf").smoke()
    params = R.init_params(cfg, torch.Generator().manual_seed(0))
    raw, init = R.make_sparse_train_step(cfg, adamw(1e-3))
    port = step_cost(raw, params, init(params), synthetic_batch("recsys", cfg, b, 0, device=CPU))

    jcfg = jax_get_arch("dlrm-mlperf").smoke()
    jp = JR.init_params(jcfg, jax.random.PRNGKey(0))
    jstep, jinit, _ = JR.make_sparse_train_step(jcfg, jax_adamw(1e-3))
    jt = jax_step_cost(jax.jit(jstep), jp, jinit(jp), jax_synthetic_batch("recsys", jcfg, b, 0))

    f, d = cfg.n_sparse + 1, cfg.embed_dim
    p = f * (f - 1) // 2
    last_w = cfg.top_mlp[-2]
    assert cfg.top_mlp[-1] == 1
    assert port.flops - 6 * b * p * d - 3 * 2 * b * last_w == jt.flops - 6 * b * f * f * d


@pytest.mark.parametrize("compress", ["off", "bf16", "int8"])
def test_mesh_step_collective_bytes_are_its_comm_plans(compress):
    """The 1x1 mesh step on a gloo group of one: every collective runs on
    meta tensors, and the output bytes of each kind are what the step's
    ``CommPlan`` element counts give. Per step: the dedup pool (one
    all-gather of the local uniques, int32); the working-set exchange
    (fp32, never compressed); the working-set and dense gradients, each a
    reduce-scatter, then an all-reduce (off) or an all-gather of the wire
    (bf16: 2 bytes, int8: 1 byte plus a 4-byte scale) across pods, then an
    all-gather inside the pod (fp32)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.compression import CommPlan

    cfg = get_arch("dlrm-mlperf").smoke()
    rows = 32
    owned = not dist.is_initialized()
    try:
        mesh = make_train_mesh(1, 1, device=CPU)
        raw, init = R.make_mesh_train_step(cfg, adamw(1e-3), mesh=mesh, compress=compress)
        params = {k: torch.empty(s, device="meta") for k, s in R.param_shapes(cfg).items()}
        batch = synthetic_batch("recsys", cfg, rows, 0, device=CPU)
        tot = step_cost(raw, params, init(params), batch)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    n_ids = R.batch_id_count(cfg, rows)
    cap = cfg.dedup_capacity or n_ids
    plan = CommPlan.for_step(n_pods=1, inner=1, compress=compress, hierarchical=True,
                             capacity=cap, embed_dim=cfg.embed_dim,
                             n_dense_elems=R.dense_param_elems(cfg),
                             local_capacity=min(cap, n_ids), ids_per_device=n_ids)
    ex, ar = plan.exchange_elems, plan.allreduce_elems
    want = {"reduce-scatter": 4 * (ex + ar), "all-reduce": 4 * ex,
            "all-gather": 4 * plan.dedup_pool_elems + 4 * ex + 4 * ar}
    if plan.codec is None:
        want["all-reduce"] += 4 * ar
    else:   # two reductions (working set, dense): two wires, and int8's scales
        want["all-gather"] += plan.wire_itemsize * ar + (2 * 4 if plan.codec == "int8" else 0)
    assert tot.collective == want
    assert tot.collective_total == sum(want.values())


def test_no_collective_in_the_sparse_step():
    cfg = get_arch("bst").smoke()
    params = R.init_params(cfg, torch.Generator().manual_seed(0))
    raw, init = R.make_sparse_train_step(cfg, adamw(1e-3))
    t = step_cost(raw, params, init(params), synthetic_batch("recsys", cfg, 16, 0, device=CPU))
    assert t.collective == {} and t.flops > 0 and np.isfinite(t.op_bytes)


def test_driver_mesh_2x2_metrics_hold_the_comm_plan(tmp_path):
    """``--mesh 2x2 --compress bf16 --check --metrics`` over 4 spawned gloo
    ranks: the preflight runs once in the parent, and rank 0's
    ``hlo.collective_total`` is the per-rank collective bytes of the step
    that the ``CommPlan`` element counts give (each reduction's vector
    padded to a multiple of the pod size, reduce-scattered, the bf16 wire
    or the fp32 exchange across the 2 pods, gathered back; the dedup pool
    over the 4 ranks; the loss and the stage-1 count summed)."""
    import dataclasses
    import json
    import os
    import subprocess
    import sys

    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.modelfeed import dedup_capacity_hint

    rows, inner = 64, 2
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "dlrm-mlperf",
         "--data-dir", str(tmp_path / "d"), "--gen-shards", "4", "--batch", str(rows),
         "--spec", "dlrm", "--device-feed", "off", "--mesh", "2x2", "--compress", "bf16",
         "--steps", "2", "--device", "cpu", "--check", "--metrics"],
        # one intra-op thread a rank: four ranks of 8 threads each would
        # crowd the other test workers' timed tests
        env=dict(os.environ, PYTHONPATH=os.path.join(repo, "src"), OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("repro_torch.check: 4 analyzers, 0 errors") == 1
    reg = json.loads(out.stdout.partition("metrics:\n")[2])
    smoke = dataclasses.replace(get_arch("dlrm-mlperf").smoke(), dedup_capacity=0)
    cfg = featureplan.compile(get_spec("dlrm")).model_feed(smoke, rows_hint=rows).config
    cap, d = cfg.dedup_capacity, cfg.embed_dim
    local_cap = dedup_capacity_hint(cfg, rows // 4)

    def npad(n):
        return -(-n // inner) * inner

    ex, ws, dense = cap * d + cap, cap * d, R.dense_param_elems(cfg)
    want = 4 * 4 * local_cap                                   # the dedup pool
    want += 4 * (npad(ex) // inner) * 2 + 4 * npad(ex)        # the exchange, fp32
    for n in (ws, dense):                                      # the gradients, bf16 wire
        want += 4 * npad(n) // inner + 2 * npad(n) + 4 * npad(n)
    want += 4 + 4                                              # loss, stage-1 count
    assert reg["hlo.collective_total"] == want
    assert reg["check.exit_code"] == 0 and reg["hlo.flops"] > 0
