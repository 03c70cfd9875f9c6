"""The dry run per device (``launch/dryrun.per_device_figures``) on the CPU.

One device's figures come from the cell's ``per_device`` call run once on
meta tensors as rank 0 of torch's fake process group of the mesh's size
(``launch/mesh.fake_mesh``). Held here, on a 2x2 ``('data', 'model')`` mesh:

* **A real rank.** The yi case's ``lm_cell`` train step (``grad_accum`` 2,
  4 x 24 tokens) and PNA's node-sharded AdamW step on the smoke graph of
  ``tests/model_parallel_ranks.py``, in 4 spawned gloo ranks under
  ``step_cost``/``PeakMode``: rank 0's FLOPs, op bytes, peak (bytes and live
  counts) and collective bytes by kind equal the fake group's, with the
  backward's reduce-scatter in the card's form in both. Gloo's own form (an
  all-reduce of the whole, then the rank's slice) is accounted for by hand:
  its all-reduce bytes are the card form's plus the group size times the
  reduce-scatter's, and it has no reduce-scatter.
* **JAX** (``tests/jax_model_parallel.py --collectives``, one subprocess:
  the same two steps with their cells' shardings, compiled on 4 host
  devices, ``analyze_hlo``'s collective bytes). PNA's layer body is a
  ``shard_map`` whose halo all-gather is explicit, and so is its transpose,
  the backward's reduce-scatter: the reduce-scatter bytes are equal. The
  all-gather is the explicit body's too, but XLA merges the checkpoint's
  recomputed gather with the forward's (the lowered StableHLO has 4 for
  the 2 layers, the compiled HLO 2), where the eager checkpoint gathers
  again: the port's bytes are 2.0x the compiled. The all-reduce (the replicated params' gradients
  and the loss, which GSPMD sums) is implicit: 1.0x. The dense LM has no
  ``shard_map`` at all: every collective of JAX's is GSPMD's, from its
  sharding constraints, and the ratios (``LM_JAX_RATIO``) are pinned as
  read: JAX lays the residual stream's ``d`` over ``model`` (a layout with
  no eager form), so it also gathers and sums activations (the port's
  all-gather bytes are 0.751x JAX's, its all-reduce 0.305x); XLA reduces
  the FSDP gradients with all-reduces where the port reduce-scatters (JAX
  has no reduce-scatter); and it moves the vocab-parallel lookup with an
  all-to-all and a collective-permute that the port's masked take and psum
  do not need.
* **By hand.** One smoke layer's FSDP all-gather bytes (forward and the
  checkpoint's recompute) and its backward reduce-scatter, from
  ``param_specs``.
* **The decode cache.** The rank's cache is the block ``cache_specs``
  gives it (MLA's latent and GQA's head_dim over ``model``): its bytes are
  the specs', so ``per_device_args_differ`` holds only the global token
  batch, and the decode's all-reduce bytes are its psums' by hand (the
  partial scores, the attention's and the FFN's outputs, the embedding).
  Every LM arch's block on both production meshes, on meta, has the shape
  ``shard_tensor`` cuts under ``cache_specs``.
* **Uneven rows.** A microbatch of 1 row over 2 data ranks (the
  ``moe16b-uneven`` case): the fake group's figures equal a real rank's,
  all-to-all bytes included; the two 2x16x16 ``train_4k`` cells of 16 rows
  a microbatch over 32 data ranks build their rank-0 call.
* The global cells' records (``per_device: null`` with the reason), the
  fake group's collectives (output bytes, the list forms, the output
  buffers as allocations), and its subgroups made in a cost that grows with
  the world, not its square.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import model_parallel_ranks as MR  # noqa: E402
from repro_torch.configs import base as B  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.sharding import Mesh, entry_axes  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch.hlo_stats import PeakMode, step_cost  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWO = {"data": 2, "model": 2}
B_GLOBAL_BATCH = "the batch is the global one: the mesh form cuts each rank's rows itself"
GROUP = {"lm": 2, "lm-uneven": 2, "pna": 4}  # the reduce-scatter's group: 'data', both axes
KINDS = {"lm": {"all-gather", "all-reduce", "reduce-scatter"},
         "lm-uneven": {"all-gather", "all-reduce", "reduce-scatter", "all-to-all"},
         "pna": {"all-gather", "all-reduce", "reduce-scatter"}}
# the port's per-device collective bytes over JAX's compiled ones, by kind
PNA_JAX_RATIO = {"all-gather": 2.0, "reduce-scatter": 1.0, "all-reduce": 1.0}
LM_JAX_RATIO = {"all-gather": 589824 / 785248, "all-reduce": 219924 / 721620,
                "all-to-all": 0.0, "collective-permute": 0.0}


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """JAX's compiled collectives (a subprocess, started first) and the gloo
    ranks' counts (spawned meanwhile)."""
    out = str(tmp_path_factory.mktemp("jax_coll") / "coll.json")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen([sys.executable, os.path.join(REPO, "tests",
                                                              "jax_model_parallel.py"),
                                 "--collectives", out], env=env, stderr=subprocess.PIPE,
                                text=True)
    try:
        ranks = MR.run({}, case="cost")
    finally:
        _, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err[-3000:]
    with open(out) as f:
        return json.load(f), ranks[0]


@pytest.fixture(scope="module")
def fake():
    """The dry run's pass of each call: fake group, meta tensors."""
    with M.fake_mesh(TWO) as mesh:
        return {name: D.call_figures(fn, args) for name, (fn, args)
                in MR.cost_calls(mesh).items()}


def _collective(rank, tag):
    pre = f"{tag}/collective/"
    return {k[len(pre):]: float(v) for k, v in rank.items() if k.startswith(pre)}


@pytest.mark.parametrize("name", ["lm", "lm-uneven", "pna"])
def test_per_device_equals_a_real_ranks(sides, fake, name):
    """``lm-uneven`` (rows that do not split over 'data'): its all-to-all
    bytes are the port's own layout change (the MoE's token block), which
    GSPMD makes implicitly in JAX, so they are held to the real ranks
    only."""
    _, rank = sides
    fig, tag = fake[name], f"cost/{name}/card"
    assert float(rank[f"{tag}/flops"]) == fig["step_flops"] > 0
    assert float(rank[f"{tag}/op_bytes"]) == fig["step_op_bytes"] > 0
    assert rank[f"{tag}/peak"].tolist() == [fig["step_peak_bytes"], fig["step_peak_live"],
                                            fig["step_max_live"], fig["step_max_live_large"]]
    card = _collective(rank, tag)
    assert card == fig["totals"].collective
    assert set(card) == KINDS[name]
    # gloo's form of the same reduce-scatters, by hand
    gloo = _collective(rank, f"cost/{name}/gloo")
    assert "reduce-scatter" not in gloo and gloo["all-gather"] == card["all-gather"]
    assert gloo["all-reduce"] == card["all-reduce"] + GROUP[name] * card["reduce-scatter"]
    assert float(rank[f"cost/{name}/gloo/flops"]) == fig["step_flops"]


@pytest.mark.parametrize("name", ["lm", "pna"])
def test_per_device_collectives_against_jax(sides, fake, name):
    jax_side, _ = sides
    port, want = fake[name]["totals"].collective, jax_side[name]
    ratios = PNA_JAX_RATIO if name == "pna" else LM_JAX_RATIO
    assert set(port) | set(want) == set(ratios) | ({"reduce-scatter"} if name == "lm" else set())
    for kind, ratio in ratios.items():
        assert port.get(kind, 0.0) == pytest.approx(ratio * want[kind], rel=1e-9), kind
    if name == "pna":
        assert port["reduce-scatter"] == want["reduce-scatter"]      # explicit: equal
    else:
        assert "reduce-scatter" not in want and port["reduce-scatter"] > 0


def _small_lm_cell(monkeypatch, cfg, kind, batch, seq, mesh=TWO):
    shape = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    monkeypatch.setitem(B.LM_SHAPES, shape, {"kind": kind, "seq": seq, "batch": batch})
    return B.lm_cell(cfg, shape, Mesh(mesh))


def test_fsdp_gather_bytes_of_one_layer_by_hand(monkeypatch):
    """One dense layer of the yi smoke (4 heads over 2 KV: no TP gather),
    one microbatch: each leaf split over 'data' is all-gathered whole over
    'data' (its 'model' shard) in the forward and again in the checkpoint's
    recompute, and its gradient reduce-scattered back once."""
    cfg = dataclasses.replace(get_arch("yi-9b").smoke(), n_layers=1, grad_accum=1)
    cell = _small_lm_cell(monkeypatch, cfg, "train", 4, 24)
    rec = D.per_device_figures(cell, TWO)
    shapes, specs = T.param_shapes(cfg)["dense_layers"], T.param_specs(cfg)["dense_layers"]
    gathered = 0
    for k, shape in shapes.items():
        spec = tuple(specs[k])[1:]
        axes = [a for e in spec for a in entry_axes(e)]
        if "data" in axes:
            gathered += math.prod(shape[1:]) // (2 if "model" in axes else 1) * 4
    assert gathered > 0
    coll = rec["collective_bytes_per_device"]
    assert coll["all-gather"] == 2 * gathered
    assert coll["reduce-scatter"] == gathered // 2
    assert rec["collective_total_bytes"] == sum(coll.values())


@pytest.mark.parametrize("case", ["mla", "gqa", "gqa-h3"])
def test_decode_cache_factor_follows_the_roadmap(monkeypatch, case):
    """The rank's decode cache (``make_cache(mesh=)``) against the cell's
    ``cache_specs`` at tp = 2: equal bytes, factor 1, for MLA (the latent
    split, the rope key whole), GQA with one KV head (``n_kv < |tp|``, the
    heads split) and GQA with 3 heads (which do not split). Only the token
    batch differs: the global one (the mesh form cuts its rows). The
    all-reduce bytes are the decode's psums, by hand for GQA: each layer's
    partial scores (B/2, H, S) and its attention and FFN outputs (B/2, 1,
    d), and the embedding's lookup, in fp32."""
    batch, seq, tp = 8, 32, 2
    if case == "mla":
        cfg = get_arch("deepseek-v2-236b").smoke()
        lat, rope = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_dim
        spec_row = lat // tp + rope                                 # one slot, one layer
    else:
        kw = {"n_kv": 1} if case == "gqa" else {"n_heads": 3, "n_kv": 1}
        cfg = dataclasses.replace(get_arch("yi-9b").smoke(), **kw)
        assert T.head_split(cfg, 0, tp).split == (case == "gqa") and cfg.n_kv < tp
        spec_row = 2 * cfg.n_kv * cfg.head_dim // tp                # k and v, head_dim split
    cell = _small_lm_cell(monkeypatch, cfg, "decode", batch, seq)
    rec = D.per_device_figures(cell, TWO)
    rows = batch // 2
    cache = cfg.n_layers * rows * seq * 4 * spec_row                 # layers x rows x slots x fp32
    block = T.make_cache(cfg, batch, seq, abstract=True, mesh=M.RankView(TWO, (0, 0)))
    assert D.arg_bytes((block,)) == cache == D.state_bytes_exact(dataclasses.replace(
        cell, args=(cell.args[2],), in_shardings=(cell.in_shardings[2],)))
    assert rec["per_device_args_differ"] == {1: [batch * 4, rows * 4]}
    state = D.state_bytes_exact(cell)
    assert rec["per_device_arg_bytes"] == state + rows * 4
    assert rec["per_device_arg_factor"] == rec["per_device_arg_bytes"] / state
    assert rec["per_device_note"] == B_GLOBAL_BATCH
    scores = cfg.n_layers * rows * (cfg.mla.n_heads if cfg.mla else cfg.n_heads) * seq * 4
    reduced = rec["collective_bytes_per_device"]["all-reduce"]
    if case == "mla":
        assert reduced > scores
    else:
        assert reduced == scores + (2 * cfg.n_layers + 1) * rows * cfg.d_model * 4


# decode_32k's rank cache (GiB) on 16x16 and 2x16x16: the specs' bytes
DECODE_CACHE_GIB = {"qwen2.5-32b": 4.0, "qwen2.5-14b": 3.0, "deepseek-v2-236b": 2.8125,
                    "yi-9b": 1.5, "deepseek-moe-16b": 3.5}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", sorted(DECODE_CACHE_GIB))
def test_rank_cache_is_the_cache_specs_block(arch, multi_pod):
    """``make_cache(abstract=True, mesh=RankView(...))`` of every LM arch's
    ``decode_32k`` on both production meshes, on meta: at ranks spread
    over the mesh, the block's shape is the one ``shard_tensor`` cuts from
    the global cache under ``cache_specs`` (rows over the data axes,
    head_dim or latent over ``model``), and rank 0's bytes are the specs'
    (half on two pods)."""
    from repro_torch.configs.base import LM_SHAPES, dp_axes_for

    cfg = get_arch(arch).config
    mesh = M.make_production_mesh(multi_pod=multi_pod)
    dp = dp_axes_for(mesh)
    info = LM_SHAPES["decode_32k"]
    full = T.make_cache(cfg, info["batch"], info["seq"], abstract=True)
    specs = T.cache_specs(cfg, dp=dp)
    dims = tuple(mesh.shape.values())
    for coord in ([0] * len(dims), [n - 1 for n in dims], [n // 3 for n in dims]):
        view = M.RankView(mesh.shape, coord)
        block = T.make_cache(cfg, info["batch"], info["seq"], abstract=True, mesh=view, dp=dp)
        assert sorted(block) == sorted(full)
        for k, v in full.items():
            assert block[k].shape == M.shard_tensor(v, specs[k], view).shape, (k, coord)
            assert block[k].device.type == "meta" and block[k].dtype == cfg.dtype
        if not any(coord):
            gib = sum(v.numel() * v.element_size() for v in block.values()) / 2**30
            assert gib == DECODE_CACHE_GIB[arch] / (2 if multi_pod else 1)


@pytest.mark.parametrize("arch,shape", [("dlrm-mlperf", "serve_p99"), ("pna", "molecule")])
def test_global_cells_have_no_per_device_call(monkeypatch, arch, shape):
    monkeypatch.setattr(D, "make_production_mesh",
                        lambda multi_pod=False: Mesh({"data": 2, "model": 4}))
    rec = D.run_cell(arch, shape, verbose=False)
    assert rec["status"] == "ok" and rec["per_device"] is None
    assert "GSPMD" in rec["per_device_reason"] and "no partitioner" in rec["per_device_reason"]
    assert "step_flops_per_device" not in rec and "collective_total_bytes" not in rec


def test_node_sharded_cell_is_the_mesh_form():
    """``pna x ogb_products`` on 2x2: its per-device call gathers every
    layer's ``h`` over both axes, forward and recompute (4 layers of 75
    fp32 columns over all padded nodes), not the global program's none."""
    cell = get_arch("pna").build_cell("ogb_products", Mesh(TWO))
    rec = D.per_device_figures(cell, TWO)
    n = cell.args[2]["features"].shape[0]
    assert rec["collective_bytes_per_device"]["all-gather"] == 2 * 4 * n * 75 * 4
    assert rec["step_flops_per_device"] < D.step_figures(cell)["step_flops"] / 3
    # the index backward of the halo rows (h_full[src]): under the tracker a
    # new (nodes, 75) output beside its zeros, in place without a mode
    assert rec["step_functional_per_device"] == n * 75 * 4
    assert rec["per_device"] == {"rank": 0, "group": "fake", "world": 4,
                                 "cost_s": rec["per_device"]["cost_s"]}


def test_uneven_cell_records_why(monkeypatch):
    """A batch the mesh form cannot split leaves the global figures and says
    why there are no per-device ones: an MoE decode of 3 tokens over 2 data
    ranks (JAX's ``shard_map`` refuses it too). 3 rows of a dense prefill
    split (2 and 1 padded): rank 0's figures. Its token argument is the
    global batch, and so is the sharding's count of it (3 rows do not split:
    the leaf counts whole, C29), so no argument differs."""
    cell = _small_lm_cell(monkeypatch, get_arch("deepseek-moe-16b").smoke(), "decode", 3, 16)
    rec = D.per_device_figures(cell, TWO)
    assert rec["per_device"] is None and "not evenly divisible" in rec["per_device_reason"]
    cell = _small_lm_cell(monkeypatch, get_arch("yi-9b").smoke(), "prefill", 3, 16)
    rec = D.per_device_figures(cell, TWO)
    assert rec["per_device"]["rank"] == 0
    assert "per_device_args_differ" not in rec and rec["step_flops_per_device"] > 0


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "deepseek-v2-236b"])
def test_multi_pod_train_4k_builds_its_rank_call(arch):
    """The two ``train_4k`` cells whose 16 microbatches of 16 rows meet 32
    data ranks on 2x16x16 build a rank-0 call (their meta pass runs in
    ``chip_smoke.py`` phase 20(e), not here): rank 0 takes 1 row of each
    microbatch, and v2's MoE block on rank 0 is 2,048 tokens of that row
    (16 x 4,096 tokens over 32 data ranks)."""
    mesh = M.make_production_mesh(multi_pod=True)
    cell = get_arch(arch).build_cell("train_4k", mesh)
    cfg, dp = cell.config, B.dp_axes_for(mesh)
    info = B.LM_SHAPES["train_4k"]
    with M.fake_mesh(mesh.shape) as dmesh:
        fn, args = cell.per_device(dmesh)
        assert callable(fn) and args[2]["tokens"].shape == (info["batch"], info["seq"])
        rows = T._dp_rows(info["batch"], dmesh, dp, cfg.grad_accum)
        assert cfg.grad_accum == 16 and M.axis_size(dmesh, dp) == 32
        assert [r.stop - r.start for r in rows] == [1] * 16
        if cfg.moe:
            mp = T._mesh_ctx(cfg, dmesh, dp, "model", info["batch"] // cfg.grad_accum)
            send, recv = T._token_splits(mp, 1, info["seq"])
            assert sum(recv) == 2048 and send[0] == 2048 and sum(send) == info["seq"]


def test_fake_group_counts_output_bytes_and_buffers():
    """Under the fake group on meta: the list-form all-gather (a list of
    lists as ``args[0]``) counts its gathered bytes, ``all_reduce`` (a list)
    its tensor's, the reduce-scatter its output's; ``PeakMode`` sees the
    gather's output buffers and the concatenation as the allocations they
    are, and the backward of ``all_gather`` is a reduce-scatter, never gloo's
    all-reduce."""
    x = torch.empty(8, 16)                    # 512 B
    with M.fake_mesh({"data": 4}) as mesh:
        group = mesh.get_group("data")

        def fn(x):
            y = M._gather(x, group, 0)        # 4 parts of 512 B, then their cat
            s = M._sum(x, group)
            return y, s, M._scatter_sum(y, group, 0)

        peak = PeakMode("meta")
        t = step_cost(fn, x, peak=peak)
        assert t.collective == {"all-gather": 2048.0, "all-reduce": 512.0,
                                "reduce-scatter": 512.0}
        assert peak.peak_bytes >= 512 + 4 * 512 + 2048

        def grad(x):
            x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                M.all_gather(x, mesh, "data").sum().backward()
            return x.grad

        t = step_cost(grad, x)
        assert t.collective == {"all-gather": 2048.0, "reduce-scatter": 512.0}


def test_fake_subgroups_grow_with_the_world(monkeypatch):
    """``_group`` over a tuple of axes of the 2x16x16 mesh makes one group a
    coordinate of the other axes: the ranks it lists add up to the world
    (512), never its square."""
    made = []
    real = M.dist.new_group
    monkeypatch.setattr(M.dist, "new_group", lambda ranks, *a, **k: made.append(len(ranks))
                        or real(ranks, *a, **k))
    shape = {"pod": 2, "data": 16, "model": 16}
    with M.fake_mesh(shape) as mesh:
        world = M.dist.group.WORLD
        for axes, n in ((("pod", "data"), 32), (("data", "model"), 256),
                        (("pod", "data", "model"), 512)):
            made.clear()
            g = M._group(mesh, axes)
            assert M.dist.get_world_size(g) == n and M.dist.get_rank(g) == 0
            assert sum(made) == math.prod(shape.values()) and set(made) == {n}
    assert not M.dist.is_initialized()
    assert not any(k[2] is world for k in M._GROUPS)        # dropped with the group


def test_fake_mesh_refuses_a_process_with_a_group():
    with M.fake_mesh(TWO):
        with pytest.raises(RuntimeError, match="no default process group"):
            with M.fake_mesh(TWO):
                pass
    assert not M.dist.is_initialized()
