"""The port's model-parallel forms against the JAX package's, on the CPU.

JAX's references come from one subprocess on a 2x2 mesh of host devices
(``tests/jax_model_parallel.py``, ``XLA_FLAGS=--xla_force_host_platform_device_count=4``);
the port's from one spawn of 4 gloo ranks (``tests/model_parallel_ranks.py``,
JAX-free) on a ``('data', 'model')`` mesh of 2x2, from JAX's init params
and the same numpy inputs. Tolerances, each read first on this pairing
(fp32 throughout; the sums over ranks and the GEMMs run in other orders):

* ``moe_ffn(mesh=)`` (tests/test_sharding.py's MoE: 8 experts top 2, one
  shared, 64 tokens) at the published capacity factor and at the no-drop
  one, with and without ``shard_ff_over_data``: the output, the gradients
  of ``sum(out * R) + 0.37 aux`` (params and tokens) and of the aux alone
  within 2e-6 of their largest |value| (read: 4.1e-7); the aux to rtol
  1e-6 (read: equal). The aux is data shard 0's, its gradient the mean's
  (ROADMAP C31); the output is each data shard's MoE (C30): bit for bit
  without shared experts, within 1e-6 of the largest |value| with them
  (their TP halves add in another order; read 1.0e-7).
* ``partition_edges`` bit for bit; the node-sharded PNA step (loss to rtol
  1e-5, gradients within 1e-4 of the largest |g|: read 1.8e-5, the std
  aggregator's cancellation, C28) and ``forward_sharded`` (5e-5 of the
  largest |logit|, read 8.4e-6); with ``halo_bf16`` the gradients within
  1e-2 (read 2.9e-3: the cotangent crosses the wire in bf16, whose
  precision is 2**-8 = 3.9e-3, and is summed in another order on each side).
* The LM step on the mesh (yi with ``grad_accum`` 2, deepseek-moe-16b,
  deepseek-v2-236b's MLA with ``shard_ff_over_data``, yi with one KV head,
  with 3 heads that do not split, and pure ZeRO-DP, ``tp=None``): the loss
  to rtol 1e-6, every
  gradient within 5e-6 of its largest |g| (read 7.2e-7), the global
  gradient norm the optimizer gets to rtol 1e-5; ``prefill`` and three
  ``serve_step`` decodes (all but pure ZeRO-DP) within 2e-6 of the largest
  |logit| (read 4.9e-7), each rank's cache the block ``cache_specs`` cuts
  from JAX's (1e-6): its rows and its slice of the head_dim or latent.
* Every rank gathers the same arrays, bit for bit; the rank bodies run in
  turn in one process equal the gloo ranks bit for bit (two ranks a sum),
  the decode's attention bodies and the cache blocks they write included.
  On a mesh of one (gloo, in this process) the decode is the plain one
  bit for bit.
"""

import itertools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import gnn as JG  # noqa: E402

import model_parallel_ranks as MR  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.sharding import Mesh, NamedSharding  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import gnn as G  # noqa: E402
from repro_torch.models import moe as MO  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train.optimizer import flatten, unflatten  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_TOL, MOE_SHARD_TOL = 2e-6, 1e-6
PNA_LOSS_RTOL, PNA_LOGIT_TOL, PNA_GRAD_TOL, PNA_HALO_GRAD_TOL = 1e-5, 5e-5, 1e-4, 1e-2
LM_GRAD_TOL, LM_LOGIT_TOL = 5e-6, 2e-6


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_mp") / "ref.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(REPO, "tests", "jax_model_parallel.py"),
                          path], env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ranks(jax_ref):
    inputs = {k: v for k, v in jax_ref.items() if "/param/" in k or k.startswith("pna/batch/")}
    return MR.run(inputs)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------------ MoE
@pytest.mark.parametrize("name", sorted(MR.MOE_VARIANTS))
def test_moe_mesh_matches_jax(jax_ref, ranks, name):
    got = ranks[0]
    for obj in ("full", "aux"):
        tag = f"moe/{name}/{obj}"
        np.testing.assert_allclose(got[f"{tag}/aux"], jax_ref[f"{tag}/aux"], rtol=1e-6)
        keys = [f"{tag}/out", f"{tag}/gx"] + [k for k in got if k.startswith(f"{tag}/grad/")]
        for k in keys:
            want = jax_ref[k]
            if np.abs(want).max() == 0:
                assert np.abs(got[k]).max() == 0, k
            else:
                assert _rel(got[k], want) <= MOE_TOL, (k, _rel(got[k], want))


@pytest.mark.parametrize("name", sorted(MR.MOE_VARIANTS))
def test_moe_aux_has_shard0s_value_and_the_means_gradient(jax_ref, ranks, name):
    """ROADMAP C31: the value is data shard 0's aux (not the local one over
    all tokens, nor shard 1's), the router's gradient that of the mean of
    the shards' auxes (not shard 0's alone)."""
    got = ranks[0]
    shard = got[f"moe/{name}/shard_aux"]
    assert got[f"moe/{name}/full/aux"] == shard[0] != shard[1]
    g = got[f"moe/{name}/aux/grad/router"]
    assert _rel(g, jax_ref[f"moe/{name}/auxmean_router_grad"]) <= MOE_TOL
    assert _rel(g, jax_ref[f"moe/{name}/aux0_router_grad"]) > 1e-2


@pytest.mark.parametrize("name", sorted(MR.MOE_VARIANTS))
def test_moe_mesh_is_each_data_shards_moe(jax_ref, ranks, name):
    """ROADMAP C30: the capacity follows the shard's tokens, so the sharded
    MoE computes ``moe_ffn`` on each data shard; at the published factor
    that is not the MoE of all 64 tokens (pairs drop), at no-drop it is."""
    got = ranks[0]
    mesh_out, shard_out = got[f"moe/{name}/full/out"], got[f"moe/{name}/shard_out"]
    if MR.MOE_VARIANTS[name].get("n_shared"):
        assert np.abs(mesh_out - shard_out).max() <= MOE_SHARD_TOL * np.abs(shard_out).max()
    else:
        np.testing.assert_array_equal(mesh_out, shard_out)
    dev = _rel(mesh_out, jax_ref[f"moe/{name}/local_out"])
    assert (dev <= MOE_TOL) if name.startswith("nodrop") else (dev > 1e-2), dev


def test_moe_refuses_experts_that_do_not_split(ranks):
    assert str(ranks[0]["moe/divisibility"]) == "7 experts not divisible by tp=2"


# ------------------------------------------------------------------ PNA
@pytest.mark.parametrize("n_nodes,n_edges,n_shards,dtype", [
    (64, 256, 4, np.int64), (61, 100, 4, np.int32), (1000, 5000, 8, np.int32),
    (10, 3, 4, np.int64)])
def test_partition_edges_is_jaxs_bit_for_bit(n_nodes, n_edges, n_shards, dtype):
    r = np.random.default_rng(n_nodes)
    src = r.integers(0, n_nodes, n_edges).astype(dtype)
    dst = r.integers(0, n_nodes, n_edges).astype(dtype)
    want = JG.partition_edges(src, dst, n_nodes, n_shards)
    got = G.partition_edges(src, dst, n_nodes, n_shards)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(MR.PNA_VARIANTS))
def test_pna_node_sharded_step_matches_jax(jax_ref, ranks, name):
    got = ranks[0]
    np.testing.assert_allclose(got[f"pna/{name}/loss"], jax_ref[f"pna/{name}/loss"],
                               rtol=PNA_LOSS_RTOL)
    assert _rel(got[f"pna/{name}/logits"], jax_ref[f"pna/{name}/logits"]) <= PNA_LOGIT_TOL
    tol = PNA_HALO_GRAD_TOL if name == "halo_bf16" else PNA_GRAD_TOL
    for k in (k for k in got if k.startswith(f"pna/{name}/grad/")):
        assert _rel(got[k], jax_ref[k]) <= tol, (k, _rel(got[k], jax_ref[k]))


@pytest.mark.parametrize("name", ["plain", "mask"])
def test_pna_node_sharded_gradients_match_the_local_step(jax_ref, ranks, name):
    """The halo all-gather's reduce-scatter counts each node's cotangent
    once: the sharded gradients are the local program's (within C28's 2e-4)."""
    got = ranks[0]
    np.testing.assert_allclose(got[f"pna/{name}/loss"], jax_ref[f"pna/{name}/local_loss"],
                               rtol=PNA_LOSS_RTOL)
    for k in (k for k in got if k.startswith(f"pna/{name}/grad/")):
        want = jax_ref[k.replace("/grad/", "/local_grad/")]
        assert _rel(got[k], want) <= 2e-4, k


def test_pna_body_drops_padding_edges_into_the_spare_row():
    """ROADMAP C32: ``index_add_`` raises for an id past the rows (JAX's
    ``segment_sum`` drops it); the body's spare row takes the padding
    edges, and its layer equals the layer of the real edges alone."""
    with pytest.raises((IndexError, RuntimeError)):
        G.segment_sum(torch.ones(3, 2), torch.tensor([0, 1, 4]), 4)
    c = G.PNAConfig(**MR.PNA)
    params = G.init_params(c, torch.Generator().manual_seed(0))
    r = np.random.default_rng(1)
    n, e = 16, 40
    h = torch.from_numpy(r.normal(size=(n, c.d_hidden)).astype(np.float32))
    src = torch.from_numpy(r.integers(0, n, e))
    dst = torch.from_numpy(r.integers(0, n, e))
    pad_src = torch.cat([src, torch.zeros(7, dtype=torch.int64)])
    pad_dst = torch.cat([dst, torch.full((7,), n)])
    lp = G.layer_params(params, 0)
    want = G._pna_layer_local(lp, h, h, src, dst, c, n)
    got = G._pna_layer_local(lp, h, h, pad_src, G.local_dst(pad_dst, 0, n), c, n)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(want, G.pna_layer({f"l0_{k}": v for k, v in lp.items()}, 0, h,
                                                 src, dst, c, n), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ LM
@pytest.mark.parametrize("name", list(MR.LM_CASES))
def test_lm_mesh_step_matches_jax(jax_ref, ranks, name):
    got = ranks[0]
    assert bool(got[f"lm/{name}/roundtrip"])
    np.testing.assert_allclose(got[f"lm/{name}/loss"], jax_ref[f"lm/{name}/loss"], rtol=1e-6)
    keys = [k for k in jax_ref if k.startswith(f"lm/{name}/grad/")]
    assert sorted(keys) == sorted(k for k in got if k.startswith(f"lm/{name}/grad/"))
    for k in keys:
        assert _rel(got[k], jax_ref[k]) <= LM_GRAD_TOL, (k, _rel(got[k], jax_ref[k]))
    sq = sum(float((jax_ref[k].astype(np.float64) ** 2).sum()) for k in keys)
    np.testing.assert_allclose(float(got[f"lm/{name}/sq_norm"]), sq, rtol=1e-5)


def _cache_block(cfg, name, want, rank):
    """Rank ``rank``'s block of JAX's global cache under ``cache_specs``:
    its rows and its slice of the head_dim (GQA) or the latent (MLA)."""
    view = M.RankView(dict(zip(("data", "model"), MR.SHAPE)), divmod(rank, MR.SHAPE[1]))
    return M.shard_tensor(torch.from_numpy(want), T.cache_specs(cfg)[name], view).numpy()


@pytest.mark.parametrize("name", MR.LM_SERVED)
def test_lm_mesh_prefill_and_decode_match_jax(jax_ref, ranks, name):
    cfg = MR.lm_config(get_arch, name)
    for r, got in enumerate(ranks):
        assert _rel(got[f"lm/{name}/prefill"], jax_ref[f"lm/{name}/prefill"]) <= LM_LOGIT_TOL
        for t in range(MR.LM_DECODE):
            k = f"lm/{name}/decode/{t}"
            assert _rel(got[k], jax_ref[k]) <= LM_LOGIT_TOL, k
        for k in ("ckv", "krope") if cfg.attn == "mla" else ("k", "v"):
            want = _cache_block(cfg, k, jax_ref[f"lm/{name}/cache/{k}"], r)
            np.testing.assert_allclose(got[f"lm/{name}/cache/{k}"], want, rtol=1e-6, atol=1e-6)


def test_every_rank_gathers_the_same_arrays(ranks):
    for k, v in ranks[0].items():
        if "/cache/" in k:
            continue
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[k], v, err_msg=k)


# ------------------------------------------------------------ in turn
@pytest.mark.parametrize("part", ["moe", "pna", "lm_layer", "lm_decode"])
def test_rank_bodies_in_turn_equal_the_gloo_ranks(jax_ref, ranks, part):
    """The bodies of the 2x2 mesh run one after another in this process,
    the gathers as concatenations and the psums as sums in rank order. The
    decode: one dense layer of each served case, its attention bodies'
    collectives in turn (``run_in_turn``), against every rank's output
    rows and the ``cache_specs`` block it wrote."""
    got = ranks[0]
    if part == "moe":
        x = torch.from_numpy(MR.moe_inputs()[0])
        for name, kw in MR.MOE_VARIANTS.items():
            c = MO.MoEConfig(**kw)
            params = {k: torch.from_numpy(jax_ref[f"moe/{name}/param/{k}"])
                      for k in MO.moe_params_shape(MR.D_MOE, c)}
            outs, auxes = MR.moe_in_turn(params, x, c, {"data": 2, "model": 2})
            np.testing.assert_array_equal(torch.cat(outs).numpy(), got[f"moe/{name}/full/out"])
            assert float(auxes[0]) == float(got[f"moe/{name}/full/aux"])
    elif part == "pna":
        for name, kw in MR.PNA_VARIANTS.items():
            c = G.PNAConfig(**MR.PNA, **kw)
            params = {k[len("pna/param/"):]: torch.from_numpy(v)
                      for k, v in jax_ref.items() if k.startswith("pna/param/")}
            batch = {k: torch.from_numpy(jax_ref[f"pna/batch/{k}"]) for k in ("features", "src",
                                                                              "dst")}
            logits = MR.pna_in_turn(params, c, batch, 4)
            np.testing.assert_array_equal(logits.numpy(), got[f"pna/{name}/logits"])
    elif part == "lm_decode":
        n_dp, n_tp = MR.SHAPE
        rows = MR.LM_B // n_dp
        for name in MR.LM_SERVED:
            cfg = MR.lm_config(get_arch, name)
            pre = f"lm/{name}/param/dense_layers."
            layer = {k[len(pre):]: torch.from_numpy(v[0]) for k, v in jax_ref.items()
                     if k.startswith(pre)}
            x, cache = MR.lm_decode_inputs(cfg)
            blocks = MR.cache_blocks({k: torch.from_numpy(v) for k, v in cache.items()}, cfg,
                                     n_tp)
            with torch.no_grad():
                y = MR.tp_decode_in_turn(layer, torch.from_numpy(x), blocks, MR.LM_LAYER_LEN,
                                         cfg, n_tp)
                # the global layer from the same cache
                want_cache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
                want = T._decode_layer(layer, torch.from_numpy(x), want_cache, 0,
                                       MR.LM_LAYER_LEN, cfg)
            np.testing.assert_array_equal(y.numpy(), got[f"lm/{name}/decode_layer"], name)
            assert _rel((y - torch.from_numpy(x)).numpy(),
                        (want - torch.from_numpy(x)).numpy()) <= LM_GRAD_TOL, name
            for r, rank in enumerate(ranks):
                d, m = divmod(r, n_tp)
                for k, v in blocks[m].items():
                    np.testing.assert_array_equal(
                        v[:, d * rows:(d + 1) * rows].numpy(),
                        rank[f"lm/{name}/decode_layer/cache/{k}"], f"{name} {k} rank {r}")
            for m, block in enumerate(MR.cache_blocks(want_cache, cfg, n_tp)):
                for k, v in block.items():
                    np.testing.assert_allclose(blocks[m][k].numpy(), v.numpy(), rtol=1e-6,
                                               atol=1e-6, err_msg=f"{name} {k} rank {m}")
    else:
        cfg = MR.lm_config(get_arch, "yi")
        layer = {k[len("lm/yi/param/dense_layers."):]: torch.from_numpy(v[0])
                 for k, v in jax_ref.items() if k.startswith("lm/yi/param/dense_layers.")}
        x = torch.from_numpy(np.random.default_rng(3).normal(
            size=(MR.LM_B, MR.LM_S, cfg.d_model)).astype(np.float32))
        with torch.no_grad():
            y = MR.tp_layer_in_turn(layer, x, cfg, MR.SHAPE[1])
            np.testing.assert_array_equal(y.numpy(), got["lm/yi/layer"])
            want, _ = T._dense_block(layer, x, cfg)
        assert _rel(y.numpy(), want.numpy()) <= LM_GRAD_TOL


# ------------------------------------------------------------ shards
@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v2-236b"])
def test_shard_params_cuts_the_dry_runs_shard_shapes(arch):
    """Each rank's shard of a 2x4 mesh has the shape the dry run's
    ``NamedSharding.shard_shape`` gives, and the shards tile the leaf."""
    cfg = get_arch(arch).smoke()
    specs = flatten(T.param_specs(cfg))
    shape = {"data": 2, "model": 4}
    full = {k: torch.arange(int(np.prod(s)), dtype=torch.float32).reshape(s)
            for k, s in flatten(T.param_shapes(cfg)).items()}
    views = [M.RankView(shape, co) for co in itertools.product(range(2), range(4))]
    shards = [flatten(M.shard_params(unflatten(full), T.param_specs(cfg), v)) for v in views]
    for k, v in full.items():
        want = NamedSharding(Mesh(shape), specs[k]).shard_shape(v.shape)
        assert all(tuple(s[k].shape) == want for s in shards), k
        n_rep = len(views) // (v.numel() // int(np.prod(want)))
        total = sum(float(s[k].sum()) for s in shards)
        assert total == n_rep * float(v.sum()), k


@pytest.mark.parametrize("name", MR.POD_VARIANTS)
def test_pod_mesh_moe_equals_the_data_mesh(ranks, name):
    """On the ``('pod', 'data', 'model')`` mesh of 2x1x2 the rows go over
    ``('pod', 'data')`` in row-major order, and ``moe_ffn`` with those
    ``dp_axes`` gives the 2x2 mesh's output, aux and gradients bit for bit."""
    for got in ranks:
        np.testing.assert_array_equal(got["pods/index"], [0, 0, 1, 1])
        for k, v in got.items():
            if k.startswith(f"moe/{name}/full/"):
                np.testing.assert_array_equal(got[k.replace("moe/", "pods/", 1)], v, err_msg=k)


@pytest.mark.parametrize("name", MR.LM_SERVED)
def test_lm_mesh_cache_refuses_a_batch_that_does_not_split(ranks, name):
    for got in ranks:
        assert "does not split" in str(got[f"lm/{name}/cache_split"])


@pytest.mark.parametrize("name", MR.LM_SERVED)
def test_lm_mesh_decode_of_one_rank_is_the_plain_decode(name):
    """``serve_step(mesh=)`` on a gloo mesh of one in this process, its
    collectives over one rank, against the plain decode from the same
    params (at the no-drop factor, ROADMAP C25): the logits and the cache
    bit for bit, four steps."""
    import dataclasses
    import torch.distributed as dist

    cfg = MR.lm_config(get_arch, name)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.from_numpy(MR.lm_tokens(cfg)).to(torch.int64)
    cache = T.make_cache(cfg, MR.LM_B, MR.LM_SLOTS, device="cpu")
    mesh = M.make_model_mesh(1, 1, device="cpu")
    try:
        local = M.shard_params(params, T.param_specs(cfg), mesh)
        mcache = T.make_cache(cfg, MR.LM_B, MR.LM_SLOTS, device="cpu", mesh=mesh)
        for t in range(4):
            want, cache = T.serve_step(params, tok[:, t:t + 1], cache, t, cfg)
            got, mcache = T.serve_step(local, tok[:, t:t + 1], mcache, t, cfg, mesh=mesh)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    finally:
        dist.destroy_process_group()
    for k, v in cache.items():
        torch.testing.assert_close(mcache[k], v, rtol=0, atol=0)


def test_model_mesh_refuses_a_mesh_without_its_ranks():
    with pytest.raises(ValueError, match="needs 4 devices but only 1 are visible"):
        M.make_model_mesh(2, 2, device="cpu")


def test_head_split_follows_the_heads():
    yi = get_arch("yi-9b").config                     # 32 heads over 4 KV heads
    assert T.head_split(yi, 3, 4) == T.HeadSplit(True, 8, 3, 1, 3, 4)
    assert T.head_split(yi, 5, 8) == T.HeadSplit(True, 4, 2, 1, 5, 8)
    assert T.head_split(yi, 0, 16) == T.HeadSplit(True, 2, 0, 1, 0, 16)
    qwen = get_arch("qwen2.5-14b").config             # 40 over 8
    assert not T.head_split(qwen, 0, 16).split
    assert "attn_wq" in T.model_gathered(qwen, T.head_split(qwen, 0, 16))
    v2 = get_arch("deepseek-v2-236b").config
    assert T.head_split(v2, 1, 4) == T.HeadSplit(True, 32, 32, 32, 1, 4)
    assert T.model_gathered(v2, T.head_split(v2, 1, 4)) == {"attn_wdq", "attn_wdkv",
                                                             "attn_wkrope"}
