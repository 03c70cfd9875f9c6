"""The port's dry-run cells against the JAX package's (CPU, no compile).

Every (arch x shape x variant) cell of ``tests/test_configs.py``'s variant
list, on both production meshes: the built and skipped counts and the skip
reasons; per cell each argument leaf's shape, dtype and shard shape (or
the error JAX's ``shard_shape`` raises), ``state_bytes_exact`` to the byte
and ``model_flops``, compared as equal floats. Then the helpers, the spec
trees, ``adamw``'s abstract state and bfloat16 update, the variant errors,
and one uneven leaf (ROADMAP C29). JAX's side comes from one subprocess
(``tests/jax_cells.py``: 512 forced host devices, cells built, never
compiled).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as B  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.core.sharding import Mesh, NamedSharding, P  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import gnn as G  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train.optimizer import adamw, flatten, unflatten  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": make_production_mesh(multi_pod=False),
          "2x16x16": make_production_mesh(multi_pod=True),
          "2x4": Mesh({"data": 2, "model": 4})}
ARCHS = list_archs()


def jax_cells_json():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "tests", "jax_cells.py")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout)


@pytest.fixture(scope="module")
def jax_side():
    return jax_cells_json()


def shard_or_error(sharding, shape):
    try:
        return list(sharding.shard_shape(shape))
    except Exception as e:  # noqa: BLE001 — the error's kind is what is compared
        return type(e).__name__


def cell_json(cell):
    """The port's cell in ``tests/jax_cells.py``'s form."""
    if cell.skip:
        return {"skip": cell.skip, "model_flops": cell.model_flops}
    args = []
    for arg, sh in zip(cell.args, cell.in_shardings):
        shs = B.leaves_by_path(sh)
        args.append({p: [list(t.shape), str(t.dtype).replace("torch.", ""),
                         shard_or_error(shs[p], tuple(t.shape))]
                     for p, t in B.leaves_by_path(arg).items()})
    return {"skip": None, "model_flops": cell.model_flops,
            "state_bytes_exact": D.state_bytes_exact(cell), "args": args}


def jax_variants(jax_side, mesh_name, arch_id, shape):
    """The variants JAX built for one (arch, shape): ``tests/test_configs.py``'s
    list (``tests/jax_cells.py``)."""
    prefix = f"{arch_id}|{shape}|"
    return [k[len(prefix):] for k in jax_side["cells"][mesh_name] if k.startswith(prefix)]


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
def test_cell_counts_and_skips_match_jax(jax_side, mesh_name):
    ref = jax_side["cells"][mesh_name]
    built, skips = 0, {}
    for key in ref:
        arch_id, shape, variant = key.split("|")
        cell = get_arch(arch_id).build_cell(shape, MESHES[mesh_name], variant=variant)
        assert cell.fn is not None or cell.skip
        if cell.skip:
            skips[key] = cell.skip
        else:
            built += 1
    assert skips == {k: v["skip"] for k, v in ref.items() if v["skip"]}
    assert {k.split("|")[0] for k in ref} == set(ARCHS)
    assert built >= 50 and len(ref) == built + len(skips) == 108
    assert {k.split("|")[1] for k in skips} == {"long_500k"}


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch_id,shape", [(a, s) for a in ARCHS for s in get_arch(a).shapes])
def test_cells_match_jax(jax_side, mesh_name, arch_id, shape):
    """Arg shapes, dtypes and shard shapes by path, the exact state bytes
    and model FLOPs (equal floats: the same formulas over the same integer
    shapes, summed in the same order)."""
    variants = jax_variants(jax_side, mesh_name, arch_id, shape)
    assert "base" in variants
    for variant in variants:
        cell = get_arch(arch_id).build_cell(shape, MESHES[mesh_name], variant=variant)
        got = cell_json(cell)
        want = jax_side["cells"][mesh_name][f"{arch_id}|{shape}|{variant}"]
        assert got == want, (variant, {k: (got.get(k), want.get(k)) for k in want
                                       if got.get(k) != want.get(k) and k != "args"})
        if not cell.skip:
            assert cell.model_flops > 0


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
def test_hierdedup_cells_match_jax(jax_side, mesh_name):
    """The ``hierdedup`` variant (outside ``tests/test_configs.py``'s list),
    every recsys cell; its train step is the sparse step over the mesh's
    row blocks (``Cell.fn_mesh``)."""
    want = jax_side["hierdedup"][mesh_name]
    for key, ref in want.items():
        arch_id, shape = key.split("|")
        cell = get_arch(arch_id).build_cell(shape, MESHES[mesh_name], variant="hierdedup")
        assert cell_json(cell) == ref, key
        assert (cell.fn_mesh == MESHES[mesh_name].shape) == (shape == "train_batch")
    assert len(want) == 16


def test_state_bytes_pinned(jax_side):
    """Five cells' per-device state bytes on 16x16, pinned to the byte."""
    want = {("dlrm-mlperf", "train_batch"): 407_551_616,
            ("deepseek-moe-16b", "train_4k"): 9_681_261_572,
            ("deepseek-v2-236b", "train_4k"): 6_186_917_892,
            ("yi-9b", "decode_32k"): 1_741_824_036,
            ("pna", "molecule"): 4_531_336}
    for (arch_id, shape), n in want.items():
        cell = get_arch(arch_id).build_cell(shape, MESHES["16x16"])
        assert D.state_bytes_exact(cell) == n
        assert jax_side["cells"]["16x16"][f"{arch_id}|{shape}|base"]["state_bytes_exact"] == n


@pytest.mark.parametrize("arch_id", ARCHS)
def test_helpers_match_jax(jax_side, arch_id):
    spec = get_arch(arch_id)
    want = jax_side["helpers"][arch_id]
    cfg = spec.build_cell.args[0]
    if spec.family == "lm":
        assert B.count_params(T.abstract_params(cfg)) == want["count_params"]
        assert B.lm_active_params(cfg) == want["lm_active_params"]
    elif spec.family == "recsys":
        assert B.count_params(R.abstract_params(cfg)) == want["count_params"]
        assert B.recsys_dense_flops(cfg) == want["dense_flops"]
        assert {f"{b}|{sr}": B.recsys_dedup_cap(cfg, b, sr)
                for b in (1, 512, 65536) for sr in (0, 100, 10**7)} == want["dedup_cap"]
    else:
        for shape in spec.shapes:
            assert (B.count_params(G.abstract_params(B.gnn_config_for(arch_id, shape)))
                    == want[f"count_params|{shape}"])


def spec_tree_json(tree):
    if isinstance(tree, P):
        return [list(e) if isinstance(e, tuple) else e for e in tree]
    return {k: spec_tree_json(v) for k, v in tree.items()}


@pytest.mark.parametrize("arch_id", ARCHS)
def test_spec_trees_match_jax(jax_side, arch_id):
    """LM: tp="model", tp=None over the flattened axes and cache_specs (GQA
    and MLA), each for ("data",) and ("pod", "data"); recsys; gnn per shape."""
    spec = get_arch(arch_id)
    want = jax_side["specs"][arch_id]
    got = {}
    if spec.family == "lm":
        cfg = spec.build_cell.args[0]
        for dp in (("data",), ("pod", "data")):
            key = "+".join(dp)
            got[f"tp=model|{key}"] = spec_tree_json(T.param_specs(cfg, dp=dp, tp="model"))
            got[f"tp=None|{key}"] = spec_tree_json(T.param_specs(cfg, dp=dp + ("model",),
                                                                 tp=None))
            got[f"cache|{key}"] = spec_tree_json(T.cache_specs(cfg, dp=dp))
    elif spec.family == "recsys":
        for dp in (("data",), ("pod", "data")):
            got["+".join(dp)] = spec_tree_json(R.param_specs(spec.build_cell.args[0], dp=dp))
    else:
        for shape in spec.shapes:
            got[shape] = spec_tree_json(G.param_specs(B.gnn_config_for(arch_id, shape)))
    assert got == want


def test_cache_specs_cover_gqa_and_mla():
    gqa = T.cache_specs(get_arch("yi-9b").config)
    mla = T.cache_specs(get_arch("deepseek-v2-236b").config, dp=("pod", "data"))
    assert set(gqa) == {"k", "v"} and gqa["k"] == P(None, "data", None, None, "model")
    assert set(mla) == {"ckv", "krope"} and mla["ckv"] == P(None, ("pod", "data"), None, "model")


@pytest.mark.parametrize("name", ["lm_bogus", "recsys_bogus", "gnn_bogus", "puredp_moe",
                                  "cf_dense"])
def test_variant_errors_match_jax(jax_side, name):
    mesh = MESHES["16x16"]
    calls = {
        "lm_bogus": lambda: B.lm_cell(get_arch("yi-9b").config, "train_4k", mesh,
                                      variant="bogus"),
        "recsys_bogus": lambda: get_arch("dlrm-mlperf").build_cell("serve_p99", mesh,
                                                                   variant="bogus"),
        "gnn_bogus": lambda: get_arch("pna").build_cell("molecule", mesh, variant="bogus"),
        "puredp_moe": lambda: get_arch("deepseek-moe-16b").build_cell("train_4k", mesh,
                                                                      variant="puredp"),
        "cf_dense": lambda: get_arch("yi-9b").build_cell("train_4k", mesh, variant="cf100"),
    }
    kind, msg = jax_side["errors"][name]
    with pytest.raises(Exception) as e:
        calls[name]()
    assert [type(e.value).__name__, str(e.value)] == [kind, msg]


def test_uneven_leaf_counts_at_full_size(jax_side):
    """ROADMAP C29: JAX's shard_shape raises on (5, 3) over P('model', None)
    on a 2x4 mesh, and the dry run counts that leaf at its full size."""
    sh = NamedSharding(MESHES["2x4"], P("model", None))
    leaf = torch.empty((5, 3), dtype=torch.float32, device="meta")
    assert shard_or_error(sh, (5, 3)) == jax_side["uneven"]["shard"] == "ValueError"
    assert D.leaf_bytes(leaf, sh) == jax_side["uneven"]["bytes"] == 60
    cell = B.Cell("x", "y", fn=None, args=({"w": leaf},), in_shardings=({"w": sh},))
    assert D.state_bytes_exact(cell) == 60
    # an argument whose sharding tree does not line up with it counts nothing
    cell = B.Cell("x", "y", fn=None, args=({"w": leaf, "b": leaf},), in_shardings=({"w": sh},))
    assert D.state_bytes_exact(cell) == 0


def test_partition_spec_and_shard_shape_follow_jax():
    mesh = MESHES["2x4"]
    assert P(("data",), None) == P("data", None) and tuple(P(("data",))) == ("data",)
    assert hash(P(("data",))) == hash(P("data"))
    assert NamedSharding(mesh, P(("data", "model"), None)).shard_shape((8, 3)) == (1, 3)
    assert NamedSharding(mesh, P("data", None)).shard_shape((4,)) == (2,)
    assert NamedSharding(mesh, P()).shard_shape(()) == ()
    with pytest.raises(IndexError):
        NamedSharding(mesh, P(None, "data")).shard_shape((4,))
    with pytest.raises(ValueError):
        NamedSharding(mesh, P("pod"))


def test_production_meshes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.axis_names == ("data", "model") and one.shape == {"data": 16, "model": 16}
    assert two.axis_names == ("pod", "data", "model") and two.size == 512
    assert B.dp_axes_for(one) == ("data",) and B.dp_axes_for(two) == ("pod", "data")


# ------------------------------------------------------------------- adamw
def test_abstract_state_matches_concrete():
    """JAX's test on the port: the same tree and the same leaves' shapes and
    dtypes. The port's concrete ``step`` is a host int (its bias
    corrections need no device read); the abstract one is JAX's int32
    scalar, which ``update`` takes as well."""
    opt = adamw(1e-3)
    params = {"w": torch.zeros((3, 3)), "b": torch.zeros(3)}
    conc, ab = opt.init(params), opt.abstract_state(params)
    assert set(ab) == set(conc) == {"m", "v", "step"}
    for k in ("m", "v"):
        assert set(ab[k]) == set(conc[k])
        for name in ab[k]:
            assert ab[k][name].shape == conc[k][name].shape
            assert ab[k][name].dtype == conc[k][name].dtype
            assert ab[k][name].device.type == "meta"
    assert conc["step"] == 0 and ab["step"].shape == () and ab["step"].dtype == torch.int32
    bf = adamw(1e-3, moment_dtype=torch.bfloat16).abstract_state(params)
    assert all(t.dtype == torch.bfloat16 for t in bf["m"].values())


def _bits_tensor(bits, shape):
    return torch.tensor(np.asarray(bits, dtype=np.int16).reshape(shape)).view(torch.bfloat16)


@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("tensor_step", [False, True])
def test_adamw_bf16_matches_jax(jax_side, step, tensor_step):
    """bfloat16 moments and math (the >5e10-param cells' optimizer, with
    weight decay) against JAX's jitted update on the same bits: held within
    1 bfloat16 ulp per element (ROADMAP C5), and bit for bit where this CPU
    shows it. The step as a host int and as an int32 tensor agree."""
    ref = jax_side["adamw_bf16"]
    shapes = {"a": (64, 33), "b.c": (129,), "b.d": (7, 5)}

    def tree(name):
        return unflatten({k: _bits_tensor(ref[f"in|{name}.{k}"], s) for k, s in shapes.items()})

    opt = adamw(1e-2, moment_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                weight_decay=0.1)
    p = tree("p")
    st = {"m": flatten(tree("m")), "v": flatten(tree("v")),
          "step": torch.tensor(step, dtype=torch.int32) if tensor_step else step}
    before = {k: v.clone() for k, v in flatten(p).items()}
    p2, s2 = opt.update(p, tree("g"), st)
    assert int(s2["step"]) == ref[f"{step}|step"]
    worst = 0
    for name, got in (("p", flatten(p2)), ("m", s2["m"]), ("v", s2["v"])):
        for k, s in shapes.items():
            want = np.asarray(ref[f"{step}|{name}.{k}"], dtype=np.int32)
            g = got[k].view(torch.int16).reshape(-1).numpy().astype(np.int32)
            worst = max(worst, int(np.abs(g - want).max()))
    assert worst <= 1, worst
    assert any(not torch.equal(before[k], v) for k, v in flatten(p2).items())


def test_adamw_f32_tensor_step_equals_int_step():
    """The float32 update with the step as an int32 tensor (the dry run's
    abstract state, materialised) is bit for bit the host-int one."""
    rng = np.random.default_rng(1)
    shapes = {"w": (17, 9), "b": (9,)}
    base = {k: torch.tensor(rng.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}
    grads = {k: torch.tensor(rng.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}
    outs = []
    for step in (3, torch.tensor(3, dtype=torch.int32)):
        opt = adamw(1e-2, weight_decay=0.1)
        p = {k: v.clone() for k, v in base.items()}
        st = opt.init(p)
        st["step"] = step
        for _ in range(3):
            p, st = opt.update(p, grads, st)
        outs.append((p, st))
    (p1, s1), (p2, s2) = outs
    assert int(s1["step"]) == int(s2["step"]) == 6
    for k in shapes:
        assert torch.equal(p1[k], p2[k]) and torch.equal(s1["m"][k], s2["m"][k])
