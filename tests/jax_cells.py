"""The JAX package's dry-run cells and their helpers, as JSON on stdout.

Run in a process of its own (it forces 512 host devices before JAX
starts): ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/jax_cells.py``.
``tests/test_torch_configs.py`` and ``tests/test_torch_dryrun.py`` hold the
port's ``configs/base.py``, its spec trees, its ``adamw`` and its dry run
to what this prints. Cells are built, never lowered or compiled.
"""

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs import base as B  # noqa: E402
from repro.configs import get_arch, list_archs  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.models import gnn as G  # noqa: E402
from repro.models import recsys as R  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.train.optimizer import adamw  # noqa: E402


def variants_for(arch_id, family):
    """``tests/test_configs.py``'s variant list."""
    variants = ["base"]
    if family == "recsys":
        variants += ["nodedup", "cap_expected", "batchall"]
    if family == "gnn":
        variants += ["halo_bf16"]
    if arch_id == "yi-9b":
        variants += ["puredp", "accum4"]
    if arch_id == "deepseek-v2-236b":
        variants += ["accum8", "accum8+cf100"]
    return variants


def path_str(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def spec_tree_json(tree):
    if isinstance(tree, P):
        return spec_json(tree)
    return {k: spec_tree_json(v) for k, v in tree.items()}


def leaf_bytes(leaf, sharding):
    """``launch/dryrun.py``'s rule (lines 104-111)."""
    n = int(np.prod(leaf.shape)) if leaf.shape else 1
    try:
        shard_shape = sharding.shard_shape(leaf.shape)
        n = int(np.prod(shard_shape)) if shard_shape else 1
    except Exception:
        pass
    return n * leaf.dtype.itemsize


def state_bytes(cell):
    """``launch/dryrun.py``'s ``state_bytes_exact`` (lines 113-118)."""
    total = 0
    for arg, sh in zip(cell.args, cell.in_shardings):
        leaves = jax.tree.leaves(arg)
        shardings = jax.tree.leaves(sh, is_leaf=lambda x: hasattr(x, "shard_shape"))
        if len(shardings) == len(leaves):
            total += sum(leaf_bytes(a, s) for a, s in zip(leaves, shardings))
    return total


def shard_or_error(sharding, shape):
    try:
        return list(sharding.shard_shape(shape))
    except Exception as e:
        return type(e).__name__


def cell_json(cell):
    args = []
    for arg, sh in zip(cell.args, cell.in_shardings):
        leaves = jax.tree_util.tree_flatten_with_path(arg)[0]
        shs = jax.tree_util.tree_flatten_with_path(
            sh, is_leaf=lambda x: hasattr(x, "shard_shape"))[0]
        shs = {path_str(p): s for p, s in shs}
        args.append({path_str(p): [list(a.shape), str(a.dtype),
                                   shard_or_error(shs[path_str(p)], a.shape)]
                     for p, a in leaves})
    return {"skip": None, "model_flops": cell.model_flops, "state_bytes_exact": state_bytes(cell),
            "args": args}


def error_of(fn):
    try:
        fn()
    except Exception as e:
        return [type(e).__name__, str(e)]
    return None


def main():
    meshes = {"16x16": make_production_mesh(multi_pod=False),
              "2x16x16": make_production_mesh(multi_pod=True),
              "2x4": jax.make_mesh((2, 4), ("data", "model"),
                                   axis_types=(jax.sharding.AxisType.Auto,) * 2)}
    out = {"cells": {}, "helpers": {}, "specs": {}}
    for mesh_name, mesh in meshes.items():
        cells = out["cells"][mesh_name] = {}
        for arch_id in list_archs():
            spec = get_arch(arch_id)
            for shape in spec.shapes:
                for variant in variants_for(arch_id, spec.family):
                    cell = spec.build_cell(shape, mesh, variant=variant)
                    key = f"{arch_id}|{shape}|{variant}"
                    cells[key] = ({"skip": cell.skip, "model_flops": cell.model_flops}
                                  if cell.skip else cell_json(cell))

    # hierdedup (not in tests/test_configs.py's list): the recsys cells
    out["hierdedup"] = {
        mesh_name: {f"{arch_id}|{shape}": cell_json(get_arch(arch_id).build_cell(
            shape, meshes[mesh_name], variant="hierdedup"))
            for arch_id in list_archs() if get_arch(arch_id).family == "recsys"
            for shape in get_arch(arch_id).shapes}
        for mesh_name in ("16x16", "2x16x16")}

    for arch_id in list_archs():
        spec = get_arch(arch_id)
        cfg = spec.build_cell.args[0]
        h = out["helpers"][arch_id] = {}
        s = out["specs"][arch_id] = {}
        if spec.family == "lm":
            h["count_params"] = B.count_params(T.abstract_params(cfg))
            h["lm_active_params"] = B.lm_active_params(cfg)
            for dp in (("data",), ("pod", "data")):
                key = "+".join(dp)
                s[f"tp=model|{key}"] = spec_tree_json(T.param_specs(cfg, dp=dp, tp="model"))
                s[f"tp=None|{key}"] = spec_tree_json(
                    T.param_specs(cfg, dp=dp + ("model",), tp=None))
                s[f"cache|{key}"] = spec_tree_json(T.cache_specs(cfg, dp=dp))
        elif spec.family == "recsys":
            h["count_params"] = B.count_params(R.abstract_params(cfg))
            h["dense_flops"] = B.recsys_dense_flops(cfg)
            h["dedup_cap"] = {f"{b}|{sr}": B.recsys_dedup_cap(cfg, b, sr)
                              for b in (1, 512, 65536) for sr in (0, 100, 10**7)}
            for dp in (("data",), ("pod", "data")):
                s["+".join(dp)] = spec_tree_json(R.param_specs(cfg, dp=dp))
        else:
            for shape in spec.shapes:
                gcfg = B.gnn_config_for(arch_id, shape)
                h[f"count_params|{shape}"] = B.count_params(G.abstract_params(gcfg))
                s[shape] = spec_tree_json(G.param_specs(gcfg))

    mesh = meshes["16x16"]
    out["errors"] = {
        "lm_bogus": error_of(lambda: B.lm_cell(get_arch("yi-9b").build_cell.args[0],
                                               "train_4k", mesh, variant="bogus")),
        "recsys_bogus": error_of(lambda: get_arch("dlrm-mlperf").build_cell(
            "serve_p99", mesh, variant="bogus")),
        "gnn_bogus": error_of(lambda: get_arch("pna").build_cell(
            "molecule", mesh, variant="bogus")),
        "puredp_moe": error_of(lambda: get_arch("deepseek-moe-16b").build_cell(
            "train_4k", mesh, variant="puredp")),
        "cf_dense": error_of(lambda: get_arch("yi-9b").build_cell(
            "train_4k", mesh, variant="cf100")),
    }

    # one uneven leaf: (5, 3) over P('model', None) on 2x4
    leaf = jax.ShapeDtypeStruct((5, 3), jnp.float32)
    sh = NamedSharding(meshes["2x4"], P("model", None))
    out["uneven"] = {"shard": shard_or_error(sh, leaf.shape), "bytes": leaf_bytes(leaf, sh)}

    # adamw in bfloat16 moments and math (the >5e10-param cells' optimizer)
    out["adamw_bf16"] = adamw_bf16()
    json.dump(out, sys.stdout)


ADAMW_SHAPES = {"a": (64, 33), "b.c": (129,), "b.d": (7, 5)}


def adamw_inputs(seed=0):
    """numpy bfloat16 params, grads and moments of ``ADAMW_SHAPES``, by
    ``<p|g|m|v>.<leaf>``."""
    import ml_dtypes
    rng = np.random.default_rng(seed)
    out = {}
    for name, scale in (("p", 1e-3), ("g", 0.05), ("m", 0.01), ("v", 1e-4)):
        for path, shape in ADAMW_SHAPES.items():
            x = rng.standard_normal(shape) * scale
            if name == "v":
                x = np.abs(x)
            out[f"{name}.{path}"] = x.astype(ml_dtypes.bfloat16)
    return out


def adamw_bf16():
    flat = adamw_inputs()

    def tree(name):
        return {"a": jnp.asarray(flat[f"{name}.a"]),
                "b": {"c": jnp.asarray(flat[f"{name}.b.c"]), "d": jnp.asarray(flat[f"{name}.b.d"])}}

    opt = adamw(1e-2, moment_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16,
                weight_decay=0.1)
    res = {f"in|{k}": np.asarray(v).view(np.int16).ravel().tolist() for k, v in flat.items()}
    for step in (0, 5):
        state = {"m": tree("m"), "v": tree("v"), "step": jnp.int32(step)}
        p2, s2 = jax.jit(opt.update)(tree("p"), tree("g"), state)
        for name, t in (("p", p2), ("m", s2["m"]), ("v", s2["v"])):
            for path, x in jax.tree_util.tree_flatten_with_path(t)[0]:
                bits = np.asarray(x).view(np.int16).ravel().tolist()
                res[f"{step}|{name}.{path_str(path)}"] = bits
        res[f"{step}|step"] = int(s2["step"])
    return res


if __name__ == "__main__":
    main()
