"""The JAX package's model-parallel forms on a 2x2 mesh of host devices.

Run by ``tests/test_torch_model_parallel.py`` in one subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``):

    python tests/jax_model_parallel.py OUT.npz

It writes JAX's init params and, on the ``('data', 'model')`` mesh, what the
port's gloo ranks compute (``tests/model_parallel_ranks.py``): ``moe_ffn(
mesh=)`` per variant with its gradients, the aux's gradient alone and the
per-shard facts around it; the node-sharded PNA train step (and the local
one) and ``forward_sharded``; the LM's ``make_train_step``, ``prefill`` and
``serve_step`` with ``mesh=``.
"""

import os
import sys
import types

# two of this process's cores (XLA compiles on a thread per core): the
# suite's timing tests share the machine (ROADMAP C12)
os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import model_parallel_ranks as MR  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.models import gnn as G  # noqa: E402
from repro.models import moe as MO  # noqa: E402
from repro.models import transformer as T  # noqa: E402

CAPTURE = types.SimpleNamespace(update=lambda p, g, s: (g, s))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def moe(mesh, out):
    x, cot = (jnp.asarray(a) for a in MR.moe_inputs())
    half = MR.T_MOE // 2
    for name, kw in MR.MOE_VARIANTS.items():
        c = MO.MoEConfig(**kw)
        kg = jax.random.PRNGKey(0)
        p = {k: jax.random.normal(jax.random.fold_in(kg, i), s) * 0.1
             for i, (k, s) in enumerate(MO.moe_params_shape(MR.D_MOE, c).items())}
        for k, v in p.items():
            out[f"moe/{name}/param/{k}"] = np.asarray(v)

        def full(p, x):
            o, aux = MO.moe_ffn(p, x, c, mesh=mesh, dp_axes=("data",))
            return (o * cot).sum() + MR.AUX_W * aux, (o, aux)

        def aux_only(p, x):
            o, aux = MO.moe_ffn(p, x, c, mesh=mesh, dp_axes=("data",))
            return MR.AUX_W * aux, (o, aux)

        with mesh:
            for tag, f in (("full", full), ("aux", aux_only)):
                (_, (o, aux)), (gp, gx) = jax.jit(
                    jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(p, x)
                out[f"moe/{name}/{tag}/out"] = np.asarray(o)
                out[f"moe/{name}/{tag}/aux"] = np.asarray(aux)
                out[f"moe/{name}/{tag}/gx"] = np.asarray(gx)
                for k, v in gp.items():
                    out[f"moe/{name}/{tag}/grad/{k}"] = np.asarray(v)
        # the per-shard facts: moe_ffn on each data shard, its aux and the
        # router gradients of shard 0's aux and of the shards' mean
        shards = [MO.moe_ffn(p, x[d * half:(d + 1) * half], c) for d in range(2)]
        out[f"moe/{name}/local_out"] = np.asarray(MO.moe_ffn(p, x, c)[0])
        out[f"moe/{name}/shard_out"] = np.concatenate([np.asarray(s[0]) for s in shards])
        out[f"moe/{name}/shard_aux"] = np.asarray([float(s[1]) for s in shards])
        for tag, fn in (("aux0", lambda p: MO.moe_ffn(p, x[:half], c)[1]),
                        ("auxmean", lambda p: 0.5 * (MO.moe_ffn(p, x[:half], c)[1]
                                                     + MO.moe_ffn(p, x[half:], c)[1]))):
            out[f"moe/{name}/{tag}_router_grad"] = np.asarray(
                jax.grad(lambda p: MR.AUX_W * fn(p))(p)["router"])


def pna(mesh, out):
    n, e, d_in, n_cls = MR.PNA_GRAPH
    g = G.random_graph(n, e, d_in, n_cls, seed=0)
    src_p, dst_p, _ = G.partition_edges(g["src"].astype(np.int64), g["dst"].astype(np.int64),
                                          n, 4)
    batch = {"features": jnp.asarray(g["features"]), "src": jnp.asarray(src_p.astype(np.int32)),
             "dst": jnp.asarray(dst_p.astype(np.int32)), "labels": jnp.asarray(g["labels"])}
    for k, v in batch.items():
        out[f"pna/batch/{k}"] = np.asarray(v)
    for name, kw in MR.PNA_VARIANTS.items():
        c = G.PNAConfig(**MR.PNA, **kw)
        params = G.init_params(c, jax.random.PRNGKey(0))
        for k, v in params.items():
            out[f"pna/param/{k}"] = np.asarray(v)
        b = dict(batch, label_mask=jnp.asarray(MR.pna_mask())) if name == "mask" else batch
        with mesh:
            grads, _, m = jax.jit(G.make_train_step(c, CAPTURE, mesh=mesh,
                                                    node_axes=MR.NODE_AXES))(params, {}, b)
            logits = jax.jit(lambda p, b: G.forward_sharded(p, c, b, mesh=mesh,
                                                            node_axes=MR.NODE_AXES))(params, b)
        out[f"pna/{name}/loss"] = np.asarray(m["loss"])
        out[f"pna/{name}/logits"] = np.asarray(logits)
        for k, v in grads.items():
            out[f"pna/{name}/grad/{k}"] = np.asarray(v)
        # the local (global-program) step on the unpartitioned graph
        lb = {k: jnp.asarray(v) for k, v in g.items()}
        if name == "mask":
            lb["label_mask"] = jnp.asarray(MR.pna_mask())
        lg, _, lm = jax.jit(G.make_train_step(c, CAPTURE))(params, {}, lb)
        out[f"pna/{name}/local_loss"] = np.asarray(lm["loss"])
        for k, v in lg.items():
            out[f"pna/{name}/local_grad/{k}"] = np.asarray(v)


def lm(mesh, out):
    for name in MR.LM_CASES:
        cfg = MR.lm_config(get_arch, name)
        params = T.init_params(cfg, jax.random.PRNGKey(0))
        for k, v in flat(params).items():
            out[f"lm/{name}/param/{k}"] = v
        tok = jnp.asarray(MR.lm_tokens(cfg))
        with mesh:
            grads, _, m = jax.jit(T.make_train_step(cfg, CAPTURE, mesh=mesh,
                                                    **MR.LM_MESH.get(name, {})))(
                params, {}, {"tokens": tok, "labels": tok})
        out[f"lm/{name}/loss"] = np.asarray(m["loss"])
        for k, v in flat(grads).items():
            out[f"lm/{name}/grad/{k}"] = v
        if name not in MR.LM_SERVED:
            continue
        with mesh:
            out[f"lm/{name}/prefill"] = np.asarray(
                jax.jit(lambda p, t: T.prefill(p, t, cfg, mesh=mesh))(params, tok))
            step = jax.jit(lambda p, t, ca, n: T.serve_step(p, t, ca, n, cfg, mesh=mesh))
            cache = T.make_cache(cfg, MR.LM_B, MR.LM_SLOTS)
            for t in range(MR.LM_DECODE):
                logits, cache = step(params, tok[:, t:t + 1], cache, jnp.int32(t))
                out[f"lm/{name}/decode/{t}"] = np.asarray(logits)
        for k, v in cache.items():
            out[f"lm/{name}/cache/{k}"] = np.asarray(v)


def main():
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    moe(mesh, out)
    pna(mesh, out)
    lm(mesh, out)
    np.savez(sys.argv[1], **out)


if __name__ == "__main__":
    main()
