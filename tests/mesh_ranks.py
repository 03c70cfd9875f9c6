"""Multi-rank cases of the port's mesh code, run over gloo on the CPU.

JAX-free: ``tests/test_torch_mesh.py`` spawns ranks that import only this
module and the port. :func:`run` starts ``n`` processes
(``torch.multiprocessing``, spawn, a ``FileStore``); each joins the process
group, runs one case of :data:`CASES` on the ``('pod', 'data')`` mesh and
saves what it computed to ``<out>/rank<r>.npz``. The inputs come from the
numpy generators below, which the JAX side of the test uses too.
"""

import os
import tempfile

import numpy as np

FILL = 2**31 - 1
MAX_ID = 2**31 - 1
N_LOCAL, CAP, LOCAL_CAP = 96, 512, 96
PSUM_N = 64
PSUM_CALLS = 8
MESH_STEPS = 8
B = 64

# tests/test_mesh.py's config and batches
CFG = dict(name="t", kind="dlrm", n_dense=13, n_sparse=6, embed_dim=16,
           vocab_sizes=(64, 32, 128, 16, 8, 40), bot_mlp=(32, 16), top_mlp=(64, 32, 1),
           dedup_capacity=256, row_align=8)


def make_batch(i):
    r = np.random.default_rng(i)
    return {"dense": r.normal(size=(B, 13)).astype(np.float32),
            "sparse": np.stack([r.integers(0, v, B) for v in CFG["vocab_sizes"]],
                               1).astype(np.int32),
            "label": r.integers(0, 2, B).astype(np.float32)}


def dedup_cases(n_dev):
    """{name: (ids int32[n_dev, N_LOCAL], capacity, local_capacity)}: plain
    ids, FILL mixed in, ids at the top of the id space, a global overflow
    and a stage-1 overflow."""
    rng = np.random.default_rng(7)
    out = {}
    for trial in range(3):
        ids = rng.integers(0, 500, size=(n_dev, N_LOCAL)).astype(np.int32)
        if trial == 1:
            ids[rng.random(ids.shape) < 0.2] = FILL
        if trial == 2:
            ids[rng.random(ids.shape) < 0.3] = MAX_ID - 1 - rng.integers(0, 3)
        out[f"trial{trial}"] = (ids, CAP, LOCAL_CAP)
    wide = rng.integers(0, 100_000, size=(n_dev, N_LOCAL)).astype(np.int32)
    out["overflow"] = (wide, 64, LOCAL_CAP)
    out["local_overflow"] = (wide, CAP, 16)
    return out


def psum_inputs(n_dev, t):
    """The ``t``-th call's per-rank inputs, f32[n_dev, PSUM_N]."""
    base = np.linspace(-1.3, 1.7, n_dev * PSUM_N).reshape(n_dev, PSUM_N)
    return (base * (1.0 + 0.37 * t) + 0.01 * np.sin(t * np.arange(PSUM_N))).astype(np.float32)


# ------------------------------------------------------------------ cases
def _mesh(shape):
    from repro_torch.launch.mesh import make_train_mesh

    return make_train_mesh(*shape, device="cpu")


def case_dedup(rank, shape, inputs):
    import torch

    from repro_torch.embedding.dedup import dedup_two_stage_local

    _mesh(shape)
    n_dev = shape[0] * shape[1]
    out = {}
    for name, (ids, cap, lcap) in dedup_cases(n_dev).items():
        u, inv, cnt, lcnt = dedup_two_stage_local(torch.from_numpy(ids[rank]), capacity=cap,
                                                  local_capacity=lcap)
        for k, v in (("u", u), ("inv", inv), ("cnt", cnt), ("lcnt", lcnt)):
            out[f"{name}/{k}"] = v.numpy()
    return out


def case_psum(rank, shape, inputs):
    import torch

    from repro_torch.train.compression import flat_psum, hierarchical_psum

    mesh = _mesh(shape)
    n_dev = shape[0] * shape[1]
    out = {f"flat/{t}/out": flat_psum(torch.from_numpy(psum_inputs(n_dev, t)[rank]), mesh).numpy()
           for t in range(PSUM_CALLS)}
    for codec in ("off", "bf16", "int8"):
        res = torch.zeros(PSUM_N // shape[1]) if codec != "off" else None
        for t in range(PSUM_CALLS):
            x = torch.from_numpy(psum_inputs(n_dev, t)[rank])
            y, res = hierarchical_psum(x, mesh, compress=codec, residual=res)
            out[f"{codec}/{t}/out"] = y.numpy()
            if res is not None:
                out[f"{codec}/{t}/res"] = res.numpy()
    return out


def case_step(rank, shape, inputs):
    """The mesh step over MESH_STEPS batches from the given params, for
    each codec, from the same params; the full params and state gathered
    at the end. Also the step's refusal of a batch that does not split."""
    import torch

    import repro_torch.models.recsys as R
    from repro_torch.train.optimizer import adamw

    mesh = _mesh(shape)
    cfg = R.RecsysConfig(**CFG)
    out = {}
    for codec in ("off", "bf16", "int8"):
        params = {k[len("step_param/"):]: torch.from_numpy(v.copy())
                  for k, v in inputs.items() if k.startswith("step_param/")}
        step, init = R.make_mesh_train_step(cfg, adamw(1e-3), mesh=mesh, compress=codec,
                                            local_dedup_capacity=64)
        p, o = R.shard_train_state(mesh, params, init(params))
        for i in range(MESH_STEPS):
            b = {k: torch.from_numpy(v) for k, v in make_batch(i).items()}
            p, o, m = step(p, o, b)
            for k in ("loss", "unique", "n_ids", "local_unique"):
                out[f"{codec}/{i}/{k}"] = np.asarray(float(m[k]) if k == "loss" else int(m[k]))
        fp, fo = R.unshard_train_state(mesh, p, o)
        for k, v in fp.items():
            out[f"{codec}/param/{k}"] = v.numpy()
        out[f"{codec}/embed_accum"] = fo["embed_accum"].numpy()
        if "comm_residual" in fo:
            out[f"{codec}/comm_residual"] = fo["comm_residual"].numpy()
    try:
        step(p, o, {k: torch.from_numpy(v[:63]) for k, v in make_batch(0).items()})
    except ValueError as e:
        out["split_error"] = np.asarray(str(e))
    return out


def case_stream(rank, shape, inputs):
    """The port's streaming driver (``run_streaming``) on the mesh, from
    the given params, over the shards in ``inputs["data_dir"]``."""
    import torch

    import repro_torch.models.recsys as R
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as T
    from repro_torch.train.optimizer import adamw

    out = {}
    for codec in ("off", "bf16"):
        args = T.parse_args(["--arch", "dlrm-mlperf", "--data-dir", str(inputs["data_dir"]),
                             "--spec", "dlrm", "--device-feed", "off", "--fault-tolerant",
                             "--mesh", f"{shape[0]}x{shape[1]}", "--compress", codec,
                             "--steps", str(int(inputs["steps"])), "--device", "cpu"])
        spec = get_arch("dlrm-mlperf")
        cfg = spec.smoke()
        params = {k[len("drv_param/"):]: torch.from_numpy(v.copy())
                  for k, v in inputs.items() if k.startswith("drv_param/")}
        state = {"params": params, "opt": R.make_sparse_train_step(cfg, adamw(1e-3))[1](params)}
        stats, losses = T.run_streaming(args, spec, cfg, state, adamw(1e-3))
        out[f"{codec}/losses"] = np.asarray(losses)
        out[f"{codec}/comm"] = np.asarray(stats.comm.summary())
    return out


def case_restore(rank, shape, inputs):
    """Restore the checkpoint in ``inputs["ckpt"]`` onto this mesh: this
    rank's shards and the state gathered back from all of them."""
    import torch

    import repro_torch.models.recsys as R
    from repro_torch.configs import get_arch
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import adamw

    mesh = _mesh(shape)
    cfg = get_arch("dlrm-mlperf").smoke()
    params = R.init_params(cfg, torch.Generator().manual_seed(5))
    state = {"params": params, "opt": R.make_sparse_train_step(cfg, adamw(1e-3))[1](params)}
    ckpt = CheckpointManager(str(inputs["ckpt"]))
    step, state = ckpt.restore_latest(state)
    p, o = R.shard_train_state(mesh, state["params"], state["opt"])
    fp, fo = R.unshard_train_state(mesh, p, o)
    return {"step": np.asarray(step), "meta": np.asarray(str(ckpt.latest_meta())),
            "shard_embed": p["embed"].numpy(), "shard_accum": o["embed_accum"].numpy(),
            "embed": fp["embed"].numpy(), "accum": fo["embed_accum"].numpy()}


def case_all(rank, shape, inputs):
    """dedup, psum, step and stream in one spawn, keys prefixed by case."""
    out = {}
    for name in ("dedup", "psum", "step", "stream"):
        out.update({f"{name}/{k}": v for k, v in CASES[name](rank, shape, inputs).items()})
    return out


CASES = {"dedup": case_dedup, "psum": case_psum, "step": case_step, "stream": case_stream,
         "restore": case_restore, "all": case_all}


# ------------------------------------------------------------------ spawn
def _rank(rank, world, store, case, shape, inputs, out_dir):
    import sys

    import torch
    import torch.distributed as dist

    sys.stdout = open(os.devnull, "w")   # the drivers' lines, once per rank
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        res = CASES[case](rank, shape, inputs)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def run(case, shape, inputs=None, out_dir=None):
    """Run ``case`` on a ``shape`` mesh, one spawned process per rank;
    returns every rank's saved arrays, in rank order."""
    import torch.multiprocessing as mp

    world = shape[0] * shape[1]
    out_dir = out_dir or tempfile.mkdtemp(prefix=f"mesh_{case}_")
    store = os.path.join(tempfile.mkdtemp(prefix="store_"), "store")
    mp.spawn(_rank, args=(world, store, case, shape, dict(inputs or {}), out_dir),
             nprocs=world, join=True)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]
