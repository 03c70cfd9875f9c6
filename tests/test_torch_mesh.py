"""The port's data-parallel training against the JAX package's, on the CPU.

Multi-rank checks run the port in spawned gloo ranks (``tests/mesh_ranks.py``,
JAX-free) and JAX in one subprocess on 4 simulated devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_mesh.py`` does), both on a 2x2 mesh, from the same numpy
inputs and JAX's init params:

* ``CommPlan`` bytes, ``CommStats``, ``parse_mesh_spec``, ``codec_name``,
  ``shard_bounds`` and the oversubscription error as JAX's;
* the codecs bit for bit against JAX's jitted codecs (ROADMAP C5: XLA
  multiplies by 1/127 and fuses ``a - q s``);
* ``dedup_two_stage_local`` and ``dedup_hierarchical`` bit for bit (FILL,
  ids at ``MAX_ID``, both overflows);
* ``hierarchical_psum`` over 8 calls, residual carried, and ``flat_psum``;
* the mesh step: 1x1 bit for bit the port's sparse step (5 steps); 2x2
  against JAX's 2x2 over 8 steps at JAX's tolerances
  (``tests/test_mesh.py:121-130``); bf16 and int8 within JAX's drift bounds
  of the port's uncompressed run and of JAX's compressed run; a batch that
  does not split raises;
* the driver: ``--mesh 2x2 --device-feed off --compress off|bf16`` against
  the JAX driver's losses and ``comm plan:`` line on the same shards, and
  with ``--fault-tolerant --chaos`` (a kill and a transient, 0.2 s leases)
  against the JAX driver's chaos run (losses, ``chaos:`` and ``fault:``
  lines); a corrupt shard ends every rank, within a time limit;
  JAX's refusals (a mesh larger than the visible cards among them), ``--mesh auto`` on the CPU, and a checkpoint saved at 2x2
  restored at 1x2.
"""

import dataclasses
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.embedding.table import shard_bounds as jax_shard_bounds  # noqa: E402
from repro.launch.mesh import parse_mesh_spec as jax_parse_mesh_spec  # noqa: E402
from repro.train import compression as JC  # noqa: E402

import mesh_ranks as M  # noqa: E402
from repro_torch.embedding.dedup import dedup_hierarchical  # noqa: E402
from repro_torch.embedding.table import shard_bounds  # noqa: E402
from repro_torch.fe.datagen import write_log_shards  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.launch.mesh import make_train_mesh, parse_mesh_spec  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.train import compression as PC  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.optimizer import adamw  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 2)
N_DEV = 4
DRIVER_STEPS = 4
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-5, 3e-5, 2e-6      # tests/test_mesh.py:121-130
DRIFT = {"bf16": 5e-3, "int8": 5e-2}                       # tests/test_mesh.py:164-175

# The JAX side of every multi-rank check, on 4 simulated devices.
JAX_SCRIPT = r"""
import contextlib, io, sys
import numpy as np, jax, jax.numpy as jnp
OUT, DATA, TESTS, STEPS = sys.argv[1:5]
sys.path.insert(0, TESTS)
import mesh_ranks as M
from jax.sharding import PartitionSpec as P
from repro import compat; compat.install()
import repro.models.recsys as R
import repro.fe.modelfeed as MF
from repro.configs import get_arch
from repro.embedding.dedup import dedup_hierarchical, dedup_two_stage_local
from repro.launch import train as JT
from repro.launch.mesh import make_train_mesh
from repro.train.compression import flat_psum, hierarchical_psum
from repro.train.optimizer import adamw

assert len(jax.devices()) == 4
out, mesh, AX = {}, make_train_mesh(2, 2), ("pod", "data")

def smap(body, n_in, n_out):
    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(AX),) * n_in,
                                 out_specs=(P(AX),) * n_out, check_vma=False))

for name, (ids, cap, lcap) in M.dedup_cases(4).items():
    def body(x, cap=cap, lcap=lcap):
        r = dedup_two_stage_local(x[0], capacity=cap, local_capacity=lcap, gather_axes=AX)
        return tuple(v[None] for v in r)
    for k, v in zip(("u", "inv", "cnt", "lcnt"), smap(body, 1, 4)(jnp.asarray(ids))):
        out[f"dedup/{name}/{k}"] = np.asarray(v)
    for k, v in zip(("u", "inv", "cnt"), dedup_hierarchical(
            jnp.asarray(ids), capacity=cap, mesh=mesh, axes=AX, local_capacity=lcap)):
        out[f"hier/{name}/{k}"] = np.asarray(v)

for codec in ("off", "bf16", "int8"):
    def body(x, r, codec=codec):
        y, nr = hierarchical_psum(x[0], compress=None if codec == "off" else codec,
                                  residual=None if codec == "off" else r[0])
        return y[None], (r[0] if nr is None else nr)[None]
    f, res = smap(body, 2, 2), jnp.zeros((4, M.PSUM_N // 2), jnp.float32)
    for t in range(M.PSUM_CALLS):
        y, res = f(jnp.asarray(M.psum_inputs(4, t)), res)
        out[f"psum/{codec}/{t}/out"] = np.asarray(y)
        out[f"psum/{codec}/{t}/res"] = np.asarray(res)

f = smap(lambda x: (flat_psum(x[0])[None],), 1, 1)
for t in range(M.PSUM_CALLS):
    out[f"flat/{t}/out"] = np.asarray(f(jnp.asarray(M.psum_inputs(4, t)))[0])

cfg = R.RecsysConfig(**M.CFG)
params = R.init_params(cfg, jax.random.PRNGKey(0))
out.update({f"step_param/{k}": np.asarray(v) for k, v in params.items()})
for codec in ("off", "bf16", "int8"):
    step, init, _ = R.make_mesh_train_step(cfg, adamw(1e-3), mesh=mesh,
                                           compress=None if codec == "off" else codec,
                                           local_dedup_capacity=64)
    pm, om = R.shard_train_state(mesh, dict(params), init(params))
    jm = jax.jit(step)
    for i in range(M.MESH_STEPS):
        pm, om, mm = jm(pm, om, {k: jnp.asarray(v) for k, v in M.make_batch(i).items()})
        for k in ("loss", "unique", "n_ids", "local_unique"):
            out[f"step/{codec}/{i}/{k}"] = np.asarray(mm[k])
    out.update({f"step/{codec}/param/{k}": np.asarray(v) for k, v in pm.items()})
    out[f"step/{codec}/embed_accum"] = np.asarray(om["embed_accum"])
    if codec != "off":
        out[f"step/{codec}/comm_residual"] = np.asarray(om["comm_residual"])

drv = R.init_params(get_arch("dlrm-mlperf").smoke(), jax.random.PRNGKey(0))
out.update({f"drv_param/{k}": np.asarray(v) for k, v in drv.items()})
losses, record = [], MF.ModelFeed._record
MF.ModelFeed._record = lambda self, m: (losses.append(float(m["loss"])), record(self, m))[1]
for run, extra in (("off", ["--compress", "off"]), ("bf16", ["--compress", "bf16"]),
                   ("chaos", ["--compress", "off"] + M.CHAOS)):
    losses.clear()
    sys.argv = ["train", "--arch", "dlrm-mlperf", "--data-dir", DATA, "--spec", "dlrm",
                "--device-feed", "off", "--fault-tolerant", "--mesh", "2x2",
                "--steps", STEPS] + extra
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JT.main()
    out[f"drv/{run}/losses"] = np.asarray(losses)
    for key, head in (("plan", "comm plan:"), ("fault", "fault:"), ("chaos", "chaos: fired")):
        lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith(head)]
        if lines:
            out[f"drv/{run}/{key}"] = np.asarray(lines[0])
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_shards")
    write_log_shards(str(d), n_shards=DRIVER_STEPS, rows_per_shard=64, seed=0)
    return d


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory, shards):
    path = str(tmp_path_factory.mktemp("jax_mesh") / "ref.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT, path, str(shards),
                          os.path.join(REPO, "tests"), str(DRIVER_STEPS)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port_ranks(jax_ref, shards):
    """Every multi-rank case of the port on a 2x2 gloo mesh, in one spawn."""
    inputs = {k: v for k, v in jax_ref.items() if k.startswith(("step_param/", "drv_param/"))}
    inputs.update(data_dir=str(shards), steps=DRIVER_STEPS)
    return M.run("all", SHAPE, inputs)


# ------------------------------------------------------------- unit parity
PLANS = [dict(n_pods=2, inner=4, compress="bf16", hierarchical=True, capacity=256,
              embed_dim=16, n_dense_elems=1000, local_capacity=64, ids_per_device=48),
         dict(n_pods=2, inner=4, compress="int8", hierarchical=True, capacity=256,
              embed_dim=16, n_dense_elems=1000, local_capacity=64, ids_per_device=48),
         dict(n_pods=1, inner=1, compress=None, hierarchical=True, capacity=256,
              embed_dim=16, n_dense_elems=1000, local_capacity=64, ids_per_device=48),
         dict(n_pods=2, inner=2, compress="off", hierarchical=False, capacity=1111,
              embed_dim=128, n_dense_elems=3_000_001, local_capacity=333, ids_per_device=999),
         dict(n_pods=4, inner=3, compress=True, hierarchical=True, capacity=77,
              embed_dim=8, n_dense_elems=101, local_capacity=5, ids_per_device=9)]


@pytest.mark.parametrize("kw", PLANS, ids=lambda kw: f"{kw['n_pods']}x{kw['inner']}-"
                         f"{kw['compress']}-{'hier' if kw['hierarchical'] else 'flat'}")
def test_comm_plan_and_stats_equal_jaxs(kw):
    want, got = JC.CommPlan.for_step(**kw), PC.CommPlan.for_step(**kw)
    assert got.as_metrics() == want.as_metrics()
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    js, ps = JC.CommStats(plan=want), PC.CommStats(plan=got)
    for _ in range(3):
        js.on_step()
        ps.on_step()
    assert ps.as_metrics() == js.as_metrics()
    assert ps.summary() == js.summary()
    assert ps.interpod_bytes_total == js.interpod_bytes_total


@pytest.mark.parametrize("spec", ["2x4", "1X1", "2×4", "", "2", "2x4x8", "0x4", "ax4"])
def test_parse_mesh_spec_and_codec_name_as_jax(spec):
    try:
        want = jax_parse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(spec)
        assert str(got.value) == str(e)
    else:
        assert parse_mesh_spec(spec) == want
    for c in (None, False, "off", "none", True, "bf16", "int8"):
        assert PC.codec_name(c) == JC.codec_name(c)
    with pytest.raises(ValueError):
        PC.codec_name("fp8")
    assert PC.WIRE_ITEMSIZE == JC.WIRE_ITEMSIZE


def test_shard_bounds_and_oversubscription(monkeypatch):
    for args in ((512, 8, 0), (512, 8, 7), (96, 4, 2)):
        assert shard_bounds(*args) == jax_shard_bounds(*args)
    with pytest.raises(ValueError, match="do not shard evenly"):
        shard_bounds(100, 8, 0)
    # no process group here: a mesh of more than one device needs its ranks
    with pytest.raises(ValueError, match="needs 4 devices but only 1 are visible"):
        make_train_mesh(2, 2, device="cpu")
    # the card: JAX's message when the mesh asks for more devices than exist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 4 devices but only 1 are visible"):
        make_train_mesh(2, 2)


@pytest.mark.parametrize("n", [1, 7, 257, 4096])
def test_codecs_bit_for_bit_against_jaxs(n):
    rng = np.random.default_rng(n)
    for trial in range(8):
        g = (rng.standard_normal(n) * 10.0 ** rng.uniform(-20, 3)).astype(np.float32)
        r = (rng.standard_normal(n) * 10.0 ** rng.uniform(-20, -1)).astype(np.float32)
        trees = ({"a": g, "b": r[: max(1, n // 2)]}, {"a": r, "b": g[: max(1, n // 2)]})
        jw, jr = JC.bf16_compress({k: jnp.asarray(v) for k, v in trees[0].items()},
                                  {k: jnp.asarray(v) for k, v in trees[1].items()})
        pw, pr = PC.bf16_compress({k: torch.from_numpy(v) for k, v in trees[0].items()},
                                  {k: torch.from_numpy(v) for k, v in trees[1].items()})
        for k in jw:
            assert np.array_equal(np.asarray(jw[k]).view(np.uint16),
                                  pw[k].view(torch.int16).numpy().view(np.uint16))
            assert np.array_equal(np.asarray(jr[k]).view(np.int32), pr[k].numpy().view(np.int32))
            assert np.array_equal(np.asarray(JC.bf16_decompress(jw)[k]),
                                  PC.bf16_decompress(pw)[k].numpy())
        # the JAX codec runs under jit in the mesh step (C5)
        jq, js, jr = jax.jit(JC.int8_compress)(jnp.asarray(g), jnp.asarray(r))
        pq, ps, pr = PC.int8_compress(torch.from_numpy(g), torch.from_numpy(r))
        assert np.array_equal(np.asarray(jq), pq.numpy())
        assert np.asarray(js).tobytes() == ps.numpy().tobytes()
        assert np.array_equal(np.asarray(jr).view(np.int32), pr.numpy().view(np.int32))
        assert np.array_equal(np.asarray(jax.jit(JC.int8_decompress)(jq, js)),
                              PC.int8_decompress(pq, ps).numpy())
        assert PC.compressed_bytes({"q": pq, "w": pw["a"]}) == JC.compressed_bytes(
            {"q": jq, "w": jw["a"]})


# --------------------------------------------------------- multi-rank parity
@pytest.mark.parametrize("case", sorted(M.dedup_cases(N_DEV)))
def test_dedups_bit_for_bit_against_jaxs(case, jax_ref, port_ranks):
    for k in ("u", "inv", "cnt", "lcnt"):
        got = np.stack([r[f"dedup/{case}/{k}"] for r in port_ranks])
        want = jax_ref[f"dedup/{case}/{k}"].reshape(got.shape)
        assert np.array_equal(got, want), k
    ids, cap, lcap = M.dedup_cases(N_DEV)[case]
    u, inv, cnt = dedup_hierarchical(torch.from_numpy(ids), capacity=cap, n_shards=N_DEV,
                                     local_capacity=lcap)
    if case == "local_overflow":   # a dropped id's inverse: take_along_axis's fill
        assert (inv.numpy() == -2**31).any()
    for k, v in (("u", u), ("inv", inv), ("cnt", cnt)):
        assert np.array_equal(v.numpy(), jax_ref[f"hier/{case}/{k}"]), k


@pytest.mark.parametrize("codec", ["off", "bf16", "int8"])
def test_hierarchical_psum_against_jaxs_over_8_calls(codec, jax_ref, port_ranks):
    for t in range(M.PSUM_CALLS):
        want = jax_ref[f"psum/{codec}/{t}/out"]
        got = np.stack([r[f"psum/{codec}/{t}/out"] for r in port_ranks])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
        if codec != "off":
            res = np.stack([r[f"psum/{codec}/{t}/res"] for r in port_ranks])
            wres = jax_ref[f"psum/{codec}/{t}/res"]
            np.testing.assert_allclose(res, wres, rtol=1e-5, atol=1e-6 * np.abs(want).max())
            assert np.abs(res).max() > 0


def test_flat_psum_against_jaxs(jax_ref, port_ranks):
    for t in range(M.PSUM_CALLS):
        want = jax_ref[f"flat/{t}/out"]
        got = np.stack([r[f"psum/flat/{t}/out"] for r in port_ranks])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_mesh_1x1_is_the_sparse_step_bit_for_bit():
    cfg = R.RecsysConfig(**M.CFG)
    mesh = make_train_mesh(1, 1, device="cpu")
    opt = adamw(1e-3)
    p0 = R.init_params(cfg, torch.Generator().manual_seed(0))
    step_s, init_s = R.make_sparse_train_step(cfg, opt)
    step_m, init_m = R.make_mesh_train_step(cfg, opt, mesh=mesh, compress=None)
    ps = {k: v.clone() for k, v in p0.items()}
    pm = {k: v.clone() for k, v in p0.items()}
    os_, om = init_s(ps), init_m(pm)
    assert set(om) == set(os_)            # no codec, no residual
    pm, om = R.shard_train_state(mesh, pm, om)
    for i in range(5):
        b = {k: torch.from_numpy(v) for k, v in M.make_batch(i).items()}
        ps, os_, ms = step_s(ps, os_, b)
        pm, om, mm = step_m(pm, om, b)
        assert float(ms["loss"]) == float(mm["loss"]), i
        assert int(ms["unique"]) == int(mm["unique"]) and ms["n_ids"] == mm["n_ids"]
    assert int(mm["local_unique"]) == int(mm["unique"])   # stage 1 == stage 2
    for k in ps:
        assert torch.equal(ps[k], pm[k]), k
    assert torch.equal(os_["embed_accum"], om["embed_accum"])
    assert os_["dense"]["step"] == om["dense"]["step"]
    for m in ("m", "v"):
        for k in os_["dense"][m]:
            assert torch.equal(os_["dense"][m][k], om["dense"][m][k]), (m, k)
    # the sparse step's single-controller two-stage dedup branch, one block
    step_h, _ = R.make_sparse_train_step(cfg, opt, mesh={"pod": 1, "data": 1},
                                         batch_axes=("pod", "data"), local_dedup_capacity=384)
    ph = {k: v.clone() for k, v in p0.items()}
    oh = init_s(ph)
    p1 = {k: v.clone() for k, v in p0.items()}
    o1 = init_s(p1)
    b = {k: torch.from_numpy(v) for k, v in M.make_batch(0).items()}
    _, _, mh = step_h(ph, oh, b)
    _, _, m1 = step_s(p1, o1, b)
    assert float(mh["loss"]) == float(m1["loss"]) and all(torch.equal(ph[k], p1[k]) for k in ph)


def test_mesh_2x2_against_jaxs_over_8_steps(jax_ref, port_ranks):
    r0 = port_ranks[0]
    for i in range(M.MESH_STEPS):
        for r in port_ranks:   # every rank reports the replicated metrics
            np.testing.assert_allclose(r[f"step/off/{i}/loss"], jax_ref[f"step/off/{i}/loss"],
                                       rtol=LOSS_RTOL)
            for k in ("unique", "n_ids", "local_unique"):
                assert int(r[f"step/off/{i}/{k}"]) == int(jax_ref[f"step/off/{i}/{k}"]), (i, k)
    for k in [k for k in jax_ref if k.startswith("step/off/param/")]:
        np.testing.assert_allclose(r0[f"step/{k[len('step/'):]}"], jax_ref[k],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)
    np.testing.assert_allclose(r0["step/off/embed_accum"], jax_ref["step/off/embed_accum"],
                               rtol=PARAM_RTOL, atol=PARAM_ATOL)
    assert "does not split" in str(r0["step/split_error"])


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_compressed_mesh_drift_within_jaxs_bounds(codec, jax_ref, port_ranks):
    r0 = port_ranks[0]
    names = [k[len("step_param/"):] for k in jax_ref if k.startswith("step_param/")]
    ours = max(float(np.abs(r0[f"step/{codec}/param/{k}"] - r0[f"step/off/param/{k}"]).max())
               for k in names)
    theirs = max(float(np.abs(r0[f"step/{codec}/param/{k}"]
                              - jax_ref[f"step/{codec}/param/{k}"]).max()) for k in names)
    assert ours < DRIFT[codec] and theirs < DRIFT[codec], (ours, theirs)
    assert np.abs(r0[f"step/{codec}/comm_residual"]).max() > 0
    assert r0[f"step/{codec}/comm_residual"].shape == jax_ref[f"step/{codec}/comm_residual"].shape


# ------------------------------------------------------------------ driver
def _fault_counts(line):
    return {k: int(v) for k, v in re.findall(r"\b(completed|reissued|reaped|retries)=(\d+)",
                                             str(line))}


def test_driver_mesh_2x2_chaos_matches_the_jax_driver(jax_ref, port_ranks):
    """``--fault-tolerant --chaos kill@1:read,transient@2:read:1`` on the
    2x2 mesh: every rank builds the same injector and leases the global
    shard order, so every rank meets the kill (reaped after the 0.2 s lease
    timeout, reissued) and the transient (one retry), and yields the
    batches of the run without faults: its losses are the ``off`` run's bit
    for bit, within ``LOSS_RTOL`` of the JAX driver's chaos run, and its
    ``chaos: fired`` line and ``fault:`` counts are the JAX driver's, the
    schedule exhausted on every rank."""
    want_fault = _fault_counts(jax_ref["drv/chaos/fault"])
    assert want_fault == {"completed": DRIVER_STEPS, "reissued": 1, "reaped": 1, "retries": 1}
    assert str(jax_ref["drv/chaos/chaos"]) == "chaos: fired {'kill': 1, 'transient': 1}"
    for r in port_ranks:
        np.testing.assert_array_equal(r["stream/chaos/losses"], r["stream/off/losses"])
        np.testing.assert_allclose(r["stream/chaos/losses"], jax_ref["drv/chaos/losses"],
                                   rtol=LOSS_RTOL)
        assert str(r["stream/chaos/chaos"]) == str(jax_ref["drv/chaos/chaos"])
        assert _fault_counts(r["stream/chaos/fault"]) == want_fault


CORRUPT_LIMIT_S = 60     # a run whose ranks all end is done in under 10 s on 8 cores


def test_cli_mesh_2x2_corrupt_shard_ends_every_rank(tmp_path):
    """A corrupt shard ends the run on every rank of a 2x2 gloo mesh at the
    same batch, each with the reader's error, none left inside a
    collective: the command exits non-zero within ``CORRUPT_LIMIT_S``, and
    every rank prints the reader's error (a rank left inside a collective
    ends with gloo's instead, once its failed peer has waited
    ``RANK_GRACE_S``, 30 s, and gone)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "dlrm-mlperf", "--data-dir", str(tmp_path), "--gen-shards", "4",
                          "--batch", "64", "--spec", "dlrm", "--device-feed", "off", "--mesh",
                          "2x2", "--steps", "4", "--device", "cpu", "--fault-tolerant",
                          "--chaos", "corrupt@1"], env=env, capture_output=True, text=True,
                         timeout=3 * CORRUPT_LIMIT_S, cwd=REPO)
    took = time.monotonic() - t0
    assert res.returncode != 0
    assert took < CORRUPT_LIMIT_S, took
    ended = sorted(ln.split(" failed:")[0] for ln in res.stderr.splitlines()
                   if ln.startswith("rank ") and "shard reader failed" in ln)
    assert ended == [f"rank {r} of 4" for r in range(4)], res.stderr[-3000:]
    assert "chaos: corrupt payload on shard 1" in res.stderr


def test_rank_failure_line_goes_out_in_one_write(monkeypatch):
    """A failing rank writes its whole ``rank r of n failed: ...`` line,
    newline included, in one call to ``sys.stderr.write``: ranks that fail
    together share the stream, and a line written in two parts (``print``
    writes the message and its newline apart) can be split by another
    rank's (ROADMAP C34)."""
    import types

    import torch.distributed as dist

    import repro_torch.launch.mesh as LM

    class Recorder:
        def __init__(self):
            self.writes = []

        def write(self, s):
            self.writes.append(s)
            return len(s)

        def flush(self):
            pass

    def fail(args):
        raise RuntimeError("shard reader failed on shard-00001.fbshard")

    rec = Recorder()
    monkeypatch.setattr(dist, "FileStore", lambda *a, **k: None)
    monkeypatch.setattr(dist, "destroy_process_group", lambda: None)
    monkeypatch.setattr(LM, "init_ranks", lambda *a, **k: None)
    monkeypatch.setattr(T, "_traced_run", fail)
    monkeypatch.setattr(T, "_end_with_peers", lambda store, world: None)
    monkeypatch.setattr(sys, "stderr", rec)
    with pytest.raises(RuntimeError, match="shard reader failed"):
        T._rank_main(0, types.SimpleNamespace(trace=None, device="cpu"), "store", 4)
    assert rec.writes == ["rank 0 of 4 failed: RuntimeError: shard reader failed on "
                          "shard-00001.fbshard\n"]


@pytest.mark.parametrize("codec", ["off", "bf16"])
def test_driver_mesh_2x2_matches_the_jax_driver(codec, jax_ref, port_ranks):
    for r in port_ranks:
        np.testing.assert_allclose(r[f"stream/{codec}/losses"], jax_ref[f"drv/{codec}/losses"],
                                   rtol=LOSS_RTOL)
    plan = str(jax_ref[f"drv/{codec}/plan"])
    assert str(port_ranks[0][f"stream/{codec}/comm"]).split(" steps=")[0] == \
        plan[len("comm plan: "):].split(" steps=")[0]


def _cli(*argv, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *argv],
                         env=env, capture_output=True, text=True, timeout=timeout, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_cli_mesh_2x2_prints_jaxs_plan_and_a_valid_trace(tmp_path, jax_ref):
    trace = str(tmp_path / "t.json")
    out = _cli("--arch", "dlrm-mlperf", "--data-dir", str(tmp_path / "d"), "--gen-shards", "4",
               "--batch", "64", "--spec", "dlrm", "--device-feed", "off", "--mesh", "2x2",
               "--compress", "bf16", "--steps", "4", "--device", "cpu", "--trace", trace)
    plan = [ln for ln in out.splitlines() if ln.startswith("comm plan:")]
    assert plan == [str(jax_ref["drv/bf16/plan"])]
    assert "mode=streaming steps=4 loss" in out and "comm: mesh 2x2 codec=bf16" in out
    res = subprocess.run([sys.executable, "-m", "repro_torch.obs.validate", trace,
                          "--require-tracks", "4", "--require-overlap", "fe.", "train."],
                         env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "comm.allreduce" in res.stdout


def test_a_checkpoint_saved_at_2x2_restores_at_1x2(tmp_path, jax_ref):
    out = _cli("--arch", "dlrm-mlperf", "--data-dir", str(tmp_path / "d"), "--gen-shards", "4",
               "--batch", "64", "--spec", "dlrm", "--device-feed", "off", "--mesh", "2x2",
               "--steps", "4", "--device", "cpu", "--checkpoint-dir", str(tmp_path / "c"),
               "--checkpoint-every", "2")
    assert [ln for ln in out.splitlines() if ln.startswith("comm plan:")] == \
        [str(jax_ref["drv/off/plan"])]
    # the checkpoint holds the full table; a 1x2 mesh restores it bit for bit
    ckpt = CheckpointManager(str(tmp_path / "c"))
    assert ckpt.latest_step() == 3 and ckpt.latest_meta() == {"mesh": [2, 2]}
    cfg = T.get_arch("dlrm-mlperf").smoke()
    like = {"params": R.init_params(cfg, torch.Generator().manual_seed(9))}
    like["opt"] = R.make_sparse_train_step(cfg, adamw(1e-3))[1](like["params"])
    _, saved = ckpt.restore_latest(like)
    ranks = M.run("restore", (1, 2), {"ckpt": str(tmp_path / "c")})
    embed, accum = saved["params"]["embed"].numpy(), saved["opt"]["embed_accum"].numpy()
    for i, r in enumerate(ranks):
        lo, hi = shard_bounds(embed.shape[0], 2, i)
        assert int(r["step"]) == 3 and str(r["meta"]) == "{'mesh': [2, 2]}"
        assert np.array_equal(r["shard_embed"], embed[lo:hi])
        assert np.array_equal(r["shard_accum"], accum[lo:hi])
        assert np.array_equal(r["embed"], embed) and np.array_equal(r["accum"], accum)
    out = _cli("--arch", "dlrm-mlperf", "--data-dir", str(tmp_path / "d"), "--spec", "dlrm",
               "--device-feed", "off", "--mesh", "1x2", "--steps", "1", "--device", "cpu",
               "--checkpoint-dir", str(tmp_path / "c"), "--resume")
    assert "resume: restored step 3 (saved mesh [2, 2], current [1, 2])" in out


def test_cli_keeps_jaxs_refusals_and_mesh_auto_is_1x1(tmp_path, capsys, monkeypatch):
    write_log_shards(str(tmp_path), n_shards=2, rows_per_shard=16, seed=0)
    base = ["--arch", "dlrm-mlperf", "--device", "cpu", "--steps", "1", "--spec", "dlrm"]
    data = ["--data-dir", str(tmp_path)]
    for extra, msg in ((["--mesh", "2x2"], "pass --data-dir"),
                       (data + ["--mesh", "1x1", "--embedding", "hierarchy",
                                "--device-feed", "on"], "incompatible with --embedding"),
                       (data + ["--mesh", "2x2", "--device-feed", "arena"],
                        "requires --device-feed off")):
        with pytest.raises(SystemExit, match=msg):
            T.main(base + extra)
    # the card: a mesh larger than the visible cards fails before any shard
    # is written or any rank spawned, with JAX's message
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        m.setattr(torch.multiprocessing, "spawn", lambda *a, **k: pytest.fail("spawned"))
        gen = tmp_path / "gen"
        with pytest.raises(ValueError, match="needs 4 devices but only 1 are visible"):
            T.main(["--arch", "dlrm-mlperf", "--steps", "1", "--spec", "dlrm",
                    "--data-dir", str(gen), "--gen-shards", "2", "--mesh", "2x2",
                    "--device-feed", "off"])
        assert not gen.exists() or not any(gen.iterdir())
    T.main(base + data + ["--mesh", "auto", "--device-feed", "arena", "--compress", "int8"])
    out = capsys.readouterr().out
    assert "elastic mesh: 1 healthy device(s) -> 1x1 (1 used)" in out
    assert "comm plan: mesh 1x1 codec=int8" in out and "comm: mesh 1x1 codec=int8" in out
    assert "steps=1" in out
