"""The port's examples (``repro_torch.examples``) against the repository's
JAX examples (``examples/*.py``), on the CPU at small sizes.

* ``stream_train``: for every spec, with ``--device-feed on`` and ``off``,
  4 shards of 512 rows: the checksum state (``sum``, ``batches``) equal to
  the JAX example's bit for bit (the sum of int32 ids is exact in float64).
* ``quickstart`` and ``serve_ctr``: JAX's params drawn by the JAX code (the
  five param lines of ``examples/quickstart.py``; ``serve_ctr.make_model``)
  and carried over, and JAX's FE batch, which the port's equals (its
  log-normalised dense columns within 2 ulp, ROADMAP C5). The first loss
  within ``FIRST_RTOL``, the first step's gradients within
  ``FIRST_GRAD_RTOL``; the AdamW loss curves
  within ``CURVE_RTOL`` (ROADMAP C6: Adam's ``lr * sign(g)`` carries
  rounding differences into the params, so a curve is held looser than a
  step); ``serve_ctr``'s scores on two request batches, from JAX's warmed
  params, within ``SCORE_ATOL`` (the scoring pass's sequence pooling runs
  ``bag_lookup``'s plain version here, the ``embedding_bag`` kernel on the
  card).
* ``train_ctr_e2e``: ``TABLE_ROWS`` set on both imported modules (no file
  edited), ``--instances 2048 --batch 256`` and ``E2E_STEPS`` steps (the
  example's closing assertion compares the means of its first and last 20
  losses, so fewer than 21 steps cannot pass it), from JAX's dense params:
  the first loss within ``FIRST_RTOL``, the losses within
  ``E2E_LOSS_RTOL`` and every row of the PS file within ``E2E_ROW_ATOL``.
* ``mesh_train``: the port's driver arguments equal the JAX example's
  ``sys.argv`` list (``examples/mesh_train.py:30-42``) node for node; with
  ``--steps 4`` appended on both sides (and one stream worker, so JAX's
  loader yields the shards in order, as the port's mesh loader always
  does), the port's losses over 8 gloo ranks (``tests/mesh_ranks.py``) from
  JAX's init params match the JAX driver's on 8 simulated host devices
  within ``tests/test_torch_mesh.py``'s driver tolerance.
* each example's ``main`` on the CPU prints its ``OK`` line, and refuses to
  run without a card unless ``--device cpu`` is given.
"""

import ast
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.pipeline import PipelinedRunner as JaxRunner  # noqa: E402
from repro.fe import featureplan as jax_featureplan  # noqa: E402
from repro.fe import get_spec as jax_get_spec  # noqa: E402
from repro.fe.datagen import gen_views as jax_gen_views  # noqa: E402
from repro.models.common import sigmoid_bce as jax_sigmoid_bce  # noqa: E402
from repro.train.optimizer import adamw as jax_adamw  # noqa: E402

import mesh_ranks as M  # noqa: E402
from repro_torch.examples import mesh_train, quickstart, serve_ctr, stream_train  # noqa: E402
from repro_torch.examples import train_ctr_e2e  # noqa: E402
from repro_torch.fe import featureplan, get_spec, list_specs  # noqa: E402
from repro_torch.fe.datagen import gen_views, write_log_shards  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")

LOG1P_ULP = 2            # XLA's CPU log1p against torch's (test_torch_fe.py)
FIRST_RTOL = 1e-6        # the first loss
# each gradient's max diff over its max: sums over 2,048 rows (w2, b2) and
# the embedding's scatter-add, in other orders (1.3e-6 read at 1 and 8 threads)
FIRST_GRAD_RTOL = 5e-6
CURVE_RTOL = 1e-4        # AdamW loss curves (C6)
SCORE_ATOL = 1e-6        # pCTRs in (0, 1) from the same params
E2E_STEPS = 24
E2E_TABLE_ROWS = 50_000
E2E_LOSS_RTOL = 1e-5     # read: 2.0e-7
E2E_ROW_ATOL = 1e-6      # PS rows uniform in +-1/8 at init; read: 7.5e-9
MESH_STEPS = 4
MESH_LOSS_RTOL = 2e-5    # tests/test_torch_mesh.py's LOSS_RTOL (tests/test_mesh.py:121-130)


def _jax_example(name):
    """``examples/<name>.py`` imported by path (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(float(np.abs(np.asarray(want)).max()), 1e-30))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


# ------------------------------------------------------------- stream_train
@pytest.mark.parametrize("feed", ["on", "off"])
@pytest.mark.parametrize("spec", list_specs())
def test_stream_train_checksums_equal_jaxs(spec, feed, tmp_path, monkeypatch, capsys):
    jmod = _jax_example("stream_train")
    states = []

    class Recording(JaxRunner):
        def run(self, state, batches):
            states.append(super().run(state, batches))
            return states[-1]

    monkeypatch.setattr(jmod, "PipelinedRunner", Recording)
    flags = ["--shards", "4", "--rows", "512", "--spec", spec, "--device-feed", feed]
    monkeypatch.setattr(sys, "argv", ["stream_train"] + flags
                        + ["--data-dir", str(tmp_path / "jax")])
    jmod.main()
    got = stream_train.main(flags + ["--data-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert got == states[0] and got["batches"] == 4
    assert type(got["sum"]) is float and got["sum"] > 0
    assert capsys.readouterr().out.count("stream_train OK") == 2


# ------------------------------------------------ quickstart and serve_ctr
def _jax_quickstart_params(layout):
    """The five param lines of ``examples/quickstart.py``, its keys."""
    key = jax.random.PRNGKey(0)
    return {
        "embed": jax.random.normal(key, (64 * 1024, 16)) * 0.05,
        "w1": jax.random.normal(jax.random.fold_in(key, 1),
                                (layout.n_dense_feats + layout.n_sparse_fields * 16 + 16,
                                 64)) * 0.05,
        "b1": jnp.zeros(64),
        "w2": jax.random.normal(jax.random.fold_in(key, 2), (64, 1)) * 0.05,
        "b2": jnp.zeros(1),
    }


def _jax_curve(forward, params, batch, steps):
    """The JAX examples' training loop: jitted value_and_grad + AdamW(1e-2)."""
    opt = jax_adamw(1e-2)
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(
            lambda p: jax_sigmoid_bce(forward(p, batch), batch["batch_label"]).mean())(p)
        return *opt.update(p, g, s), loss

    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return params, losses


def _port_batch(jplan_batch, views):
    """The port's FE batch of ``views`` held to JAX's (bit for bit, the
    log-normalised dense columns within ``LOG1P_ULP``: ROADMAP C5), then
    JAX's batch as tensors, so the model comparisons start from one input."""
    plan = featureplan.compile(get_spec("ads_ctr"))
    batch = plan.outputs(plan.run(views, device="cpu"))
    assert set(batch) == set(jplan_batch)
    for k, v in jplan_batch.items():
        if k == "batch_dense":
            np.testing.assert_array_max_ulp(batch[k].numpy(), np.asarray(v), maxulp=LOG1P_ULP)
        else:
            np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v), err_msg=k)
    return plan, {k: torch.from_numpy(np.array(v)) for k, v in jplan_batch.items()}


def test_quickstart_first_step_and_curve_match_jax(capsys):
    jforward = _jax_example("serve_ctr").forward     # quickstart's model, TABLE = 64 * 1024
    jplan = jax_featureplan.compile(jax_get_spec("ads_ctr"))
    jbatch = jplan.outputs(jplan.run(jax_gen_views(2048, seed=0)))
    jparams = _jax_quickstart_params(jplan.layout)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_sigmoid_bce(jforward(p, jbatch), jbatch["batch_label"]).mean())(jparams)
    _, jlosses = _jax_curve(jforward, jparams, jbatch, 30)

    plan, batch = _port_batch(jbatch, gen_views(2048, seed=0))
    params = serve_ctr.make_model(torch.Generator(), plan.layout, params=_np(jparams))
    loss = serve_ctr.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, [params[k] for k in sorted(params)])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=FIRST_RTOL)
    for k, g in zip(sorted(params), grads):
        assert _rel(g.numpy(), jgrads[k]) <= FIRST_GRAD_RTOL, k
    _, losses = serve_ctr.train(params, batch, 30, log_every=10)
    np.testing.assert_allclose(losses, jlosses, rtol=CURVE_RTOL)
    assert losses[-1] < 0.7 and jlosses[-1] < 0.7
    assert "step  20 loss" in capsys.readouterr().out


def test_serve_ctr_warmup_and_scores_match_jax():
    jmod = _jax_example("serve_ctr")
    jplan = jax_featureplan.compile(jax_get_spec("ads_ctr"))
    jparams = jmod.make_model(jax.random.PRNGKey(0), jplan.layout)
    jenv = jplan.outputs(jplan.run(jax_gen_views(1024, seed=1)))
    jwarm, jlosses = _jax_curve(jmod.forward, jparams, jenv, 20)

    plan, env = _port_batch(jenv, gen_views(1024, seed=1))
    before = {k: np.array(v) for k, v in jparams.items()}
    params = serve_ctr.make_model(torch.Generator(), plan.layout, params=_np(jparams))
    _, losses = serve_ctr.train(params, env, 20)
    for k, v in before.items():     # the port trained on copies of JAX's arrays
        np.testing.assert_array_equal(np.asarray(jparams[k]), v, err_msg=k)
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=FIRST_RTOL)
    np.testing.assert_allclose(losses, jlosses, rtol=CURVE_RTOL)

    warm = serve_ctr.make_model(torch.Generator(), plan.layout, params=_np(jwarm))
    score = jax.jit(lambda p, b: jax.nn.sigmoid(jmod.forward(p, b)))
    for seed in (100, 101):
        jreq = jplan.outputs(jplan.run(jax_gen_views(256, seed=seed)))
        _, req = _port_batch(jreq, gen_views(256, seed=seed))
        got = serve_ctr.score(warm, req)
        np.testing.assert_allclose(got.numpy(), np.asarray(score(jwarm, jreq)),
                                   rtol=0, atol=SCORE_ATOL)
        # the kernel's pooling is the training pass's gather on the same rows
        ids = torch.remainder(req["batch_seq_ids"], serve_ctr.TABLE)
        with torch.no_grad():
            np.testing.assert_allclose(
                serve_ctr.bag_pool(warm["embed"], ids, req["batch_seq_mask"]).numpy(),
                serve_ctr.gather_pool(warm["embed"], ids, req["batch_seq_mask"]).numpy(),
                rtol=0, atol=1e-6)


# ------------------------------------------------------------ train_ctr_e2e
def test_train_ctr_e2e_losses_and_ps_rows_match_jax(tmp_path, monkeypatch, capsys):
    jmod = _jax_example("train_ctr_e2e")
    monkeypatch.setattr(jmod, "TABLE_ROWS", E2E_TABLE_ROWS)
    monkeypatch.setattr(train_ctr_e2e, "TABLE_ROWS", E2E_TABLE_ROWS)
    jlosses = []

    class JaxRecording:
        """The module's ``jax`` with ``jit`` recording each step's loss."""

        def __getattr__(self, name):
            return getattr(jax, name)

        def jit(self, fn):
            step = jax.jit(fn)

            def run(*a):
                out = step(*a)
                jlosses.append(float(out[2]))
                return out
            return run

    monkeypatch.setattr(jmod, "jax", JaxRecording())
    flags = ["--steps", str(E2E_STEPS), "--instances", "2048", "--batch", "256"]
    monkeypatch.setattr(sys, "argv", ["train_ctr_e2e"] + flags
                        + ["--workdir", str(tmp_path / "jax")])
    jmod.main()
    jdense = _np(jmod.build_model(jax.random.PRNGKey(0),
                                  jax_featureplan.compile(jax_get_spec("ads_ctr")).layout))
    build = train_ctr_e2e.build_model
    monkeypatch.setattr(train_ctr_e2e, "build_model",
                        lambda generator, layout: build(generator, layout, params=jdense))
    got = train_ctr_e2e.main(flags + ["--workdir", str(tmp_path / "port"), "--device", "cpu"])
    assert capsys.readouterr().out.count("train_ctr_e2e OK") == 2
    assert len(jlosses) == len(got["losses"]) == E2E_STEPS
    np.testing.assert_allclose(got["losses"][0], jlosses[0], rtol=FIRST_RTOL)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=E2E_LOSS_RTOL)
    shape = (E2E_TABLE_ROWS, train_ctr_e2e.EMBED_DIM)
    jrows = np.memmap(tmp_path / "jax" / "embed.bin", dtype=np.float32, mode="r", shape=shape)
    rows = np.memmap(tmp_path / "port" / "embed.bin", dtype=np.float32, mode="r", shape=shape)
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=E2E_ROW_ATOL)
    assert (got["accum"] != np.float32(0.1)).sum() > 1000   # the pushes reached many rows


# ---------------------------------------------------------------- mesh_train
def _argv_list(path):
    """The list literal of the driver arguments (the one starting "train")."""
    tree = ast.parse(open(path).read())
    lists = [n for n in ast.walk(tree) if isinstance(n, ast.List) and n.elts
             and isinstance(n.elts[0], ast.Constant) and n.elts[0].value == "train"]
    assert len(lists) == 1, path
    return lists[0]


def test_mesh_train_argv_is_the_jax_examples():
    want = _argv_list(os.path.join(EXAMPLES, "mesh_train.py"))
    got = _argv_list(mesh_train.__file__)
    assert ast.dump(got) == ast.dump(want)
    argv = mesh_train.driver_argv("D")
    assert argv[argv.index("--data-dir") + 1] == "D" and argv[0] == "train"


JAX_MESH_SCRIPT = r"""
import ast, contextlib, io, sys
import numpy as np, jax
OUT, DATA, EXAMPLE, STEPS = sys.argv[1:5]
from repro import compat; compat.install()
import repro.models.recsys as R
import repro.fe.modelfeed as MF
from repro.configs import get_arch
from repro.launch import train as JT

assert len(jax.devices()) == 8
tree = ast.parse(open(EXAMPLE).read())
lst = next(n for n in ast.walk(tree) if isinstance(n, ast.List) and n.elts
           and isinstance(n.elts[0], ast.Constant) and n.elts[0].value == "train")
argv = [DATA if isinstance(e, ast.Name) else e.value for e in lst.elts]
losses, record = [], MF.ModelFeed._record
MF.ModelFeed._record = lambda self, m: (losses.append(float(m["loss"])), record(self, m))[1]
sys.argv = argv + ["--steps", STEPS, "--stream-workers", "1"]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    JT.main()
plan = [ln for ln in buf.getvalue().splitlines() if ln.startswith("comm plan:")]
params = R.init_params(get_arch("dlrm-mlperf").smoke(), jax.random.PRNGKey(0))
np.savez(OUT, losses=np.asarray(losses), plan=np.asarray(plan[0]),
         **{f"drv_param/{k}": np.asarray(v) for k, v in params.items()})
"""


def test_mesh_train_8_ranks_match_the_jax_example(tmp_path):
    out = str(tmp_path / "jax.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", JAX_MESH_SCRIPT, out, str(tmp_path / "jax"),
                          os.path.join(EXAMPLES, "mesh_train.py"), str(MESH_STEPS)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = dict(np.load(out))
    assert len(ref["losses"]) == MESH_STEPS
    # the port's driver main() writes the shards once before spawning its ranks
    data = str(tmp_path / "port")
    write_log_shards(data, n_shards=4, rows_per_shard=256, seed=0)
    inputs = {k: v for k, v in ref.items() if k.startswith("drv_param/")}
    inputs.update(data_dir=data, extra=np.asarray(["--steps", str(MESH_STEPS),
                                                   "--stream-workers", "1", "--device", "cpu"]))
    ranks = M.run("example", (2, 4), inputs)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=MESH_LOSS_RTOL)
    assert str(ranks[0]["comm"]).split(" steps=")[0] == \
        str(ref["plan"])[len("comm plan: "):].split(" steps=")[0]


# ------------------------------------------------------------- entry points
@pytest.mark.parametrize("name", ["quickstart", "serve_ctr", "stream_train", "train_ctr_e2e",
                                  "mesh_train"])
def test_example_needs_the_card_unless_asked_for_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"quickstart": quickstart, "serve_ctr": serve_ctr, "stream_train": stream_train,
           "train_ctr_e2e": train_ctr_e2e, "mesh_train": mesh_train}[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--mesh", "1x1"] if name == "mesh_train" else [])


def test_examples_run_on_the_cpu_with_their_ok_lines(tmp_path, capsys):
    assert quickstart.main(["--device", "cpu"])[-1] < 0.7
    out = serve_ctr.main(["--device", "cpu", "--requests", "512"])
    assert out["scores"].shape == (256,) and len(out["latency_ms"]) == 2
    assert ((out["scores"] > 0) & (out["scores"] < 1)).all()
    res = subprocess.run([sys.executable, "-m", "repro_torch.examples.mesh_train", "--mesh",
                          "1x1", "--steps", "2", "--device", "cpu"],
                         env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "comm plan:" in res.stdout and res.stdout.rstrip().endswith("mesh_train OK")
    printed = capsys.readouterr().out
    assert "quickstart OK" in printed and "serve_ctr OK" in printed
    assert "pipeline: 2 fused dispatches over 8 layer executions" in printed
