"""The port's in-memory training path (``train/loop.py`` and the driver's
branch without ``--data-dir``) against the JAX package, on the CPU.

* ``synthetic_batch`` is the JAX driver's draws bit for bit.
* ``run_training`` over ``synthetic_batch`` steps from JAX's params: losses
  to rtol 1e-4, as the streaming chain of ``test_torch_driver.py`` (fp32
  sums in another order, compounded over the steps; dense params are not
  compared, ROADMAP C6); the ``LoopStats`` fields as JAX's.
* ``finalize`` runs when a step raises; a restart from the checkpoint of
  step k reproduces the uninterrupted losses exactly; the FE layers and the
  spans of the loop.
* The CLI trains each ported arch, prints the JAX driver's loss line,
  refuses what JAX refuses without ``--data-dir``, and runs on the card
  unless asked for the CPU.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch.train import synthetic_batch as jax_synthetic_batch  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.train.loop import LoopConfig as JaxLoopConfig  # noqa: E402
from repro.train.loop import LoopStats as JaxLoopStats  # noqa: E402
from repro.train.loop import run_training as jax_run_training  # noqa: E402
from repro.train.optimizer import adamw as jax_adamw  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.loop import LoopConfig, LoopStats, run_training  # noqa: E402
from repro_torch.train.optimizer import adamw  # noqa: E402

CPU = torch.device("cpu")
LR = 1e-3
ARCHS = ("dlrm-mlperf", "dcn-v2", "autoint", "bst")


def _args(arch, *extra):
    return T.parse_args(["--arch", arch, "--device", "cpu", *extra])


def _state(cfg, params):
    return {"params": params, "opt": R.make_sparse_train_step(cfg, adamw(LR))[1](params)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("width", ["smoke", "published"])
def test_synthetic_batch_is_jaxs_bit_for_bit(arch, width):
    spec, jspec = get_arch(arch), jax_get_arch(arch)
    cfg = spec.smoke() if width == "smoke" else spec.config
    jcfg = (jspec.smoke() if width == "smoke"
            else importlib.import_module(f"repro.configs.{arch.replace('-', '_')}").CONFIG)
    for step in (0, 7):
        got = T.synthetic_batch("recsys", cfg, 48, step, device=CPU)
        want = jax_synthetic_batch("recsys", jcfg, 48, step)
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].numpy().dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    assert ("dense" in got) == bool(cfg.n_dense)


def test_synthetic_batch_refuses_what_is_not_ported():
    cfg = get_arch("dlrm-mlperf").smoke()
    with pytest.raises(SystemExit, match="no synthetic batches for the 'vision' family"):
        T.synthetic_batch("vision", cfg, 8, 0, device=CPU)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_matches_jax(arch):
    """The driver's in-memory run (``run_in_memory``: ``run_training`` over
    ``synthetic_batch`` with the sparse step) against JAX's ``run_training``
    wired as the JAX driver wires it, from JAX's params."""
    steps, batch = 5, 64
    spec, jspec = get_arch(arch), jax_get_arch(arch)
    cfg, jcfg = spec.smoke(), jspec.smoke()
    jparams = JR.init_params(jcfg, jax.random.PRNGKey(0))
    stats, losses = T.run_in_memory(_args(arch, "--steps", str(steps), "--batch", str(batch)),
                                    spec, cfg, _state(cfg, R.params_from_jax(jparams, CPU)),
                                    adamw(LR))
    jstep_fn, jinit, _ = JR.make_sparse_train_step(jcfg, jax_adamw(LR))
    jstep = jax.jit(jstep_fn)

    def step_wrapper(state, b):
        p, o, m = jstep(state["params"], state["opt"], b)
        return {"params": p, "opt": o}, m

    _, jstats = jax_run_training(
        cfg=JaxLoopConfig(n_steps=steps), state={"params": jparams, "opt": jinit(jparams)},
        train_step=step_wrapper,
        batch_source=lambda s: jax_synthetic_batch("recsys", jcfg, batch, s))
    assert isinstance(stats, LoopStats) and losses == stats.losses
    np.testing.assert_allclose(stats.losses, jstats.losses, rtol=1e-4)
    assert stats.steps == jstats.steps == steps and stats.restarts == jstats.restarts == 0
    assert stats.fe_seconds > 0 and stats.train_seconds > 0
    assert [f.name for f in dataclasses.fields(LoopStats)] == \
        [f.name for f in dataclasses.fields(JaxLoopStats)]
    jax_loop_fields = {f.name: f.default for f in dataclasses.fields(JaxLoopConfig)}
    for f in dataclasses.fields(LoopConfig):      # the fields the loop reads, JAX's defaults
        assert f.name in jax_loop_fields and f.default == jax_loop_fields[f.name], f.name
    assert [f.name for f in dataclasses.fields(LoopConfig)] == \
        ["n_steps", "checkpoint_every", "checkpoint_dir"]
    assert stats.as_metrics().keys() == jstats.as_metrics().keys() == \
        {"steps", "restarts", "fe_seconds", "train_seconds"}


def test_finalize_runs_when_a_step_raises(tmp_path):
    calls = []

    def step(state, batch):
        if batch["i"] == 2:
            raise RuntimeError("step failed")
        return state, {"loss": torch.tensor(1.0)}

    with pytest.raises(RuntimeError, match="step failed"):
        run_training(cfg=LoopConfig(n_steps=5, checkpoint_dir=str(tmp_path)),
                     state={"w": torch.zeros(2)}, train_step=step,
                     batch_source=lambda s: {"i": s}, finalize=lambda: calls.append(1))
    assert calls == [1]
    assert CheckpointManager(str(tmp_path)).latest_step() is None   # no final save
    _, stats = run_training(cfg=LoopConfig(n_steps=2), state={"w": torch.zeros(2)},
                            train_step=step, batch_source=lambda s: {"i": s},
                            finalize=lambda: calls.append(2))
    assert calls == [1, 2] and stats.steps == 2 and stats.losses == [1.0, 1.0]


def test_loop_trains_and_restarts(tmp_path):
    """JAX's own loop test (``tests/test_train.py``) on the port: a linear
    regression trains, and a second run over the same directory resumes
    from the latest checkpoint and runs only the remaining steps."""
    def batch_source(step):
        x = np.random.default_rng(step).normal(size=(16, 4)).astype(np.float32)
        return {"x": torch.from_numpy(x), "y": torch.from_numpy(x.sum(1))}

    def train_step(state, batch):
        w = state["w"].detach().requires_grad_(True)
        loss = ((batch["x"] @ w - batch["y"]) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [w])
        state["w"].sub_(0.2 * g)
        return state, {"loss": loss.detach()}

    cfg = LoopConfig(n_steps=30, checkpoint_every=10, checkpoint_dir=str(tmp_path))
    state, stats = run_training(cfg=cfg, state={"w": torch.zeros(4)}, train_step=train_step,
                                batch_source=batch_source)
    assert stats.steps == 30 and stats.losses[-1] < stats.losses[0]
    again = {"w": torch.zeros(4)}
    state2, stats2 = run_training(
        cfg=LoopConfig(n_steps=40, checkpoint_every=10, checkpoint_dir=str(tmp_path)),
        state=again, train_step=train_step, batch_source=batch_source)
    assert stats2.restarts == 1 and stats2.steps == 40 - 30
    assert state2["w"] is again["w"]              # restored in place


@pytest.mark.parametrize("arch", ARCHS)
def test_restart_reproduces_the_uninterrupted_losses(arch, tmp_path):
    """The driver's in-memory run of 6 steps, checkpointing every 3, against
    a run of 3 steps and a restart from its checkpoint (other initial
    params, overwritten by the restore): the same losses, exactly."""
    spec = get_arch(arch)
    cfg = spec.smoke()

    def run(steps, ckpt_dir, seed=0):
        params = R.init_params(cfg, torch.Generator().manual_seed(seed))
        args = _args(arch, "--steps", str(steps), "--checkpoint-every", "3",
                     "--checkpoint-dir", str(ckpt_dir))
        return T.run_in_memory(args, spec, cfg, _state(cfg, params), adamw(LR))

    whole = run(6, tmp_path / "a")[1]
    first_stats, first = run(3, tmp_path / "b")
    rest_stats, rest = run(6, tmp_path / "b", seed=1)
    assert first_stats.restarts == 0 and rest_stats.restarts == 1 and rest_stats.steps == 3
    assert first == whole[:3] and rest == whole[3:]
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 5


def test_fe_layers_run_on_each_batch_and_the_loop_traces_its_spans():
    """With ``fe_layers`` the loop runs the FE schedule on each raw batch
    (the env equals ``plan.run`` of the same views), and with a tracer on it
    emits one ``fe.batch`` and one ``train.step`` span per step."""
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import gen_views
    from repro_torch.obs.trace import Tracer, get_tracer, set_tracer

    plan = featureplan.compile(get_spec("dlrm"))
    seen = []

    def step(state, env):
        seen.append({k: env[k].clone() for k in plan.output_slots})
        return state, {}

    prev = get_tracer()
    set_tracer(Tracer(enabled=True))
    try:
        _, stats = run_training(cfg=LoopConfig(n_steps=2), state={}, train_step=step,
                                batch_source=lambda s: gen_views(16, seed=s),
                                fe_layers=plan.layers, device=CPU)
        names = [e["name"] for e in get_tracer().to_dict()["traceEvents"] if e["ph"] == "B"]
    finally:
        set_tracer(prev)
    assert stats.steps == 2 and stats.losses == []
    for s, env in enumerate(seen):
        want = plan.run(gen_views(16, seed=s), device=CPU)
        for k in plan.output_slots:
            assert torch.equal(env[k], want[k]), k
    assert names.count("fe.batch") == 2 and names.count("train.step") == 2
    with pytest.raises(ValueError, match="device"):
        run_training(cfg=LoopConfig(n_steps=1), state={}, train_step=step,
                     batch_source=lambda s: gen_views(16, seed=s), fe_layers=plan.layers)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_in_memory_and_the_loss_falls(arch, capsys):
    T.main(["--arch", arch, "--steps", "4", "--batch", "256", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"arch={arch} steps=4 loss ") and "ms/step)" in line
    first, last = (float(x) for x in line.split(" loss ")[1].split(" (")[0].split(" -> "))
    assert last < first


def test_cli_in_memory_refusals_and_device(monkeypatch):
    base = ["--arch", "dcn-v2", "--device", "cpu", "--steps", "1"]
    for flag in ("--resume", "--fault-tolerant", "--chaos=kill@0"):
        with pytest.raises(SystemExit, match="pass --data-dir"):
            T.main(base + [flag])
    with pytest.raises(SystemExit, match="--embedding hierarchy runs on the streaming"):
        T.main(base + ["--embedding", "hierarchy"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.main(["--arch", "dcn-v2", "--steps", "1"])
