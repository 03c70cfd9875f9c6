"""The port's streaming training driver (``repro_torch.launch.train``) and
its checkpoints, on the CPU.

* ``run_streaming`` over generated shards, 5 steps, ``--device-feed arena
  --fault-tolerant``, from params copied out of JAX, against the JAX chain
  built from the parts the JAX driver wires (``PipelinedRunner`` +
  ``StreamingLoader`` + ``arena_binding`` + ``make_step``) on the same
  shards: losses to rtol 1e-4, as the plain 5-step chain of
  ``test_torch_train.py`` (dense params are not compared, ROADMAP C6);
  batch, feed and working-set counts exact.
* The CLI prints its loss and summary lines, refuses what is not ported,
  and runs on the card unless asked for the CPU.
* Checkpoints: an async save is a snapshot of the step it was taken at;
  resume reproduces the uninterrupted run's losses exactly.
"""

import dataclasses
import itertools
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import PipelinedRunner as JaxPipelinedRunner  # noqa: E402
from repro.fe import featureplan as jax_featureplan  # noqa: E402
from repro.fe import get_spec as jax_get_spec  # noqa: E402
from repro.io.dataset import ShardDataset as JaxShardDataset  # noqa: E402
from repro.io.stream import StreamingLoader as JaxStreamingLoader  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.train.optimizer import adamw as jax_adamw  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.fe.datagen import write_log_shards  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.optimizer import adamw  # noqa: E402

CPU = torch.device("cpu")
LR = 1e-3
ROWS = 64


def _args(data_dir, *extra):
    return T.parse_args(["--arch", "dlrm-mlperf", "--data-dir", str(data_dir), "--spec", "dlrm",
                         "--device", "cpu", *extra])


def _state(cfg, seed=0):
    params = R.init_params(cfg, torch.Generator().manual_seed(seed))
    _, init = R.make_sparse_train_step(cfg, adamw(LR))
    return {"params": params, "opt": init(params)}


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    write_log_shards(str(d), n_shards=5, rows_per_shard=ROWS, seed=0)
    return d


def test_run_streaming_matches_the_jax_chain(shards):
    steps = 5
    args = _args(shards, "--device-feed", "arena", "--fault-tolerant", "--steps", str(steps))
    spec, jspec = get_arch("dlrm-mlperf"), jax_get_arch("dlrm-mlperf")
    cfg, jcfg = spec.smoke(), jspec.smoke()
    jparams = JR.init_params(jcfg, jax.random.PRNGKey(0))
    params = R.params_from_jax(jparams, CPU)
    _, init = R.make_sparse_train_step(cfg, adamw(LR))
    stats, losses = T.run_streaming(args, spec, cfg, {"params": params, "opt": init(params)},
                                    adamw(LR))

    # the JAX chain, wired as repro.launch.train.run_streaming wires it
    jplan = jax_featureplan.compile(jax_get_spec("dlrm"))
    jds = JaxShardDataset(str(shards))
    jloader = JaxStreamingLoader(jds, workers=2, prefetch=4, epochs=-(-steps // len(jds)),
                                 shuffle=True, seed=0, columns=jplan.required_columns,
                                 ordered=True)
    jmf = jplan.model_feed(dataclasses.replace(jcfg, dedup_capacity=0),
                           split_sparse_fields=True, rows_hint=jloader.rows_hint)
    jraw, jinit, _ = JR.make_sparse_train_step(jmf.config, jax_adamw(LR))
    jab = jplan.arena_binding(split_sparse_fields=True)
    jfeeder = jab.make_feeder(rows_hint=jloader.rows_hint)
    jfused = jmf.make_step(jraw, fence_cb=jfeeder.donation_fence)
    jlosses = []

    def jstep(state, env):
        p, o, m = jfused(state["params"], state["opt"], env)
        jlosses.append(float(m["loss"]))
        return {"params": p, "opt": o}

    jstep.feed_stats = jmf.stats
    jrunner = JaxPipelinedRunner(jab.layers, jstep, prefetch=4, device_feed=jfeeder)
    jrunner.run({"params": jparams, "opt": jinit(jparams)},
                itertools.islice(iter(jloader), steps))
    jloader.close()

    assert len(losses) == steps and all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert stats.batches == jrunner.stats.batches == steps
    for field in ("batches", "bytes_staged", "rewinds", "reallocs", "copies_elided"):
        assert getattr(stats.feed, field) == getattr(jrunner.stats.feed, field), field
    for field in ("steps", "unique_ids", "total_ids", "overflows"):
        assert getattr(stats.train_feed, field) == getattr(jrunner.stats.train_feed, field), field
    assert stats.ingest.shards == steps and stats.fault is not None


def test_cli_prints_loss_and_summary_lines(tmp_path, capsys):
    T.main(["--arch", "dlrm-mlperf", "--data-dir", str(tmp_path), "--gen-shards", "4",
            "--batch", "256", "--spec", "dlrm", "--device-feed", "arena", "--steps", "4",
            "--device", "cpu"])
    out = capsys.readouterr().out
    assert "wrote 4 shards" in out and "plan 'dlrm'" in out
    line = next(ln for ln in out.splitlines() if "mode=streaming" in ln)
    assert "steps=4 loss" in line and "ms/step" in line and "wall=" in line
    for prefix in ("ingest: shards=4", "device-feed: batches=4", "train-feed: steps=4"):
        assert any(ln.startswith(prefix) for ln in out.splitlines()), prefix
    assert "elided=120" in out      # 30 slots x 4 batches written straight into the arena


def test_cli_traces_the_threads_and_survives_a_killed_reader(tmp_path, capsys):
    """--trace exports every thread's spans; --chaos kills a shard reader,
    and the ordered stream still trains every step."""
    import json

    from repro_torch.obs.trace import get_tracer, set_tracer

    trace = tmp_path / "trace.json"
    prev = get_tracer()
    try:
        T.main(["--arch", "dlrm-mlperf", "--data-dir", str(tmp_path / "d"), "--gen-shards", "3",
                "--batch", "32", "--spec", "dlrm", "--device-feed", "arena", "--steps", "3",
                "--device", "cpu", "--fault-tolerant", "--chaos", "kill@1:read",
                "--lease-timeout", "0.2", "--vocab-scale", "0.5", "--trace", str(trace)])
        tracks = set(get_tracer().track_names().values())
    finally:
        set_tracer(prev)
    out = capsys.readouterr().out
    assert "mode=streaming steps=3" in out
    assert "chaos: fired {'kill': 1}" in out and "NOT exhausted" not in out
    assert "fault: completed=3 reissued=1" in out
    assert {"fe-worker", "h2d-feeder"} <= tracks
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"fe.extract", "h2d.stage", "train.step"} <= names


def test_tracer_gives_a_new_thread_its_own_track_when_its_ident_is_reused():
    """A thread started after another one ended often gets the same ident
    (a killed shard reader, then the feeder thread): its spans still land
    on a track named after it."""
    from repro_torch.obs.trace import Tracer

    tracer = Tracer()
    idents = []

    def emit():
        idents.append(threading.get_ident())
        with tracer.span("work"):
            pass

    for i in range(8):
        t = threading.Thread(target=emit, name=f"worker-{i}")
        t.start()
        t.join()
    assert sorted(tracer.track_names().values()) == [f"worker-{i}" for i in range(8)]
    assert len(set(idents)) < len(idents)    # the case above did occur


def test_cli_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    write_log_shards(str(tmp_path), n_shards=1, rows_per_shard=8, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.main(["--arch", "dlrm-mlperf", "--data-dir", str(tmp_path), "--spec", "dlrm",
                "--steps", "1"])


def test_cli_refuses_what_is_not_ported(tmp_path, capsys):
    write_log_shards(str(tmp_path), n_shards=1, rows_per_shard=8, seed=0)
    base = ["--arch", "dlrm-mlperf", "--device", "cpu", "--steps", "1"]
    for flag, item in (("--adapt=eager", "A6"), ("--no-donate", "A6")):
        with pytest.raises(SystemExit):
            T.parse_args(base + [flag])
        assert f"ROADMAP {item}" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="--fault-tolerant"):
        T.main(base + ["--spec", "dlrm", "--data-dir", str(tmp_path), "--chaos", "kill@0"])


def test_capacity_comes_from_the_shards_never_from_batch(tmp_path, capsys):
    """Without a manifest the dataset scan reads the row counts; without
    any row count the step keeps its batch-sized bound (capacity 0). A
    capacity sized from --batch (8 here) would drop ids of 64-row shards."""
    import json

    write_log_shards(str(tmp_path), n_shards=2, rows_per_shard=ROWS, seed=0)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    spec = get_arch("dlrm-mlperf")
    cfg = spec.smoke()
    assert cfg.dedup_capacity            # the smoke config's own capacity is dropped
    args = _args(tmp_path, "--steps", "2", "--batch", "8")
    os.remove(tmp_path / "manifest.json")
    stats, _ = T.run_streaming(args, spec, cfg, _state(cfg), adamw(LR))
    want = dataclasses.replace(cfg, dedup_capacity=0)
    from repro_torch.fe.modelfeed import dedup_capacity_hint
    assert f"(capacity={dedup_capacity_hint(want, ROWS)})" in capsys.readouterr().out
    for entry in manifest["shards"]:
        entry["n_rows"] = 0               # a manifest without row counts
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    stats, losses = T.run_streaming(args, spec, cfg, _state(cfg), adamw(LR))
    assert len(losses) == 2 and stats.train_feed.overflows == 0
    assert "(capacity=0)" in capsys.readouterr().out


def test_async_save_is_a_snapshot_of_its_step(tmp_path):
    """save_async at step k, two more in-place steps before the write runs,
    restore: the state equals step k's, tensor for tensor, in place."""
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import gen_views

    cfg = get_arch("dlrm-mlperf").smoke()
    plan = featureplan.compile(get_spec("dlrm"))
    mf = plan.model_feed(cfg)
    raw, _ = R.make_sparse_train_step(cfg, adamw(LR))
    step = mf.make_step(raw)
    state = _state(cfg)
    envs = [plan.run(gen_views(32, seed=i), device=CPU) for i in range(4)]
    for env in envs[:2]:
        p, o, _ = step(state["params"], state["opt"], env)
        state = {"params": p, "opt": o}
    at_k = {k: v.clone() for k, v in state["params"].items()}
    accum_k, step_k = state["opt"]["embed_accum"].clone(), state["opt"]["dense"]["step"]

    ckpt = CheckpointManager(str(tmp_path), keep=2)
    release = threading.Event()
    save = ckpt.save

    def late_save(*a, **kw):          # the write runs only after two more steps
        assert release.wait(30)
        return save(*a, **kw)

    ckpt.save = late_save
    ckpt.save_async(1, state)
    for env in envs[2:]:
        p, o, _ = step(state["params"], state["opt"], env)
        state = {"params": p, "opt": o}
    release.set()
    ckpt.wait()
    embed = state["params"]["embed"]
    assert not torch.equal(embed, at_k["embed"])
    step_no, restored = ckpt.restore_latest(state)
    assert step_no == 1 and restored["params"]["embed"] is embed      # written in place
    for k, v in at_k.items():
        assert torch.equal(state["params"][k], v), k
    assert torch.equal(state["opt"]["embed_accum"], accum_k)
    assert restored["opt"]["dense"]["step"] == step_k == 2
    assert sorted(os.listdir(tmp_path)) == ["manifest.json", "step_0000000001"]
    with pytest.raises(ValueError, match="shape"):
        bad = dict(state["params"], embed=torch.zeros(3, 3))
        ckpt.restore(1, {"params": bad, "opt": state["opt"]})


def test_checkpoint_retention_and_stale_temp_sweep(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(4.0), "n": 3}
    for s in range(4):
        ckpt.save(s, tree)
    assert ckpt.latest_step() == 3
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) == \
        ["step_0000000002", "step_0000000003"]
    os.makedirs(tmp_path / ".tmp_step_0000000009_h0")
    assert CheckpointManager(str(tmp_path)).stats["stale_tmp_swept"] == 1
    with pytest.raises(ValueError, match="keep"):
        CheckpointManager(str(tmp_path), keep=0)


def test_resume_reproduces_the_uninterrupted_losses(shards, tmp_path, capsys):
    spec = get_arch("dlrm-mlperf")
    cfg = spec.smoke()
    common = ("--device-feed", "arena", "--fault-tolerant", "--checkpoint-every", "3")
    _, whole = T.run_streaming(
        _args(shards, *common, "--steps", "6", "--checkpoint-dir", str(tmp_path / "a")),
        spec, cfg, _state(cfg), adamw(LR))
    _, first = T.run_streaming(
        _args(shards, *common, "--steps", "3", "--checkpoint-dir", str(tmp_path / "b")),
        spec, cfg, _state(cfg), adamw(LR))
    _, rest = T.run_streaming(
        _args(shards, *common, "--steps", "3", "--checkpoint-dir", str(tmp_path / "b"),
              "--resume"),
        spec, cfg, _state(cfg, seed=1), adamw(LR))
    assert "resume: restored step 2" in capsys.readouterr().out
    assert first == whole[:3]
    assert rest == whole[3:]
