"""The whole serving slice on the CPU, JAX against the port: raw views ->
FeaturePlan (dlrm) -> ModelFeed.apply -> serve_step, with JAX's parameters
carried across. Logits to rtol 1e-4 / atol 1e-5 (fp32 sums in another
order); the FE ids in between must be equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.fe import featureplan as jax_featureplan  # noqa: E402
from repro.fe import get_spec as jax_get_spec  # noqa: E402
from repro.fe.datagen import gen_views as jax_gen_views  # noqa: E402
from repro.models import recsys as JR  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.metakernel import ExecutionStats  # noqa: E402
from repro_torch.fe import featureplan, get_spec  # noqa: E402
from repro_torch.fe.datagen import gen_views  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402


@pytest.mark.parametrize("seed", [0, 5])
def test_views_to_pctr_matches_jax(seed):
    jcfg, cfg = jax_get_arch("dlrm-mlperf").smoke(), get_arch("dlrm-mlperf").smoke()
    jplan, plan = jax_featureplan.compile(jax_get_spec("dlrm")), featureplan.compile(get_spec("dlrm"))
    jfeed, feed = jplan.model_feed(jcfg, rows_hint=64), plan.model_feed(cfg, rows_hint=64)
    jparams = JR.init_params(jcfg, jax.random.PRNGKey(seed))
    params = R.params_from_jax(jparams, "cpu")

    jbatch = jfeed.apply(jfeed.select(jplan.run(jax_gen_views(64, seed=seed))))
    (scores,), (lat,) = serve.serve_requests(
        plan, feed, params, cfg, [gen_views(64, seed=seed)], device=torch.device("cpu"))
    batch = feed.apply(feed.select(plan.run(gen_views(64, seed=seed), device="cpu")))
    np.testing.assert_array_equal(batch["sparse"].numpy(), np.asarray(jbatch["sparse"]))
    np.testing.assert_allclose(R.forward(params, cfg, batch).numpy(),
                               np.asarray(JR.forward(jparams, jcfg, jbatch)),
                               rtol=1e-4, atol=1e-5)
    want = np.asarray(JR.serve_step(jparams, jcfg, jbatch))
    assert scores.shape == (64,) and lat > 0
    np.testing.assert_allclose(scores.numpy(), want, rtol=1e-4, atol=1e-5)


def test_serve_requests_counts_one_fe_dispatch_per_batch():
    cfg = get_arch("dlrm-mlperf").smoke()
    plan = featureplan.compile(get_spec("dlrm"))
    params = R.init_params(cfg, torch.Generator().manual_seed(0))
    stats = ExecutionStats()
    scores, lat = serve.serve_requests(
        plan, plan.model_feed(cfg), params, cfg,
        (gen_views(16, seed=i) for i in range(3)), device=torch.device("cpu"), stats=stats)
    assert len(scores) == len(lat) == 3
    assert stats.n_device_dispatches == 3
    assert all(torch.isfinite(s).all() and s.shape == (16,) for s in scores)


def test_serve_main_runs_on_cpu(capsys):
    serve.main(["--arch", "dlrm-mlperf", "--requests", "64", "--batch", "32",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=dlrm-mlperf device=cpu batches=2 batch=32" in out
    assert "fe_dispatches=2" in out


def test_serve_main_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "dlrm-mlperf", "--requests", "64"])
