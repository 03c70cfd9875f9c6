"""The port's static checks against the JAX package's, on the CPU.

* ``run_check(..., device="cpu")`` gives JAX's ``run_check`` analyzers,
  rule ids, severities and counts for the three preset x arch pairs, and
  the same exit contract (CLI included);
* every broken-plan negative of ``tests/test_check_{aliasing,planverify,
  report}.py`` runs through both packages and hits the same rule the same
  number of times; the effects negatives have torch forms (a host sync for
  JAX's effects, the in-place update for its donation) that hit the rule
  JAX's do;
* the planverify abstract environment equals JAX's ``abstract_flow`` slot
  by slot;
* the aliasing properties of ``tests/test_check_aliasing_property.py``
  hold for the port (``hypothesis``, no example database);
* the driver's ``--check`` and ``--metrics`` give the JAX driver's metric
  keys, and the flags change no loss.

Location strings are compared where a negative reports one: they are the
JAX package's except the kernel planner's, ``.../mempool_kernel`` for
JAX's ``.../pallas_kernel``.
"""

import collections
import dataclasses
import json
import pathlib
import sys
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

import jax  # noqa: E402,F401

from repro.check import aliasing as jax_aliasing  # noqa: E402
from repro.check import planverify as jax_planverify  # noqa: E402
from repro.check import run_check as jax_run_check  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core.devicefeed import FeedLayout as JaxFeedLayout  # noqa: E402
from repro.core.devicefeed import SlotSpec as JaxSlotSpec  # noqa: E402
from repro.fe import featureplan as jax_featureplan  # noqa: E402
from repro.fe import get_spec as jax_get_spec  # noqa: E402

from repro_torch.check import (  # noqa: E402
    Finding,
    Report,
    aliasing,
    effects,
    planverify,
    run_check,
)
from repro_torch.check.__main__ import main as check_main  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.devicefeed import FeedLayout, SlotSpec  # noqa: E402
from repro_torch.core.mempool import ALIGN, ArenaPool, align_up  # noqa: E402
from repro_torch.fe import featureplan, get_spec  # noqa: E402
from repro_torch.fe.datagen import write_log_shards  # noqa: E402
from repro_torch.fe.spec import Hash, SparseOutput  # noqa: E402
from repro_torch.kernels.feature_hash.ops import OPS_PER_LAUNCH  # noqa: E402
from repro_torch.kernels.mempool_alloc import ops as alloc_ops  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (JAX-free; its mutants are held here on the CPU)

PAIRS = [("ads_ctr", "dlrm-mlperf"), ("dlrm", "dlrm-mlperf"), ("bst", "bst")]


def _rules(findings):
    return sorted({f.rule for f in findings})


def _counts(findings):
    return collections.Counter((f.rule, f.severity) for f in findings)


# --------------------------------------------------------------- run_check
@pytest.mark.parametrize("preset,arch", PAIRS)
def test_run_check_reports_jaxs_rules(preset, arch):
    port, jax_r = run_check(preset, arch, device="cpu"), jax_run_check(preset, arch)
    assert port.crashed == jax_r.crashed == {}
    assert sorted(port.analyzers_run) == sorted(jax_r.analyzers_run) == \
        ["aliasing", "effects", "lockset", "plan"]
    assert _counts(port.findings) == _counts(jax_r.findings)
    # no location string differs: the port names plans, layers, layouts and
    # steps as the JAX package does
    assert sorted(f.location for f in port.findings) == sorted(f.location for f in jax_r.findings)
    assert port.exit_code == jax_r.exit_code == 0, "\n".join(f.render() for f in port.findings)
    assert port.as_metrics().keys() == jax_r.as_metrics().keys()


def test_run_check_runs_the_kernel_planner():
    before = alloc_ops.alloc_offsets.launches
    calls = []
    real = aliasing.plan_block

    def spy(sizes, **kw):
        calls.append(kw)
        return real(sizes, **kw)

    with mock.patch.object(aliasing, "plan_block", spy):
        r = run_check("dlrm", "dlrm-mlperf", analyzers=("aliasing",), device="cpu")
    assert r.exit_code == 0 and len(calls) == 2          # packed and split layouts
    assert all(kw["device"] == "cpu" for kw in calls)
    assert alloc_ops.alloc_offsets.launches == before    # the CPU takes the plain version


def test_run_check_records_compile_crash_as_exit_1():
    r, j = run_check("no-such-preset", "dlrm-mlperf", device="cpu"), \
        jax_run_check("no-such-preset", "dlrm-mlperf")
    assert r.exit_code == j.exit_code == 1
    assert "compile" in r.crashed and "compile" in j.crashed


def test_run_check_kernel_failure_is_a_crash_not_a_skipped_oracle():
    def broken(sizes, **kw):
        raise RuntimeError("nvcc failed")

    with mock.patch.object(aliasing, "plan_block", broken):
        r = run_check("dlrm", "dlrm-mlperf", analyzers=("aliasing",), device="cpu")
    assert r.exit_code == 1 and "nvcc failed" in r.crashed["aliasing"]


def test_cli_exit_contract(capsys, monkeypatch):
    base = ["--preset", "dlrm", "--arch", "dlrm-mlperf", "--device", "cpu"]
    assert check_main(base + ["--analyzers", "plan,aliasing"]) == 0
    assert "repro_torch.check: 2 analyzers, 0 errors" in capsys.readouterr().out
    assert check_main(base + ["--json"]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["exit_code"] == 0 and d["analyzers"] == ["lockset", "plan", "aliasing", "effects"]
    with monkeypatch.context() as m:   # an error finding: exit 2
        m.setattr(aliasing, "check_ring", lambda *a, **k: [Finding(
            rule="AL206", severity="error", location="x", message="m")])
        assert check_main(base + ["--analyzers", "aliasing"]) == 2
    with monkeypatch.context() as m:   # an analyzer crash: exit 1
        m.setattr(planverify, "verify_plan", lambda *a, **k: 1 / 0)
        assert check_main(base + ["--analyzers", "plan"]) == 1
    capsys.readouterr()
    with pytest.raises(SystemExit):
        check_main(base + ["--analyzers", "plan,nope"])
    assert "unknown analyzers" in capsys.readouterr().err


def test_cli_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert check_main(["--preset", "dlrm", "--arch", "dlrm-mlperf",
                       "--analyzers", "aliasing"]) == 1     # resolve_device raises


def test_report_contract_matches_jax():
    from repro.check import Finding as JaxFinding
    from repro.check import Report as JaxReport

    for fcls, rcls in ((Finding, Report), (JaxFinding, JaxReport)):
        with pytest.raises(ValueError):
            fcls(rule="PV101", severity="fatal", location="x", message="m")
        r = rcls()
        r.record_analyzer("plan", [fcls(rule="PV101", severity=s, location="here",
                                        message="m", hint="h")
                                   for s in ("error", "warning", "info")])
        assert r.exit_code == 2
        m = r.as_metrics()
        assert (m["errors"], m["warnings"], m["infos"], m["findings"]) == (1, 1, 1, 3)
        r.record_crash("effects", RuntimeError("boom"))
        assert r.exit_code == 1
        assert json.loads(r.to_json())["n_errors"] == 1


# --------------------------------------------------------- aliasing (AL2xx)
PLAN_CASES = {     # (sizes, offsets, total, align) -> rules, from test_check_aliasing.py
    "al201 overlap": (([256, 256], [0, 128], 512, ALIGN), ["AL201"]),
    "al201 overrun": (([128, 256], [0, 128], 256, ALIGN), ["AL201"]),
    "al201 unordered": (([256, 256], [128, 0], 512, ALIGN), ["AL201"]),
    "al202 offset": (([64], [8], 128, ALIGN), ["AL202"]),
    "al202 total": (([64], [0], 100, ALIGN), ["AL202"]),
    "al202 custom clean": (([64], [8], 128, 8), []),
    "al202 custom": (([64], [4], 128, 8), ["AL202"]),
    "al203 negative": (([-1], [0], 128, ALIGN), ["AL203"]),
    "al203 int32": (([2**31], [0], 2**31 + 128, ALIGN), ["AL203"]),
    "al204 count": (([64, 64], [0], 128, ALIGN), ["AL204"]),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_check_plan_negatives_match_jax(case):
    (sizes, offsets, total, align), want = PLAN_CASES[case]
    got = aliasing.check_plan(sizes, offsets, total, align=align)
    jgot = jax_aliasing.check_plan(sizes, offsets, total, align=align)
    assert want == [] or set(want) <= set(_rules(got))
    assert [(f.rule, f.severity, f.location, f.message) for f in got] == \
        [(f.rule, f.severity, f.location, f.message) for f in jgot]


@pytest.mark.parametrize("plans,want", [
    ({"a": ([0, 128], 256), "b": ([0, 256], 384)}, ["AL204"]),
    ({"a": ([0, 128], 256), "b": ([0, 128], 256)}, []),
])
def test_check_agreement_matches_jax(plans, want):
    got = aliasing.check_agreement(plans)
    assert _rules(got) == want == _rules(jax_aliasing.check_agreement(plans))


RING_CASES = {      # kwargs -> (rules, severities), from test_check_aliasing.py
    "al205 zero buffers": (dict(buffers=0), ["AL205"]),
    "al205 under-provisioned": (dict(buffers=2, queue_capacity=2, donate=False), ["AL205"]),
    "al206 fence unreachable": (dict(buffers=1, queue_capacity=1), ["AL205", "AL206"]),
    "al206 without donation": (dict(buffers=1, queue_capacity=1, donate=False), ["AL205"]),
}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_check_ring_negatives_match_jax(case):
    kw, want = RING_CASES[case]
    got, jgot = aliasing.check_ring(None, -1, **kw), jax_aliasing.check_ring(None, -1, **kw)
    assert _rules(got) == want == _rules(jgot)
    assert _counts(got) == _counts(jgot)


def test_al203_overflowing_layout_reports_instead_of_crashing():
    got = aliasing.check_feed_layout(FeedLayout(slots=(SlotSpec("huge", 2**22, "float32"),)),
                                     rows=2**10, device="cpu")
    jgot = jax_aliasing.check_feed_layout(
        JaxFeedLayout(slots=(JaxSlotSpec("huge", 2**22, "float32"),)), rows=2**10)
    assert _rules(got) == _rules(jgot) == ["AL203"]


@pytest.mark.parametrize("preset", ["ads_ctr", "dlrm", "bst"])
@pytest.mark.parametrize("split", [False, True])
def test_compiled_layouts_pass_the_tri_oracle(preset, split):
    layout = featureplan.compile(get_spec(preset)).feed_layout(split_sparse_fields=split)
    findings = aliasing.check_feed_layout(layout, rows=64, device="cpu")
    assert findings == [], "\n".join(f.render() for f in findings)
    assert aliasing.check_ring(layout, 64, buffers=3) == []


def test_hand_built_layout_tri_oracle():
    layout = FeedLayout(slots=(SlotSpec("a", 3, "float32"), SlotSpec("b", 1, "int64", rank1=True),
                               SlotSpec("c", 17, "int32")))
    assert aliasing.check_feed_layout(layout, rows=33, device="cpu") == []


def test_corrupt_plan_offsets_detected_against_oracle():
    layout = FeedLayout(slots=(SlotSpec("a", 4, "float32"), SlotSpec("b", 4, "float32")))
    offsets, total = layout.plan(16)
    bad = np.array(offsets)
    bad[1] = 0  # collide with slot a
    assert "AL201" in _rules(aliasing.check_plan(layout.sizes(16), list(bad), total,
                                                 names=layout.slot_names))


def test_kernel_plan_moved_by_128_is_al204():
    """The mutant ``chip_smoke.py`` runs on the card: one offset of the
    kernel planner's plan moved by 128 disagrees with the other planners."""
    layout = featureplan.compile(get_spec("dlrm")).feed_layout(split_sparse_fields=True)
    real = aliasing.plan_block

    def moved(sizes, **kw):
        offsets, total = real(sizes, **kw)
        offsets = offsets.copy()
        offsets[1] += 128
        return offsets, total

    with mock.patch.object(aliasing, "plan_block", moved):
        findings = aliasing.check_feed_layout(layout, rows=64, device="cpu", location="x")
    assert "AL204" in _rules(findings)
    assert any(f.location == "x/mempool_kernel" for f in findings)


def test_multi_tile_layout_is_clean():
    """20,000 slots: more requests than one block of the kernel scans
    (8,192), so on the card the planner takes its multi-block form."""
    layout = FeedLayout(slots=tuple(SlotSpec(f"s{i:05d}", 1 + i % 7, "float32", rank1=i % 7 == 0)
                                    for i in range(20_000)))
    assert aliasing.check_feed_layout(layout, rows=3, device="cpu") == []


_DTYPES = ("float32", "int32", "int64", "float64", "uint8")


@st.composite
def layouts(draw):
    n = draw(st.integers(min_value=1, max_value=8))
    slots = []
    for i in range(n):
        width = draw(st.integers(min_value=1, max_value=64))
        rank1 = draw(st.booleans())
        slots.append(SlotSpec(f"slot{i:02d}", 1 if rank1 else width,
                              draw(st.sampled_from(_DTYPES)), rank1=rank1))
    return FeedLayout(slots=tuple(slots))


@hypothesis.settings(max_examples=60, deadline=None, database=None)
@hypothesis.given(layout=layouts(), rows=st.integers(min_value=0, max_value=4096))
def test_analyzer_passes_every_valid_layout(layout, rows):
    findings = aliasing.check_feed_layout(layout, rows, device="cpu")
    assert findings == [], "\n".join(f.render() for f in findings)


@hypothesis.settings(max_examples=60, deadline=None, database=None)
@hypothesis.given(layout=layouts(), rows=st.integers(min_value=0, max_value=4096))
def test_shadow_plan_matches_arena_pool_and_planners(layout, rows):
    sizes = layout.sizes(rows)
    offsets, end = aliasing._shadow_plan(sizes, layout.align)
    total = align_up(end, layout.align)
    assert [a.offset for a in ArenaPool(total, align=layout.align).alloc_block(sizes)] == offsets
    plan_offsets, plan_total = layout.plan(rows)
    assert list(np.asarray(plan_offsets)) == offsets
    k_offsets, k_total = layout.plan(rows, use_kernel=True, device="cpu")
    assert list(k_offsets) == offsets
    assert int(plan_total) == k_total == total == layout.arena_bytes(rows)


@hypothesis.settings(max_examples=60, deadline=None, database=None)
@hypothesis.given(sizes=st.lists(st.integers(min_value=0, max_value=1 << 20),
                                 min_size=1, max_size=10))
def test_shadow_plan_invariants_hold_for_raw_sizes(sizes):
    offsets, end = aliasing._shadow_plan(sizes, ALIGN)
    assert aliasing.check_plan(sizes, offsets, align_up(end, ALIGN)) == []


@hypothesis.settings(max_examples=40, deadline=None, database=None)
@hypothesis.given(
    sizes=st.lists(st.integers(min_value=1, max_value=1 << 16), min_size=2, max_size=8),
    victim=st.integers(min_value=1, max_value=7),
    shift=st.integers(min_value=1, max_value=ALIGN - 1))
def test_any_offset_perturbation_is_caught(sizes, victim, shift):
    offsets, end = aliasing._shadow_plan(sizes, ALIGN)
    bad = list(offsets)
    bad[victim % len(sizes)] -= shift
    findings = aliasing.check_plan(sizes, bad, align_up(end, ALIGN))
    assert findings and {f.rule for f in findings} <= {"AL201", "AL202"}
    assert _counts(findings) == _counts(jax_aliasing.check_plan(sizes, bad, align_up(end, ALIGN)))


# ------------------------------------------------------ planverify (PV1xx)
@pytest.fixture(scope="module")
def plans():
    """``ads_ctr`` x the ``dlrm-mlperf`` smoke config, in both packages:
    ``{pkg: (planverify, plan, model feed, its feed layout)}``."""
    out = {}
    for pkg, pv, fp, spec, arch in (
            ("port", planverify, featureplan, get_spec, get_arch),
            ("jax", jax_planverify, jax_featureplan, jax_get_spec, jax_get_arch)):
        plan = fp.compile(spec("ads_ctr"))
        mf = plan.model_feed(arch("dlrm-mlperf").smoke(), split_sparse_fields=True)
        out[pkg] = (pv, plan, mf, plan.feed_layout(split_sparse_fields=mf.split))
    return out


def _swap_layer(plan, target, new):
    return dataclasses.replace(plan, layers=[new if e is target else e for e in plan.layers])


def _pv102(pv, plan, mf, fl):
    target = [ex for ex in plan.layers if len(ex.layer_indices) > 1][-1]
    alien = [p for ex in plan.layers for p in ex.host_ops
             if plan.schedule.depth_of[p.op.name] != target.layer_indices[0]]
    return pv.check_placement(_swap_layer(plan, target,
                                          dataclasses.replace(target, host_ops=(alien[0],))))


def _pv103_unproducible(pv, plan, mf, fl):
    last = plan.layers[-1]
    bad = dataclasses.replace(last, device_input_slots=("mystery_slot",)
                              + tuple(last.device_input_slots))
    return pv.abstract_flow(_swap_layer(plan, last, bad), 8)[1]


def _pv103_broken_fn(pv, plan, mf, fl):
    def broken_fn(env):
        raise TypeError("shape contract violated")

    first = next(ex for ex in plan.layers if ex.fused_fn is not None)
    broken = _swap_layer(plan, first, dataclasses.replace(first, fused_fn=broken_fn))
    return pv.abstract_flow(broken, 8)[1]


def _pv103_duplicate(pv, plan, mf, fl):
    dup = [ex for ex in plan.layers if ex.fused_fn is not None][0]
    return pv.abstract_flow(dataclasses.replace(plan, layers=list(plan.layers) + [dup]), 8)[1]


def _pv104(drop_view):
    def case(pv, plan, mf, fl):
        rc = {v: tuple(cols) for v, cols in plan.required_columns.items()}
        view = sorted(v for v, cols in rc.items() if cols)[0]
        if drop_view:
            rc.pop(view)
        else:
            rc[view] = rc[view][:-1]
        return pv.verify_plan(dataclasses.replace(plan, required_columns=rc), rows=8)
    return case


def _pv105_vocab(edit):
    def case(pv, plan, mf, fl):
        vocab = np.array(mf.vocab).copy()
        return pv.verify_model_feed(dataclasses.replace(mf, vocab=edit(vocab)), fl)
    return case


def _pv105_source(pv, plan, mf, fl):
    sources = np.array(mf.field_sources).copy()
    sources[0] = mf.n_spec_fields + 5
    return pv.verify_model_feed(dataclasses.replace(mf, field_sources=sources), fl)


def _zero_first(v):
    v[0] = 0
    return v


PV_CASES = {   # the negatives of tests/test_check_planverify.py -> the rule they hit
    "pv101 phantom seq": (lambda pv, plan, mf, fl: pv.verify_plan(dataclasses.replace(
        plan, layout=dataclasses.replace(plan.layout, seq_len=7)), rows=8), ["PV101"]),
    "pv101 width": (lambda pv, plan, mf, fl: pv.verify_plan(dataclasses.replace(
        plan, layout=dataclasses.replace(plan.layout, n_dense_feats=plan.layout.n_dense_feats + 3)),
        rows=8), ["PV101"]),
    "pv101 undeclared": (lambda pv, plan, mf, fl: pv.verify_plan(dataclasses.replace(
        plan, layout=dataclasses.replace(plan.layout, n_sparse_fields=0)), rows=8), ["PV101"]),
    "pv102 host op inside": (_pv102, ["PV102"]),
    "pv102 barrier legal": (lambda pv, plan, mf, fl: pv.check_placement(plan), []),
    "pv102 singles exempt": (lambda pv, plan, mf, fl: pv.check_placement(dataclasses.replace(
        plan, layers=[ex for ex in plan.layers if len(ex.layer_indices) == 1])), []),
    "pv103 unproducible": (_pv103_unproducible, ["PV103"]),
    "pv103 tracing failure": (_pv103_broken_fn, ["PV103"]),
    "pv103 duplicate": (_pv103_duplicate, ["PV103"]),
    "pv104 column": (_pv104(False), ["PV104"]),
    "pv104 view": (_pv104(True), ["PV104"]),
    "pv104 superset legal": (lambda pv, plan, mf, fl: pv.verify_plan(dataclasses.replace(
        plan, required_columns={v: tuple(c) + ("extra_unused_col",)
                                for v, c in plan.required_columns.items()}), rows=8), []),
    "pv105 modulo > table": (_pv105_vocab(lambda v: v * 1000), ["PV105"]),
    "pv105 truncated": (_pv105_vocab(lambda v: v[:2]), ["PV105"]),
    "pv105 nonpositive": (_pv105_vocab(_zero_first), ["PV105"]),
    "pv105 source": (_pv105_source, ["PV105"]),
    "pv106 unstaged": (lambda pv, plan, mf, fl: pv.verify_model_feed(dataclasses.replace(
        mf, slots=tuple(mf.slots) + ("batch_phantom",)), fl), ["PV106"]),
    "pv106 packed satisfies split": (lambda pv, plan, mf, fl: pv.verify_model_feed(
        mf, plan.feed_layout(split_sparse_fields=False)), []),
}


@pytest.mark.parametrize("case", sorted(PV_CASES))
def test_planverify_negatives_match_jax(plans, case):
    fn, want = PV_CASES[case]
    got, jgot = fn(*plans["port"]), fn(*plans["jax"])
    assert _rules(got) == want == _rules(jgot), "\n".join(f.render() for f in got)
    assert _counts(got) == _counts(jgot)
    assert [f.location for f in got] == [f.location for f in jgot]


@pytest.mark.parametrize("n_hashed", [OPS_PER_LAUNCH, OPS_PER_LAUNCH + 1, 130])
def test_hash_layer_past_one_launch_verifies_clean(n_hashed):
    """``ads_ctr`` with its sparse layer hashing ``n_hashed`` fields in one
    ``feature_hash`` program. JAX's kernel takes any number of ops; the
    port's wrapper runs a program past ``OPS_PER_LAUNCH`` ops as several
    launches, so the abstract flow is clean at any length, with the
    layer's output holding every op's row."""
    base = get_spec("ads_ctr")
    extra = tuple(Hash(f"f_user_{i}", "user_id") for i in range(n_hashed - 4))
    outputs = tuple(dataclasses.replace(o, fields=o.fields + tuple(t.name for t in extra))
                    if isinstance(o, SparseOutput) else o for o in base.outputs)
    plan = featureplan.compile(dataclasses.replace(
        base, transforms=base.transforms + extra, outputs=outputs))
    findings = planverify.verify_plan(plan, rows=8)
    assert findings == [], "\n".join(f.render() for f in findings)
    env, _ = planverify.abstract_flow(plan, 8)
    assert env["batch_sparse"].shape[1] == n_hashed + sum(
        1 for o in base.outputs if isinstance(o, SparseOutput) for _ in o.fields) - 4


@pytest.mark.parametrize("preset,arch", PAIRS)
def test_compiled_presets_verify_clean(preset, arch):
    p = featureplan.compile(get_spec(preset))
    m = p.model_feed(get_arch(arch).smoke(), split_sparse_fields=True)
    findings = planverify.verify_plan(p, rows=8)
    findings += planverify.verify_model_feed(m, p.feed_layout(split_sparse_fields=m.split))
    assert findings == [], "\n".join(f.render() for f in findings)


# JAX's abstract_flow keeps the dtype a host slot was synthesized with and
# gives the device ops' outputs the layout's dtypes, as the port's meta run
# does: the map from JAX's dtypes to the port's is the identity for every
# slot of the three presets.
DTYPE_MAP = {name: name for name in ("float32", "int32", "int64")}


@pytest.mark.parametrize("preset", ["ads_ctr", "dlrm", "bst"])
@pytest.mark.parametrize("rows", [1, 8, 33])
def test_abstract_env_equals_jaxs_slot_by_slot(preset, rows):
    env, findings = planverify.abstract_flow(featureplan.compile(get_spec(preset)), rows)
    jplan = jax_featureplan.compile(jax_get_spec(preset))
    jenv, jfindings = jax_planverify.abstract_flow(jplan, rows)
    assert findings == [] and jfindings == []
    assert sorted(env) == sorted(jenv)
    for slot, sds in jenv.items():
        got = env[slot]
        assert got.device.type == "meta", slot
        assert tuple(got.shape) == tuple(sds.shape), slot
        assert str(got.dtype).removeprefix("torch.") == DTYPE_MAP[np.dtype(sds.dtype).name], slot


# --------------------------------------------------------- effects (EF3xx)
@dataclasses.dataclass
class _FakeEx:
    index: int
    layer_indices: tuple
    fused_fn: object
    device_input_slots: tuple
    host_ops: tuple = ()


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


_ENV = {"a": _meta(4)}


def _step_args():
    return {"w": _meta(2, 2)}, {"m": _meta(2, 2)}, {"x": _meta(4)}


def _item(env):            # torch form of jax.debug.print: reads a value back
    _ = float(env["a"].sum())
    return {"b": env["a"] + 1}


def _to_host(env):         # torch form of io_callback: copies to the host
    _ = env["a"].cpu()
    return {"b": env["a"] * 2}


def _nonzero(env):
    return {"b": env["a"][env["a"].nonzero()]}


@pytest.mark.parametrize("fn,what", [(_item, "_local_scalar_dense"),
                                     (_to_host, "_to_copy (copy to the host)"),
                                     (_nonzero, "nonzero")])
def test_ef301_host_sync_in_fused_dispatch(fn, what):
    findings = effects.scan_executables([_FakeEx(0, (0, 1), fn, ("a",))], _ENV)
    assert _rules(findings) == ["EF301"] and what in findings[0].message


def test_ef301_missing_abstract_input_reported_not_raised():
    findings = effects.scan_executables([_FakeEx(0, (0, 1), lambda env: env, ("a", "ghost"))], _ENV)
    assert _rules(findings) == ["EF301"] and "ghost" in findings[0].message


def test_ef301_tracing_failure_reported_not_raised():
    def broken(env):
        raise TypeError("shape contract violated")

    findings = effects.scan_executables([_FakeEx(0, (0,), broken, ("a",))], _ENV)
    assert _rules(findings) == ["EF301"] and "TypeError" in findings[0].message


def test_pure_fused_dispatch_is_clean():
    layers = [_FakeEx(0, (0, 1), lambda env: {"b": env["a"] + 1}, ("a",)),
              _FakeEx(1, (2,), None, ())]  # host-only layer: skipped
    assert effects.scan_executables(layers, _ENV) == []


def test_ef302_nothing_updated_in_place():
    def step(params, opt, feed):
        return {k: v + 1.0 for k, v in params.items()}, {k: v * 1 for k, v in opt.items()}, {}

    assert _rules(effects.check_step(step, _step_args(), expect_donation=True)) == ["EF302"]
    assert effects.check_step(step, _step_args(), expect_donation=False) == []


@pytest.mark.parametrize("update", ["identity", "in place", "view"])
def test_ef302_clean_when_params_are_updated_in_place(update):
    def step(params, opt, feed):
        if update == "identity":
            return params, opt, {}
        if update == "in place":
            return {k: v.add_(1.0) for k, v in params.items()}, opt, {}
        return {k: v.view(-1) for k, v in params.items()}, {}, {}   # shares storage

    assert effects.check_step(step, _step_args(), expect_donation=True) == []


def test_ef303_host_sync_in_train_step():
    def step(params, opt, feed):
        if float(feed["x"].sum()) > 0:     # the torch form of a debug print of the loss
            pass
        return {k: v.add_(1.0) for k, v in params.items()}, opt, {}

    findings = effects.check_step(step, _step_args(), expect_donation=True)
    assert _rules(findings) == ["EF303"] and "_local_scalar_dense" in findings[0].message


def test_ef303_tracing_failure_reported_not_raised():
    findings = effects.check_step(lambda p, o, f: (p["no_such_key"], o, {}), _step_args(),
                                  expect_donation=True)
    assert _rules(findings) == ["EF303"] and "KeyError" in findings[0].message


def test_sync_recorder_sees_indexing_with_a_0d_tensor():
    """Indexing with a 0-d tensor brings it to the host; ``index_select``
    does not. The sparse step's write-back (``scatter_rows``) uses the
    second form."""
    from repro_torch.embedding.table import scatter_rows

    v, i = _meta(5), torch.empty((), dtype=torch.int64, device="meta")
    assert effects.run_recorded(lambda: v[i])[1] == ("_local_scalar_dense",)
    assert effects.run_recorded(lambda: v.index_select(0, i.reshape(1)))[1] == ()
    table = _meta(10, 3)
    idx = torch.empty((4,), dtype=torch.int32, device="meta")
    valid = torch.empty((4,), dtype=torch.bool, device="meta")
    assert effects.run_recorded(scatter_rows, table, idx, _meta(4, 3), valid)[1:] == ((), None)


def _sparse_step_on_cpu():
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw

    cfg = get_arch("dlrm-mlperf").smoke()
    params = R.init_params(cfg, torch.Generator().manual_seed(0))
    raw, init = R.make_sparse_train_step(cfg, adamw(1e-3))
    batch = synthetic_batch("recsys", cfg, 64, 0, device=torch.device("cpu"))
    opt = init(params)
    rec = effects.SyncRecorder()
    with rec:
        out = raw(params, opt, batch)
    return out, rec.syncs


def test_sparse_step_reads_nothing_back_where_the_0d_index_form_did():
    """One sparse step on the CPU under the recorder: no
    ``_local_scalar_dense``; with the 0-d index form of ``scatter_rows``
    three a call, two calls (table and accumulator); the same bits."""
    (params, opt, metrics), syncs = _sparse_step_on_cpu()
    with mock.patch("repro_torch.embedding.table.scatter_rows", chip_smoke.scatter_rows_0d_index):
        (old_params, old_opt, old_metrics), old_syncs = _sparse_step_on_cpu()
    assert "_local_scalar_dense" not in syncs, syncs
    assert old_syncs.count("_local_scalar_dense") == 6, old_syncs
    assert all(torch.equal(params[k], old_params[k]) for k in params)
    assert torch.equal(opt["embed_accum"], old_opt["embed_accum"])
    assert torch.equal(metrics["loss"], old_metrics["loss"])


def test_ef303_catches_the_0d_index_form_in_the_sparse_step():
    """The mutant the card runs: the sparse step's write-back with a 0-d
    index, scanned on meta tensors."""
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw

    plan = featureplan.compile(get_spec("dlrm"))
    mf = plan.model_feed(get_arch("dlrm-mlperf").smoke(), split_sparse_fields=True)
    raw, _ = R.make_sparse_train_step(mf.config, adamw(1e-3))
    args = effects.abstract_step_args(plan, mf, rows=8)
    assert effects.check_step(mf.make_step(raw).boundary, args, expect_donation=True) == []
    with mock.patch("repro_torch.embedding.table.scatter_rows", chip_smoke.scatter_rows_0d_index):
        findings = effects.check_step(mf.make_step(raw).boundary,
                                      effects.abstract_step_args(plan, mf, rows=8),
                                      expect_donation=True)
    assert _rules(findings) == ["EF303"] and "_local_scalar_dense" in findings[0].message


@pytest.mark.parametrize("preset,arch", PAIRS)
def test_preset_scan_is_clean_and_leaves_no_group(preset, arch):
    plan = featureplan.compile(get_spec(preset))
    mf = plan.model_feed(get_arch(arch).smoke(), split_sparse_fields=True)
    had_group = torch.distributed.is_initialized()    # another test may have left one
    findings = effects.scan_preset(plan, mf, rows=16, device="cpu")
    assert findings == [], "\n".join(f.render() for f in findings)
    assert torch.distributed.is_initialized() == had_group   # a group it made is gone


def test_abstract_step_args_match_the_step_signature():
    plan = featureplan.compile(get_spec("ads_ctr"))
    mf = plan.model_feed(get_arch("dlrm-mlperf").smoke(), split_sparse_fields=True)
    params, opt, feed = effects.abstract_step_args(plan, mf, rows=8)
    assert set(feed) == set(mf.slots)
    assert all(t.device.type == "meta" and t.shape[0] == 8 for t in feed.values())
    assert all(t.device.type == "meta" for t in params.values())
    assert opt["embed_accum"].device.type == "meta"


def test_syncing_fused_layer_caught_on_real_plan():
    """The mutant ``chip_smoke.py`` runs on the card: an ``.item()`` in a
    fused layer of a compiled plan."""
    plan = featureplan.compile(get_spec("ads_ctr"))
    target = next(ex for ex in plan.layers if ex.fused_fn is not None)
    inner = target.fused_fn

    def syncing(env):
        _ = env[target.device_input_slots[0]].sum().item()
        return inner(env)

    layers = [dataclasses.replace(target, fused_fn=syncing) if e is target else e
              for e in plan.layers]
    env, _ = planverify.abstract_flow(plan, 8)
    findings = effects.scan_executables(layers, env)
    assert _rules(findings) == ["EF301"] and len(findings) == 1


# ----------------------------------------------------------- the driver
def _metrics(out):
    head, _, tail = out.partition("metrics:\n")
    return json.loads(tail), head


def _jax_driver(argv, capsys):
    from repro.launch import train as JT

    prev = sys.argv
    try:
        sys.argv = ["train"] + argv
        JT.main()
    finally:
        sys.argv = prev
    return capsys.readouterr().out


# metric keys of tiers other than check and hlo that differ between the two
# drivers: the port's feed also counts its D2H time, its placement and its
# fresh arenas (device arenas, which JAX's host-side feeder does not have);
# every key of JAX's is the port's too
KNOWN_KEY_DIFFERENCES = (
    {"feed.d2h_seconds", "feed.fresh_arenas", "feed.place_seconds"},
    set())


# hlo keys of the JAX driver the port renames or leaves out, each with its reason
HLO_RENAMED = {"hlo.bytes": "hlo.op_bytes"}    # eager ops are unfused: not the card's HBM traffic
HLO_LEFT_OUT = {
    "hlo.artifact_bytes": "XLA's CPU promotion copies; eager torch runs none",
    "hlo.bytes_tpu_corrected": "bytes less those copies: a TPU figure with no torch source",
}


@pytest.mark.parametrize("mode", ["streaming", "in-memory"])
def test_driver_check_and_metrics_keys_match_jax(mode, tmp_path, capsys):
    argv = ["--arch", "dlrm-mlperf", "--steps", "3", "--batch", "64", "--check", "--metrics"]
    if mode == "streaming":
        argv += ["--gen-shards", "4", "--spec", "dlrm", "--device-feed", "arena"]
    T.main(argv + ["--device", "cpu"] + (["--data-dir", str(tmp_path / "p")]
                                         if mode == "streaming" else []))
    port, phead = _metrics(capsys.readouterr().out)
    jax_m, jhead = _metrics(_jax_driver(argv + (["--data-dir", str(tmp_path / "j")]
                                                if mode == "streaming" else []), capsys))
    for head in (phead, jhead):
        assert "check: 4 analyzers, 0 errors" in head and "hlo/step: " in head
    hlo_line = next(ln for ln in phead.splitlines() if ln.startswith("hlo/step: "))
    assert "op_bytes=" in hlo_line
    assert not any(w in hlo_line for w in ("hbm", "tpu-corrected", "intensity"))
    tiers = lambda m: {k.split(".")[0] for k in m}   # noqa: E731
    assert tiers(port) == tiers(jax_m) and {"check", "hlo"} <= tiers(port)
    for tier in ("check", "hlo"):
        want = {HLO_RENAMED.get(k, k) for k in jax_m
                if k.startswith(tier + ".") and k not in HLO_LEFT_OUT}
        assert {k for k in port if k.startswith(tier + ".")} == want
    only_port, only_jax = set(port) - set(jax_m), set(jax_m) - set(port)
    assert only_port == (set(HLO_RENAMED.values())
                         | (KNOWN_KEY_DIFFERENCES[0] if mode == "streaming" else set()))
    assert only_jax == (set(HLO_RENAMED) | set(HLO_LEFT_OUT)
                        | (KNOWN_KEY_DIFFERENCES[1] if mode == "streaming" else set()))
    assert port["hlo.op_bytes"] > 0 and port["hlo.collective_total"] == 0
    assert port["check.exit_code"] == jax_m["check.exit_code"] == 0


def test_driver_flags_change_no_loss(tmp_path, capsys):
    write_log_shards(str(tmp_path), n_shards=4, rows_per_shard=64, seed=0)
    argv = ["--arch", "dlrm-mlperf", "--data-dir", str(tmp_path), "--spec", "dlrm",
            "--device-feed", "arena", "--steps", "4", "--fault-tolerant", "--device", "cpu"]
    _, plain = T.main(argv)
    _, flagged = T.main(argv + ["--check", "--metrics"])
    assert flagged == plain and len(plain) == 4
    out = capsys.readouterr().out
    assert "hlo/step" in out and out.count("check: 4 analyzers") == 1


def test_driver_check_refuses_to_train_on_an_error(tmp_path, monkeypatch):
    bad = Report()
    bad.record_analyzer("plan", [Finding(rule="PV101", severity="error", location="x",
                                         message="m")])
    monkeypatch.setattr("repro_torch.check.run_check", lambda *a, **k: bad)
    gen = tmp_path / "gen"
    with pytest.raises(SystemExit) as e:
        T.main(["--arch", "dlrm-mlperf", "--data-dir", str(gen), "--gen-shards", "2",
                "--spec", "dlrm", "--steps", "1", "--device", "cpu", "--check"])
    assert e.value.code == 2
    assert not gen.exists()                       # no data was touched


def test_driver_check_runs_once_in_the_parent_of_a_mesh(tmp_path, monkeypatch):
    """A multi-rank mesh: the preflight runs once, in the parent, before
    any shard is written or a rank spawned, and the ranks get its report
    on ``args``."""
    seen = []

    def fake_check(*a, **k):
        seen.append(("check", (tmp_path / "gen").exists()))
        return Report()

    spawned = []
    monkeypatch.setattr("repro_torch.check.run_check", fake_check)
    monkeypatch.setattr(torch.multiprocessing, "spawn",
                        lambda fn, args, nprocs, join: spawned.append((list(seen), args, nprocs)))
    T.main(["--arch", "dlrm-mlperf", "--data-dir", str(tmp_path / "gen"), "--gen-shards", "2",
            "--spec", "dlrm", "--device-feed", "off", "--mesh", "2x2", "--steps", "1",
            "--device", "cpu", "--check"])
    (before_spawn, (args, _, world), nprocs), = spawned
    assert before_spawn == [("check", False)] and world == nprocs == 4
    assert args.check_report is not None and args.check_report.exit_code == 0
