"""The guard flight recorder in the port (``repro_torch.obs``: telemetry,
events, spans, roofline_compare; ``repro_torch.roofline``) against the
JAX package on the same inputs, on the CPU.

* The ring: pushes and reads give the JAX ring's lanes bit for bit, and
  each package's ``ring_read`` decodes the other's; the wrap keeps the
  last ``ring_size`` frames in push order.
* Off is free: ``telemetry=None`` and ``TelemetryConfig(enabled=False)``
  give bit-identical results and dispatch the same operations, counted by
  a ``TorchDispatchMode`` (fused, dense, dp_sketch, krum, generating).
* The frames of ``run_sgd`` (generated problem d = 32, m = 8, T = 30,
  ring 8) against ``repro.run_sgd``'s ``ring_read``: the fused guard (f32
  and bf16, a resync every 8 steps), the dense guard under an adaptive
  sign flip, a straggling and partially reporting fleet, ``krum``,
  ``coordinate_median`` under the quarantine with NaN rows, ``dp_exact``,
  ``dp_sketch`` and the generating guard: ``alive``, ``n_alive``, ``step``,
  ``first_filter_step``, ``byz_alive`` and the NaN positions equal, every
  other float within 1e-5 relative (1e-2 at bf16); ``gram_drift`` (at f32
  the incremental Gram's rounding noise, which moves with the order of the
  sums) within the same plus 1e-6·𝔗_B².
  Armed, the port decides and moves exactly as unarmed.
* An armed campaign's rings, first-filter steps and survival series are
  bit-identical across chunk sizes 1, 5 and 12 (the reference's grid of
  ``tests/test_campaign_chunked.py``), ``filter_timelines`` equals JAX's
  on the same grid, and ``campaign_trace_events`` → ``EventLog`` → JSONL
  and Chrome trace read back.
* ``guard_cost``'s bytes and FLOPs equal the reference's for every
  backend and stats dtype; ``steady_state_us`` reads the H100's HBM rate.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core.solver import SolverConfig as JaxConfig
from repro.core.solver import run_sgd as jax_run_sgd
from repro.data.problems import make_generated_problem as jax_problem
from repro.obs import telemetry as jtel
from repro.roofline import guard_cost as jcost
from repro.scenarios import faults as jfaults
from repro.scenarios import report as jreport
from repro.scenarios import spec as jspec
from repro.scenarios.adversary import ScenarioAdversary as JaxAdversary
from repro.scenarios.campaign import run_campaign as jax_run_campaign
from repro_torch import prng
from repro_torch.core.solver import SolverConfig, run_sgd
from repro_torch.data.problems import make_generated_problem
from repro_torch.obs import (
    FRAME_SCHEMA,
    EventLog,
    TelemetryConfig,
    ring_init,
    ring_push,
    ring_read,
    roofline_rows,
    spans_by_name,
    trace_span,
)
from repro_torch.roofline import H100, guard_cost
from repro_torch.scenarios import (
    ScenarioAdversary,
    campaign_trace_events,
    expand_grid,
    faults,
    filter_timelines,
    run_campaign,
    spec,
)

M, D, T, RING = 8, 32, 30, 8


# ---------------------------------------------------------------- the ring

def _frames(m: int, n: int) -> list[dict]:
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        f = {k: rng.normal(size=m).astype(np.float32) for k in jtel.PER_WORKER_KEYS}
        f.update({k: np.float32(rng.normal()) for k in jtel.SCALAR_KEYS})
        f["step"] = np.float32(i + 1)
        f["v_est"] = np.float32(np.nan)
        out.append(f)
    return out


@pytest.mark.parametrize("n", [3, 4, 11])
def test_ring_round_trip_and_wrap_match_jax(n):
    m, size = 3, 4
    frames = _frames(m, n)
    ring, jring = ring_init(m, size), jtel.ring_init(m, size)
    for i, f in enumerate(frames):
        # the port takes device tensors and host numbers alike
        tf = {k: (torch.from_numpy(v) if i % 2 and v.ndim else v) for k, v in f.items()}
        ring = ring_push(ring, tf)
        jring = jtel.ring_push(jring, {k: jax.numpy.asarray(v) for k, v in f.items()})
    assert ring.head == int(jring.head) == n
    np.testing.assert_array_equal(ring.lanes.numpy().view(np.int32),
                                  np.asarray(jring.lanes).view(np.int32))
    got = ring_read(ring)
    assert len(got) == min(n, size)
    assert [float(f["step"]) for f in got] == list(range(n - len(got) + 1, n + 1))
    for a, b, c in zip(got, jtel.ring_read(jring), frames[n - len(got):]):
        assert list(a) == list(FRAME_SCHEMA) == list(b)
        for k in FRAME_SCHEMA:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])
    # each package decodes the other's ring
    assert len(jtel.ring_read(jtel.TelemetryRing(lanes=ring.lanes.numpy(), head=n))) == len(got)


def test_telemetry_config_gate():
    from repro_torch.obs import telemetry_on

    assert not telemetry_on(None) and not telemetry_on(TelemetryConfig(enabled=False))
    assert telemetry_on(TelemetryConfig(ring_size=1))
    with pytest.raises(TypeError, match="TelemetryConfig"):
        telemetry_on(object())
    with pytest.raises(ValueError, match="ring_size"):
        telemetry_on(TelemetryConfig(ring_size=0))


# ---------------------------------------------------------------- runs

def _scenario(mod, name):
    return {"sign_flip": mod.scenario_static("sign_flip"),
            "adaptive": mod.scenario_adaptive("sign_flip", adapt_rate=0.5)}[name]


RUNS = {
    # name: (SolverConfig overrides, scenario, profile, fault)
    "fused": (dict(guard_backend="fused", guard_opts=(("gram_resync_every", 8),)),
              "sign_flip", None, None),
    "fused@bf16": (dict(guard_backend="fused", stats_dtype="bf16",
                        guard_opts=(("gram_resync_every", 8),)), "sign_flip", None, None),
    "dense_adaptive": (dict(guard_backend="dense"), "adaptive", None, None),
    "dense_fleet": (dict(guard_backend="dense", max_delay=2, partial_participation=True),
                    "sign_flip", "fleet", None),
    "krum": (dict(aggregator="krum"), "sign_flip", None, None),
    "median_quarantine": (dict(aggregator="coordinate_median", sanitize="quarantine"),
                          "sign_flip", None, "nan_rows"),
    "fused_quarantine": (dict(guard_backend="fused", sanitize="quarantine",
                              guard_opts=(("gram_resync_every", 8),)),
                         "sign_flip", None, "nan_rows"),
    "dp_exact": (dict(guard_backend="dp_exact"), "sign_flip", None, None),
    "dp_sketch": (dict(guard_backend="dp_sketch", guard_opts=(("sketch_dim", 16),)),
                  "sign_flip", None, None),
    "gen": (dict(guard_backend="fused", generate="kernel",
                 guard_opts=(("gram_resync_every", 8),)), "sign_flip", None, None),
}


def _fleet(mod, **kw):
    return mod.worker_profile(M, delay=[0] * (M - 2) + [2, 2],
                              p_report=[0.7] * (M - 2) + [1.0, 1.0], **kw)


def _run(mod, name, telemetry):
    over, scn, prof, fault = RUNS[name]
    base = {**dict(m=M, T=T, eta=0.05, alpha=0.25, aggregator="byzantine_sgd"), **over}
    if mod is spec:
        kw = {"device": "cpu"}
        plan = None if fault is None else faults.make_fault_plan(fault, frac=0.25,
                                                                 start_step=5)
        adv = ScenarioAdversary(_scenario(spec, scn), 0.25, faults=plan,
                                profile=None if prof is None else _fleet(spec, **kw))
        return run_sgd(make_generated_problem(d=D, sigma=1.0, L=8.0, V=1.0, seed=0, device="cpu"),
                       SolverConfig(**base), prng.PRNGKey(3), adversary=adv,
                       telemetry=telemetry, device="cpu")
    plan = None if fault is None else jfaults.make_fault_plan(fault, frac=0.25, start_step=5)
    adv = JaxAdversary(_scenario(jspec, scn), jax.numpy.asarray(0.25, jax.numpy.float32),
                       faults=plan, profile=None if prof is None else _fleet(jspec))
    return jax_run_sgd(jax_problem(d=D, sigma=1.0, L=8.0, V=1.0, seed=0), JaxConfig(**base),
                       jax.random.PRNGKey(3), adversary=adv,
                       telemetry=None if telemetry is None else jtel.TelemetryConfig(
                           ring_size=telemetry.ring_size))


@pytest.fixture(scope="module")
def armed_runs():
    """Each run of RUNS in both packages with the recorder armed, and the
    port's run without it."""
    tel = TelemetryConfig(ring_size=RING)
    return {name: (_run(spec, name, tel), _run(jspec, name, tel), _run(spec, name, None))
            for name in RUNS}


EXACT = ("alive", "n_alive", "step")


@pytest.mark.parametrize("name", sorted(RUNS))
def test_frames_match_jax(armed_runs, name):
    got, want, off = armed_runs[name]
    tol = 1e-2 if RUNS[name][0].get("stats_dtype") == "bf16" else 1e-5
    # armed, the run decides and moves as unarmed
    for f in ("gaps", "n_alive", "final_alive", "x_final"):
        assert torch.equal(getattr(got, f), getattr(off, f)), f
    assert off.telemetry is None
    np.testing.assert_array_equal(got.telemetry.first_filter_step.numpy(),
                                  np.asarray(want.telemetry.first_filter_step))
    np.testing.assert_array_equal(got.telemetry.byz_alive.numpy(),
                                  np.asarray(want.telemetry.byz_alive))
    gf, wf = ring_read(got.telemetry.ring), jtel.ring_read(want.telemetry.ring)
    assert len(gf) == len(wf) == RING
    for a, b in zip(gf, wf):
        for k in FRAME_SCHEMA:
            x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
            np.testing.assert_array_equal(np.isnan(x), np.isnan(y), err_msg=f"{name} {k}")
            if k in EXACT:
                np.testing.assert_array_equal(x, y, err_msg=k)
            elif k == "gram_drift" and not np.isnan(y):
                # at f32 the drift is the incremental Gram's rounding noise,
                # which moves with the order of the sums: held to a floor of
                # 1e-6·𝔗_B² beside the relative tolerance (at bf16 it is the
                # rounding of B, and the relative term holds it)
                floor = 1e-6 * float(b["thr_b"]) ** 2
                assert abs(x - y) <= tol * abs(y) + floor, (name, x, y)
            else:
                x, y = np.nan_to_num(x), np.nan_to_num(y)
                assert np.linalg.norm(x - y) <= tol * np.linalg.norm(y) + 1e-6, (name, k, x, y)


def test_frames_fill_the_keys_each_producer_knows(armed_runs):
    last = {name: ring_read(runs[0].telemetry.ring)[-1] for name, runs in armed_runs.items()}
    assert math.isnan(last["krum"]["thr_a"]) and last["krum"]["alive"].min() == 1.0
    assert not math.isnan(last["dp_sketch"]["v_est"]) and math.isnan(last["fused"]["v_est"])
    assert last["dense_adaptive"]["gram_drift"] == 0.0
    assert not math.isnan(last["dense_adaptive"]["adapt_scale"])
    assert not math.isnan(last["dense_fleet"]["n_reporting"])
    assert not math.isnan(last["dense_fleet"]["staleness"])
    assert last["median_quarantine"]["n_nonfinite"] == 2.0
    drift = [f["gram_drift"] for f in ring_read(armed_runs["fused"][0].telemetry.ring)]
    steps = [int(f["step"]) for f in ring_read(armed_runs["fused"][0].telemetry.ring)]
    assert [s for s, g in zip(steps, drift) if not math.isnan(g)] == [s for s in steps if s % 8 == 0]


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["fused", "dense_fleet", "krum", "dp_sketch", "gen"])
def test_off_state_dispatches_the_same_operations(name):
    runs = {}
    for key, tel in (("none", None), ("disabled", TelemetryConfig(enabled=False))):
        with _CountOps() as mode:
            res = _run(spec, name, tel)
        runs[key] = (res, mode.ops)
    (a, ops_a), (b, ops_b) = runs["none"], runs["disabled"]
    assert ops_a == ops_b and len(ops_a) > 0
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None and y is None) or torch.equal(x, y), f


# ---------------------------------------------------------------- campaigns

CAMPAIGN_M, CAMPAIGN_T = 16, 25


def _campaign_grid(mod):
    return mod.expand_grid(
        [("static_sign_flip", mod.scenario_static("sign_flip")),
         ("churn", mod.scenario_churn("sign_flip", period=10, stride=2))],
        alphas=[0.125, 0.25], seeds=range(3))


@pytest.fixture(scope="module")
def armed_campaigns():
    """The reference's chunked-campaign grid, armed, at chunk sizes None,
    1, 5, 12 in the port, and once in the JAX package."""
    prob = make_generated_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=0, device="cpu")
    cfg = SolverConfig(m=CAMPAIGN_M, alpha=0.25, T=CAMPAIGN_T, eta=0.05)
    tel = TelemetryConfig(ring_size=8)
    got = {c: run_campaign(prob, cfg, _campaign_grid(spec), ["byzantine_sgd"],
                           backends=("fused", "gen"), telemetry=tel, chunk_size=c,
                           device="cpu")
           for c in (None, 1, 5, 12)}
    want = jax_run_campaign(jax_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=0),
                            JaxConfig(m=CAMPAIGN_M, alpha=0.25, T=CAMPAIGN_T, eta=0.05),
                            _campaign_grid(jspec), ["byzantine_sgd"], backends=("fused", "gen"),
                            telemetry=jtel.TelemetryConfig(ring_size=8))
    return got, want


@pytest.mark.parametrize("chunk_size", [1, 5, 12])
def test_campaign_rings_bit_identical_across_chunk_sizes(armed_campaigns, chunk_size):
    got, _ = armed_campaigns
    flat, chunked = got[None], got[chunk_size]
    for name in flat.stats:
        a, b = flat.stats[name].telemetry, chunked.stats[name].telemetry
        assert torch.equal(a["ring"].lanes.view(torch.int32), b["ring"].lanes.view(torch.int32))
        assert torch.equal(a["ring"].head, b["ring"].head)
        for k in ("first_filter_step", "byz_alive", "byz_mask"):
            assert torch.equal(a[k], b[k]), (name, k)
        for f in ("gap_final", "n_alive_final", "detect_latency"):
            assert torch.equal(getattr(flat.stats[name], f), getattr(chunked.stats[name], f))


def test_campaign_timelines_and_trace_events(armed_campaigns, tmp_path):
    got, want = armed_campaigns
    res = got[None]
    assert filter_timelines(res) == jreport.filter_timelines(want)
    for name, st in res.stats.items():
        tel, jt = st.telemetry, want.stats[name].telemetry
        for k in ("first_filter_step", "byz_alive", "byz_mask"):
            np.testing.assert_array_equal(tel[k].numpy(), np.asarray(jt[k]), err_msg=k)
        assert tel["ring"].lanes.shape == np.asarray(jt["ring"].lanes).shape
    log = EventLog(note="campaign")
    with trace_span("report/drain", log):
        n = campaign_trace_events(res, log, select=lambda e: e["scenario"] == "churn")
    assert n == 2 * 6
    steps = [e for e in log.events if e["type"] == "guard_step"]
    assert len(steps) == n * 8 and {e["type"] for e in log.events} == {
        "guard_step", "timeline", "span"}
    assert spans_by_name(log.events)["report/drain"]["count"] == 1
    path = tmp_path / "trace.jsonl"
    log.write_jsonl(str(path))
    meta, events = EventLog.read_jsonl(str(path))
    assert meta["note"] == "campaign" and len(events) == len(log.events)
    assert events[0]["run"].startswith("churn/a0.125/byzantine_sgd@fused/s")
    chrome = tmp_path / "trace.json"
    log.write_chrome_trace(str(chrome))
    trace = json.loads(chrome.read_text())
    counters = [e for e in trace["traceEvents"] if e["ph"] == "C"]
    assert len(counters) == 3 * len(steps)   # n_alive, xi_norm, adapt_scale (v_est NaN)
    assert sum(e["ph"] == "X" for e in trace["traceEvents"]) == 1


# ---------------------------------------------------------------- cost model

@pytest.mark.parametrize("backend", sorted(jcost.BACKEND_COSTS))
@pytest.mark.parametrize("sd", ["f32", "bf16"])
def test_guard_cost_bytes_equal_the_reference(backend, sd):
    for m, d in ((32, 2 ** 20), (8, 4099), (256, 2 ** 18)):
        got = guard_cost.backend_cost(backend, m, d, sd)
        want = jcost.backend_cost(backend, m, d, sd)
        assert tuple(got) == tuple(want) and got.step_bytes == want.step_bytes
        assert guard_cost.steady_state_us(got) == pytest.approx(
            want.step_bytes / 3.35e12 * 1e6, rel=1e-12)
    assert H100.name == "NVIDIA H100 80GB HBM3" and H100.power_limit_w == 700.0
    rows = roofline_rows({f"{backend}@{sd}": 1000.0}, 32, 2 ** 20)
    assert rows[0]["model_step_bytes"] == jcost.backend_cost(backend, 32, 2 ** 20, sd).step_bytes
