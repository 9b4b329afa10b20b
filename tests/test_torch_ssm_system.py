"""The JAX package's own system smokes on mamba2-130m, run by the port and
held to the JAX package's, on the CPU: a launcher run stopped and resumed
from its checkpoint (``tests/test_system.py::test_e2e_resume_equals_
uninterrupted``'s sizes: reduced d_model 64, W = 4, per-worker batch 1,
seq 16, 20 steps, dp_sketch, log_every 5), and a train campaign
(``benchmarks/bench_train.py``'s grid cut to size: static sign_flip at
twice the scale, 2 seeds in one group, mean and byzantine_sgd@dp_exact,
W = 4, seq 32 (one SSD chunk), per-worker batch 1, 4 steps); and jamba's
serving roundtrip (``tests/test_system.py::test_e2e_serving_roundtrip``:
reduced, batch 2, prompt 32, 8 tokens, cache 64).

Tolerances: the resumed run's parameters and the guard's B bit for bit
the uninterrupted run's; every filter decision at every step and every
served token exactly the JAX package's; losses within 1e-4 relative on
the campaign's 4 steps and 1e-3 over the launcher's 20 (AdamW carries the
f32 rounding of gradients summed in another order from step to step, as
``chip_smoke.py``'s launcher phase states for the dense decoder).
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.solver import SolverConfig as JConfig
from repro.data.synthetic import SyntheticTokens as JTokens
from repro.launch.serve import run_serving as jrun_serving
from repro.launch.train import run_training as jrun_training
from repro.models.model import build_model as jbuild
from repro.optim import optimizers as jopt
from repro.scenarios import expand_grid as jexpand_grid
from repro.scenarios import scenario_static as jstatic
from repro.scenarios.train_campaign import run_train_campaign as jrun_campaign
from repro_torch import utils
from repro_torch.configs import get_config
from repro_torch.core.solver import SolverConfig
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import build_model
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.scenarios import expand_grid, run_train_campaign, scenario_static

ARCH = "mamba2-130m"
DECISIONS = ("n_alive", "byz_alive", "good_filtered", "n_byz")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread: the resumed run is compared bit for bit, and torch
    splits a CPU reduction by the size of its thread team."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.abs(want)


RESUME = dict(reduced=True, workers=4, per_worker_batch=1, seq_len=16, steps=20, alpha=0.25,
              attack="sign_flip", guard_backend="dp_sketch", d_model=64, log_every=5)


def test_resume_equals_uninterrupted_and_decides_as_jax(tmp_path):
    full_state, full = tlaunch.run_training(ARCH, device="cpu", verbose=False, **RESUME)
    ck = str(tmp_path / "ck")
    _, head = tlaunch.run_training(ARCH, device="cpu", verbose=False, stop_after=10,
                                   ckpt_dir=ck, **RESUME)
    assert len(head) == 10
    state, hist = tlaunch.run_training(ARCH, device="cpu", verbose=False, ckpt_dir=ck,
                                       resume=True, **RESUME)
    for a, b in zip(utils.tree_leaves(full_state.params), utils.tree_leaves(state.params)):
        assert torch.equal(a, b)
    assert torch.equal(full_state.guard.B, state.guard.B)
    np.testing.assert_equal(hist, full)
    _, want = jrun_training(ARCH, driver="loop", **RESUME)
    assert len(want) == len(full) == RESUME["steps"]
    for a, b in zip(want, full):
        for k in DECISIONS:
            assert a[k] == b[k], (a["step"], k)
        assert _rel(b["loss_good_workers"], a["loss_good_workers"]) <= 1e-3, a["step"]


W, T, SEQ = 4, 4, 32
CAMPAIGN = dict(m=W, T=T, eta=3e-3, alpha=0.25, attack="sign_flip", mean_over_alive=True)
VARIANTS = ["mean", "byzantine_sgd@dp_exact"]


def test_train_campaign_matches_jax():
    jm = jbuild(jget_config(ARCH).reduced(max_d_model=64))
    jgrid = jexpand_grid([("static", jstatic("sign_flip", attack_scale=2.0))], [0.25], [0, 1])
    want = jrun_campaign(jm, jopt.adamw(jopt.linear_warmup_cosine(3e-3, 1, T), grad_clip=1.0),
                         JConfig(**CAMPAIGN), jgrid, steps=T, stream=JTokens(512, SEQ, seed=0),
                         aggregators=VARIANTS)
    model = build_model(get_config(ARCH).reduced(max_d_model=64), device="cpu")
    grid = expand_grid([("static", scenario_static("sign_flip", attack_scale=2.0))], [0.25],
                       [0, 1])
    got = run_train_campaign(model, adamw(linear_warmup_cosine(3e-3, 1, T), grad_clip=1.0),
                             SolverConfig(**CAMPAIGN), grid, steps=T,
                             stream=SyntheticTokens(512, SEQ, seed=0), aggregators=VARIANTS)
    assert got.entries == want.entries and got.n_runs == want.n_runs == 2
    for variant in VARIANTS:
        g, w = got.stats[variant], want.stats[variant]
        for f in ("n_alive_final", "byz_alive_final", "n_byz_ever", "ever_filtered_good"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)),
                                          err_msg=f"{variant} {f}")
        for f in ("loss_first", "loss_final"):
            assert np.all(_rel(getattr(g, f).numpy(), getattr(w, f)) <= 1e-4), (variant, f)
    guard = got.stats["byzantine_sgd@dp_exact"]
    assert not guard.ever_filtered_good.any() and int(guard.byz_alive_final.max()) == 0


def test_jamba_run_serving_tokens_are_jaxs():
    """Both packages' run_serving at the reference roundtrip's sizes."""
    kw = dict(batch=2, prompt_len=32, gen_tokens=8, cache_len=64)
    want = np.asarray(jrun_serving("jamba-v0.1-52b", **kw))
    got = tserve.run_serving("jamba-v0.1-52b", device="cpu", verbose=False, **kw)
    assert got.tokens.shape == want.shape == (2, 8)
    np.testing.assert_array_equal(got.tokens.numpy(), want)
