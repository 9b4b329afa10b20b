"""The port's checkpoints (``repro_torch.checkpoint``) and the launcher's
``ckpt_dir``/``resume``/``ckpt_every``/``keep_last`` and SIGTERM flush,
on the CPU.

The crash-safety cases are ``tests/test_checkpoint_safety.py``'s, on
trees of tensors.  Across the packages: the trainer's ``TrainState`` on
the JAX package's ``VectorModel`` (the quadratic of d = 16, m = 8,
``projected_sgd``) saved by one package restores in the other bit for
bit, with the same manifest keys; a bf16 leaf round-trips in the port and
a JAX-written one restores there, while the JAX package quarantines its
own (``ROADMAP.md`` §3).  The launcher runs internlm2-1.8b
``reduced(max_d_model=64)``, W = 4, seq 16: stopped and resumed, or
stopped by SIGTERM and resumed, its final state equals the uninterrupted
run's leaf for leaf, bits exact, and its history record for record
(each run on one CPU thread, see ``one_thread``).
"""
import json
import os
import signal
import threading
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.checkpoint.ckpt import _flatten_with_paths
from repro.core.solver import SolverConfig as JConfig
from repro.core.tree_harness import VectorModel as JVectorModel
from repro.data.problems import make_quadratic_problem as jquadratic
from repro.distributed import trainer as jtrainer
from repro.optim.optimizers import projected_sgd as jprojected_sgd
from repro_torch import prng, utils
from repro_torch.checkpoint import (
    CheckpointCorruptError,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.core.solver import SolverConfig
from repro_torch.core.tree_harness import VectorModel
from repro_torch.data.problems import make_quadratic_problem
from repro_torch.distributed import trainer as ttrainer
from repro_torch.launch import train as tlaunch
from repro_torch.optim.optimizers import projected_sgd


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The runs compared bit for bit take one CPU thread: torch splits a
    CPU reduction by the size of its thread team, so a team that comes up
    short on a loaded host would change a run's bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"a": torch.from_numpy(r.normal(size=(4, 3)).astype(np.float32)),
            "b": [torch.arange(5), {"c": torch.tensor(2.5 + seed, dtype=torch.float32)}],
            "step": 3 + seed}


def _assert_trees_equal(got, want):
    gl, wl = utils.tree_leaves(got), utils.tree_leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        else:
            assert type(a) is type(b) and a == b


def _npz(d, step):
    return os.path.join(d, f"ckpt_{step:08d}.npz")


def _truncate(path, keep=None):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2 if keep is None else keep)


def _rewrite_leaf0(path, fn):
    """Silent corruption: leaf_0 changed under the manifest's old checksum
    (the zip container stays valid)."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["leaf_0"] = fn(arrays["leaf_0"])
    np.savez(path, **arrays)


# ---------------------------------------------------------------- crash safety

@pytest.mark.parametrize("damage", ["truncated", "zero_byte", "checksum"])
def test_damaged_newest_falls_back(tmp_path, damage):
    """A truncated or empty newest file is no complete unit (latest_step
    skips it); a silently corrupted one is, and restore quarantines it and
    falls back to the step before."""
    d = str(tmp_path)
    save_checkpoint(d, 3, _tree(3))
    save_checkpoint(d, 7, _tree(7))
    if damage == "truncated":
        _truncate(_npz(d, 7))
    elif damage == "zero_byte":
        open(_npz(d, 7), "wb").close()
    else:
        _rewrite_leaf0(_npz(d, 7), lambda a: a + 1.0)
    if damage == "checksum":
        assert latest_step(d) == 7
        with pytest.warns(RuntimeWarning, match="quarantined"):
            got, step = restore_checkpoint(d, _tree())
        assert os.path.exists(_npz(d, 7) + ".corrupt") and not os.path.exists(_npz(d, 7))
    else:
        got, step = restore_checkpoint(d, _tree())
    assert step == 3 and latest_step(d) == 3
    _assert_trees_equal(got, _tree(3))


@pytest.mark.parametrize("damage", ["tail", "checksum"])
def test_pinned_step_raises_on_damage(tmp_path, damage):
    d = str(tmp_path)
    save_checkpoint(d, 3, _tree())
    save_checkpoint(d, 7, _tree(1))
    if damage == "tail":
        _truncate(_npz(d, 7), keep=os.path.getsize(_npz(d, 7)) - 16)
    else:
        _rewrite_leaf0(_npz(d, 7), lambda a: a * 2.0)
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(d, _tree(), step=7)
    got, step = restore_checkpoint(d, _tree(), step=3)
    assert step == 3
    _assert_trees_equal(got, _tree())


@pytest.mark.parametrize("case", ["empty_dir", "all_corrupt"])
def test_nothing_to_restore_raises(tmp_path, case):
    d = str(tmp_path)
    if case == "all_corrupt":
        save_checkpoint(d, 1, _tree())
        _rewrite_leaf0(_npz(d, 1), lambda a: a * 2.0)
        with pytest.warns(RuntimeWarning):
            with pytest.raises(FileNotFoundError, match="quarantined"):
                restore_checkpoint(d, _tree())
    else:
        assert latest_step(d) is None
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(d, _tree())


@pytest.mark.parametrize("case", ["missing_and_extra", "shape"])
def test_template_mismatch_is_a_value_error(tmp_path, case):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"a": torch.zeros(3)})
    if case == "shape":
        with pytest.raises(ValueError, match="shape mismatch"):
            restore_checkpoint(d, {"a": torch.zeros(4)})
        return
    with pytest.raises(ValueError) as ei:
        restore_checkpoint(d, {"zz": torch.zeros(3)})
    lines = str(ei.value).splitlines()
    missing = [ln for ln in lines if "missing" in ln][0]
    extra = [ln for ln in lines if "extra" in ln][0]
    assert "zz" in missing and "zz" not in extra
    assert "a" in extra and "a" not in missing


def _write_v1(d, step, tree):
    """The legacy layout: arrays-only npz and a sidecar json manifest."""
    items = utils.tree_flatten_with_path(tree)
    arrays = {f"leaf_{i}": np.asarray(v) for i, (_, v) in enumerate(items)}
    np.savez(_npz(d, step), **arrays)
    with open(os.path.join(d, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump({"step": step, "keys": [k for k, _ in items]}, f)


@pytest.mark.parametrize("sidecar", [True, False])
def test_legacy_v1(tmp_path, sidecar):
    d = str(tmp_path)
    _write_v1(d, 4, _tree(5))
    if not sidecar:   # npz committed, crash before the json: not advertised
        os.remove(os.path.join(d, "ckpt_00000004.json"))
        assert latest_step(d) is None
        return
    assert latest_step(d) == 4
    got, step = restore_checkpoint(d, _tree())
    assert step == 4
    _assert_trees_equal(got, _tree(5))


@pytest.mark.parametrize("case", ["stale_tmp", "keep_last", "keep_only_newest"])
def test_hygiene_and_retention(tmp_path, case):
    d = str(tmp_path)
    if case == "stale_tmp":
        save_checkpoint(d, 1, _tree())
        orphan = _npz(d, 2) + ".tmp-99999"
        for when in ("save", "restore"):
            with open(orphan, "wb") as f:
                f.write(b"partial write from a dead process")
            if when == "save":
                save_checkpoint(d, 2, _tree(1))
            else:
                restore_checkpoint(d, _tree())
            assert not os.path.exists(orphan)
        assert [f for f in os.listdir(d) if ".tmp" in f] == []
    elif case == "keep_last":
        for s in (1, 2, 3, 4, 5):
            save_checkpoint(d, s, _tree(s), keep_last=3)
        assert sorted(int(f[5:13]) for f in os.listdir(d) if f.endswith(".npz")) == [3, 4, 5]
    else:
        save_checkpoint(d, 9, _tree(), keep_last=1)
        assert latest_step(d) == 9
        _assert_trees_equal(restore_checkpoint(d, _tree())[0], _tree())


class _St(NamedTuple):
    p: dict
    step: int


def test_tree_flatten_with_path_is_jaxs():
    tree = _St(p={"b": [1, 2], "a": 3, "n": None, "e": ()}, step=4)
    assert [k for k, _ in utils.tree_flatten_with_path(tree)] == \
        [k for k, _ in _flatten_with_paths(tree)] == [".p/a", ".p/b/0", ".p/b/1", ".step"]


# ---------------------------------------------------------------- across the packages

QUAD_M, QUAD_STEPS = 8, 4
BACKENDS = {"dense": "f32", "dp_exact": "f32", "dp_sketch": "f32", "fused": "bf16"}


@pytest.fixture(scope="module")
def quads():
    return (jquadratic(d=16, sigma=1.0, L=8.0, V=1.0, seed=1),
            make_quadratic_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=1, device="cpu"))


def _states(quads, backend):
    """The JAX package's TrainState after QUAD_STEPS steps, and the port's
    initial one (the template) for the same configuration."""
    jq, tq = quads
    kw = dict(m=QUAD_M, T=12, eta=0.05, alpha=0.25, aggregator="byzantine_sgd",
              attack="sign_flip", guard_backend=backend, stats_dtype=BACKENDS[backend])
    jcfg, tcfg = JConfig(**kw), SolverConfig(**kw)
    jopt = jprojected_sgd(0.05, {"x": jq.x1}, jq.D)
    jmodel = JVectorModel(jq)
    state = jtrainer.init_train_state(jmodel, jopt, jcfg, jax.random.PRNGKey(0), V=jq.V,
                                      D=jq.D)
    step = jax.jit(jtrainer.build_train_step(jmodel, jopt, jcfg, V=jq.V, D=jq.D))
    rank = jnp.arange(QUAD_M, dtype=jnp.int32)
    for i in range(QUAD_STEPS):
        kk = jax.random.fold_in(jax.random.PRNGKey(7), i)
        noise = jax.random.normal(kk, (QUAD_M, jq.d))
        state, _ = step(state, {"noise": noise[:, None, :]}, rank, jax.random.fold_in(kk, 1))
    topt = projected_sgd(0.05, {"x": tq.x1}, tq.D)
    template = ttrainer.init_train_state(VectorModel(tq), topt, tcfg, prng.PRNGKey(0), V=tq.V,
                                         D=tq.D)
    return state, template


def _assert_port_equals_jax(port_tree, jax_tree):
    pl = utils.tree_flatten_with_path(port_tree)
    jl = _flatten_with_paths(jax_tree)
    assert [k for k, _ in pl] == [k for k, _ in jl]
    for (k, a), (_, b) in zip(pl, jl):
        b = np.asarray(b)
        if isinstance(a, torch.Tensor):
            if a.dtype == torch.bfloat16:
                assert b.dtype.name == "bfloat16", k
                np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                              b.view(np.int16), err_msg=k)
            else:
                assert str(a.dtype) == f"torch.{b.dtype}", k
                np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
        else:
            assert isinstance(a, int) and b.dtype == np.int32 and a == int(b), k


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_jax_written_train_state_restores_in_the_port(tmp_path, quads, backend):
    jstate, template = _states(quads, backend)
    d = str(tmp_path)
    jsave(d, QUAD_STEPS, jstate)
    got, step = restore_checkpoint(d, template)
    assert step == QUAD_STEPS and got.step == QUAD_STEPS
    _assert_port_equals_jax(got, jstate)


@pytest.mark.parametrize("backend", ["dense", "dp_exact", "dp_sketch"])
def test_port_written_train_state_restores_in_jax(tmp_path, quads, backend):
    jstate, template = _states(quads, backend)
    d = str(tmp_path)
    jsave(os.path.join(d, "jax"), QUAD_STEPS, jstate)
    ported, _ = restore_checkpoint(os.path.join(d, "jax"), template)
    save_checkpoint(os.path.join(d, "port"), QUAD_STEPS, ported)
    back, step = jrestore(os.path.join(d, "port"), jstate)
    assert step == QUAD_STEPS
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    manifests = []
    for who in ("jax", "port"):
        with np.load(_npz(os.path.join(d, who), QUAD_STEPS)) as z:
            manifests.append(json.loads(bytes(z["__manifest__"])))
    assert manifests[0]["keys"] == manifests[1]["keys"]
    assert manifests[0]["checksums"] == manifests[1]["checksums"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bf16_leaf_restores_in_the_port(tmp_path, writer):
    d = str(tmp_path)
    vals = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    jtree = {"B": jnp.asarray(vals, jnp.bfloat16), "k": jnp.int32(5)}
    tree = {"B": torch.from_numpy(vals).to(torch.bfloat16), "k": 5}
    if writer == "jax":
        jsave(d, 1, jtree)
    else:
        save_checkpoint(d, 1, tree)
    with np.load(_npz(d, 1)) as z:
        assert z["leaf_0"].dtype == np.dtype("V2")
        manifest = json.loads(bytes(z["__manifest__"]))
    template = {"B": torch.zeros(3, 4, dtype=torch.bfloat16), "k": 0}
    got, _ = restore_checkpoint(d, template)
    _assert_trees_equal(got, tree)
    assert manifest["checksums"][0] == _jax_manifest_checksum(tmp_path, jtree)


def _jax_manifest_checksum(tmp_path, jtree):
    d = str(tmp_path / "jax_sum")
    jsave(d, 1, jtree)
    with np.load(_npz(d, 1)) as z:
        return json.loads(bytes(z["__manifest__"]))["checksums"][0]


def test_reference_quarantines_its_own_bf16_checkpoint(tmp_path):
    """The JAX package hashes a bf16 leaf as ``bfloat16`` when it writes
    it and as ``|V2`` when it reads it back, so it cannot restore its own
    bf16 checkpoints (``ROADMAP.md`` §3); the port reads the same file."""
    d = str(tmp_path)
    jtree = {"a": jnp.ones(3, jnp.bfloat16), "b": jnp.zeros(2)}
    jsave(d, 1, jtree)
    with pytest.warns(RuntimeWarning, match="checksum mismatch on leaf_0"):
        with pytest.raises(FileNotFoundError):
            jrestore(d, jtree)
    jsave(d, 1, jtree)
    got, _ = restore_checkpoint(d, {"a": torch.zeros(3, dtype=torch.bfloat16),
                                    "b": torch.ones(2)})
    assert torch.equal(got["a"], torch.ones(3, dtype=torch.bfloat16))


# ---------------------------------------------------------------- the launcher

LAUNCH = dict(reduced=True, d_model=64, workers=4, seq_len=16, steps=20, log_every=4,
              guard_backend="dp_sketch", device="cpu", verbose=False)
STOP = 10


@pytest.fixture(scope="module")
def uninterrupted():
    """The scan driver's run; the loop driver's is the same run
    (``tests/test_torch_lm_trainer.py::test_scan_and_loop_drivers_agree_and_trace``)."""
    return tlaunch.run_training("internlm2-1.8b", **LAUNCH)


def _assert_same_run(got, want):
    (gs, gh), (ws, wh) = got, want
    _assert_trees_equal(gs, ws)
    np.testing.assert_equal(gh, wh)   # NaN (n_reporting off) equal to NaN


@pytest.mark.parametrize("driver", ["scan", "loop"])
def test_resume_equals_uninterrupted(tmp_path, uninterrupted, driver):
    """Stop after 10 of 20 steps (not a multiple of log_every: the resumed
    scan driver runs a head of 2 steps), with a checkpoint every 4 steps
    and the newest 2 kept, then resume: params, AdamW moments, the guard's
    A, B and gram_B, the anchor, prev_xi, ever_byz, adv and the step equal
    the uninterrupted run's bit for bit, and the history record for
    record."""
    d = str(tmp_path)
    kw = dict(LAUNCH, driver=driver, ckpt_dir=d, ckpt_every=4, keep_last=2)
    _, head = tlaunch.run_training("internlm2-1.8b", stop_after=STOP, **kw)
    assert latest_step(d) == STOP and len(head) == STOP
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == \
        ["ckpt_00000008.npz", "ckpt_00000010.npz"]
    got = tlaunch.run_training("internlm2-1.8b", resume=True, **kw)
    _assert_same_run(got, uninterrupted)
    with open(os.path.join(d, "history.json")) as f:
        np.testing.assert_equal(json.load(f), got[1])
    # a resume at the end runs no step and keeps the label
    again = tlaunch.run_training("internlm2-1.8b", resume=True, **kw)
    _assert_same_run(again, uninterrupted)
    assert latest_step(d) == LAUNCH["steps"]


def test_sigterm_flushes_a_final_checkpoint(tmp_path, monkeypatch, uninterrupted):
    """SIGTERM to this process after the first chunk: the run stops at that
    segment boundary with a final checkpoint of its step, the handler is
    put back, and resuming gives the uninterrupted run."""
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("a SIGTERM handler is installed only on the main thread")
    calls = {"n": 0}
    fetch = tlaunch.fetch_metrics

    def fetch_then_signal(ms):
        calls["n"] += 1
        if calls["n"] == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return fetch(ms)

    monkeypatch.setattr(tlaunch, "fetch_metrics", fetch_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    d = str(tmp_path)
    state, hist = tlaunch.run_training("internlm2-1.8b", ckpt_dir=d, **LAUNCH)
    assert signal.getsignal(signal.SIGTERM) is before
    assert state.step == LAUNCH["log_every"] == latest_step(d) and len(hist) == state.step
    monkeypatch.setattr(tlaunch, "fetch_metrics", fetch)
    got = tlaunch.run_training("internlm2-1.8b", ckpt_dir=d, resume=True, **LAUNCH)
    _assert_same_run(got, uninterrupted)


def test_cli_checkpoint_flags(tmp_path, capsys):
    d = str(tmp_path)
    args = ["--arch", "internlm2-1.8b", "--d-model", "64", "--workers", "4", "--steps", "4",
            "--seq-len", "16", "--log-every", "2", "--device", "cpu", "--ckpt-dir", d,
            "--ckpt-every", "2", "--keep-last", "1"]
    tlaunch.main(args + ["--stop-after", "2"])
    assert latest_step(d) == 2
    tlaunch.main(args + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed from" in out and latest_step(d) == 4
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == ["ckpt_00000004.npz"]
    with open(os.path.join(d, "history.json")) as f:
        assert [r["step"] for r in json.load(f)] == [0, 1, 2, 3]
