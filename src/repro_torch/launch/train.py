"""Training driver (the counterpart of :mod:`repro.launch.train`).

Runs real steps on the card (``--device cpu`` for the CPU).  Byzantine
workers are simulated on the worker axis; the guard backend, optimizer and
data pipeline are all exercised.

Aggregation is the solver's guard axis: ``--aggregator byzantine_sgd``
with ``--guard-backend`` one of ``dp_exact`` (auto-V, the default),
``dp_sketch`` (CountSketch statistics), ``dense`` or ``fused`` (no auto-V:
pass ``--guard-v``), or a stateless baseline via ``--aggregator``.  The
adversary is a static gradient attack (``--attack``), the ``label_flip``
data attack, or a Remark-2.3 scenario built around the attack
(``--scenario``: static, lie_low, churn, adaptive, coalition).

Two drivers: ``scan`` (default) keeps a chunk of ``log_every`` steps'
metrics on the device and moves them to the host in one transfer at the
chunk's end, the contract of the JAX package's ``lax.scan`` chunk;
``loop`` moves them every step.  Both run the same step function.

PRNG: ``split(PRNGKey(seed), 4)`` fans the seed into init / mask / data /
loop keys; step i's attack key is ``fold_in(loop_key, i)``, a model with a
frontend draws step i's frames from ``fold_in(data_key, i)`` in the
activation dtype (:func:`frontend_batch`), and the Byzantine ranks are
``byz_rank(mask_key, W)``, as in the JAX package.

Checkpoints: ``ckpt_dir`` gets a final checkpoint of the whole
``TrainState`` (labelled with its own step) and ``history.json``;
``ckpt_every`` adds one at every segment boundary that is a multiple of
it, ``keep_last`` keeps the newest N, and ``resume`` continues from the
newest valid one, keeping the history records of the steps before it.  A
SIGTERM sets a flag the drivers read at segment boundaries: the run stops
there and writes its final checkpoint (a launcher off the main thread
installs no handler).  The format is :mod:`repro_torch.checkpoint`'s, the
JAX package's.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --reduced --workers 8 --steps 100 --alpha 0.25 --attack sign_flip \\
        --guard-backend dp_exact --scenario churn
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.solver import SolverConfig, byz_rank
from repro_torch.data.synthetic import SyntheticTokens, make_worker_batch
from repro_torch.distributed.trainer import build_train_step, init_train_state
from repro_torch.models import build_model
from repro_torch.models.common import resolve_dtype
from repro_torch.obs import EventLog, TelemetryConfig, trace_span
from repro_torch.optim import adamw, linear_warmup_cosine

GUARD_BACKENDS = ("dp_exact", "dp_sketch", "dense", "fused")
SCENARIOS = ("static", "lie_low", "churn", "adaptive", "coalition")


def _make_scenario_adversary(name: str, attack: str, alpha: float, steps: int, workers: int):
    from repro_torch.scenarios import (
        ScenarioAdversary,
        scenario_adaptive,
        scenario_churn,
        scenario_coalition,
        scenario_lie_low_then_strike,
        scenario_static,
    )

    if name == "static":
        scn = scenario_static(attack)
    elif name == "lie_low":
        scn = scenario_lie_low_then_strike(attack, switch_step=steps // 2)
    elif name == "churn":
        scn = scenario_churn(attack, period=max(steps // 2, 1), stride=max(workers // 8, 1))
    elif name == "adaptive":
        scn = scenario_adaptive(attack, adapt_rate=0.5)
    elif name == "coalition":
        scn = scenario_coalition(attack, "inner_product", 0.5)
    else:
        raise KeyError(f"unknown scenario {name!r}; have {SCENARIOS}")
    return ScenarioAdversary(scenario=scn, alpha=np.float32(alpha))


def fetch_metrics(ms: list[dict]) -> list[dict]:
    """Metrics of a run of steps on the host, in one device→host transfer:
    every tensor value is packed into one f32 vector (counts are exact in
    f32), host numbers pass through."""
    parts, where = [], []
    for j, m in enumerate(ms):
        for name, v in m.items():
            if isinstance(v, torch.Tensor):
                where.append((j, name, tuple(v.shape), v.numel()))
                parts.append(v.detach().reshape(-1).to(torch.float32))
    host = torch.cat(parts).cpu().numpy() if parts else np.zeros(0, np.float32)
    out = [dict(m) for m in ms]
    ofs = 0
    for j, name, shape, n in where:
        val = host[ofs: ofs + n].reshape(shape)
        out[j][name] = val if shape else val[()]
        ofs += n
    return out


def frontend_batch(cfg, key: torch.Tensor, lead: tuple) -> torch.Tensor:
    """The stubbed frontend's embeddings, ``0.02·normal`` of ``key`` in the
    activation dtype: (*lead, enc_seq_len or frontend_seq, frontend_dim)
    (the encoder's frames for an encoder-decoder, else the patches put
    before the tokens), as the JAX package draws them."""
    dtype = resolve_dtype(cfg.activation_dtype)
    fseq = cfg.enc_seq_len if cfg.enc_dec else cfg.frontend_seq
    draw = prng.normal(key, (*lead, fseq, cfg.frontend_dim), dtype)
    return torch.tensor(0.02, dtype=dtype, device=key.device) * draw


def run_training(
    arch: str, *, reduced: bool = True, workers: int = 8, per_worker_batch: int = 2,
    seq_len: int = 128, steps: int = 100, alpha: float = 0.25,
    attack: str = "sign_flip", aggregator: str = "byzantine_sgd",
    guard_backend: str = "dp_exact", guard_opts: tuple = (),
    stats_dtype: str = "f32",
    guard_v: float = 0.0, scenario: str | None = None, lr: float = 3e-3,
    seed: int = 0, ckpt_dir: str | None = None, resume: bool = False,
    stop_after: int | None = None, log_every: int = 10, d_model: int = 256,
    driver: str = "scan", trace: str | None = None,
    ckpt_every: int | None = None, keep_last: int | None = None, device="cuda",
    verbose: bool = True,
):
    """Train ``steps`` steps on ``device``; returns (final TrainState,
    per-step history).  ``trace`` (a path) arms the guard flight recorder:
    the frames ride the metrics flush and are written with ``train/chunk``
    host spans and the run's provenance as JSONL at that path.
    ``stop_after`` stops after that many steps while every schedule stays
    sized by ``steps``.  ``verbose`` prints a line a chunk.  Checkpoints:
    the module docstring."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced(max_d_model=d_model)
    model = build_model(cfg, device=dev)
    stream = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=seq_len, seed=seed)
    opt = adamw(linear_warmup_cosine(lr, warmup=max(steps // 20, 1), total_steps=steps),
                grad_clip=1.0)
    # label_flip poisons the DATA of Byzantine workers (their gradients are
    # honest gradients of corrupted batches): no gradient-level transform
    grad_attack = "none" if attack == "label_flip" else attack
    if scenario is not None and attack == "label_flip":
        raise ValueError("label_flip is a data attack; scenarios schedule "
                         "gradient attacks — pick one")
    scfg = SolverConfig(
        m=workers, T=steps, eta=lr, alpha=alpha, aggregator=aggregator,
        attack=grad_attack, mean_over_alive=True,
        guard_backend=guard_backend, guard_opts=tuple(guard_opts),
        stats_dtype=stats_dtype,
    )
    adversary = (_make_scenario_adversary(scenario, grad_attack, alpha, steps, workers)
                 if scenario is not None else None)
    telemetry = TelemetryConfig(enabled=True) if trace else None
    elog = None
    if trace:
        elog = EventLog(
            tool="repro_torch.launch.train", arch=arch, workers=workers,
            steps=steps, alpha=alpha, attack=attack, aggregator=aggregator,
            guard_backend=guard_backend, scenario=scenario, seed=seed,
        )
    train_step = build_train_step(model, opt, scfg, V=guard_v, adversary=adversary,
                                  telemetry=telemetry)

    # PRNG: one split at the top → disjoint init / mask / data / loop streams
    init_key, mask_key, data_key, loop_key = prng.split(prng.PRNGKey(seed, device=dev), 4)
    state = init_train_state(model, opt, scfg, init_key, V=guard_v, adversary=adversary)
    rank = byz_rank(mask_key, workers)
    static_mask = rank < scfg.n_byzantine
    poison = static_mask if attack == "label_flip" else None
    start = 0
    history: list[dict] = []
    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        state, start = restore_checkpoint(ckpt_dir, state)
        if verbose:
            print(f"resumed from {ckpt_dir} at step {start}")
        hist_path = os.path.join(ckpt_dir, "history.json")
        if os.path.exists(hist_path):
            # keep the records before the restart so history.json stays whole
            with open(hist_path) as f:
                history = [r for r in json.load(f) if r["step"] < start]
    stop = steps if stop_after is None else min(stop_after, steps)
    run_label = f"train/{arch}"
    n_prior = len(history)

    def make_batch(i):
        batch = make_worker_batch(stream, workers, per_worker_batch, i, poison_mask=poison,
                                  device=dev)
        if cfg.frontend != "none":
            batch["frontend"] = frontend_batch(cfg, prng.fold_in(data_key, i),
                                               (workers, per_worker_batch))
        return batch

    def one_step(st, i):
        return train_step(st, make_batch(i), rank, prng.fold_in(loop_key, i))

    def flush_recs(ms: list[dict], lo: int):
        """Host-side split of one transfer: ``tel/`` forensics go to the
        event log as guard_step events, the rest becomes history records."""
        for j, m in enumerate(fetch_metrics(ms)):
            rec, frame = {}, {}
            for name, v in m.items():
                if name.startswith("tel/"):
                    frame[name[4:]] = v
                else:
                    rec[name] = float(v)
            rec["step"] = lo + j
            history.append(rec)
            if elog is not None and frame:
                elog.guard_step(frame, run=run_label)

    # preemption: SIGTERM sets a flag the drivers read at segment
    # boundaries; the run stops there and the tail below writes the final
    # checkpoint and history, instead of dying with its progress on the card
    preempted = {"hit": False}
    prev_sigterm = None
    if ckpt_dir:
        def _on_sigterm(signum, frame):
            preempted["hit"] = True
        try:
            prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            prev_sigterm = None  # not the main thread: no handler, no flush

    def maybe_ckpt(state, lo):
        """A mid-run save at a segment boundary."""
        if ckpt_dir and ckpt_every and lo < stop and lo % ckpt_every == 0:
            save_checkpoint(ckpt_dir, state.step, state, keep_last=keep_last)

    t0 = time.time()

    def log(rec):
        if verbose:
            print(f"step {rec['step']:5d}  loss={rec['loss_good_workers']:.4f}  "
                  f"alive={int(rec['n_alive'])}/{workers}  "
                  f"byz_alive={int(rec.get('byz_alive', 0))}  "
                  f"good_filtered={int(rec.get('good_filtered', 0))}  "
                  f"({(time.time() - t0) / max(len(history) - n_prior, 1):.2f}s/step)",
                  flush=True)

    try:
        if driver == "scan":
            def run_segment(state, lo, hi):
                with trace_span("train/chunk", log=elog, lo=lo, hi=hi):
                    ms = []
                    for i in range(lo, hi):
                        state, m = one_step(state, i)
                        ms.append(m)
                    flush_recs(ms, lo)
                log(history[-1])
                return state

            # segments end on multiples of log_every: a resume from an unaligned
            # step first runs the head up to the next multiple
            lo = start
            head = max(min((log_every - start % log_every) % log_every, stop - start), 0)
            if head:
                state = run_segment(state, lo, lo + head)
                lo += head
                maybe_ckpt(state, lo)
            while lo < stop and not preempted["hit"]:
                hi = min(lo + log_every, stop)
                state = run_segment(state, lo, hi)
                lo = hi
                maybe_ckpt(state, lo)
        elif driver == "loop":
            for i in range(start, stop):
                if preempted["hit"]:
                    break
                state, m = one_step(state, i)
                flush_recs([m], i)
                if i % log_every == 0 or i == stop - 1:
                    log(history[-1])
                maybe_ckpt(state, i + 1)
        else:
            raise KeyError(f"unknown driver {driver!r}; have scan|loop")

        if preempted["hit"] and verbose:
            print(f"SIGTERM: preempted at step {state.step} — flushing final checkpoint")
        if ckpt_dir:
            # labelled with the state's own count: a resume at or past `stop`
            # runs no step, and the label must not go backwards
            save_checkpoint(ckpt_dir, state.step, state, keep_last=keep_last)
            with open(os.path.join(ckpt_dir, "history.json"), "w") as f:
                json.dump(history, f)
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
    if elog is not None:
        elog.add_meta(wall_s=time.time() - t0, steps_run=max(stop - start, 0))
        elog.write_jsonl(trace)
        if verbose:
            print(f"wrote trace {trace} ({len(elog.events)} events)")
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--per-worker-batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--attack", default="sign_flip",
                    choices=["none", "sign_flip", "random_gaussian", "constant_drift", "alie",
                             "inner_product", "hidden_shift", "label_flip"])
    ap.add_argument("--aggregator", default="byzantine_sgd",
                    choices=["byzantine_sgd", "mean", "coordinate_median", "trimmed_mean",
                             "krum"])
    ap.add_argument("--guard-backend", default="dp_exact", choices=list(GUARD_BACKENDS),
                    help="guard realization; dense/fused need --guard-v")
    ap.add_argument("--stats-dtype", default="f32", choices=["f32", "bf16"],
                    help="guard statistics precision; gradients cast once at ravel")
    ap.add_argument("--guard-v", type=float, default=0.0,
                    help="explicit Assumption-2.2 V (0 = auto-calibrate, dp backends only)")
    ap.add_argument("--scenario", default=None, choices=list(SCENARIOS),
                    help="Remark-2.3 scenario adversary built around --attack")
    ap.add_argument("--driver", default="scan", choices=["scan", "loop"])
    ap.add_argument("--d-model", type=int, default=256, help="reduced-config width cap")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None, metavar="N",
                    help="also checkpoint every N steps mid-run (at segment boundaries)")
    ap.add_argument("--keep-last", type=int, default=None, metavar="K",
                    help="retain only the newest K complete checkpoints")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--stop-after", type=int, default=None, metavar="N",
                    help="stop after N steps (schedules stay sized by --steps)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="arm the guard flight recorder and write the JSONL event log here")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    run_training(
        args.arch, reduced=args.reduced, workers=args.workers,
        per_worker_batch=args.per_worker_batch, seq_len=args.seq_len, steps=args.steps,
        alpha=args.alpha, attack=args.attack, aggregator=args.aggregator,
        guard_backend=args.guard_backend, stats_dtype=args.stats_dtype,
        guard_v=args.guard_v, scenario=args.scenario, driver=args.driver, lr=args.lr,
        seed=args.seed, ckpt_dir=args.ckpt_dir, resume=args.resume,
        log_every=args.log_every, trace=args.trace, ckpt_every=args.ckpt_every,
        keep_last=args.keep_last, stop_after=args.stop_after, d_model=args.d_model,
        device=args.device,
    )


if __name__ == "__main__":
    main()
