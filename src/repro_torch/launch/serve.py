"""Serving driver: batched prefill and greedy decode (the counterpart of
:mod:`repro.launch.serve`), on the card unless ``--device cpu``.

The prompt is ``prng.randint`` of ``PRNGKey(seed)`` over the vocabulary,
the weights ``model.init`` of the same key and, for a model with a
frontend, its frames ``0.02·normal`` of that key in f32, as in the JAX
package, so a seed gives the JAX package's greedy tokens.  ``--trace PATH`` writes
the ``serve/prefill`` and ``serve/decode`` spans and a
``serve/throughput`` counter as JSONL through :mod:`repro_torch.obs`.
Every config serves: the dense decoders, MLA and MoE (deepseek-v2-lite,
kimi-k2), the pure SSM (mamba2), the hybrid (jamba), the encoder-decoder
(seamless) and the frontend decoder (internvl2), on KV, int8, MLA and
Mamba caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b --tokens 32
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from repro_torch import prng, resolve_device
from repro_torch.configs import get_config
from repro_torch.distributed.trainer import greedy_tokens
from repro_torch.models import build_model
from repro_torch.obs import EventLog, trace_span


class ServeResult(NamedTuple):
    tokens: torch.Tensor      # (B, gen_tokens) int32: prefill's argmax, then each step's
    logits: list | None       # per generated token its (B, 1, V) logits, when kept
    prefill_s: float          # prompt → first token, to the device's end
    decode_s: float           # the gen_tokens − 1 decode steps
    ms_per_token: float       # decode_s a step (B tokens a step)
    tokens_per_s: float       # B · (gen_tokens − 1) / decode_s
    peak_bytes: int | None    # the device's peak allocation over the call (None on the CPU)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model, params, prompt: torch.Tensor, *, gen_tokens: int, cache_len: int,
             elog: EventLog | None = None, keep_logits: bool = False,
             frontend: torch.Tensor | None = None) -> ServeResult:
    """Prefill ``prompt`` (B, S), after ``frontend`` (B, F, fd) where the
    model takes one, into caches of ``cache_len`` and decode greedily up to
    ``gen_tokens`` tokens; ``keep_logits`` keeps each token's logits."""
    dev = prompt.device
    batch, prompt_len = prompt.shape
    cuda = dev.type == "cuda"
    if cuda:
        _sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    kept = []
    t0 = time.perf_counter()
    with trace_span("serve/prefill", log=elog, batch=batch, prompt_len=prompt_len):
        batch_in = {"tokens": prompt}
        if frontend is not None:
            batch_in["frontend"] = frontend
        logits, cache = model.prefill(params, batch_in, cache_len=cache_len)
        tok = greedy_tokens(logits)
        _sync(dev)
    t_prefill = time.perf_counter() - t0
    if keep_logits:
        kept.append(logits)

    out_tokens = [tok]
    t0 = time.perf_counter()
    with trace_span("serve/decode", log=elog, n_tokens=gen_tokens - 1):
        for _ in range(gen_tokens - 1):
            # build_serve_step's step, with the logits at hand to keep
            logits, cache = model.decode_step(params, cache, tok)
            tok = greedy_tokens(logits)
            if keep_logits:
                kept.append(logits)
            out_tokens.append(tok)
        gen = torch.cat(out_tokens, dim=1)
        _sync(dev)
    t_decode = time.perf_counter() - t0
    steps = max(gen_tokens - 1, 1)
    return ServeResult(
        tokens=gen, logits=kept if keep_logits else None, prefill_s=t_prefill,
        decode_s=t_decode, ms_per_token=t_decode / steps * 1e3,
        tokens_per_s=batch * steps / max(t_decode, 1e-9),
        peak_bytes=int(torch.cuda.max_memory_allocated(dev)) if cuda else None)


def serve_frontend(cfg, key: torch.Tensor, batch: int) -> torch.Tensor | None:
    """A served request's stubbed frontend: ``0.02·normal(key)`` in f32,
    (batch, enc_seq_len, frontend_dim) for an encoder-decoder, (batch,
    frontend_seq, frontend_dim) for a frontend decoder, else None."""
    if cfg.frontend == "none" and not cfg.enc_dec:
        return None
    fseq = cfg.enc_seq_len if cfg.enc_dec else cfg.frontend_seq
    return 0.02 * prng.normal(key, (batch, fseq, cfg.frontend_dim))


def run_serving(arch: str, *, batch: int = 4, prompt_len: int = 64, gen_tokens: int = 32,
                cache_len: int = 256, seed: int = 0, reduced: bool = True,
                trace: str | None = None, device="cuda", keep_logits: bool = False,
                verbose: bool = True) -> ServeResult:
    """Build ``arch`` (``reduced()`` unless ``reduced=False``), draw its
    weights and a prompt from ``PRNGKey(seed)`` and serve it on
    ``device``; ``result.tokens`` are the greedy tokens."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=dev)
    key = prng.PRNGKey(seed, device=dev)
    params = model.init(key)
    prompt = prng.randint(key, (batch, prompt_len), 0, cfg.vocab_size)
    frontend = serve_frontend(cfg, key, batch)
    elog = EventLog(tool="repro_torch.launch.serve", arch=arch, batch=batch,
                    prompt_len=prompt_len, gen_tokens=gen_tokens,
                    cache_len=cache_len) if trace else None
    res = generate(model, params, prompt, gen_tokens=gen_tokens, cache_len=cache_len,
                   elog=elog, keep_logits=keep_logits, frontend=frontend)
    if verbose:
        print(f"{arch}: prefill({batch}x{prompt_len}) {res.prefill_s:.2f}s, "
              f"decode {gen_tokens} tokens {res.decode_s:.2f}s "
              f"({res.ms_per_token:.0f} ms/tok)")
        print("sample:", res.tokens[0, :16].tolist())
    if elog is not None:
        # the batch's sequences decode together: batch tokens a step
        elog.event("counter", name="serve/throughput", prefill_s=res.prefill_s,
                   decode_s=res.decode_s, ms_per_token=res.ms_per_token,
                   tokens_per_s=res.tokens_per_s)
        elog.write_jsonl(trace)
        if verbose:
            print(f"wrote trace {trace}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the serve phase timings and throughput as JSONL")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    run_serving(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen_tokens=args.tokens, cache_len=args.cache_len, trace=args.trace,
                device=args.device)


if __name__ == "__main__":
    main()
