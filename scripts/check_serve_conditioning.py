#!/usr/bin/env python3
"""How far a reduced config's served f32 logits lie from the same decode
taken in f64, on the CPU: the rounding the card's greedy tokens are
compared against the CPU's within (``chip_smoke.py``'s
``GREEDY_RTOL``).

    PYTHONPATH=src python3 scripts/check_serve_conditioning.py --arch seamless-m4t-large-v2 \\
        [--rescaled]

``run_serving``'s reduced config, weights, prompt and frontend from
``PRNGKey(0)`` (batch 4, prompt 64, 32 tokens, cache 256) through
``launch.serve.generate`` in f32 (with ``--rescaled``, on the weights
with the attention rescaled, ``chip_smoke.attention_rescaled``, as
``chip_smoke.serve_rescaled`` serves them); then the same prefill and decode with
every weight and activation in f64, fed the f32 run's tokens.  Prints one
JSON line: the largest relative error ‖f32 − f64‖/‖f64‖ of the logits
over the batch at each position, and the smallest relative gap between
the f32 run's top two logits.  Runs on the CPU only: it measures
rounding, not time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import generate, serve_frontend  # noqa: E402
from repro_torch.models import build_model, common  # noqa: E402
from repro_torch.utils import tree_map  # noqa: E402

PROMPT, TOKENS, CACHE, BATCH = 64, 32, 256, 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="seamless-m4t-large-v2")
    ap.add_argument("--rescaled", action="store_true",
                    help="the attention rescaled, as chip_smoke.serve_rescaled serves it")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).reduced()
    key = prng.PRNGKey(0)
    model = build_model(cfg, device="cpu")
    params = model.init(key)
    if args.rescaled:
        from chip_smoke import attention_rescaled
        params = attention_rescaled(params, cfg)
    prompt = prng.randint(key, (BATCH, PROMPT), 0, cfg.vocab_size)
    frontend = serve_frontend(cfg, key, BATCH)
    res = generate(model, params, prompt, gen_tokens=TOKENS, cache_len=CACHE, keep_logits=True,
                   frontend=frontend)
    got = torch.cat(res.logits, dim=1).double()                       # (B, T, V)

    common.DTYPES.setdefault("float64", torch.float64)
    model64 = build_model(dataclasses.replace(cfg, param_dtype="float64",
                                              activation_dtype="float64"), device="cpu")
    batch = {"tokens": prompt}
    if frontend is not None:
        batch["frontend"] = frontend.double()
    with torch.no_grad():
        params64 = tree_map(lambda a: a.double(), params)
        logits, cache = model64.prefill(params64, batch, cache_len=CACHE)
        want = [logits]
        for t in range(TOKENS - 1):
            logits, cache = model64.decode_step(params64, cache, res.tokens[:, t:t + 1])
            want.append(logits)
    want = torch.cat(want, dim=1)
    err = ((got - want).norm(dim=-1) / want.norm(dim=-1)).amax(0)      # (T,)
    top = torch.topk(got, 2, dim=-1).values
    gap = (top[..., 0] - top[..., 1]) / top[..., 0].abs()
    print(json.dumps({"arch": args.arch, "rescaled": args.rescaled, "d_model": cfg.d_model,
                      "batch": BATCH,
                      "prompt": PROMPT, "tokens": TOKENS,
                      "f32_vs_f64_max": float(err.max()),
                      "f32_vs_f64_by_position": [float(f"{e:.2e}") for e in err],
                      "top2_gap_min": float(gap.min())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
