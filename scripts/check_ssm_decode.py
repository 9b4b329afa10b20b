#!/usr/bin/env python3
"""How far mamba2-130m's decoded logits and its teacher-forced forward
lie from each other and from the same function taken in f64, on the CPU:
the bound ``chip_smoke.py`` holds the card's decode check to
(``SSM_SERVE_LOGIT_RTOL``).

    PYTHONPATH=src python3 scripts/check_ssm_decode.py [--arch mamba2-130m] [--layers N]

The model at its published widths (``--layers`` cuts the depth), weights
``init(PRNGKey(0))`` in f32 and in bf16, batch 4, prompt 64, 31 decoded
tokens into caches of 256 (``launch.serve.generate``); the teacher-forced
forward over the prompt and the decoded tokens; and, for f32, that
forward again with every f32 computation of the model taken in f64 (the
f32 weights cast up exactly).  Prints one JSON line: per dtype the
largest relative error ‖got − want‖/‖want‖ over the batch at each
decoded position, decode against forward, and for f32 each against f64.
Runs on the CPU only: it measures rounding, not time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import build_model, common, model as model_lib, ssm  # noqa: E402
from repro_torch.utils import tree_map  # noqa: E402

PROMPT, TOKENS, CACHE, BATCH = 64, 32, 256, 4


def rel_by_position(got: torch.Tensor, want: torch.Tensor) -> list:
    err = (got.double() - want.double()).norm(dim=-1) / want.double().norm(dim=-1)
    return [float(e) for e in err.amax(0)]


def forward_logits(model, params, seq) -> torch.Tensor:
    with torch.no_grad():
        h, _, _ = model.forward(params, {"tokens": seq})
        return model_lib._lm_head(model.cfg, params, h[:, PROMPT - 1:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--layers", type=int, default=0)
    args = ap.parse_args(argv)
    base = get_config(args.arch)
    if args.layers:
        base = dataclasses.replace(base, n_layers=args.layers)
    out = {"arch": args.arch, "n_layers": base.n_layers, "device": "cpu"}
    key = prng.PRNGKey(0)
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, param_dtype=dtype, activation_dtype=dtype)
        model = build_model(cfg, device="cpu")
        params = model.init(key)
        prompt = prng.randint(key, (BATCH, PROMPT), 0, cfg.vocab_size)
        res = generate(model, params, prompt, gen_tokens=TOKENS, cache_len=CACHE,
                       keep_logits=True)
        seq = torch.cat([prompt, res.tokens[:, :-1]], dim=1)
        decoded, forced = torch.cat(res.logits, dim=1), forward_logits(model, params, seq)
        row = {"decode_vs_forward": rel_by_position(decoded, forced)}
        if dtype == "float32":
            # every f32 step of the norms, the SSD and the head in f64
            saved = common.F32, ssm.F32, model_lib.F32
            common.DTYPES["float64"] = torch.float64
            common.F32 = ssm.F32 = model_lib.F32 = torch.float64
            try:
                cfg64 = dataclasses.replace(base, param_dtype="float64",
                                            activation_dtype="float64")
                exact = forward_logits(build_model(cfg64, device="cpu"),
                                       tree_map(lambda a: a.double(), params), seq)
            finally:
                common.F32, ssm.F32, model_lib.F32 = saved
                del common.DTYPES["float64"]
            row["decode_vs_f64"] = rel_by_position(decoded, exact)
            row["forward_vs_f64"] = rel_by_position(forced, exact)
        out[dtype] = {k: {"max": max(v), "by_position": [round(x, 7) for x in v]}
                      for k, v in row.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
