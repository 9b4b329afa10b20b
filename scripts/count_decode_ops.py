#!/usr/bin/env python3
"""Counts the torch operations one ``decode_step`` of internlm2-1.8b
dispatches, on the CPU.  The count depends on the model's structure (24
layers, a KV cache a layer), not on its widths, so the model keeps the
published layer plan and head counts at narrow widths (d_model 256,
head_dim 16, d_ff 512, vocab 1024) to fit any host.  On the card each
operation that moves data is a kernel launch and each one costs host
time, so the count is what sets a decoded token's time there.

    PYTHONPATH=src python3 scripts/count_decode_ops.py [--batch 4] [--cache-len 256]

Prints one JSON line: the operations a decode step dispatches, per layer,
and the most frequent ones by name.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


class CountOps(TorchDispatchMode):
    """Counts every operation dispatched inside the ``with`` block, by name."""

    def __init__(self):
        super().__init__()
        self.by_name = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.by_name[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--cache-len", type=int, default=256)
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), d_model=256, head_dim=16,
                              d_ff=512, vocab_size=1024)
    model = build_model(cfg, device="cpu")
    params = model.init(prng.PRNGKey(0, device="cpu"))
    prompt = torch.zeros((args.batch, args.prompt_len), dtype=torch.int32)
    _, cache = model.prefill(params, {"tokens": prompt}, cache_len=args.cache_len)
    token = torch.zeros((args.batch, 1), dtype=torch.int32)
    with CountOps() as count:
        model.decode_step(params, cache, token)
    total = sum(count.by_name.values())
    print(json.dumps({"arch": cfg.name, "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
                      "n_kv_heads": cfg.n_kv_heads, "batch": args.batch,
                      "cache_len": args.cache_len, "ops_per_decode_step": total,
                      "ops_per_layer": total / cfg.n_layers,
                      "most_frequent": count.by_name.most_common(12)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
