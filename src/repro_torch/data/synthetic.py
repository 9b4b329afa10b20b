"""Deterministic synthetic token pipeline for LM training (the counterpart
of :mod:`repro.data.synthetic`).

Worker w at step k draws its batch from ``fold_in(fold_in(PRNGKey(seed),
w), k)``: per-worker disjoint streams, exactly reproducible, with tokens
bit-equal to the JAX package's.  The sequences follow a learnable
recurrence ``token_{t+1} = (a·token_t + b + shift + noise) mod vocab``.
The W workers' keys are drawn as one batch of keys and the recurrence runs
once over all W·b rows, on the device of the keys.  ``poison_mask`` is
the label-flip data attack: poisoned workers' labels shift by vocab/2.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import prng
from repro_torch.kernels.gradgen import threefry2x32


def _fold_in_each(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``vmap(fold_in)`` over (..., 2) keys and a matching batch of 32-bit
    ``data``."""
    x0, x1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack([x0, x1], dim=-1)


class SyntheticTokens(NamedTuple):
    vocab_size: int
    seq_len: int
    seed: int = 0
    # Markov-ish structure: token_{t+1} = (a * token_t + b + noise) % vocab
    a: int = 31
    b: int = 7
    noise_levels: int = 8

    def worker_keys(self, workers, step: int, device="cuda") -> torch.Tensor:
        """(W, 2) keys ``fold_in(fold_in(PRNGKey(seed), w), step)`` for the
        workers ``workers`` (a sequence of ints or an int tensor)."""
        base = prng.PRNGKey(self.seed, device=device)
        w = torch.as_tensor(workers, dtype=torch.int64, device=device)
        keys = _fold_in_each(base.expand(w.shape[0], 2), w)
        return _fold_in_each(keys, torch.full_like(w, int(step)))

    def sample_keys(self, keys: torch.Tensor, batch: int, b_shift=0) -> torch.Tensor:
        """(W, batch, seq_len+1) int32 sequences, one batch per key of
        ``keys`` (W, 2); ``b_shift`` (an int or a (W,) int tensor) offsets
        each worker's recurrence constant (the non-iid axis; 0 reproduces
        the iid stream bit for bit)."""
        halves = prng.split(keys)                                     # (W, 2, 2)
        x0 = prng.randint(halves[:, 0], (batch,), 0, self.vocab_size).to(torch.int64)
        noise = prng.randint(halves[:, 1], (batch, self.seq_len + 1), 0,
                             self.noise_levels).to(torch.int64)
        shift = torch.as_tensor(b_shift, dtype=torch.int64, device=keys.device)
        if shift.dim() == 1:
            shift = shift[:, None]
        const = self.b + shift
        tok, out = x0, []
        for t in range(self.seq_len + 1):
            tok = torch.remainder(self.a * tok + const + noise[..., t], self.vocab_size)
            out.append(tok)
        # joined out of place, so a vmap over runs with per-run shifts maps it
        return torch.stack(out, dim=-1).to(torch.int32)

    def sample(self, worker: int, step: int, batch: int, b_shift=0,
               device="cuda") -> torch.Tensor:
        """(batch, seq_len+1) sequences of one worker; inputs and
        next-token labels come from slicing."""
        keys = self.worker_keys([int(worker)], step, device)
        shift = b_shift if isinstance(b_shift, int) else torch.as_tensor(b_shift).reshape(1)
        return self.sample_keys(keys, batch, shift)[0]


def make_worker_batch(stream: SyntheticTokens, n_workers: int, per_worker_batch: int,
                      step: int, poison_mask: torch.Tensor | None = None,
                      skew: torch.Tensor | None = None, device="cuda") -> dict:
    """Global batch with a leading worker axis: {'tokens': (W, b, S),
    'labels': (W, b, S)} int32 on ``device``.  ``poison_mask`` (W,) bool
    flips the poisoned workers' labels by vocab/2; ``skew`` ((W,) f32)
    shifts worker w's recurrence constant by ``round(skew[w]·(vocab//4))``
    (``skew ≡ 0`` is bit-identical to the iid pipeline)."""
    keys = stream.worker_keys(range(n_workers), step, device)
    if skew is None:
        shifts = 0
    else:
        shifts = torch.round(skew.to(device) * float(stream.vocab_size // 4)).to(torch.int32)
    seqs = stream.sample_keys(keys, per_worker_batch, shifts)
    tokens, labels = seqs[..., :-1], seqs[..., 1:]
    if poison_mask is not None:
        flipped = (labels + stream.vocab_size // 2) % stream.vocab_size
        labels = torch.where(poison_mask.to(device)[:, None, None], flipped, labels)
    return {"tokens": tokens, "labels": labels}
