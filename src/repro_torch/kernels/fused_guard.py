"""One-pass guard statistics: the wrapper of the CUDA kernel
``csrc/fused_guard.cu``, which replaces the JAX package's
``fused_guard_pallas`` (``sanitize=False`` and ``sanitize=True``).

``fused_guard_cuda(grads, B, delta)`` returns ``(gram_g, cross, a_inc,
B_new)`` = (g gᵀ, B gᵀ, g·δ, B + g) for CUDA tensors, with f32 Grams and
A-increments and ``B_new`` in ``B.dtype`` (f32 or bf16).  With
``sanitize=True`` it launches the sanitizing variant, which zeroes NaN/Inf
entries of g before every product and the B store, and returns a fifth
output ``nf``, each row's (m,) int32 count of non-finite entries.  The
plain versions are :func:`repro_torch.kernels.ref.fused_guard_ref` and
``fused_guard_sanitize_ref``; :mod:`ops` chooses between kernel and plain
version by the tensor's device.  The TPU's ``d_block`` strip width has no
counterpart here: the kernel takes any d without padding.

``fused_guard_cuda.launches`` counts launches of the plain variant,
``fused_guard_cuda.launches_sanitize`` those of the sanitizing one.

The two generating kernels replace ``fused_guard_gen_pallas`` and
``gen_xi_pallas``: ``fused_guard_gen_cuda`` is the sweep above with each
tile of g generated in the kernel from the worker keys and the attack
parameters (``csrc/fused_guard.cu``'s ``rt_fused_guard_gen``: flag ``GEN``
there at f32, in ``csrc/guard_sweep.cuh`` at bf16; the generator is
``csrc/gen_rows.cuh``), and
``gen_xi_cuda`` the filtered-mean loop of ``csrc/filtered_mean.cu`` over
generated rows, returning ξ and the Byzantine row sum.  Neither reads or
writes an (m, d) gradient batch.  ALIE's honest column moments are taken
once a step: ``fused_guard_gen_cuda(..., moments=buf)`` leaves them in
``buf`` and ``gen_xi_cuda(..., moments=buf)`` reads them.  Their plain
versions are ``ref.fused_guard_gen_ref`` and ``ref.gen_xi_ref``; each
counts its launches in ``.launches``.

Every wrapper has a run-axis form for a campaign group, one launch for
its R runs (``*_runs_cuda``; :mod:`repro_torch.kernels.run_axis` calls
them under ``torch.func.vmap``).  ``fused_guard_gen_runs_cuda`` returns
the (R, 2, d) moments as a fifth output, and ``gen_xi_runs_cuda`` takes
them as an input, so neither mutates an argument.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gradgen import GEN_NPARAMS, MASK32

# The port's one worker cap: every CUDA wrapper takes 1 <= m <= MAX_WORKERS
# and raises above it (csrc/common.cuh repeats it for the kernels).  It is
# filtered_mean's bound: its m weights fit in 48 KB of shared memory.  The
# Pallas kernels set no cap; ROADMAP.md §3 lists this as a difference.
MAX_WORKERS = 12288
_TILE = 32
# blocks per SM that fill the card: at m <= 128, 2 d-splits per SM times
# 16 worker-tile pairs
_BLOCKS_PER_SM = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int64] + [ctypes.c_void_p] * 10
             + [ctypes.c_int64] * 4 + [ctypes.c_void_p])
_SANITIZE_ARGTYPES = ([ctypes.c_int64] + [ctypes.c_void_p] * 12
                      + [ctypes.c_int64] * 4 + [ctypes.c_void_p])
_GEN_ARGTYPES = ([ctypes.c_int64] + [ctypes.c_void_p] * 18
                 + [ctypes.c_int64] * 4 + [ctypes.c_void_p])
_GEN_XI_ARGTYPES = ([ctypes.c_int64] + [ctypes.c_void_p] * 13
                    + [ctypes.c_int64] * 4 + [ctypes.c_void_p])
# columns of d per tile of the sweep: f32 on the CUDA cores, bf16 on the
# tensor cores (csrc/guard_sweep.cuh); the d-splits count these tiles
_SWEEP_TILE = {torch.float32: 64, torch.bfloat16: 128}


def check_cuda_inputs(name: str, tensors: dict, dtypes) -> torch.device:
    """Raise unless every tensor is a contiguous CUDA tensor of one of
    ``dtypes`` on one device; returns that device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors on one device, got "
                         + ", ".join(f"{k} on {t.device}" for k, t in tensors.items()))
    for k, t in tensors.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {k} has dtype {t.dtype}, expected one of {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    return next(iter(devices))


def check_workers(name: str, m: int) -> None:
    """Raise unless 1 <= m <= MAX_WORKERS, naming the cap."""
    if not 1 <= m <= MAX_WORKERS:
        raise ValueError(f"{name}: takes 1 <= m <= MAX_WORKERS = {MAX_WORKERS} workers "
                         f"(the port's worker cap), got m={m}")


def d_splits(n_tiles: int, tile_pairs: int, dev: torch.device) -> int:
    """How many blocks split d: enough that ``d_splits · tile_pairs``
    blocks fill the card, at least one, at most two per SM and at most
    ``n_tiles``.  A function of the shape only, so the order of the
    sums, and the bits, repeat from call to call; the partials
    (``d_splits`` · mp² floats) stay bounded as m grows.  For the guard
    sweep at m <= 128 it is min(n_tiles, 2·SMs), as it was before the
    worker cap was raised."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fill = -(-_BLOCKS_PER_SM * sms // tile_pairs)
    return max(1, min(n_tiles, 2 * sms, fill))


def _sweep_buffers(B: torch.Tensor, dev: torch.device):
    """The d-split count and the buffers of one sweep over (m, d) ``B``, or
    of one launch over the runs of (R, m, d) ``B`` (each run with a one-run
    launch's d-split count, an R axis in front of every buffer):
    ``(nb, parts, a_part, gram_g, cross, a_inc, B_new)``; ``parts`` holds
    both Grams' per-split partials."""
    *lead, m, d = B.shape
    nt = -(-m // _TILE)
    mp = _TILE * nt
    nb = d_splits(-(-d // _SWEEP_TILE[B.dtype]), nt * nt, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return (nb, torch.empty((2, *lead, nb, mp, mp), **f32), torch.empty((*lead, nb, mp), **f32),
            torch.empty((*lead, m, m), **f32), torch.empty((*lead, m, m), **f32),
            torch.empty((*lead, m), **f32), torch.empty_like(B))


def _moments_buffer(name: str, moments, shape: tuple, dev: torch.device) -> torch.Tensor:
    """``moments`` checked as a contiguous f32 tensor of ``shape`` ((2, d),
    or (R, 2, d) over a run axis) on ``dev``, or a new one when it is
    None."""
    if moments is None:
        return torch.empty(shape, dtype=torch.float32, device=dev)
    if (moments.device != dev or moments.dtype != torch.float32
            or moments.shape != shape or not moments.is_contiguous()):
        raise ValueError(f"{name}: moments must be a contiguous {shape} f32 tensor on {dev}, "
                         f"got {tuple(moments.shape)} {moments.dtype} on {moments.device}")
    return moments


def fused_guard_cuda(grads: torch.Tensor, B: torch.Tensor, delta: torch.Tensor,
                     sanitize: bool = False):
    """Launch the fused guard kernel (its sanitizing variant when
    ``sanitize``); raises on anything it does not take."""
    dev = check_cuda_inputs("fused_guard", {"grads": grads, "B": B, "delta": delta},
                            tuple(_DTYPE_CODES))
    if grads.dim() != 2 or B.shape != grads.shape or delta.shape != grads.shape[1:]:
        raise ValueError(f"fused_guard: shapes grads {tuple(grads.shape)}, "
                         f"B {tuple(B.shape)}, delta {tuple(delta.shape)}")
    if not grads.dtype == B.dtype == delta.dtype:
        raise TypeError("fused_guard: grads, B and delta must share a dtype")
    m, d = grads.shape
    check_workers("fused_guard", m)
    if d < 1:
        raise ValueError(f"fused_guard: needs d >= 1, got d={d}")
    nb, parts, a_part, gram_g, cross, a_inc, B_new = _sweep_buffers(B, dev)
    inputs = [grads, B, delta, B_new, parts[0], parts[1], a_part]
    outputs = [gram_g, cross, a_inc]
    if sanitize:
        # per-block counts, then the (m,) int32 output nf
        inputs.append(torch.empty_like(a_part, dtype=torch.int32))
        outputs.append(torch.empty((m,), dtype=torch.int32, device=dev))
        fn = _build.load_function("fused_guard", "rt_fused_guard_sanitize",
                                  _SANITIZE_ARGTYPES)
    else:
        fn = _build.load_function("fused_guard", "rt_fused_guard", _ARGTYPES)
    rc = fn(_DTYPE_CODES[grads.dtype], *(t.data_ptr() for t in inputs + outputs),
            m, d, nb, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_guard: kernel launch failed with CUDA error {rc}")
    if sanitize:
        fused_guard_cuda.launches_sanitize += 1
        return gram_g, cross, a_inc, B_new, outputs[3]
    fused_guard_cuda.launches += 1
    return gram_g, cross, a_inc, B_new


fused_guard_cuda.launches = 0
fused_guard_cuda.launches_sanitize = 0

_RUNS_ARGTYPES = ([ctypes.c_int64] * 3 + [ctypes.c_void_p] * 12
                  + [ctypes.c_int64] * 4 + [ctypes.c_void_p])


def check_runs(name: str, x: torch.Tensor, others: dict) -> int:
    """Raise unless ``x`` is (R, m, d) with R >= 1 and every tensor of
    ``others`` (name → (tensor, expected shape)) has its shape; returns R."""
    if x.dim() != 3 or x.shape[0] < 1:
        raise ValueError(f"{name}: expected (runs, m, d), got shape {tuple(x.shape)}")
    for k, (t, shape) in others.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {k} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    return x.shape[0]


def fused_guard_runs_cuda(grads: torch.Tensor, B: torch.Tensor, delta: torch.Tensor,
                          sanitize: bool = False):
    """:func:`fused_guard_cuda` over a leading run axis, in one launch:
    grads and B (R, m, d), delta (R, d) → gram_g, cross (R, m, m), a_inc
    (R, m), B_new (R, m, d) [, nf (R, m)].  Run r's outputs are the bits of
    ``fused_guard_cuda(grads[r], B[r], delta[r])``: the d-split count is a
    one-run launch's and each run sums its partials in that order.  Counts
    one launch, in ``fused_guard_cuda.launches`` (or ``_sanitize``)."""
    dev = check_cuda_inputs("fused_guard", {"grads": grads, "B": B, "delta": delta},
                            tuple(_DTYPE_CODES))
    R = check_runs("fused_guard", grads, {"B": (B, grads.shape),
                                          "delta": (delta, (grads.shape[0], grads.shape[2]))})
    if not grads.dtype == B.dtype == delta.dtype:
        raise TypeError("fused_guard: grads, B and delta must share a dtype")
    _, m, d = grads.shape
    check_workers("fused_guard", m)
    if d < 1:
        raise ValueError(f"fused_guard: needs d >= 1, got d={d}")
    nb, parts, a_part, gram_g, cross, a_inc, B_new = _sweep_buffers(B, dev)
    nf_part = nf = None
    if sanitize:
        nf_part = torch.empty_like(a_part, dtype=torch.int32)
        nf = torch.empty((R, m), dtype=torch.int32, device=dev)
    fn = _build.load_function("fused_guard", "rt_fused_guard_runs", _RUNS_ARGTYPES)
    ptrs = [grads, B, delta, B_new, parts[0], parts[1], a_part, nf_part, gram_g, cross, a_inc,
            nf]
    rc = fn(_DTYPE_CODES[grads.dtype], R, int(bool(sanitize)),
            *(None if t is None else t.data_ptr() for t in ptrs),
            m, d, nb, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_guard: kernel launch failed with CUDA error {rc}")
    if sanitize:
        fused_guard_cuda.launches_sanitize += 1
        return gram_g, cross, a_inc, B_new, nf
    fused_guard_cuda.launches += 1
    return gram_g, cross, a_inc, B_new


def _gen_operands(name: str, dev: torch.device, m: int, d: int, x, h, x_star, het_dir,
                  keys, skewsign, slot, params, runs: int | None = None) -> list[torch.Tensor]:
    """The generator's operands as the kernels take them, after checking
    that they lie on ``dev``: the (d,) f32 vectors, the keys as (m, 2)
    int32 bit patterns of their uint32 words (from int64), skewsign f32,
    slot int32, params f32.  With ``runs`` = R every per-worker operand
    and params carry a leading run axis (keys (R, m, 2), skewsign and slot
    (R, m), params (R, 12)) and each (d,) vector is (R, d) or (d,), one for
    every run; the keys' words are converted in one pass over the stack."""
    f32 = {"x": x, "h": h, "x_star": x_star, "het_dir": het_dir, "skewsign": skewsign,
           "params": params}
    if check_cuda_inputs(name, {**f32, "keys": keys, "slot": slot},
                         (torch.float32, torch.int64, torch.int32)) != dev:
        raise ValueError(f"{name}: the generator's operands must lie on {dev}")
    if (any(t.dtype != torch.float32 for t in f32.values()) or keys.dtype != torch.int64
            or slot.dtype != torch.int32):
        raise TypeError(f"{name}: expected f32 vectors, skewsign and params, int64 keys "
                        f"and int32 slot")
    lead = () if runs is None else (runs,)
    vectors = ((d,),) if runs is None else ((d,), (runs, d))
    if (any(t.shape not in vectors for t in (x, h, x_star, het_dir))
            or keys.shape != (*lead, m, 2) or skewsign.shape != (*lead, m)
            or slot.shape != (*lead, m) or params.shape != (*lead, GEN_NPARAMS)):
        raise ValueError(f"{name}: expected vectors of shape {' or '.join(map(str, vectors))}, "
                         f"keys {(*lead, m, 2)}, skewsign and slot {(*lead, m)}, params "
                         f"{(*lead, GEN_NPARAMS)}")
    check_workers(name, m)
    if d < 1:
        raise ValueError(f"{name}: needs d >= 1, got d={d}")
    words = keys & MASK32
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)
    return [x, h, x_star, het_dir, words, skewsign, slot, params]


def _shared_bits(vectors) -> int:
    """The run entries' ``shared`` flags: bit q set when (d,) vector q of
    (x, h, x*, het_dir) is one for every run."""
    return sum(1 << q for q, t in enumerate(vectors) if t.dim() == 1)


def fused_guard_gen_cuda(B, delta, x, h, x_star, het_dir, keys, skewsign, slot, params,
                         moments=None):
    """Launch the generating fused guard: ``fused_guard_cuda``'s four
    outputs over the rows the generator makes, rounded through ``B.dtype``;
    raises on anything it does not take.  ``moments``, a (2, d) f32 tensor,
    receives the honest column moments (μ, σ) when an ALIE id is in play,
    for :func:`gen_xi_cuda` of the same step; without it they go to scratch."""
    dev = check_cuda_inputs("fused_guard_gen", {"B": B, "delta": delta}, tuple(_DTYPE_CODES))
    if B.dim() != 2 or delta.shape != B.shape[1:] or B.dtype != delta.dtype:
        raise ValueError(f"fused_guard_gen: B {tuple(B.shape)} {B.dtype} and delta "
                         f"{tuple(delta.shape)} {delta.dtype}")
    m, d = B.shape
    gen = _gen_operands("fused_guard_gen", dev, m, d, x, h, x_star, het_dir, keys, skewsign,
                        slot, params)
    moments = _moments_buffer("fused_guard_gen", moments, (2, d), dev)
    nb, parts, a_part, gram_g, cross, a_inc, B_new = _sweep_buffers(B, dev)
    fn = _build.load_function("fused_guard", "rt_fused_guard_gen", _GEN_ARGTYPES)
    ptrs = [B, delta, B_new, parts[0], parts[1], a_part, gram_g, cross, a_inc, *gen, moments]
    rc = fn(_DTYPE_CODES[B.dtype], *(t.data_ptr() for t in ptrs), m, d, nb, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_guard_gen: kernel launch failed with CUDA error {rc}")
    fused_guard_gen_cuda.launches += 1
    return gram_g, cross, a_inc, B_new


def gen_xi_cuda(w_xi, w_byz, x, h, x_star, het_dir, keys, skewsign, slot, params,
                stats_dtype=torch.float32, moments=None):
    """Launch the generating ξ pass: ``(Σ w_xi·round(rows), Σ w_byz·rows)``,
    the rows rounded through ``stats_dtype`` for ξ only; raises on anything
    it does not take.  ``moments``: the (2, d) f32 tensor that
    :func:`fused_guard_gen_cuda` filled for the same operands; the kernel
    then reads ALIE's moments from it and runs no moments pass of its own."""
    m, d = keys.shape[0], x.shape[0]
    dev = check_cuda_inputs("gen_xi", {"w_xi": w_xi, "w_byz": w_byz}, (torch.float32,))
    if w_xi.shape != (m,) or w_byz.shape != (m,):
        raise ValueError(f"gen_xi: w_xi and w_byz must be ({m},)")
    if stats_dtype not in _DTYPE_CODES:
        raise TypeError(f"gen_xi: stats_dtype {stats_dtype} is not one of {tuple(_DTYPE_CODES)}")
    gen = _gen_operands("gen_xi", dev, m, d, x, h, x_star, het_dir, keys, skewsign, slot,
                        params)
    ready = moments is not None
    moments = _moments_buffer("gen_xi", moments, (2, d), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    xi = torch.empty((d,), **f32)
    byz = torch.empty((d,), **f32)
    fn = _build.load_function("filtered_mean", "rt_gen_xi", _GEN_XI_ARGTYPES)
    ptrs = [w_xi, w_byz, xi, byz, *gen, moments]
    rc = fn(_DTYPE_CODES[stats_dtype], *(t.data_ptr() for t in ptrs), int(ready), m, d,
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gen_xi: kernel launch failed with CUDA error {rc}")
    gen_xi_cuda.launches += 1
    return xi, byz


fused_guard_gen_cuda.launches = 0
gen_xi_cuda.launches = 0

_GEN_RUNS_ARGTYPES = ([ctypes.c_int64] * 3 + [ctypes.c_void_p] * 18
                      + [ctypes.c_int64] * 4 + [ctypes.c_void_p])
_GEN_XI_RUNS_ARGTYPES = ([ctypes.c_int64] * 3 + [ctypes.c_void_p] * 13
                         + [ctypes.c_int64] * 4 + [ctypes.c_void_p])


def fused_guard_gen_runs_cuda(B, delta, x, h, x_star, het_dir, keys, skewsign, slot, params):
    """:func:`fused_guard_gen_cuda` over a leading run axis, in one launch:
    B (R, m, d), delta (R, d), keys (R, m, 2), skewsign and slot (R, m),
    params (R, 12); x, h, x_star and het_dir each (R, d) or (d,), one for
    every run (not copied R times) → gram_g, cross (R, m, m), a_inc
    (R, m), B_new (R, m, d) and ALIE's honest moments (R, 2, d).  Run r's
    outputs and moments are the bits of its own one-run launch (the same
    d-split count, the same order of sums).  Counts one launch, in
    ``fused_guard_gen_cuda.launches``."""
    dev = check_cuda_inputs("fused_guard_gen", {"B": B, "delta": delta}, tuple(_DTYPE_CODES))
    R = check_runs("fused_guard_gen", B, {"delta": (delta, (B.shape[0], B.shape[2]))})
    if B.dtype != delta.dtype:
        raise TypeError("fused_guard_gen: B and delta must share a dtype")
    _, m, d = B.shape
    if R > 65535:
        raise ValueError(f"fused_guard_gen: takes at most 65535 runs, got {R}")
    gen = _gen_operands("fused_guard_gen", dev, m, d, x, h, x_star, het_dir, keys, skewsign,
                        slot, params, runs=R)
    nb, parts, a_part, gram_g, cross, a_inc, B_new = _sweep_buffers(B, dev)
    moments = torch.empty((R, 2, d), dtype=torch.float32, device=dev)
    fn = _build.load_function("fused_guard", "rt_fused_guard_gen_runs", _GEN_RUNS_ARGTYPES)
    ptrs = [B, delta, B_new, parts[0], parts[1], a_part, gram_g, cross, a_inc, *gen, moments]
    rc = fn(_DTYPE_CODES[B.dtype], R, _shared_bits(gen[:4]), *(t.data_ptr() for t in ptrs),
            m, d, nb, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_guard_gen: kernel launch failed with CUDA error {rc}")
    fused_guard_gen_cuda.launches += 1
    return gram_g, cross, a_inc, B_new, moments


def gen_xi_runs_cuda(w_xi, w_byz, x, h, x_star, het_dir, keys, skewsign, slot, params,
                     stats_dtype=torch.float32, moments=None):
    """:func:`gen_xi_cuda` over a leading run axis, in one launch: w_xi and
    w_byz (R, m), the generator's operands as
    :func:`fused_guard_gen_runs_cuda` takes them, ``moments`` None or the
    (R, 2, d) that it returned for the same operands → ξ and byz (R, d),
    each run the bits of its own one-run launch.  Counts one launch, in
    ``gen_xi_cuda.launches``."""
    dev = check_cuda_inputs("gen_xi", {"w_xi": w_xi, "w_byz": w_byz}, (torch.float32,))
    if w_xi.dim() != 2 or w_byz.shape != w_xi.shape:
        raise ValueError(f"gen_xi: w_xi and w_byz must be (runs, m), got "
                         f"{tuple(w_xi.shape)} and {tuple(w_byz.shape)}")
    R, m = w_xi.shape
    d = x.shape[-1]
    if not 1 <= R <= 65535:
        raise ValueError(f"gen_xi: takes 1 to 65535 runs, got {R}")
    if stats_dtype not in _DTYPE_CODES:
        raise TypeError(f"gen_xi: stats_dtype {stats_dtype} is not one of {tuple(_DTYPE_CODES)}")
    gen = _gen_operands("gen_xi", dev, m, d, x, h, x_star, het_dir, keys, skewsign, slot,
                        params, runs=R)
    ready = moments is not None
    moments = _moments_buffer("gen_xi", moments, (R, 2, d), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    xi = torch.empty((R, d), **f32)
    byz = torch.empty((R, d), **f32)
    fn = _build.load_function("filtered_mean", "rt_gen_xi_runs", _GEN_XI_RUNS_ARGTYPES)
    ptrs = [w_xi, w_byz, xi, byz, *gen, moments]
    rc = fn(_DTYPE_CODES[stats_dtype], R, _shared_bits(gen[:4]),
            *(t.data_ptr() for t in ptrs), int(ready), m, d, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gen_xi: kernel launch failed with CUDA error {rc}")
    gen_xi_cuda.launches += 1
    return xi, byz
