"""The port's chaos harness (``repro_torch.chaos``, the counterpart of the
JAX package's ``scripts/chaos.py``) on the CPU.

The ``corrupt`` case runs through real ``python -m repro_torch.launch.
train`` subprocesses (mamba2-130m reduced to d_model 32, W = 4, 17 steps
with a checkpoint every 8, so two land before the end): the damaged
newest checkpoint is quarantined and the resumed run's final checkpoint
is bit for bit the uninterrupted run's.  ``nonfinite`` runs the
reference's grid (NaN, Inf and bitflip fault plans over every guard
backend under quarantine) at 5 steps, one past the bitflip's start: every
gap finite and the victims counted.  ``_bit_identical`` tells a
one-element change apart.  The harness writes no report of its own here.
"""
import numpy as np
import pytest

from repro_torch import chaos

STEPS, D_MODEL = 17, 32


def test_corrupt_case_quarantines_and_resumes_bit_identical(tmp_path):
    work = str(tmp_path)
    base, arrays = chaos.case_baseline(work, STEPS, D_MODEL, "cpu")
    assert base["ok"], base["detail"]
    assert arrays and all(k.startswith("leaf_") or k.startswith("__") for k in arrays)
    res = chaos.case_corrupt(work, STEPS, D_MODEL, arrays, device="cpu")
    assert res["ok"], res.get("detail")
    assert res["bit_identical"] and res["resumed_line"].startswith("resumed")
    quarantined = [f for f in (tmp_path / "corrupt").iterdir() if f.name.endswith(".corrupt")]
    assert len(quarantined) == 1


def test_nonfinite_case_at_its_smallest_steps():
    res = chaos.case_nonfinite(5, device="cpu")
    assert res["ok"], res
    assert res["victims_filtered"] and res["non_finite_cells"] == []
    assert res["cells_checked"] == 6 * 2 * 8 and len(res["variants"]) == 6


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_bit_identical_tells_one_element_apart(dtype):
    a = {"leaf_0": np.arange(12, dtype=dtype).reshape(3, 4), "leaf_1": np.array([np.nan, 1.0])}
    b = {k: v.copy() for k, v in a.items()}
    assert chaos._bit_identical(a, b)        # NaN equals NaN in place
    b["leaf_0"][2, 3] += 1
    assert not chaos._bit_identical(a, b)
    assert not chaos._bit_identical(a, {"leaf_0": a["leaf_0"]})
    assert not chaos._bit_identical(a, {**a, "leaf_0": a["leaf_0"].astype(np.float64)})


def test_main_requires_out():
    with pytest.raises(SystemExit):
        chaos.main(["--device", "cpu"])
