"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``.

Module names are matched exactly (``repro`` or ``repro.*``), because
``repro_torch`` itself starts with "repro".  ``chip_smoke.py`` is only
parsed here, never run: it needs a card.
"""
import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules() -> list[str]:
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]


def test_importing_every_port_module_loads_no_jax_or_repro():
    mods = _port_modules()
    assert {"repro_torch.core.solver", "repro_torch.kernels.ops",
            "repro_torch.data.problems", "repro_torch.convert",
            "repro_torch.kernels.pairdist", "repro_torch.kernels.robust_reduce",
            "repro_torch.core.aggregators", "repro_torch.core.attacks",
            "repro_torch.scenarios.faults", "repro_torch.distributed.byzantine_dp",
            "repro_torch.kernels.countsketch", "repro_torch.scenarios.spec",
            "repro_torch.scenarios.adversary", "repro_torch.scenarios.campaign",
            "repro_torch.scenarios.report", "repro_torch.obs.provenance",
            "repro_torch.experiments.table1", "repro_torch.kernels.run_axis",
            "repro_torch.obs.telemetry", "repro_torch.obs.events", "repro_torch.obs.spans",
            "repro_torch.obs.roofline_compare", "repro_torch.roofline.hw",
            "repro_torch.roofline.guard_cost"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         check=True, timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if _forbidden(m)] == []


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_sources_and_chip_smoke_import_no_jax_or_repro():
    # the card-only tests run on GPU machines that have no JAX
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]
    for path in files:
        bad = sorted(n for n in _imports(path) if _forbidden(n))
        assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"
    assert "repro_torch.core.solver" in _imports(ROOT / "chip_smoke.py")


def test_guard_sweep_timing_script_imports_no_jax_or_repro():
    """scripts/time_guard_sweep.py runs on the GPU machine beside
    chip_smoke.py, whose helpers it imports, and never JAX."""
    names = _imports(ROOT / "scripts" / "time_guard_sweep.py")
    assert [n for n in names if _forbidden(n)] == []
    assert "importlib" in names and "torch" in names
