"""The port imports nothing of JAX and nothing of the JAX package: the
machine with the GPU has no JAX, and the port keeps its own copies of the
numpy-only host modules.

A fresh interpreter imports ``ocean_model_arch_torch``, every module of
the port, chip_smoke.py and the port's probe script, and must end with no ``jax``, ``jaxlib`` or
``ocean_model_arch_tpu`` module loaded; no source of the port names one
of them in an import. And the entry points place their tensors on the
CUDA device unless told otherwise: without one they raise.
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ocean_model_arch_torch")
FORBIDDEN = ("jax", "jaxlib", "ocean_model_arch_tpu")

MODULES = [
    "ocean_model_arch_torch",
    "ocean_model_arch_torch.host",
    "ocean_model_arch_torch.core",
    "ocean_model_arch_torch.ops",
    "ocean_model_arch_torch.model",
    "ocean_model_arch_torch.config",
    "ocean_model_arch_torch.config.basinpar",
    "ocean_model_arch_torch.config.parallel",
    "ocean_model_arch_torch.config.parfile",
    "ocean_model_arch_torch.config.runpar",
    "ocean_model_arch_torch.config.sw",
    "ocean_model_arch_torch.core.constants",
    "ocean_model_arch_torch.core.masks",
    "ocean_model_arch_torch.core.metrics",
    "ocean_model_arch_torch.io",
    "ocean_model_arch_torch.io.mask_io",
    "ocean_model_arch_torch.io.native",
    "ocean_model_arch_torch.io.grads",
    "ocean_model_arch_torch.io.checkpoint",
    "ocean_model_arch_torch.parallel",
    "ocean_model_arch_torch.parallel.decomposition",
    "ocean_model_arch_torch.parallel.mesh",
    "ocean_model_arch_torch.parallel.domain",
    "ocean_model_arch_torch.parallel.halo",
    "ocean_model_arch_torch.parallel.multihost",
    "ocean_model_arch_torch.diag",
    "ocean_model_arch_torch.diag.scaling",
    "ocean_model_arch_torch.utils",
    "ocean_model_arch_torch.utils.calendar",
    "ocean_model_arch_torch.utils.timers",
    "ocean_model_arch_torch.ops.stencil",
    "ocean_model_arch_torch.ops.sw_kernels",
    "ocean_model_arch_torch.ops.depth_kernels",
    "ocean_model_arch_torch.ops.tracer_kernels",
    "ocean_model_arch_torch.ops.fused_layout",
    "ocean_model_arch_torch.ops.fused_step",
    "ocean_model_arch_torch.ops.copy_step",
    "ocean_model_arch_torch.ops.persistent_probe",
    "ocean_model_arch_torch.ops.vpu_probe",
    "ocean_model_arch_torch.ops._build",
    "ocean_model_arch_torch.core.grid",
    "ocean_model_arch_torch.core.state",
    "ocean_model_arch_torch.model.init",
    "ocean_model_arch_torch.model.step",
    "ocean_model_arch_torch.model.fused",
    "ocean_model_arch_torch.model.fused_sharded2d",
    "ocean_model_arch_torch.model.sharded",
    "ocean_model_arch_torch.model.model",
    "ocean_model_arch_torch.__main__",
    "chip_smoke",
    "scripts.roofline_probe_torch",
    "scripts.persistent_probe_torch",
    "scripts.vpu_op_probe_torch",
    "scripts.vpu_shift_probe_torch",
    "scripts.multiprocess_worker_torch",
]


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "roofline_probe_torch.py"),
             os.path.join(REPO, "scripts", "persistent_probe_torch.py"),
             os.path.join(REPO, "scripts", "vpu_op_probe_torch.py"),
             os.path.join(REPO, "scripts", "vpu_shift_probe_torch.py"),
             os.path.join(REPO, "scripts", "multiprocess_worker_torch.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_modules_list_covers_the_port():
    """Every .py of the port is in MODULES (so the subprocess check
    imports it)."""
    have = set(MODULES)
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        if rel.endswith(".__init__"):
            rel = rel[:-len(".__init__")]
        assert rel in have, rel


def test_port_imports_without_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = sorted(m for m in sys.modules\n"
              f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
              "print('FORBIDDEN_MODULES', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "FORBIDDEN_MODULES []" in res.stdout, res.stdout


def test_sources_reach_the_jax_package_only_through_host():
    """No source of the port, ``host.py`` included, and neither
    chip_smoke.py nor the port's probe script, names jax, jaxlib or the JAX package in an import."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ocean_model_arch_tpu)"
                     r"\b", re.M)
    files = _port_sources()
    assert len(files) > 20
    offenders = []
    for path in files:
        with open(path) as f:
            if pat.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders


def _imported_roots(path):
    """The top-level package of every import statement in a source, at
    any depth: inside functions and conditionals too."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_lazy_import_of_jax_either():
    """An import inside a function counts: the scan walks every
    statement of every source (the JAX package's own ``utils/timers.py``
    imports jax inside ``gather``, and the scan sees it there)."""
    lazy = os.path.join(REPO, "ocean_model_arch_tpu", "utils", "timers.py")
    assert "jax" in _imported_roots(lazy)
    with open(lazy) as f:
        assert not re.search(r"^(import|from) jax", f.read(), re.M)
    offenders = {os.path.relpath(p, REPO): sorted(bad)
                 for p in _port_sources()
                 if (bad := _imported_roots(p) & set(FORBIDDEN))}
    assert not offenders, offenders


def test_running_the_timers_loads_no_jax():
    """``PhaseTimers.gather`` / ``reduced_report`` of the port, run in a
    fresh interpreter, leave no forbidden module loaded."""
    code = ("import sys\n"
            "from ocean_model_arch_torch.utils.timers import PhaseTimers\n"
            "t = PhaseTimers()\n"
            "t.add('model_step', 1.5)\n"
            "assert len(t.gather()) == 1\n"
            "assert 'model_step' in t.reduced_report()\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print('FORBIDDEN_MODULES', bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "FORBIDDEN_MODULES []" in res.stdout, res.stdout


@pytest.mark.parametrize("entry", ["build_grid", "zero_state",
                                   "grid_from_numpy", "state_from_numpy",
                                   "make_mesh", "initialize",
                                   "local_device"])
def test_entry_points_default_to_the_card(entry):
    """Called without a device on a machine without CUDA, the entry
    points raise instead of returning CPU tensors; ``device="cpu"`` is
    how the CPU is asked for."""
    import torch

    from ocean_model_arch_torch.core import grid as tg
    from ocean_model_arch_torch.core import state as ts
    from ocean_model_arch_torch.host import (Precision, basinpar_as250m_test,
                                             default_device,
                                             frame_of_land_mask)
    from ocean_model_arch_torch.parallel import multihost
    from ocean_model_arch_torch.parallel.mesh import make_mesh
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    basin = basinpar_as250m_test()
    basin = type(basin)(**{**basin.__dict__, "nx": 12, "ny": 10})
    mask = frame_of_land_mask(12, 10)
    cpu_grid = tg.build_grid(basin, mask, precision=Precision.f32(),
                             device="cpu")
    cpu_state = ts.zero_state(12, 10, 2, Precision.f32(), device="cpu")
    assert cpu_grid.lu.device.type == cpu_state.ff.device.type == "cpu"
    grid_d = {n: getattr(cpu_grid, n).numpy() for n in tg.GRID_FIELDS}
    state_d = {n: np.zeros((12, 10)) for n in ts.STATE_FIELDS
               if n not in ts.TRACER_FIELDS}
    calls = {
        "build_grid": lambda: tg.build_grid(basin, mask),
        "zero_state": lambda: ts.zero_state(12, 10),
        "grid_from_numpy": lambda: tg.grid_from_numpy(grid_d),
        "state_from_numpy": lambda: ts.state_from_numpy(state_d),
        "make_mesh": lambda: make_mesh(2, 2),
        # a process of a group takes the card unless asked for the CPU
        "initialize": lambda: multihost.initialize(
            "file:///nowhere", 2, 0, backend="gloo"),
        "local_device": multihost.local_device,
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
