"""The port imports no JAX: the machine with the GPU has none installed.

A fresh interpreter imports ``ocean_model_arch_torch``, every module of
the slice and chip_smoke.py's imports, and must end with no ``jax``
module loaded. The port's sources (and chip_smoke.py) reach the JAX
package's numpy-only host modules through ``ocean_model_arch_torch/
host.py`` alone.
"""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ocean_model_arch_torch")

MODULES = [
    "ocean_model_arch_torch",
    "ocean_model_arch_torch.host",
    "ocean_model_arch_torch.ops.stencil",
    "ocean_model_arch_torch.ops.sw_kernels",
    "ocean_model_arch_torch.ops.depth_kernels",
    "ocean_model_arch_torch.ops.fused_layout",
    "ocean_model_arch_torch.ops.fused_step",
    "ocean_model_arch_torch.ops._build",
    "ocean_model_arch_torch.core.grid",
    "ocean_model_arch_torch.core.state",
    "ocean_model_arch_torch.model.init",
    "ocean_model_arch_torch.model.step",
    "ocean_model_arch_torch.model.fused",
    "chip_smoke",
]


def test_port_imports_without_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = sorted(m for m in sys.modules\n"
              "             if m.split('.')[0] in ('jax', 'jaxlib'))\n"
              "print('JAX_MODULES', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "JAX_MODULES []" in res.stdout, res.stdout


def test_sources_reach_the_jax_package_only_through_host():
    """No port module but host.py, and not chip_smoke.py, names jax or
    the JAX package in an import."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ocean_model_arch_tpu)"
                     r"\b", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            src = f.read()
        hits = pat.findall(src)
        if path == os.path.join(PORT, "host.py"):
            hits = [h for h in hits if h[1] != "ocean_model_arch_tpu"]
        if hits:
            offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders
