"""The copy step (ops/copy_step.py), the roofline kernel beside the fused
step, on the CPU, where ``copy_step`` runs its plain PyTorch version:
closed-form values, the order of the sum, the guard's zero tiles, the
input checks, and the byte counts of the probe script
(scripts/roofline_probe_torch.py). The CUDA kernel is compared with the
plain version on the card by chip_smoke.py."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ocean_model_arch_torch.ops import _build
from ocean_model_arch_torch.ops import fused_layout as fl
from ocean_model_arch_torch.ops import fused_step as fstep
from ocean_model_arch_torch.ops.copy_step import (copy_step,
                                                  copy_step_reference,
                                                  tile_shape)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "roofline_probe_torch.py")


def _probe_module():
    spec = importlib.util.spec_from_file_location("roofline_probe_torch",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("met2d", [False, True])
@pytest.mark.parametrize("tracers", [0, 2])
def test_constant_inputs_give_closed_form(tracers, met2d):
    """Inputs constant at small integers: out_i = their sum + i exactly,
    in every cell of the layout, for each form's counts of inputs."""
    lay = fl.make_layout(40, 50)
    n_out = 6 + 2 * tracers
    n_met = len(fl.fast2d_met_rows(tracers))
    windows = tuple(torch.full((lay.Xs, lay.Ys), float(j + 1))
                    for j in range(n_out + 4))
    shape = (n_met, lay.Xs, lay.Ys) if met2d else (n_met, lay.Ys)
    met = torch.full(shape, 0.5)
    outs = copy_step(windows, met, n_out, lay, tracer_form=tracers > 0)
    total = sum(range(1, n_out + 5)) + 0.5 * n_met
    assert len(outs) == n_out
    for i, o in enumerate(outs):
        assert o.shape == (lay.Xs, lay.Ys) and o.dtype == torch.float32
        assert bool((o == total + i).all()), i


def test_sum_runs_in_input_order():
    """Random float32 inputs: the same additions in the same order as a
    numpy loop (windows, then metric rows), bit for bit; a profile row is
    added along y."""
    lay = fl.make_layout(30, 40)
    rng = np.random.RandomState(5)
    wins = [(rng.randn(lay.Xs, lay.Ys) * 10.0 ** rng.randint(-3, 4))
            .astype(np.float32) for _ in range(10)]
    prof = rng.randn(7, lay.Ys).astype(np.float32)
    plan = rng.randn(7, lay.Xs, lay.Ys).astype(np.float32)
    for met in (prof, plan, None):
        acc = np.zeros((lay.Xs, lay.Ys), np.float32)
        for w in wins:
            acc = acc + w
        for r in (() if met is None else met):
            acc = acc + (r[None, :] if r.ndim == 1 else r)
        outs = copy_step(tuple(torch.from_numpy(w) for w in wins),
                         None if met is None else torch.from_numpy(met),
                         6, lay)
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o.numpy(),
                                          acc + np.float32(i))


def test_guard_zeroes_all_land_tiles():
    lay = fl.make_layout(70, 52)
    tile = tile_shape("cpu")
    assert tile == fstep.CPU_TILE
    lu = np.ones((70, 52), np.float32)
    lu[40:64, :] = 0.0
    wet = fl.tile_wet(fl.embed(lay, torch.from_numpy(lu)).numpy(), lay,
                      *tile)
    assert 0 < wet.sum() < wet.size
    flags = torch.from_numpy(wet)
    windows = tuple(torch.full((lay.Xs, lay.Ys), 1.0) for _ in range(10))
    free = copy_step(windows, None, 6, lay)
    outs = copy_step(windows, None, 6, lay, tile_wet=flags, tile=tile)
    cells = flags.repeat_interleave(tile[0], 0).repeat_interleave(
        tile[1], 1)[:lay.Xs, :lay.Ys] > 0
    for o, f in zip(outs, free):
        assert bool((o[~cells] == 0).all())
        assert torch.equal(o[cells], f[cells])
    with pytest.raises(ValueError, match="tile_wet"):
        copy_step_reference(windows, None, 6, lay, flags, (8, 8))


@pytest.mark.parametrize("guard", [False, True])
def test_chained_window_changes_no_output(guard):
    """The chained form's copy step (``steps = 2``: the chained tile,
    window and shared memory) gives the single step's outputs, guarded by
    the chained tile's flags (the plain version's tile on the CPU); a
    launch of 3 steps is refused before anything runs."""
    lay = fl.make_layout(70, 52)
    tile = tile_shape("cpu", 2)
    assert tile == tile_shape("cpu") == fstep.CPU_TILE
    lu = np.ones((70, 52), np.float32)
    lu[40:64, :] = 0.0
    flags = (torch.from_numpy(fl.tile_wet(fl.embed(
        lay, torch.from_numpy(lu)).numpy(), lay, *tile)) if guard else None)
    gen = torch.Generator().manual_seed(7)
    windows = tuple(torch.randn((lay.Xs, lay.Ys), generator=gen)
                    for _ in range(14))
    met = torch.randn((9, lay.Ys), generator=gen)
    one = copy_step(windows, met, 10, lay, True, flags, tile)
    two = copy_step(windows, met, 10, lay, True, flags, tile, steps=2)
    want = copy_step_reference(windows, met, 10, lay, flags, tile)
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(two, one, want))
    f = torch.empty((lay.Xs, lay.Ys), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        copy_step((f,) * 10, None, 6, lay, steps=2)
    assert copy_step.launches == 0


def test_cpu_tensors_do_not_launch():
    lay = fl.make_layout(24, 20)
    windows = tuple(torch.zeros((lay.Xs, lay.Ys)) for _ in range(10))
    copy_step(windows, torch.zeros((7, lay.Ys)), 6, lay)
    assert copy_step.launches == 0
    assert "copy_step" not in _build.BUILDS


def test_non_cpu_tensors_never_take_the_plain_version():
    """Tensors off the CPU go to the kernel or raise: here (meta tensors)
    the input check raises before any build or launch."""
    lay = fl.make_layout(24, 20)
    f = torch.empty((lay.Xs, lay.Ys), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        copy_step((f,) * 10, torch.empty((7, lay.Ys), device="meta"), 6,
                  lay)
    with pytest.raises(ValueError, match="met"):
        copy_step((f,) * 10, torch.empty((7,), device="meta"), 6, lay)
    assert copy_step.launches == 0
    assert "copy_step" not in _build.BUILDS


def test_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """The tile header enters each library's name: editing it rebuilds
    both kernels. (No nvcc here: the build raises after the name is
    known, so the name is read from the command it would run.)"""
    names = {}

    def fake_run(cmd, **kw):
        names[cmd[-1]] = cmd[cmd.index("-o") + 1]
        raise RuntimeError("stop before nvcc")

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for n in ("fused_step.cu", "copy_step.cu", "fused_tile.cuh"):
        (csrc / n).write_bytes(open(os.path.join(_build.CSRC, n),
                                    "rb").read())
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)

    def lib_names():
        names.clear()
        for n in ("fused_step", "copy_step"):
            with pytest.raises(RuntimeError, match="stop"):
                _build.build(n)
        return [os.path.basename(names[str(csrc / f"{n}.cu")]).split(".")[0]
                for n in ("fused_step", "copy_step")]

    before = lib_names()
    assert before == lib_names()
    with open(csrc / "fused_tile.cuh", "a") as f:
        f.write("// edited\n")
    after = lib_names()
    assert before[0] != after[0] and before[1] != after[1]


def test_build_targets_with_a_define_get_their_own_library(tmp_path,
                                                           monkeypatch):
    """``<source>@<MACRO>=<value>[@...]`` compiles the source with a -D for
    each define into a library named after the target: the fused step's
    libraries for 0, 1 and 2 tracers and for every count from 3 up, and
    the same four raw, for each of the four (trans, ffs) forms, one step
    a launch and two chained, build side by side and never share a file;
    the full step's libraries keep the flags, and so the libraries, they
    had."""
    cmds = []

    def fake_run(cmd, **kw):
        cmds.append(cmd)
        raise RuntimeError("stop before nvcc")

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    targets = fstep.library_targets()
    assert targets[:8] == ("fused_step@FUSED_NT=0", "fused_step@FUSED_NT=1",
                           "fused_step@FUSED_NT=2", "fused_step@FUSED_NT=3",
                           "fused_step@FUSED_RAW_NT=0",
                           "fused_step@FUSED_RAW_NT=1",
                           "fused_step@FUSED_RAW_NT=2",
                           "fused_step@FUSED_RAW_NT=3")
    assert len(targets) == 64 and targets[8] == \
        "fused_step@FUSED_NT=0@FUSED_TRANS=0"
    assert targets[31] == \
        "fused_step@FUSED_RAW_NT=3@FUSED_TRANS=0@FUSED_FFS=0"
    assert targets[32] == "fused_step@FUSED_NT=0@FUSED_STEPS=2"
    assert targets[-1] == ("fused_step@FUSED_RAW_NT=3@FUSED_TRANS=0"
                           "@FUSED_FFS=0@FUSED_STEPS=2")
    for t in targets + ("fused_step",):
        with pytest.raises(RuntimeError, match="stop"):
            _build.build(t)
    outs = [os.path.basename(c[c.index("-o") + 1]) for c in cmds]
    assert len(set(outs)) == 65
    for n, (cmd, out) in enumerate(zip(cmds[:64], outs)):
        trans, ffs = fstep.FORMS[n % 32 // 8]
        steps = 1 + n // 32
        macro = "FUSED_NT" if n % 8 < 4 else "FUSED_RAW_NT"
        defines = [a for a in cmd if a.startswith("-D")]
        assert defines == [f"-D{macro}={n % 4}"] + (
            [] if trans else ["-DFUSED_TRANS=0"]) + (
            [] if ffs else ["-DFUSED_FFS=0"]) + (
            [] if steps == 1 else ["-DFUSED_STEPS=2"])
        assert cmd[-1].endswith("fused_step.cu")
        assert out.startswith(f"libfused_step-{macro}{n % 4}-")
        assert fstep.library_target(n % 4, n % 8 >= 4, trans, ffs,
                                    steps) == targets[n]
    assert not any(a.startswith("-D") for a in cmds[64])
    assert "--use_fast_math" not in " ".join(cmds[0])


@pytest.mark.parametrize("tracers,met2d,per_cell",
                         [(0, False, 64), (0, True, 92), (2, False, 96),
                          (2, True, 132)])
def test_probe_counts_the_fused_steps_bytes(tracers, met2d, per_cell):
    """The probe's byte count per form: 64 + 16 T bytes per layout cell,
    + 4 per metric plane; guarded, the all-land tiles' cells count their
    zero writes only."""
    probe = _probe_module()
    lay = fl.make_layout(1525, 1115)
    assert (lay.Xs, lay.Ys) == (1533, 1152)
    cells = lay.Xs * lay.Ys
    n_met = len(fl.fast2d_met_rows(tracers))
    prof = 0 if met2d else 4 * n_met * lay.Ys
    assert probe.bytes_moved(lay, tracers, met2d) == cells * per_cell + prof
    wet = np.zeros((96, 36), np.int32)
    wet[:10, :5] = 1
    done = 10 * 16 * 5 * 32
    n_out = 6 + 2 * tracers
    assert probe.bytes_moved(lay, tracers, met2d, wet, (16, 32)) == (
        done * per_cell + (cells - done) * 4 * n_out + prof + 4 * wet.size)
    assert probe.form_counts(tracers) == (n_out + 4, n_out, n_met)


@pytest.mark.parametrize("tracers,met2d,visc,hr_varies,per_cell", [
    (0, False, True, False, 64),      # viscosity: no bytes on profiles
    (0, True, True, False, 132),      # 17 metric planes instead of 7
    (0, False, False, True, 68),      # + hrludxdy
    (0, False, True, True, 72),       # + hrludxdy + hr
    (2, False, True, True, 104),
    (0, True, True, True, 140),
    (1, False, False, False, 80)])
def test_probe_counts_the_new_forms_bytes(tracers, met2d, visc, hr_varies,
                                          per_cell):
    """Bytes per layout cell of the viscous and bathymetry-plane forms
    and of the 1-tracer form, all of them in the probe's list."""
    probe = _probe_module()
    lay = fl.make_layout(1525, 1115)
    cells = lay.Xs * lay.Ys
    n_out = 6 + 2 * tracers
    n_met = len(fl.fast2d_met_rows(tracers, visc))
    n_planes = len(fstep.kernel_planes(tracers, visc, hr_varies))
    assert probe.form_counts(tracers, visc, hr_varies) == (
        n_out + n_planes, n_out, n_met)
    assert n_out + n_planes <= 16        # the copy kernel's windows
    prof = 0 if met2d else 4 * n_met * lay.Ys
    assert probe.bytes_moved(lay, tracers, met2d, visc=visc,
                             hr_varies=hr_varies) == cells * per_cell + prof
    assert {(0, False, True, False), (0, False, False, True),
            (2, False, True, True), (0, True, True, True),
            (1, False, False, False)} <= set(probe.FORMS)


def test_probe_script_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    res = subprocess.run([sys.executable, SCRIPT, "24", "20"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "CUDA" in res.stderr
    assert res.stdout == ""


def test_probe_mask_argument_cuts_a_shard():
    """``file@NXxNY+x0+y0`` names a shard's part of a basin's mask: the
    raw form's array is probed at the shard's own extents, whose layout
    is the sharded model's."""
    from ocean_model_arch_torch.io.mask_io import read_mask
    probe = _probe_module()
    path = os.path.join(REPO, "data", "BS", "mask_bs4km.txt")
    full = read_mask(path, 289, 163)
    part = probe.mask_argument(f"{path}@289x163+145+82", 144, 81)
    np.testing.assert_array_equal(part, full[145:, 82:])
    np.testing.assert_array_equal(probe.mask_argument(path, 289, 163), full)
    np.testing.assert_array_equal(probe.mask_argument("frame", 12, 9),
                                  probe.frame_of_land_mask(12, 9))
    with pytest.raises(ValueError, match="cut"):
        probe.mask_argument(f"{path}@289x163+200+0", 144, 81)
    # one shard of a 2 x 2 split has the layout of a basin of its extents
    lay = fl.make_layout(144, 81)
    assert (lay.Xs, lay.Ys) == (152, 96)
