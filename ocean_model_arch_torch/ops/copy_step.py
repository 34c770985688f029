"""The copy step: the fused step's memory traffic without its arithmetic.

Counterpart of ``scripts/roofline_probe.py::build_copy_step``, the
copy-through Pallas kernel with exactly the fused step's windows and
tiles. Every output is

    out_i = (sum over all inputs, cell by cell) + i

over the windowed inputs (the carried fields, then the static planes)
and the metric rows (``(n, Ys)`` profiles or ``(n, Xs, Ys)`` planes),
summed in that order in float32. The CUDA kernel (``csrc/copy_step.cu``)
loads what the fused kernel loads, with its tile, its window halo (3, or
4 with tracers: ``tracer_form``, the form's tracer count), its shared
memory (more with ``visc_form``) and, with ``tile_wet``, its land-tile
guard, so its time is the floor of that form of the fused step on this
layout; with ``steps = 2`` the chained form's tile, window (halo 6, or 8)
and shared memory, the floor of a launch that runs two model steps. It is
a measuring tool: nothing on the model's step loop calls it;
``scripts/roofline_probe_torch.py`` is its entry point.

:func:`copy_step_stacked` is the counterpart of
``scripts/roofline_probe.py::build_copy_step_stacked``: the same sum
read from ONE (n_in, Xs, Ys) tensor and written to ONE (n_out, Xs, Ys)
tensor. Its plain version is :func:`copy_step_reference` on the
unstacked planes.

:func:`copy_step` takes CPU tensors to :func:`copy_step_reference` and
CUDA tensors to the kernel, which it builds on first use; a kernel that
does not build or launch raises. The two agree exactly: they make the
same float32 additions in the same order. The kernel loads its windows by
TMA, as the fused step does (``loader="tma"``: one block a tile; at most
``copy_step_max_async_windows()`` windowed inputs, each 16-byte aligned),
or by its threads, element by element (``"threads"``, the loader the fused
step had before; the stacked form always).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ._build import load
from .fused_layout import FusedLayout
from .fused_step import CPU_TILE, _wet_cells, tma_refusal


# the kernel's loaders and their codes in the C launcher
LOADERS = {"threads": 0, "tma": 1}


def copy_step_reference(windows, met, n_out: int, lay: FusedLayout,
                        tile_wet=None, tile=None) -> tuple:
    """The copy step in plain PyTorch on whole arrays. ``tile_wet`` (with
    its ``tile`` shape) reproduces the guard: zeros in every tile flagged
    all-land."""
    acc = torch.zeros((lay.Xs, lay.Ys), dtype=torch.float32,
                      device=windows[0].device)
    for w in windows:
        acc = acc + w
    for r in (() if met is None else met):
        acc = acc + (r[None, :] if r.dim() == 1 else r)
    outs = [acc + float(i) for i in range(n_out)]
    if tile_wet is not None:
        cells = _wet_cells(tile_wet, tile, lay)
        outs = [torch.where(cells, o, 0.0) for o in outs]
    return tuple(outs)


def tile_shape(device, steps: int = 1, tracer_form: bool = False,
               visc_form: bool = False) -> tuple:
    """The (rows, columns) of the kernel's output tile on a CUDA device
    for the fused step's fast form of ``steps`` model steps a launch, with
    tracers or not, viscous or not (the library is built if needed; the
    chained forms with tracers have tiles of their own), ``CPU_TILE`` on
    the CPU."""
    if torch.device(device).type == "cpu":
        return CPU_TILE
    lib = _library()
    form = (int(bool(tracer_form)), int(bool(visc_form)), steps)
    return lib.copy_step_tile_x(*form), lib.copy_step_tile_y(*form)


def _check_inputs(windows, met, n_out, lay, tile_wet, tile,
                  steps, stacked: bool = False,
                  loader: str = "threads", tracer_form: bool = False,
                  visc_form: bool = False) -> None:
    """``stacked``: the windows are the planes of one tensor, and neither
    they nor the outputs are bounded in number; ``loader``: with TMA, its
    bounds and alignment too; ``tracer_form``, ``visc_form``: the fused
    form whose tile the guard's flags are for."""
    dev = windows[0].device
    shapes = [(w, (lay.Xs, lay.Ys)) for w in windows]
    if met is not None:
        if met.dim() not in (2, 3):
            raise ValueError("met: need (n, Ys) profiles or (n, Xs, Ys) "
                             f"planes, got {tuple(met.shape)}")
        shapes.append((met, (met.shape[0],) + ((lay.Ys,) if met.dim() == 2
                                               else (lay.Xs, lay.Ys))))
    for t, want in shapes:
        if (dev.type != "cuda" or t.device != dev
                or t.dtype != torch.float32):
            raise ValueError(f"need float32 CUDA tensors on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"need a contiguous {want} tensor, got "
                             f"{tuple(t.shape)}")
    if steps not in (1, 2):
        raise ValueError(f"steps={steps}: 1 or 2 model steps a launch")
    lib = _library()
    if not stacked and len(windows) > lib.copy_step_max_windows():
        raise ValueError(f"at most {lib.copy_step_max_windows()} windowed "
                         f"inputs, got {len(windows)}")
    if n_out < 1 or not stacked and n_out > lib.copy_step_max_outputs():
        raise ValueError(f"need 1 to {lib.copy_step_max_outputs()} outputs, "
                         f"got {n_out}")
    if loader not in LOADERS:
        raise ValueError(f"loader={loader!r}: one of {tuple(LOADERS)}")
    if loader == "tma":
        if len(windows) > lib.copy_step_max_async_windows():
            raise ValueError(f"the TMA loader takes at most "
                             f"{lib.copy_step_max_async_windows()} windowed "
                             f"inputs, got {len(windows)}")
        why = tma_refusal(lay, windows, steps, int(bool(tracer_form)),
                          visc=visc_form)
        if why:
            raise ValueError(f"the TMA loader cannot take {why}")
    if tile_wet is None:
        return
    want = (-(-lay.Xs // tile[0]), -(-lay.Ys // tile[1]))
    own = tile_shape(dev, steps, tracer_form, visc_form)
    if (tuple(tile) != own or tile_wet.device != dev
            or tile_wet.dtype != torch.int32 or not tile_wet.is_contiguous()
            or tuple(tile_wet.shape) != want):
        raise ValueError(f"tile_wet: need a contiguous int32 {want} tensor "
                         f"on {dev} for {own} tiles, got "
                         f"{tile_wet.dtype} {tuple(tile_wet.shape)} for "
                         f"{tuple(tile)} tiles")


def copy_step(windows, met, n_out: int, lay: FusedLayout,
              tracer_form: bool = False, tile_wet=None, tile=None,
              visc_form: bool = False, steps: int = 1,
              loader: str = "tma") -> tuple:
    """One copy step: ``n_out`` (Xs, Ys) outputs from the ``windows``
    (the (Xs, Ys) fields and static planes) and the metric rows ``met``
    ((n, Ys), (n, Xs, Ys) or None). The plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (counted in ``copy_step.launches``,
    and by loader in ``copy_step.loader_launches``).
    ``tracer_form`` (the fused form's tracer count; True counts 1) makes
    the kernel load the tracer form's wider window and take that form's
    shared memory, ``visc_form`` a viscous form's, ``steps = 2`` the
    chained form's tile, window and shared memory, ``loader`` the loader
    (``LOADERS``); the result depends on none of them but the tile of
    ``tile_wet``."""
    if windows[0].device.type == "cpu":
        return copy_step_reference(windows, met, n_out, lay, tile_wet, tile)
    _check_inputs(windows, met, n_out, lay, tile_wet, tile, steps,
                  loader=loader, tracer_form=tracer_form,
                  visc_form=visc_form)
    lib = _library()
    outs = tuple(torch.empty_like(windows[0]) for _ in range(n_out))
    win_p = (ctypes.c_void_p * len(windows))(*(w.data_ptr()
                                               for w in windows))
    out_p = (ctypes.c_void_p * n_out)(*(o.data_ptr() for o in outs))
    with torch.cuda.device(windows[0].device):
        rc = lib.copy_step_launch(
            win_p, len(windows), out_p, n_out,
            None if met is None else met.data_ptr(),
            0 if met is None else met.shape[0],
            int(met is not None and met.dim() == 3),
            None if tile_wet is None else tile_wet.data_ptr(),
            int(tracer_form), int(bool(visc_form)), int(steps),
            lay.Xs, lay.Ys, LOADERS[loader],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("copy_step kernel launch failed: "
                           + lib.copy_step_error_string(rc).decode())
    copy_step.launches += 1
    copy_step.loader_launches[loader] += 1
    return outs


copy_step.launches = 0
copy_step.loader_launches = collections.Counter()    # by loader


def copy_step_stacked(stack: torch.Tensor, met, n_out: int, lay: FusedLayout,
                      tracer_form: int = 0, tile_wet=None, tile=None,
                      visc_form: bool = False, steps: int = 1) -> torch.Tensor:
    """The copy step on ONE stacked (n_in, Xs, Ys) input, into ONE
    (n_out, Xs, Ys) output: output o is that of :func:`copy_step` on
    ``stack.unbind(0)``. The plain version for a CPU tensor, the stacked
    CUDA kernel for a CUDA one (counted in ``copy_step_stacked.launches``);
    the other arguments are those of :func:`copy_step`."""
    if (stack.dim() != 3 or tuple(stack.shape[1:]) != (lay.Xs, lay.Ys)
            or not stack.is_contiguous()):
        raise ValueError(f"stack: need a contiguous (n, {lay.Xs}, {lay.Ys}) "
                         f"tensor, got {tuple(stack.shape)}")
    if stack.device.type == "cpu":
        return torch.stack(copy_step_reference(stack.unbind(0), met, n_out,
                                               lay, tile_wet, tile))
    _check_inputs(stack.unbind(0), met, n_out, lay, tile_wet, tile, steps,
                  stacked=True, tracer_form=tracer_form,
                  visc_form=visc_form)
    lib = _library()
    out = torch.empty((n_out, lay.Xs, lay.Ys), dtype=torch.float32,
                      device=stack.device)
    with torch.cuda.device(stack.device):
        rc = lib.copy_step_stacked_launch(
            stack.data_ptr(), stack.shape[0], out.data_ptr(), n_out,
            None if met is None else met.data_ptr(),
            0 if met is None else met.shape[0],
            int(met is not None and met.dim() == 3),
            None if tile_wet is None else tile_wet.data_ptr(),
            int(tracer_form), int(bool(visc_form)), int(steps),
            lay.Xs, lay.Ys, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("copy_step stacked kernel launch failed: "
                           + lib.copy_step_error_string(rc).decode())
    copy_step_stacked.launches += 1
    return out


copy_step_stacked.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/copy_step.cu, built on first use, with its C signatures."""
    lib = load("copy_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.copy_step_tile_x, lib.copy_step_tile_y):
        fn.argtypes = [i, i, i]
        fn.restype = i
    for fn in (lib.copy_step_max_windows, lib.copy_step_max_outputs,
               lib.copy_step_max_async_windows):
        fn.argtypes = []
        fn.restype = i
    lib.copy_step_window.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.copy_step_window.restype = i
    lib.copy_step_error_string.argtypes = [i]
    lib.copy_step_error_string.restype = ctypes.c_char_p
    lib.copy_step_launch.argtypes = [p, i, p, i, p, i, i, p, i, i, i, i, i,
                                     i, p]
    lib.copy_step_stacked_launch.argtypes = [p, i, p, i, p, i, i, p, i, i,
                                             i, i, i, p]
    for fn in (lib.copy_step_launch, lib.copy_step_stacked_launch):
        fn.restype = i
    return lib
