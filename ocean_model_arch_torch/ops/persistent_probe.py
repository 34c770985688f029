"""The persistent walk: mechanism probe of the persistent fused step.

Counterpart of ``scripts/persistent_probe.py::build`` and ``::build_fori``,
the TPU probe of ``ocean_model_arch_tpu/ops/pallas/fused_step.py::
build_persistent_sw_step``. For every interior row r of 6 float32 fields
on the (X + 2 M, YS) margined layout of ``build_fori`` (the M margin rows
above and below carried unchanged), ``n_steps`` times:

    new[r] = fma(old[r], 1.000001, 0.000001 * old[r - M])

``build`` is the same function on the interior rows with zero margins.
The CUDA kernel (``csrc/persistent_probe.cu``) has three forms with the
same bits (``FORMS``): ``inplace``, one cooperative launch for all the
steps with the state updated in place (the TPU design: each tile stashes
its new last rows for the next tile's next step, one grid barrier a
step); ``pingpong``, one cooperative launch between two state buffers
(the design of the persistent fused step); ``launches``, one ordinary
launch a step between the same two buffers, the baseline that prices the
barrier. ``scripts/persistent_probe_torch.py`` is its entry point; nothing
on the model's step loop calls it.

:func:`persistent_walk` takes CPU tensors to
:func:`persistent_walk_reference` and CUDA tensors to the kernel, which it
builds on first use; a kernel that does not build, or a launch the card
refuses (a grid it cannot hold at once), raises. The plain version takes
the sum in float64 and rounds it once to float32, which is the fused
multiply-add's result but where the float64 sum lands on a float32
rounding tie (then it may differ by one unit in the last place).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ._build import load

N_FIELDS = 6
MARGIN = 8              # the stencil's reach in rows (the TPU probe's M)
TILE_ROWS = 64          # rows of a tile (the TPU probe's TX)
FORMS = ("inplace", "pingpong", "launches")
# the update's constants as float32 values, the fma's operands
SCALE = float(torch.tensor(1.000001, dtype=torch.float32))
COUPLE = torch.tensor(0.000001, dtype=torch.float32)


def persistent_walk_reference(fields, n_steps: int,
                              margin: int = MARGIN) -> tuple:
    """``n_steps`` steps of the walk in plain PyTorch: new (X + 2 M, YS)
    tensors, margins copied."""
    m = margin
    out = []
    for f in fields:
        x = f.clone()
        rows = x.shape[0] - 2 * m
        for _ in range(n_steps):
            prev = (COUPLE.to(x.device) * x[:rows]).double()
            x[m:m + rows] = (x[m:m + rows].double() * SCALE + prev).float()
        out.append(x)
    return tuple(out)


def step_bytes(X: int, YS: int, margin: int = MARGIN,
               n_fields: int = N_FIELDS) -> int:
    """The bytes one step must move: each field's X + 2 M rows read (the
    interior and the margin rows the first tiles read) and its X interior
    rows written."""
    return n_fields * ((X + 2 * margin) + X) * YS * 4


def stash_floats(X: int, YS: int, tile_rows: int = TILE_ROWS) -> int:
    """The in-place form's stash: the last M rows of every tile of every
    field, at both step parities."""
    return 2 * N_FIELDS * (X // tile_rows) * MARGIN * YS


def coresident_grid(form: str = "pingpong") -> int:
    """The blocks the card holds at once for a cooperative form on the
    current CUDA device (occupancy x SMs): the largest grid it takes."""
    lib = _library()
    blocks = ctypes.c_int(0)
    rc = lib.walk_coresident(int(form == "inplace"), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError("persistent walk occupancy query failed: "
                           + lib.walk_error_string(rc).decode())
    return blocks.value


def n_tiles(X: int, YS: int, tile_rows: int = TILE_ROWS) -> int:
    """The tiles of one step: tile_rows rows of one field by a block's
    columns."""
    cols = _library().walk_threads()
    return N_FIELDS * (X // tile_rows) * -(-YS // cols)


def _check(fields, spare, tile_rows: int) -> None:
    if len(fields) != N_FIELDS:
        raise ValueError(f"need {N_FIELDS} fields, got {len(fields)}")
    dev, shape = fields[0].device, tuple(fields[0].shape)
    X = shape[0] - 2 * MARGIN
    if (len(shape) != 2 or X <= 0 or tile_rows <= 0
            or tile_rows % MARGIN or X % tile_rows):
        raise ValueError(f"fields of {shape}: need (X + {2 * MARGIN}, YS) "
                         f"with X a multiple of the tile's {tile_rows} rows, "
                         f"themselves a multiple of {MARGIN}")
    for t in tuple(fields) + tuple(spare or ()):
        if (dev.type != "cuda" or t.device != dev
                or t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"need contiguous float32 {shape} CUDA tensors "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if spare is not None and (
            len(spare) != N_FIELDS
            or {t.data_ptr() for t in spare} & {t.data_ptr() for t in fields}):
        raise ValueError(f"spare: need {N_FIELDS} tensors, none of them a "
                         "field")


def persistent_walk(fields, n_steps: int, form: str = "inplace",
                    spare=None, tile_rows: int = TILE_ROWS,
                    sync: bool = True) -> tuple:
    """``n_steps`` steps of the walk on 6 (X + 2 M, YS) float32 fields.
    CPU tensors: the plain version (new tensors). CUDA tensors: the kernel
    in ``form`` (``FORMS``), counted in ``persistent_walk.launches`` and,
    by form, ``.form_launches``:
    ``inplace`` updates ``fields`` in place and returns them; ``pingpong``
    and ``launches`` step between ``fields`` and ``spare`` (6 tensors of
    the same shape whose margin rows hold the fields' margins; allocated
    as a copy of the fields when None) and return whichever set holds step
    ``n_steps``, the other one overwritten. A cooperative form runs the
    co-resident grid (:func:`coresident_grid`) or the tiles of a step,
    whichever is fewer. ``sync=False`` drops the
    cooperative forms' barrier, for timing what the steps cost without it:
    the results are then not the walk's."""
    if form not in FORMS:
        raise ValueError(f"form {form!r}: one of {FORMS}")
    if fields[0].device.type == "cpu":
        return persistent_walk_reference(fields, n_steps)
    if n_steps < 1:
        raise ValueError(f"n_steps={n_steps}: at least one step")
    if form == "inplace":
        spare = None
    elif spare is None:
        spare = tuple(f.clone() for f in fields)
    _check(fields, spare, tile_rows)
    lib = _library()
    X, YS = fields[0].shape[0] - 2 * MARGIN, fields[0].shape[1]
    dev = fields[0].device
    stash = None
    if form == "inplace":
        stash = torch.empty(stash_floats(X, YS, tile_rows),
                            dtype=torch.float32, device=dev)
    sets = [(ctypes.c_void_p * N_FIELDS)(*(t.data_ptr() for t in s))
            for s in (fields, spare or fields)]
    with torch.cuda.device(dev):
        grid = (0 if form == "launches" else
                min(coresident_grid(form), n_tiles(X, YS, tile_rows)))
        stream = torch.cuda.current_stream().cuda_stream
        if form == "launches":
            for s in range(n_steps):
                rc = lib.walk_launch(sets[s % 2], sets[1 - s % 2], None, X, YS,
                                     tile_rows, 1, 2, 0, 0, stream)
                if rc != 0:
                    break
                persistent_walk.launches += 1
                persistent_walk.form_launches[form] += 1
        else:
            rc = lib.walk_launch(sets[0], sets[1], None if stash is None
                                 else stash.data_ptr(), X, YS, tile_rows,
                                 n_steps, FORMS.index(form), int(sync),
                                 int(grid), stream)
            if rc == 0:
                persistent_walk.launches += 1
                persistent_walk.form_launches[form] += 1
    if rc != 0:
        raise RuntimeError(f"persistent walk ({form}) launch failed: "
                           + lib.walk_error_string(rc).decode())
    if form == "inplace" or n_steps % 2 == 0:
        return tuple(fields)
    return tuple(spare)


def reset_launch_counts() -> None:
    """Zero ``persistent_walk.launches`` and ``.form_launches``."""
    persistent_walk.launches = 0
    persistent_walk.form_launches = collections.Counter()


reset_launch_counts()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/persistent_probe.cu, built on first use, with its C
    signatures."""
    lib = load("persistent_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.walk_margin, lib.walk_fields, lib.walk_threads):
        fn.argtypes = []
        fn.restype = i
    if (lib.walk_margin(), lib.walk_fields()) != (MARGIN, N_FIELDS):
        raise RuntimeError("csrc/persistent_probe.cu was built for "
                           f"(margin, fields) = ({lib.walk_margin()}, "
                           f"{lib.walk_fields()}), not ({MARGIN}, "
                           f"{N_FIELDS})")
    lib.walk_coresident.argtypes = [i, ctypes.POINTER(i)]
    lib.walk_coresident.restype = i
    lib.walk_error_string.argtypes = [i]
    lib.walk_error_string.restype = ctypes.c_char_p
    lib.walk_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.walk_launch.restype = i
    return lib
