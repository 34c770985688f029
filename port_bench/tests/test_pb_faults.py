"""The check's control and faults: the reference in bfloat16 in the
program's place, and the timed path broken underneath a run, each has to
come out not correct. On the card at the cells' own size:
``python3 port_bench/control.py --workload <cell> --seeds 1,2,3``."""

import pytest
import torch

import tiny

SEEDS = (11, 2**31 + 5, 4242)


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("bench")))


def failed_checks(checks: dict) -> list:
    return [k for k, c in checks.items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("cell", ["tiny.t", "tiny_t2.t"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_in_bfloat16_fails(copy, cell, seed):
    from port_bench import control
    checks = control.readings(cell, seed, "cpu", copy, torch.bfloat16)
    assert failed_checks(checks), checks


def _unchanged(step, fields, *a, **k):
    _, m = step(fields, *a, **k)
    return tuple(f.clone() for f in fields), m


def _half_left_out(step, fields, *a, **k):
    outs, m = step(fields, *a, **k)
    h = fields[0].shape[0] // 2
    outs = [o.clone() for o in outs]
    for o, f in zip(outs, fields):
        o[:h] = f[:h]
    return tuple(outs), m


def _one_cell_altered(step, fields, *a, **k):
    outs, m = step(fields, *a, **k)
    outs = [o.clone() for o in outs]
    i, j = (int(x) for x in torch.nonzero(outs[0] != 0)[len(outs[0]) // 2])
    outs[0][i, j] += 1e-2 * float(outs[0].abs().max())
    return tuple(outs), m


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _one_cell_altered])
@pytest.mark.parametrize("cell", ["tiny.t", "tiny_t2.t"])
def test_broken_step_is_not_correct(copy, monkeypatch, fault, cell):
    """A run whose every launch of the fused step is broken (the harness's
    look for a card skipped: the CPU runs the kernel's plain version)."""
    from ocean_model_arch_torch.model import fused

    from port_bench import harness
    step = fused.fused_sw_step
    monkeypatch.setattr(fused, "fused_sw_step",
                        lambda *a, **k: fault(step, *a, **k))
    out = harness.run_cell(cell, 2**31 + 3, 0.2, False, device="cpu",
                           root=copy)
    assert out["correct"] is False
    assert failed_checks(out["checks"])
