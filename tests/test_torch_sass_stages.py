"""scripts/sass_stages_torch.py on a small piece of cuobjdump -sass text:
the kernel split at its block barriers, each piece's instruction classes
and its loops' bodies."""

import importlib.util
import os

import pytest

SASS = """
        code for sm_90a
                Function : _Z6kernelILi0EEvPf
        .headerflags    @"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   UTMALDG.2D [UR8], [UR4] ;
        /*0020*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R0 ;
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0040*/                   LDS R2, [R3] ;
        /*0050*/                   FFMA R2, R2, R4, R5 ;
        /*0060*/                   IADD3 R3, R3, 0x200, RZ ;
        /*0070*/                   STS [R3], R2 ;
        /*0080*/               @P0 BRA 0x40 ;
        /*0090*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00a0*/                   LDG.E R6, [R8.64] ;
        /*00b0*/                   FADD R6, R6, R2 ;
        /*00c0*/                   STG.E [R8.64], R6 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   BRA 0xe0 ;
"""


def _script():
    spec = importlib.util.spec_from_file_location(
        "sass_stages_torch", os.path.join(os.path.dirname(__file__), "..",
                                          "scripts", "sass_stages_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pieces_split_at_barriers_with_their_classes():
    mod = _script()
    (name, ins), = mod.functions(SASS).items()
    assert name == "_Z6kernelILi0EEvPf" and len(ins) == 15
    pieces = mod.stages(ins)
    assert [p["address"] for p in pieces] == [0x0, 0x40, 0xa0]
    setup, loop, tail = (p["counts"] for p in pieces)
    assert (setup["all"], setup["tma"], setup["wait"]) == (4, 1, 1)
    assert (loop["all"], loop["fp32"], loop["int"], loop["lds"],
            loop["sts"]) == (6, 1, 1, 1, 1)
    assert (tail["ldg"], tail["stg"], tail["fp32"]) == (1, 1, 1)


@pytest.mark.parametrize("path_kind", ["text", "missing kernel"])
def test_loop_bodies_and_the_command_line(tmp_path, capsys, path_kind):
    mod = _script()
    pieces = mod.stages(next(iter(mod.functions(SASS).values())))
    # the predicated branch back to 0x40 closes a 5-instruction body with
    # one FFMA; a branch to itself at the end is not a loop of a piece
    assert pieces[1]["loops"] == [(5, 1)] and pieces[2]["loops"] == []
    path = tmp_path / "k.sass"
    path.write_text(SASS)
    pattern = "kernelILi0E" if path_kind == "text" else "nothing"
    rc = mod.main(["sass_stages_torch.py", str(path), pattern])
    out = capsys.readouterr()
    if path_kind == "text":
        assert rc == 0 and "piece 1 @0x40: all 6 fp32 1" in out.out
        assert "loop bodies (instructions, fp32) [(5, 1)]" in out.out
    else:
        assert rc == 1 and "no kernel matches" in out.err


def test_instructions_a_tile_from_the_cells_of_each_stage(tmp_path, capsys):
    """--cells: each piece's cell loops (the unrolled twin after a loop,
    k times its FP32 instructions and at most k times its body, does not
    run at a few cells a thread) times the cells of its stages."""
    mod = _script()
    loops = [(10, 2), (84, 32), (28, 6), (102, 24), (16, 2)]
    assert mod.cell_loops(loops) == [(10, 2), (28, 6), (16, 2)]
    pieces = [{"loops": []}, {"loops": loops}]
    assert mod.per_tile(pieces, [[0], [100, 50, 20]]) == [
        0, 10 * 100 + 28 * 50 + 16 * 20]
    path = tmp_path / "k.sass"
    path.write_text(SASS)
    rc = mod.main(["sass_stages_torch.py", str(path), "kernelILi0E",
                   "--cells", "0,1000,0"])
    assert rc == 0
    assert "all 5.0k instructions a tile" in capsys.readouterr().out
    rc = mod.main(["sass_stages_torch.py", str(path), "kernelILi0E",
                   "--cells", "0,1000"])
    assert rc == 2 and "--cells has 2 pieces" in capsys.readouterr().err


def test_cells_by_the_halo_of_each_stage_region(tmp_path, capsys):
    """--cells with --tile: an entry ``hN`` is the region N cells beyond
    the tile, (TX + 2 N) x (TY + 2 N) cells, so a chained form's stages
    (the general body's among them) are given by their halos, ``/K`` for
    a loop of K cells an iteration; ``hN`` without --tile, or --tile
    without --cells, is refused."""
    mod = _script()
    assert mod.parse_cells("0,h6+h5,7", (16, 32)) == [[0], [28 * 44, 26 * 42],
                                                      [7]]
    # a loop nvcc unrolled twice: half as many iterations
    assert mod.parse_cells("h1/2,9/3", (2, 4)) == [[12.0], [3.0]]
    with pytest.raises(ValueError, match="--tile"):
        mod.parse_cells("h1")
    path = tmp_path / "k.sass"
    path.write_text(SASS)
    # h0 of a 10 x 10 tile is 100 cells of the 5-instruction loop: 0.5k
    rc = mod.main(["sass_stages_torch.py", str(path), "kernelILi0E",
                   "--cells", "0,h0,0", "--tile", "10x10"])
    assert rc == 0
    assert "all 0.5k instructions a tile" in capsys.readouterr().out
    assert mod.main(["sass_stages_torch.py", str(path), "kernelILi0E",
                     "--cells", "0,h0,0"]) == 2
    assert "needs --tile" in capsys.readouterr().err
    assert mod.main(["sass_stages_torch.py", str(path), "kernelILi0E",
                     "--tile", "10x10"]) == 2
