"""``sims/sass_floor``: the slot loops and their common path on a small
SASS listing written in cuobjdump's format.  Plain Python, no JAX."""

import pytest

from qamreconciliation_tpu_torch.ops.kernels import CM_ILP, H100_SMS
from qamreconciliation_tpu_torch.sims.sass_floor import (
    CLOCK_GHZ, common_path, floor_of, issue_floor_ms, main, parse_function,
    slot_loops,
)

SASS = """
        Function : _Z5otheri
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   MUFU.EX2 R2, R2 ;
        /*0020*/              @!P0 BRA 0x0000 ;
        Function : _Z6kernelIfEvv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS R4, [R3] ;
        /*0020*/                   FSETP.GEU.AND P3, PT, R4, 10, PT ;
        /*0030*/              @!P3 BRA 0x0070 ;
        /*0040*/                   MUFU.EX2 R5, R4 ;
        /*0050*/                   FADD R5, R5, 1 ;
        /*0060*/                   BRA 0x0090 ;
        /*0070*/                   MUFU.RCP R5, R4 ;
        /*0080*/                   FMUL R5, R5, R4 ;
        /*0090*/                   STS [R3], R5 ;
        /*00a0*/              @!P1 BRA 0x0010 ;
        /*00b0*/                   IADD3 R3, R3, 0x4, RZ ;
        /*00c0*/              @!P2 BRA 0x0000 ;
        /*00d0*/                   EXIT ;
"""


def test_slot_loop_and_its_common_path():
    instrs = parse_function(SASS, "kernelIfE")
    assert len(instrs) == 14 and instrs[0] == (0, "MOV R1, c[0x0][0x28]")
    # the outer loop 0x0-0xc0 holds the inner MUFU loop 0x10-0xa0
    loops = slot_loops(instrs)
    assert loops == [(0x10, 0xa0)]
    # 10 instructions, of which the large-argument block 0x40-0x60 (3) is
    # branched around
    assert common_path(instrs, loops[0]) == 7
    # the same with an ordered compare and another predicate's compare
    # between the test and its branch; a branch on a predicate another
    # compare set last skips nothing
    other = SASS.replace("FSETP.GEU.AND P3, PT, R4, 10, PT",
                         "FSETP.GE.AND P3, PT, R4, 10, PT").replace(
        "MOV R1, c[0x0][0x28] ;\n        /*0010*/",
        "ISETP.GE.AND P1, PT, R1, RZ, PT ;\n        /*0010*/")
    assert common_path(parse_function(other, "kernelIfE"), loops[0]) == 7
    reset = SASS.replace("FSETP.GEU.AND P3, PT, R4, 10, PT",
                         "FSETP.GEU.AND P3, PT, R4, 11, PT")
    assert common_path(parse_function(reset, "kernelIfE"), loops[0]) == 10


def test_issue_floor_arithmetic_and_cli(tmp_path):
    # 32 slots of 4 instructions: 4 warp instructions, one SM's 4
    # schedulers, one cycle at 1 GHz
    assert issue_floor_ms(4, 32, 1.0, sms=1) == pytest.approx(1e-6)
    # the CLI reads kernel 5's pairs a loop, the H100's SMs and its clock
    path = tmp_path / "k.sass"
    path.write_text(SASS)
    floor = main([str(path), "kernelIfE", "--elements", "64"])
    assert floor == pytest.approx(
        1e3 * 64 * 7 / CM_ILP / 32 / (H100_SMS * 4) / (CLOCK_GHZ * 1e9))
    assert (CM_ILP, H100_SMS, CLOCK_GHZ) == (2, 132, 1.98)
    with pytest.raises(ValueError, match="no function"):
        parse_function(SASS, "missing")


@pytest.mark.parametrize("ilp", [1, 6])
def test_ilp_sets_the_slots_a_loop_iteration_runs(tmp_path, ilp):
    """``--ilp`` (kernel 6's register rows run a pair's dc slots an
    iteration) divides the loop's common path into that many slots."""
    path = tmp_path / "k.sass"
    path.write_text(SASS)
    floor = main([str(path), "kernelIfE", "--elements", "64",
                  "--ilp", str(ilp)])
    assert floor == pytest.approx(issue_floor_ms(7 / ilp, 64))
    assert floor_of(SASS, "kernelIfE", 64, ilp) == floor


def test_integer_division_loops_are_not_slot_loops():
    """A loop whose only MUFU is the MUFU.RCP of an integer division (a
    producer's copy loop) is no slot loop; the transcendental one is."""
    sass = """
        Function : _Z4probev
        /*0000*/                   MUFU.EX2 R5, R4 ;
        /*0010*/                   FADD R5, R5, 1 ;
        /*0020*/              @!P1 BRA 0x0000 ;
        /*0030*/                   MUFU.RCP R7, R6 ;
        /*0040*/                   IMAD.HI.U32 R8, R7, R6, RZ ;
        /*0050*/              @!P2 BRA 0x0030 ;
        /*0060*/                   EXIT ;
"""
    assert slot_loops(parse_function(sass, "probe")) == [(0x0, 0x20)]
