"""profiling/sass_slots.py's SASS reading, on the CPU: a disassembly in
cuobjdump's layout with an outer and an inner loop, of which the inner
one holds the reciprocal."""

import pytest

from craytracer_tpu_torch.profiling import sass_slots

SASS = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_16otherEv
        /*0000*/                   MUFU.RCP R1, R2 ;       /* 0x0 */
        /*0010*/                   BRA 0x0 ;               /* 0x0 */
                Function : _ZN12_GLOBAL__N_113k6_tri_kernelEPKf
        /*0000*/                   LDC R1, c[0x0][0x28] ;  /* 0x0 */
        /*0010*/                   LDS R4, [R2] ;          /* 0x0 */
        /*0020*/                   FMUL R5, R4, R3 ;       /* 0x0 */
        /*0030*/                   FADD R6, R5, R4 ;       /* 0x0 */
        /*0040*/                   MUFU.RCP R7, R6 ;       /* 0x0 */
        /*0050*/                   FMUL R8, R7, R5 ;       /* 0x0 */
        /*0060*/                   MUFU.RCP R9, R8 ;       /* 0x0 */
        /*0070*/                   FSETP.GT.AND P0, PT, R9, R1, PT ;
        /*0080*/               @P0 BRA 0x20 ;              /* 0x0 */
        /*0090*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00a0*/              @!P1 BRA 0x10 ;              /* 0x0 */
        /*00b0*/                   EXIT ;                  /* 0x0 */
"""


def test_parse_takes_the_named_function():
    insns = sass_slots.parse(SASS, "k6_tri_kernel")
    assert [op for _, op, _ in insns][:3] == ["LDC", "LDS", "FMUL"]
    assert insns[-1] == (0xB0, "EXIT", "EXIT")
    assert ("@P0 BRA 0x20" in [t for _, _, t in insns])
    with pytest.raises(ValueError):
        sass_slots.parse(SASS, "k2_shade_kernel")


def test_innermost_loop_holding_the_reciprocal():
    loop = sass_slots.innermost_loop(sass_slots.parse(SASS, "k6_tri_kernel"))
    assert [a for a, _, _ in loop] == list(range(0x20, 0x90, 0x10))
    assert sum(op == "MUFU.RCP" for _, op, _ in loop) == 2
    with pytest.raises(ValueError):
        sass_slots.innermost_loop(sass_slots.parse(SASS, "k6_tri_kernel"),
                                  marker="DFMA")
