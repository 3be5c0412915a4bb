"""The SASS loop walker that K7's operations bound is counted with
(``ceph_tpu_torch/kernels/sass.py``), on hand-written ``cuobjdump -sass``
text: the loop is found by its backward branch, forward conditional
branches fall through, a CALL runs its subroutine to RET, and each
opcode lands on its pipe."""

from collections import Counter

import pytest

from ceph_tpu_torch.kernels import sass

_TEXT = """
	code for sm_90a
		Function : _Z10other_kernelPi
        /*0000*/                   IMAD R0, R1, R2, R3 ;
        /*0010*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_111loop_kernelEPi
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   ISETP.GE.AND P0, PT, R0, 0x1, PT ;
        /*0020*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0030*/              @!P0 BRA 0x80 ;
        /*0040*/                   LOP3.LUT R2, R1, R0, RZ, 0x3c, !PT ;
        /*0050*/                   SHF.R.U32.HI R2, RZ, 0xd, R2 ;
        /*0060*/                   MOV R26, 0x80 ;
        /*0070*/                   CALL.REL.NOINC 0xc0 ;
        /*0080*/               @P1 IMAD.SHL.U32 R3, R2, 0x100, RZ ;
        /*0090*/                   ISETP.GE.AND P1, PT, R1, R4, PT ;
        /*00a0*/              @!P1 BRA 0x20 ;
        /*00b0*/                   EXIT ;
        /*00c0*/                   I2F.U64.RP R8, R6 ;
        /*00d0*/                   MUFU.RCP R8, R8 ;
        /*00e0*/                   IMAD.WIDE.U32 R10, R8, R6, RZ ;
        /*00f0*/                   RET.REL.NODEC R26 0x0 ;
"""


def test_loop_mix_walks_one_iteration():
    mix = sass.loop_mix(_TEXT, "loop_kernel")
    assert mix == Counter({
        "IADD3": 1, "BRA": 2, "LOP3.LUT": 1, "SHF.R.U32.HI": 1, "MOV": 1,
        "CALL.REL.NOINC": 1, "I2F.U64.RP": 1, "MUFU.RCP": 1,
        "IMAD.WIDE.U32": 1, "RET.REL.NODEC": 1, "IMAD.SHL.U32": 1,
        "ISETP.GE.AND": 1})


def test_pipes_and_the_least_clocks():
    mix = sass.loop_mix(_TEXT, "loop_kernel")
    pipes = sass.pipe_counts(mix)
    assert pipes == {"issue": 13, "alu": 4, "fma": 2, "xu": 2}
    # the conversion unit (2 of 16 a clock) beats issue (13 of 128)
    assert sass.clocks_per_iteration(mix) == pytest.approx(2 / 16)
    alu = Counter({"IADD3": 90, "LOP3.LUT": 70, "IMAD": 40})
    assert sass.clocks_per_iteration(alu) == pytest.approx(160 / 64)


@pytest.mark.parametrize("text,name", [
    (_TEXT, "kernel"),                       # two functions match
    (_TEXT, "missing_kernel"),               # none does
    (_TEXT.replace("@!P1 BRA 0x20", "@!P1 BRA 0xb0"), "loop_kernel"),
], ids=["ambiguous", "absent", "no-loop"])
def test_refuses_what_it_cannot_walk(text, name):
    with pytest.raises(ValueError):
        sass.loop_mix(text, name)
