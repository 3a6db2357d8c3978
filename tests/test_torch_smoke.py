"""K5's count of instructions a point-hypothesis test
(``semantic_slam_tpu_torch/tools/k5_sass.py``), which ``chip_smoke.py``
bounds K5 with (``K5_INSTR_PER_TEST``): on a made-up disassembly, the
smallest backward-branch loop that holds warp sums is the one counted, and on
the inner loop of the kernel as nvcc built it for sm_90a (``cuobjdump -sass``
of ``libscore_hypotheses.so``, 2 hypotheses x 4 points) the count is the
constant's."""

import importlib.util
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

HEADER = "        Function : _ZN12_GLOBAL__N_112score_kernelEPKfS1_PKhS1_S1_iiffPi\n"

MADE_UP = HEADER + """
        /*0000*/                   MOV R1, c[0x0][0x28] ;                      /* 0x00000a0000017a02 */
        /*0010*/               @P1 BRA 0x90 ;                                  /* 0x0000000000001947 */
        /*0020*/                   LDS.128 R12, [UR8] ;                        /* 0x00000008ff0c7984 */
        /*0030*/                   FFMA R32, R24, R13, R32 ;                   /* 0x0000000d18207223 */
        /*0040*/                   REDUX.SUM.S32 UR18, R32 ;                   /* 0x00000000201273c4 */
        /*0050*/                   FSETP.LT.AND P0, PT, |R32|, UR16, P3 ;      /* 0x0000001020007c0b */
        /*0060*/                   REDUX.SUM.S32 UR19, R12 ;                   /* 0x000000000c1373c4 */
        /*0070*/               @P0 BRA 0x20 ;                                  /* 0xfffffff8005c0947 */
        /*0080*/                   REDUX.SUM.S32 UR7, R12 ;                    /* 0x000000000c0773c4 */
        /*0090*/              @!P0 BRA 0x0 ;                                   /* 0xfffffff000648947 */
        /*00a0*/                   IADD3 R2, R2, 0x1, RZ ;                     /* 0x0000000102027810 */
        /*00b0*/               @P2 BRA 0xa0 ;                                  /* 0xfffffffc00b81947 */
        /*00c0*/                   EXIT ;                                      /* 0x000000000000794d */
"""

# score_kernel's inner loop as built for sm_90a (H100): per hypothesis one
# LDS.128 of (n, d), 4 points' dot products and compares, the count, one REDUX
SM90A_LOOP = HEADER + """
    /*11a0*/ UIADD3 UR8, UR6, UR5, URZ ;
    /*11b0*/ UIADD3 UR7, UR7, -0x2, URZ ;
    /*11c0*/ ULEA UR8, UR8, UR12, 0x4 ;
    /*11d0*/ LDS.128 R12, [UR8] ;
    /*11e0*/ FMUL R32, R37, R12 ;
    /*11f0*/ FFMA R32, R24, R13, R32 ;
    /*1200*/ FFMA R32, R3, R14, R32 ;
    /*1210*/ FADD R32, R15, R32 ;
    /*1220*/ FSETP.LT.AND P0, PT, |R32|, UR16, P3 ;
    /*1230*/ FMUL R32, R5, R12 ;
    /*1240*/ FFMA R32, R4, R13, R32 ;
    /*1250*/ FFMA R32, R7, R14, R32 ;
    /*1260*/ FSETP.GT.AND P0, PT, R32, UR17, P0 ;
    /*1270*/ FMUL R32, R9, R12 ;
    /*1280*/ FFMA R32, R6, R13, R32 ;
    /*1290*/ FFMA R32, R11, R14, R32 ;
    /*12a0*/ FADD R32, R15, R32 ;
    /*12b0*/ FSETP.LT.AND P1, PT, |R32|, UR16, P4 ;
    /*12c0*/ FMUL R32, R17, R12 ;
    /*12d0*/ FFMA R32, R8, R13, R32 ;
    /*12e0*/ FFMA R32, R19, R14, R32 ;
    /*12f0*/ FSETP.GT.AND P1, PT, R32, UR17, P1 ;
    /*1300*/ FMUL R32, R21, R12 ;
    /*1310*/ FFMA R32, R10, R13, R32 ;
    /*1320*/ FFMA R32, R23, R14, R32 ;
    /*1330*/ FADD R32, R15, R32 ;
    /*1340*/ FSETP.LT.AND P2, PT, |R32|, UR16, P5 ;
    /*1350*/ FMUL R32, R25, R12 ;
    /*1360*/ FFMA R32, R16, R13, R32 ;
    /*1370*/ FFMA R32, R27, R14, R32 ;
    /*1380*/ FSETP.GT.AND P2, PT, R32, UR17, P2 ;
    /*1390*/ FMUL R32, R29, R12.reuse ;
    /*13a0*/ FMUL R12, R33, R12 ;
    /*13b0*/ FFMA R32, R18, R13.reuse, R32 ;
    /*13c0*/ FFMA R12, R20, R13, R12 ;
    /*13d0*/ SEL R13, RZ, 0x1, !P1 ;
    /*13e0*/ FFMA R32, R31, R14.reuse, R32 ;
    /*13f0*/ FFMA R12, R35, R14, R12 ;
    /*1400*/ IMAD.MOV.U32 R14, RZ, RZ, 0x2 ;
    /*1410*/ @!P1 IADD3 R14, RZ, 0x1, RZ ;
    /*1420*/ FADD R15, R15, R32 ;
    /*1430*/ @!P0 IMAD.MOV R14, RZ, RZ, R13 ;
    /*1440*/ FSETP.LT.AND P1, PT, |R15|, UR16, P6 ;
    /*1450*/ FSETP.GT.AND P1, PT, R12, UR17, P1 ;
    /*1460*/ VIADD R12, R14, 0x1 ;
    /*1470*/ @!P2 IMAD.MOV R12, RZ, RZ, R14 ;
    /*1480*/ IADD3 R32, R12, 0x1, RZ ;
    /*1490*/ @!P1 IMAD.MOV R32, RZ, RZ, R12 ;
    /*14a0*/ LDS.128 R12, [UR8+0x10] ;
    /*14b0*/ UIADD3 UR8, UR6, 0x1, URZ ;
    /*14c0*/ REDUX.SUM.S32 UR18, R32 ;
    /*14d0*/ FMUL R32, R9, R12.reuse ;
    /*14e0*/ FMUL R34, R37, R12 ;
    /*14f0*/ FFMA R32, R6, R13.reuse, R32 ;
    /*1500*/ FFMA R34, R24, R13, R34 ;
    /*1510*/ FFMA R32, R11, R14.reuse, R32 ;
    /*1520*/ FFMA R34, R3, R14, R34 ;
    /*1530*/ FADD R32, R15.reuse, R32 ;
    /*1540*/ FADD R34, R15, R34 ;
    /*1550*/ FSETP.LT.AND P1, PT, |R32|, UR16, P4 ;
    /*1560*/ FMUL R32, R17, R12.reuse ;
    /*1570*/ FSETP.LT.AND P0, PT, |R34|, UR16, P3 ;
    /*1580*/ FMUL R34, R5, R12 ;
    /*1590*/ FFMA R32, R8, R13.reuse, R32 ;
    /*15a0*/ FFMA R34, R4, R13, R34 ;
    /*15b0*/ FFMA R32, R19, R14.reuse, R32 ;
    /*15c0*/ FFMA R34, R7, R14, R34 ;
    /*15d0*/ FSETP.GT.AND P1, PT, R32, UR17, P1 ;
    /*15e0*/ FMUL R32, R21, R12 ;
    /*15f0*/ FSETP.GT.AND P0, PT, R34, UR17, P0 ;
    /*1600*/ FFMA R32, R10, R13, R32 ;
    /*1610*/ FFMA R32, R23, R14, R32 ;
    /*1620*/ FADD R32, R15, R32 ;
    /*1630*/ FSETP.LT.AND P2, PT, |R32|, UR16, P5 ;
    /*1640*/ FMUL R32, R25, R12 ;
    /*1650*/ FFMA R32, R16, R13, R32 ;
    /*1660*/ FFMA R32, R27, R14, R32 ;
    /*1670*/ FSETP.GT.AND P2, PT, R32, UR17, P2 ;
    /*1680*/ FMUL R32, R29, R12.reuse ;
    /*1690*/ FMUL R12, R33, R12 ;
    /*16a0*/ FFMA R32, R18, R13.reuse, R32 ;
    /*16b0*/ FFMA R12, R20, R13, R12 ;
    /*16c0*/ SEL R13, RZ, 0x1, !P1 ;
    /*16d0*/ FFMA R32, R31, R14.reuse, R32 ;
    /*16e0*/ FFMA R12, R35, R14, R12 ;
    /*16f0*/ IMAD.MOV.U32 R14, RZ, RZ, 0x2 ;
    /*1700*/ FADD R15, R15, R32 ;
    /*1710*/ @!P1 IMAD.MOV R14, RZ, RZ, 0x1 ;
    /*1720*/ @!P0 IADD3 R14, R13, RZ, RZ ;
    /*1730*/ ISETP.NE.AND P0, PT, R30, UR6, PT ;
    /*1740*/ UIADD3 UR6, UR6, 0x2, URZ ;
    /*1750*/ FSETP.LT.AND P1, PT, |R15|, UR16, P6 ;
    /*1760*/ VIADD R13, R14, 0x1 ;
    /*1770*/ @!P2 IMAD.MOV R13, RZ, RZ, R14 ;
    /*1780*/ FSETP.GT.AND P1, PT, R12, UR17, P1 ;
    /*1790*/ VIADD R12, R13, 0x1 ;
    /*17a0*/ @!P1 IADD3 R12, R13, RZ, RZ ;
    /*17b0*/ IMAD.U32 R13, RZ, RZ, UR18 ;
    /*17c0*/ ISETP.NE.AND P1, PT, R30, UR8, PT ;
    /*17d0*/ REDUX.SUM.S32 UR19, R12 ;
    /*17e0*/ IMAD.U32 R14, RZ, RZ, UR19 ;
    /*17f0*/ @P1 SEL R14, R13, R22, !P0 ;
    /*1800*/ ISETP.NE.AND P0, PT, RZ, UR7, PT ;
    /*1810*/ IMAD.MOV.U32 R22, RZ, RZ, R14 ;
    /*1820*/ @P0 BRA 0x11a0 ;
"""


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k5_instructions_per_test_from_sass():
    tool = _load("k5_sass_under_test", REPO / "semantic_slam_tpu_torch" / "tools" / "k5_sass.py")
    cs = _load("chip_smoke_under_test", REPO / "chip_smoke.py")
    # the loop [0x20, 0x70]: 6 instructions, 2 fp32 (FFMA, FSETP), for 2 hypotheses x 4 points
    body, hyps = tool.inner_loop(MADE_UP)
    assert len(body) == 6 and hyps == 2 and body[0].startswith("LDS.128")
    assert tool.per_test(MADE_UP, 4)["per_test"] == 2 / 8 + tool.COUNT_OPS
    got = tool.per_test(SM90A_LOOP, 4)
    assert got["loop_instructions"] == 105 and got["hypotheses"] == 2
    assert got["fp_per_test"] == 9 and got["per_test"] == cs.K5_INSTR_PER_TEST == 11
