"""The port's SASS loop reader (tools/sass_loops.py) on cuobjdump-style
text: cuobjdump itself runs only where the CUDA toolkit is installed."""
import pytest

from snap_rnaseq_tpu_torch.tools import sass_loops

_LABELS = """
	code for sm_90a
		Function : _Zk1
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe40000000800 */
.L_x_1:
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;
.L_x_2:
        /*0020*/                   LOP3.LUT R3, R2, R4, R5, 0x96, !PT ;
        /*0030*/              @!P0 BRA `(.L_x_2) ;
        /*0040*/               @P1 BRA `(.L_x_1) ;
        /*0050*/                   BRA `(.L_x_3) ;
.L_x_3:
        /*0060*/                   EXIT ;
		Function : _Zk2
        /*0000*/                   ISETP.NE.AND P0, PT, R2, RZ, PT ;
        /*0010*/                   SHF.L.W.U32.HI R5, R4, 0x1, R3 ;
        /*0020*/                   LOP3.LUT R6, R5, R4, RZ, 0xc0, !PT ;
        /*0030*/               @P0 BRA 0x10 ;
        /*0040*/                   EXIT ;
"""


def test_sass_innermost_loops():
    """Labels and raw addresses as branch targets; an outer loop that holds
    another is not innermost; a forward branch is no loop."""
    funcs, labels = sass_loops.parse(_LABELS)
    assert set(funcs) == {"_Zk1", "_Zk2"}
    assert [b - a + 1 for a, b in sass_loops.innermost_loops(
        funcs["_Zk1"], labels["_Zk1"])] == [2]
    loops = sass_loops.innermost_loops(funcs["_Zk2"], labels["_Zk2"])
    assert [b - a + 1 for a, b in loops] == [3]
    assert [op for op, _ in funcs["_Zk2"][loops[0][0]:loops[0][1] + 1]] == [
        "SHF.L.W.U32.HI", "LOP3.LUT", "BRA"]


def test_sass_report_needs_cuobjdump(monkeypatch):
    monkeypatch.setattr(sass_loops, "cuobjdump", lambda: None)
    with pytest.raises(RuntimeError, match="cuobjdump"):
        sass_loops.report("lib.so")
