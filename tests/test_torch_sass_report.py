"""posetpu_torch.tools.sass_report's parser on a listing in the form that
``cuobjdump -sass`` prints (no GPU or CUDA toolkit needed)."""

from posetpu_torch.tools import sass_report

LISTING = """
	code for sm_90a
		Function : _Z6kernelPf
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                           /* 0x000fe20000000800 */
        /*0010*/                   ISETP.GE.AND P0, PT, R0, 0x10, PT ;     /* 0x0000001000007c0c */
        /*0020*/               @P0 EXIT ;                                  /* 0x000000000000094d */
        /*0030*/                   STG.E.128 desc[UR4][R2.64], RZ ;        /* 0x000000ff02007986 */
        /*0040*/                   IADD3 R0, R0, 0x1, RZ ;                 /* 0x0000000100007810 */
        /*0050*/               @!P0 BRA 0x30 ;                             /* 0xfffffffc00008947 */
        /*0060*/                   EXIT ;                                  /* 0x000000000000794d */
        /*0070*/                   BRA 0x70;                               /* 0xfffffffc00fc7947 */
		Function : _Z5otherv
        /*0000*/                   EXIT ;                                  /* 0x000000000000794d */
"""


def test_blocks_loops_and_counts():
    out = {e["function"]: e for e in sass_report.summarize(sass_report.parse_sass(LISTING))}
    k = out["_Z6kernelPf"]
    assert k["instructions"] == 8
    assert [(b["start"], b["end"], b["instructions"]) for b in k["blocks"]] == [
        ("0x0000", "0x0020", 3), ("0x0030", "0x0050", 3), ("0x0060", "0x0060", 1),
        ("0x0070", "0x0070", 1),
    ]
    assert k["blocks"][1]["last"] == "@!P0 BRA 0x30"
    # the store loop, and the self-branch that pads the end of the code
    assert k["loops"] == [{"from": "0x0030", "to": "0x0050", "instructions": 3}]
    assert out["_Z5otherv"]["instructions"] == 1


def test_opcode_drops_predicate_and_modifiers():
    assert sass_report._opcode("@!P0 BRA 0x30") == "BRA"
    assert sass_report._opcode("STG.E.128 desc[UR4][R2.64], RZ") == "STG"
    assert sass_report._target("@P1 BRA P2, 0x550") == 0x550
    assert sass_report._target("BSSY B0, 0x500") == 0x500
    assert sass_report._target("STG.E desc[UR4][R2.64], R17") is None
