"""posetpu_torch.tools.sass_report's parser and path count on a listing in
the form that ``cuobjdump -sass`` prints, and its default sources (no GPU or
CUDA toolkit needed)."""

import json
import os
import types
from collections import Counter

import pytest

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


def test_default_sources_are_every_kernel_of_the_port():
    """With no arguments the report covers every CUDA library of the port:
    the rasterizer, the conv bias, the fused norm and ReLU and the decode
    route's idct_islow and ycc_canvas kernels (nothing is built to answer
    this)."""
    sources = sass_report.parser().parse_args([]).sources
    assert sorted(os.path.basename(s) for s in sources) == ["bn_relu.cu", "conv_bias.cu",
                                                             "idct_islow.cu", "rasterize.cu",
                                                             "ycc_canvas.cu"]
    assert all(os.path.isfile(s) for s in sources)


def test_path_length_follows_the_branches_it_is_told():
    k = sass_report.parse_sass(LISTING)["_Z6kernelPf"]
    # the predicated EXIT and the loop's branch fall through: 7 instructions
    assert sass_report.path_length(k, 0x0, 0x60) == 7
    assert sass_report.path_length(k, 0x30, 0x60) == 4
    with pytest.raises(ValueError, match="loops"):
        sass_report.path_length(k, 0x0, 0x60, taken={0x50})
    with pytest.raises(ValueError, match="no instruction"):
        sass_report.path_length(k, 0x0, 0x64)
    # an unconditional branch is followed whatever it is told
    loop = [(0x0, "IADD3 R0, R0, 0x1, RZ"), (0x10, "BRA 0x30"), (0x20, "EXIT"),
            (0x30, "BRA.DIV UR4, 0x20"), (0x40, "@P0 BRA 0x0"), (0x50, "EXIT")]
    assert sass_report.path_length(loop, 0x0, 0x50) == 5
    with pytest.raises(ValueError, match="exits"):
        sass_report.path_length(loop, 0x0, 0x50, taken={0x30})


def test_path_lists_the_issued_instructions_by_opcode(capsys, monkeypatch, tmp_path):
    """``--path`` prints the path's instructions in all and by opcode
    (the build and ``cuobjdump`` stood in for by the test's listing)."""
    k = sass_report.parse_sass(LISTING)["_Z6kernelPf"]
    issued = sass_report.path(k, 0x0, 0x60)
    assert len(issued) == sass_report.path_length(k, 0x0, 0x60) == 7
    src = str(tmp_path / "k.cu")
    monkeypatch.setattr(sass_report.cuda_build, "build", lambda sources: {src: "k.so"})
    monkeypatch.setattr(sass_report, "_cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(sass_report.subprocess, "run",
                        lambda *a, **kw: types.SimpleNamespace(stdout=LISTING))
    sass_report.main([src, "--path", "0", "60"])
    entry = json.loads(capsys.readouterr().out.splitlines()[0])
    opcodes = entry["path"]["opcodes"]
    assert entry["path"]["instructions"] == 7 == sum(opcodes.values())
    assert opcodes == dict(Counter(sass_report._opcode(i) for i in issued))
