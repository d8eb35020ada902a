"""``srnn_tpu_torch.bench_kernels``' report plumbing on the CPU: the build
jobs of each group (the weightwise, recurrent and k-vector builds off the
default one included), ptxas' report parsed per kernel and per
instantiation, the residency that registers and shared memory admit on an
H100 SM, the SASS digests and census on a hand-written ``cuobjdump -sass``
excerpt, and the local memory of a hand-written PTX excerpt by source
line.  The timing and the kernels themselves run only on the card."""

import pytest

from srnn_tpu_torch import bench_kernels as bk
from srnn_tpu_torch.ops import _build

PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114rnn_sgd_kernelILi3ELi3ELi0ELb1EEEvPKfS2_PfS3_xif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114rnn_sgd_kernelILi3ELi3ELi0ELb1EEEvPKfS2_PfS3_xif
    2224 bytes stack frame, 4000 bytes spill stores, 3860 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114rnn_sgd_kernelILi3ELi3ELi0ELb0EEEvPKfS2_PfS3_xif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114rnn_sgd_kernelILi3ELi3ELi0ELb0EEEvPKfS2_PfS3_xif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 200 registers, used 1 barriers, 524 bytes smem, 400 bytes cmem[0]
"""

SASS = """\
        Function : _ZN12_GLOBAL__N_114rnn_sgd_kernelILi2ELi2ELi0ELb1EEEvPKfS2_PfS3_xif
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FMUL R2, R3, R4 ;
        /*0020*/              @!P0 BRA `(.L_x_7) ;
        /*0030*/                   FADD R2, R2, R5 ;
        /*0040*/                   LDL R6, [R1] ;
        Function : _ZN12_GLOBAL__N_117generation_kernelIN12_GLOBAL__N_17RnnBodyILi2ELi2ELi0EEEfLb0EEEvN4srnn7GenArgsIT0_EENT_6ConstsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FFMA R2, R3, R4, R5 ;
        /*0020*/                   BRA `(.L_x_9) ;
"""


def test_jobs_for_groups():
    rnn = bk.jobs_for(["rnn"])
    assert [n for n, b in rnn if b == _build.DEFAULT] == list(
        bk.GROUPS["rnn"])
    wide = [bk.job_key(n, b) for n, b in rnn if b != _build.DEFAULT]
    assert wide == [f"{src}[w{w}d{d}-linear]" for w, d in bk.RNN_WIDE
                    for src in ("rnn_train", "generation_rnn")]
    ww = bk.jobs_for(["ww"])
    assert [n for n, b in ww if b == _build.DEFAULT] == list(bk.GROUPS["ww"])
    # K1, K2 and K3's two weightwise bodies at each WW_WIDE topology
    assert [bk.job_key(n, b) for n, b in ww if b != _build.DEFAULT] == [
        f"{src}[w{w}d{d}-linear]" for w, d in bk.WW_WIDE
        for src in ("ww_apply", "ww_train", "generation", "generation_bf16")]
    assert bk.WW_WIDE == ((3, 3),)
    assert bk.census_fragment(*ww[-1]) == ""
    # K4 and K3's float32 k-vector body at each KVEC_WIDE topology, average
    # and fft (the fft build with its generated DFT table)
    kvec = bk.jobs_for(["kvec"])
    assert [n for n, b in kvec if b == _build.DEFAULT] == list(
        bk.GROUPS["kvec"])
    assert [bk.job_key(n, b) for n, b in kvec if b != _build.DEFAULT] == [
        f"{src}[{shape}-linear-{kind}]" for shape in ("w3d3k4", "w2d2k6")
        for kind in ("average", "fft")
        for src in ("kvec_train", "generation_kvec")]
    assert [t for t, _ in bk.kvec_wide_topos()] == [
        "w3d3k4avg", "w3d3k4fft", "w2d2k6avg", "w2d2k6fft"]
    assert [topo.num_weights for _, topo in bk.kvec_wide_topos()] == [
        42, 42, 28, 28]
    assert kvec[-1][1].headers and not kvec[-3][1].headers


def test_census_fragment():
    assert bk.census_fragment("rnn_train") == bk.LINEAR
    assert bk.census_fragment("generation_kvec") == bk.KVEC_LINEAR
    wide = dict(bk.jobs_for(["rnn"])[3:4])
    assert bk.census_fragment("rnn_train", wide["rnn_train"]) == ""


def test_ptxas_entries_and_resources(tmp_path):
    ents = bk.ptxas_entries(PTXAS)
    assert sorted(e["regs"] for e in ents.values()) == [200, 255]
    assert sorted(e["spill"] for e in ents.values()) == [0, 7860]
    log = tmp_path / "k.log"
    log.write_text(PTXAS)
    res = bk.linear_resources(log, "Li3ELi3ELi0E", dynamic=72704)
    assert res["registers"] == 255 and res["stack_bytes"] == 2224
    assert res["spill_bytes"] == 7860 and res["smem_bytes"] == 524
    assert res["dynamic_smem_bytes"] == 72704
    # 255 registers: 2 warps a partition; 73 KB a block: 3 blocks by memory
    assert res["warps_per_sm"] == 8
    # per kernel template: one template here, the report over both
    by = bk.resources_by_kernel(log, "Li3ELi3ELi0E", dynamic=72704)
    assert list(by) == ["rnn_sgd_kernel"]
    assert by["rnn_sgd_kernel"]["registers"] == 255
    assert by["rnn_sgd_kernel"]["spill_bytes"] == 7860
    assert by["rnn_sgd_kernel"]["warps_per_sm"] == 8
    # per instantiation: each entry on its own
    ents = bk.resources_by_entry(log, "Li3ELi3ELi0E")
    assert len(ents) == 2
    assert sorted((e["registers"], e["stack_bytes"], e["spill_bytes"])
                  for e in ents.values()) == [(200, 0, 0), (255, 2224, 7860)]


@pytest.mark.parametrize("regs,smem,blocks", [
    (148, 0, 3),        # K5's register path at P = 17: 12 warps
    (168, 0, 3),
    (200, 72704, 2),    # registers bound it: 2 warps a partition
    (128, 111616, 2),   # shared memory bounds it
    (64, 0, 8),
    (32, 0, 16),        # at most 64 warps
])
def test_resident_blocks(regs, smem, blocks):
    assert bk.resident_blocks(regs, smem, 128) == blocks


def test_sass_census_and_digests():
    census = bk.sass_census(SASS)
    assert len(census) == 2   # both linear width-2 / depth-2 kernels
    c = next(c for name, c in census.items() if "rnn_sgd_kernel" in name)
    assert c == {"instructions": 5, "FMUL": 1, "FADD": 1, "FFMA": 0,
                 "MOV": 1, "LDL": 1, "STL": 0}
    by_kernel = bk.sass_digests_by_kernel(SASS)
    assert sorted(by_kernel) == ["generation_kernel", "rnn_sgd_kernel"]
    # branch labels renumbered per kernel, names masked: a kernel's digest
    # does not depend on the library's other kernels or its label numbers
    alone = SASS.split("        Function : _ZN12_GLOBAL__N_117generation")[0]
    assert bk.sass_digests_by_kernel(alone.replace(".L_x_7", ".L_x_1"))[
        "rnn_sgd_kernel"] == by_kernel["rnn_sgd_kernel"]
    assert bk.sass_digest(SASS) != bk.sass_digest(SASS.replace("FADD", "FMUL"))


PTX = """\
	.file	1 "/src/kvec_common.cuh"
	.file	2 "/src/kvec_train.cu"
.entry _ZN12_GLOBAL__N_115kvec_sgd_kernelILi3ELi3ELi4ELi0ELi0ELb1EEEvPKfS2_PfS3_xif(
{
	.local .align 4 .b8 	__local_depot0[168];
	.loc	2 40 5
	ld.global.f32 	%f1, [%rd4];
	.loc	1 441 9
	st.local.f32 	[%rd5+4], %f1;
	st.local.f32 	[%rd5+8], %f1;
	.loc	1 447 26, function_name $L__info_string0, inlined_at 2 51 20
	ld.local.f32 	%f2, [%rd5+4];
}
.entry _ZN12_GLOBAL__N_115kvec_sgd_kernelILi3ELi3ELi4ELi0ELi0ELb0EEEvPKfS2_PfS3_xif(
{
	.loc	2 40 5
	ld.global.f32 	%f1, [%rd4];
}
"""


def test_ptx_locals():
    locs = bk.ptx_locals(PTX)
    # only the entry that uses local memory, its loads and stores by line
    (name, e), = locs.items()
    assert "Lb1E" in name
    assert e == {"depot_bytes": 168, "ld": 1, "st": 2,
                 "lines": {"kvec_common.cuh:441": {"ld": 0, "st": 2},
                           "kvec_common.cuh:447": {"ld": 1, "st": 0}}}


def test_kernel_template():
    assert bk.kernel_template(
        "_ZN12_GLOBAL__N_113ww_sgd_kernelILi2ELi2ELi0EEEvPKf") == \
        "ww_sgd_kernel"
    assert bk.kernel_template("no_kernel_here") == "no_kernel_here"


def test_check_exact_counts_ulps():
    import torch

    a = torch.tensor([1.0, float("nan"), float("inf"), 0.0])
    bk.check_exact("same", a, a.clone())
    b = a.clone()
    b[0] = torch.nextafter(b[0], torch.tensor(2.0))
    assert bk.max_ulps(b, a) == 1
    with pytest.raises(AssertionError):
        bk.check_exact("one ulp", b, a)
    bk.check_exact("one ulp allowed", b, a, ulps=1)
    c = a.clone()
    c[3] = -0.0   # -0 equals +0 by value: 0 ulps
    bk.check_exact("signed zero", c, a)
    with pytest.raises(AssertionError):
        bk.check_exact("nan moved", a.flip(0), a)
