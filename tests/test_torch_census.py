"""The census of the CUDA screen kernel, the issue-rate probe's plain
version and the machine-code reader that holds the census to the built
kernels (``defuse_tpu_torch/ops/split_dp_census.py``).

The census is pinned per row for every column width C the screen kernel
is compiled for, so a change to ``csrc/split_dp.cu`` that moves the
instruction mix shows here and in ``chip_smoke.py``'s census-vs-SASS
check.  The probe's plain version is held to the closed form of each
mix's chains."""

import numpy as np
import pytest
import torch

from defuse_tpu_torch.ops import split_dp_census as sc

# per-row warp instructions of dp_instance<C, REVERSE> by class
# (alu, dpx, shfl, redux), forward and reversed read
ROWS = {4: ((62, 8, 7, 1), (62, 8, 7, 1)),
        8: ((94, 16, 7, 1), (94, 16, 7, 1)),
        16: ((158, 32, 7, 1), (203, 32, 7, 1)),
        32: ((286, 64, 7, 1), (286, 64, 7, 1))}


@pytest.mark.parametrize("C", sorted(ROWS))
def test_row_census_pinned(C):
    for reverse, want in zip((False, True), ROWS[C]):
        total = sc.row_census(C, reverse)["total"]
        assert tuple(total[k] for k in sc.CLASSES) == want
    # one diagonal, five scan and one carry shuffle; one warp max
    items = sc.row_census(C)["items"]
    assert sum(i.get("shfl", 0) for i in items.values()) == 1 + 5 + 1
    assert items["reduce"]["redux"] == 1
    assert items["vertical"]["dpx"] + items["carry_in"]["dpx"] == 2 * C


@pytest.mark.parametrize("R,C", [(3, 4), (127, 4), (128, 8), (255, 8),
                                 (256, 16), (511, 16), (512, 32),
                                 (1023, 32)])
def test_cols_per_lane(R, C):
    assert sc.cols_per_lane(R) == C
    assert sc.census_screen_ops(R, 64, 50)["cols_per_lane"] == C


def test_census_at_roofline_shape():
    c = sc.census_screen_ops(256, 64, 50)
    fwd, rev = ROWS[16]
    combine_trips = 2  # ceil(51 / 32)
    assert c["rows"] == 100
    assert c["per_candidate"] == {
        "alu": 50 * (fwd[0] + rev[0]) + 5 * combine_trips,
        "dpx": 50 * (fwd[1] + rev[1]), "shfl": 50 * 14, "redux": 101}
    assert c["warp_instructions_per_candidate"] == \
        sum(c["per_candidate"].values())


@pytest.mark.parametrize("read_len", [1, 25, 50, 64])
def test_census_scales_with_read_length(read_len):
    base = sc.census_screen_ops(256, 64, 50)["per_candidate"]
    c = sc.census_screen_ops(256, 64, read_len)["per_candidate"]
    trips = -(-(read_len + 1) // 32)
    for k in ("dpx", "shfl"):
        assert c[k] * 50 == base[k] * read_len
    assert c["redux"] == 2 * read_len + 1
    assert c["alu"] - 5 * trips == (base["alu"] - 10) * read_len // 50


def test_census_clips_rows_to_read_width():
    assert sc.census_screen_ops(256, 64, 100) == \
        {**sc.census_screen_ops(256, 64, 64), "read_len": 100}
    assert sc.census_screen_ops(256, 64, 0)["per_candidate"] == \
        {"alu": 5, "dpx": 0, "shfl": 0, "redux": 1}


def test_census_grows_across_a_column_boundary():
    """R = 255 fits 8 columns a lane, R = 256 needs 16: every row's
    per-column work doubles, the per-row shuffles and reductions stay."""
    narrow = sc.census_screen_ops(255, 64, 50)
    wide = sc.census_screen_ops(256, 64, 50)
    assert (narrow["cols_per_lane"], wide["cols_per_lane"]) == (8, 16)
    assert wide["per_candidate"]["dpx"] == 2 * narrow["per_candidate"]["dpx"]
    assert wide["per_candidate"]["alu"] > 1.5 * narrow["per_candidate"]["alu"]
    for k in ("shfl", "redux"):
        assert wide["per_candidate"][k] == narrow["per_candidate"][k]
    assert sc.census_screen_ops(256, 64, 50) == \
        sc.census_screen_ops(300, 64, 50) | {"R": 256}
    with pytest.raises(ValueError, match="flank width"):
        sc.census_screen_ops(1024, 64, 50)


@pytest.mark.parametrize("mix", sc.MIXES)
def test_mix_census_is_unrolled_steps_plus_control(mix):
    trip = sc.mix_census(mix)
    step = sc.MIX_STEP[mix]
    for k in sc.CLASSES:
        assert trip[k] == sc.UNROLL * step.get(k, 0) + \
            sc.LOOP_CONTROL.get(k, 0)


# --- the probe's plain version -----------------------------------------------

def closed_form(seed: np.ndarray, n: int, mix: str) -> np.ndarray:
    """Each thread's max over its chains after n steps, in closed form.
    Chains start at seed + s; the largest pair starts at seed + (2, 3)."""
    s = seed.astype(np.int64)
    if mix == "alu":    # (a, a+1) -> (a+3m, a+3m+1) after 2m steps
        return s + 3 + (3 * n // 2 if n % 2 == 0 else (3 * n + 1) // 2 - 1)
    if mix == "dpx":    # (a, a+1) -> (a+2n-1, a+2n+1)
        return s + 3 + 2 * n
    lane = np.arange(len(s)) % 32
    if mix == "shfl":   # lane l: max over j <= min(l, n) of seed[l-j]+n-j
        out = np.empty_like(s)
        for t in range(len(s)):
            out[t] = max(s[t - j] + 3 + n - j
                         for j in range(min(lane[t], n) + 1))
        return out
    # redux: every lane takes max(seed + lane) + 3, then +31 a step
    if n == 0:
        return s + 3
    warp_max = (s + lane).reshape(-1, 32).max(axis=1).repeat(32)
    return warp_max + 3 + 31 * (n - 1)


@pytest.mark.parametrize("n", [0, 1, 2, 5, 16])
@pytest.mark.parametrize("mix", sc.MIXES)
def test_probe_plain_matches_closed_form(mix, n):
    seed = np.random.default_rng(n).integers(0, 1 << 20, 64).astype(np.int32)
    got = sc.issue_probe_ref(torch.from_numpy(seed), n, mix)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), closed_form(seed, n, mix))


def test_probe_wrapper_on_cpu_is_plain_and_uncounted():
    sc.reset_launches()
    seed = torch.arange(256, dtype=torch.int32)
    for mix in sc.MIXES:
        torch.testing.assert_close(sc.issue_probe(seed, 32, mix),
                                   sc.issue_probe_ref(seed, 32, mix),
                                   rtol=0, atol=0)
    assert sc.LAUNCHES == {"issue_probe": 0}
    with pytest.raises(ValueError, match="mix"):
        sc.issue_probe(seed, 32, "fma")


def test_probe_and_roofline_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="is_available"):
        sc.issue_peak_probe("cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        sc.screen_roofline("cpu")


# --- the machine-code reader -------------------------------------------------

def sass(name, body):
    """A function in ``cuobjdump -sass``'s layout: an address comment, the
    instruction, its encoding (and a second encoding line)."""
    lines = [f"\t\tFunction : {name}", '\t.headerflags\t@"EF_CUDA_SM90"']
    for i, ins in enumerate(body):
        if ins.endswith(":"):
            lines.append(ins)
            continue
        lines.append(f"        /*{16 * i:04x}*/                   {ins} ;"
                     "    /* 0x000000000000794d */")
        lines.append("                                              "
                     "             /* 0x000fea0003800000 */")
    return "\n".join(lines)


PROBE = "_ZN47_GLOBAL__N__6fa9ba2c_14_issue_probe_cu_45d4067912probe_kernel" \
    "ILi2EEEvPKiiPi"
SCREEN = "_ZN44_GLOBAL__N__02a77418_11_split_dp_cu_bb31729813screen_kernel" \
    "ILi16EEEvPKhPKiS2_S4_iS4_S2_S4_iS4_PiiNS_6ScoresE"


def probe_text():
    # addresses are 16 * index; the loop runs from index 2 to index 7
    return sass(PROBE, [
        "LDC R1, c[0x0][0x28]", "@!P0 BRA 0x90",
        "SHFL.UP PT, R4, R5, 0x1, RZ", "VIADDMNMX R5, R5, 0x1, R4, !PT",
        "UIADD3 UR4, UR4, 0x10, URZ", "LDG.E R6, desc[UR6][R4.64]",
        "ISETP.LE.AND P0, PT, R3, UR4, PT", "@!P0 BRA 0x20",
        "EXIT", "BRA 0x90"])


def test_sass_loops_finds_the_rolled_loop():
    loops = sc.sass_loops(probe_text())[PROBE]
    body = max(loops, key=lambda lp: sum(lp["counts"].values()))
    assert (body["start"], body["end"]) == (0x20, 0x70)
    assert body["counts"] == {"alu": 2, "dpx": 1, "shfl": 1, "redux": 0,
                              "mem": 1, "control": 1}
    assert body["opcodes"]["SHFL"] == 1
    assert sc.probe_loops(probe_text()) == {"shfl": body}


def test_sass_loops_reads_label_targets_and_innermost_loops():
    text = sass(SCREEN, [
        "MOV R2, RZ", ".L_x_0:", "SHFL.UP PT, R4, R5, 0x1, RZ",
        ".L_x_1:", "VIADDMNMX R5, R5, 0x1, R4, !PT",
        "REDUX.MAX.S32 UR4, R5", "ISETP.NE.AND P1, PT, R7, RZ, PT",
        "@P1 BRA `(.L_x_1)", "SHFL.IDX PT, R8, R5, RZ, 0x1f",
        "REDUX.MAX.S32 UR5, R8", "SEL R9, R8, RZ, P2",
        "@P0 BRA `(.L_x_0)", "EXIT"])
    loops = sc.sass_loops(text)[SCREEN]
    assert len(loops) == 1  # the outer loop holds the inner one
    assert loops[0]["counts"]["redux"] == 1
    rows = sc.screen_row_loops(text)
    assert list(rows) == [16] and rows[16] == []  # no shuffle inside


def test_screen_row_loops_per_row_counts():
    text = sass(SCREEN, [
        "MOV R2, RZ", "SHFL.UP PT, R4, R5, 0x1, RZ",
        "VIADDMNMX R5, R5, 0x1, R4, !PT", "REDUX.MAX.S32 UR4, R5",
        "SHFL.UP PT, R4, R5, 0x1, RZ", "VIADDMNMX R5, R5, 0x1, R4, !PT",
        "REDUX.MAX.S32 UR4, R5", "IADD3 R2, R2, 0x2, RZ",
        "ISETP.NE.AND P1, PT, R2, R7, PT", "@P1 BRA 0x10", "EXIT"])
    (row,) = sc.screen_row_loops(text)[16]
    assert row["rows_per_trip"] == 2
    assert row["per_row"] == {"alu": 1.0, "dpx": 1.0, "shfl": 1.0,
                              "redux": 1.0}


@pytest.mark.parametrize("opcode,cls", [
    ("VIADDMNMX", "dpx"), ("SHFL.BFLY", "shfl"), ("REDUX.MAX.S32", "redux"),
    ("ISETP.GE.AND", "alu"), ("IMAD.MOV.U32", "alu"), ("UIADD3", "alu"),
    ("LDS.U8", "mem"), ("STG.E", "mem"), ("BRA", "control"),
    ("BSSY", "control"), ("EXIT", "control"), ("VIMNMX", "alu")])
def test_sass_class(opcode, cls):
    assert sc.sass_class(opcode) == cls


def test_census_mismatches_tolerance():
    census = {"alu": 100, "dpx": 10, "shfl": 7, "redux": 1}
    assert sc.census_mismatches(census, {"alu": 120, "dpx": 8, "shfl": 8,
                                         "redux": 2}) == []
    bad = sc.census_mismatches(census, {"alu": 121, "dpx": 10, "shfl": 7,
                                        "redux": 3})
    assert bad == ["alu: census 100, SASS 121", "redux: census 1, SASS 3"]
