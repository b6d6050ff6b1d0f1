"""The census of the CUDA screen kernel, the issue-rate probe's plain
version and the machine-code reader that holds the census to the built
kernels (``defuse_tpu_torch/ops/split_dp_census.py``).

The census is pinned per row for a sample of the column counts C the
screen kernel is compiled for, so a change to ``csrc/split_dp.cu`` that moves the
instruction mix shows here and in ``chip_smoke.py``'s census-vs-SASS
check.  The probe's plain version is held to the closed form of each
mix's chains."""

import numpy as np
import pytest
import torch

from defuse_tpu_torch.ops import split_dp_census as sc

# per-row warp instructions of dp_rows<C, LANES> by class (alu, dpx, shfl,
# redux), in a group of 32 lanes and of 16
ROWS = {4: ((25, 13, 6, 0), (24, 13, 5, 0)),
        8: ((33, 27, 6, 0), (32, 27, 5, 0)),
        16: ((49, 55, 6, 0), (48, 55, 5, 0)),
        32: ((81, 111, 6, 0), (80, 111, 5, 0))}


@pytest.mark.parametrize("C", sorted(ROWS))
def test_row_census_pinned(C):
    for lanes, want in zip((32, 16), ROWS[C]):
        total = sc.row_census(C, lanes)["total"]
        assert tuple(total[k] for k in sc.CLASSES) == want
    # five scan shuffles and one carry shuffle (which is also the next
    # row's diagonal); no warp reduction in the row loop
    items = sc.row_census(C)["items"]
    assert sum(i.get("shfl", 0) for i in items.values()) == 5 + 1
    assert all("redux" not in i for i in items.values())
    # three DPX a column (substitution test, recurrence, row min) and the
    # lane min's VIMNMX3 over column pairs
    assert items["vertical"]["dpx"] + items["running"]["dpx"] == 3 * C
    assert items["lane_min"]["dpx"] == (C - 1) // 2
    # the recomputation nvcc adds at a kernel's largest column counts
    assert sc.row_census(16, 32, 16)["total"]["alu"] == \
        sc.row_census(16, 32)["total"]["alu"] + sc.RECOMPUTED[32, 16, 16]


@pytest.mark.parametrize("key", sorted(sc.RECOMPUTED_ROWMAX))
def test_rowmax_row_census_pinned(key):
    """``rowmax_kernel`` runs ``dp_rows`` as the screen does, at the same
    shapes, so its rows count what the screen's count, but for the row
    loops where nvcc recomputes more (read from its SASS)."""
    lanes, cmax, C = key
    for c in range(1, cmax + 1):
        base = sc.row_census(c, lanes)["total"]
        got = sc.row_census(c, lanes, cmax, "rowmax_kernel")["total"]
        extra = sc.RECOMPUTED_ROWMAX.get((lanes, cmax, c), 0)
        assert got == dict(base, alu=base["alu"] + extra)
    assert sc.RECOMPUTED_ROWMAX[key] > 0


def test_census_rowmax_counts_warps_of_pairs():
    """R 256: groups of 16 lanes, two pairs of instances a warp; a warp
    runs its longest read with the columns of its longest flank, and the
    last warp's missing instances count as empty."""
    ref_lens = [200, 100, 50, 0, 175, 175]
    read_lens = [50, 20, 64, 10, 33, 0]
    c = sc.census_rowmax(ref_lens, read_lens, 256, 64)
    assert (c["lanes"], c["warps"]) == (16, 2)
    want = dict.fromkeys(sc.CLASSES, 0)
    for C, n in ((13, 64), (11, 33)):  # ceil(201 / 16), ceil(176 / 16)
        row = sc.row_census(C, 16, 18, "rowmax_kernel")["total"]
        flushes = [sc.flush_census(16)["total"]] * (n // 32) + \
            [sc.flush_census(16, n % 32)["total"]] * (n % 32 > 0)
        for k in sc.CLASSES:
            want[k] += n * row[k] + sum(f[k] for f in flushes)
    assert c["instructions"] == want
    cost = {"alu": 1.0, "dpx": 2.0, "shfl": 2.0, "redux": 6.0}
    assert sc.census_ms(want, cost) == sum(
        want[k] * cost[k] for k in sc.CLASSES) / 1e6


@pytest.mark.parametrize("R,C", [(3, 1), (127, 16), (128, 9), (255, 16),
                                 (256, 17), (511, 16), (512, 17),
                                 (1023, 32)])
def test_cols_per_lane(R, C):
    lanes, cmax = sc.shape_for(R)
    assert sc.cols_per_lane(R, lanes) == C <= cmax
    assert sc.census_screen_ops(R, 64, 50)["cols_per_lane"] == C
    assert sc.census_screen_ops(R, 64, 50)["lanes"] == lanes


@pytest.mark.parametrize("R,shape", [(1, (8, 16)), (127, (8, 16)),
                                     (128, (16, 18)), (287, (16, 18)),
                                     (288, (32, 16)), (511, (32, 16)),
                                     (512, (32, 32)), (1023, (32, 32)),
                                     (1024, (0, 0))])
def test_shape_follows_the_table_width(R, shape):
    assert sc.shape_for(R) == shape


def test_census_at_roofline_shape():
    c = sc.census_screen_ops(256, 64, 50)
    assert (c["lanes"], c["cols_per_lane"], c["candidates_per_warp"]) == \
        (16, 17, 2)
    row = sc.row_census(17, 16, 18)["total"]
    # 50 rows: one full tile of 32 and a rest of 18
    flushes = [sc.flush_census(16, 32)["total"],
               sc.flush_census(16, 18)["total"]]
    combine_trips = 4  # ceil(51 / 16)
    assert c["rows"] == 50
    per_warp = {k: 50 * row[k] + sum(f[k] for f in flushes)
                for k in sc.CLASSES}
    per_warp["alu"] += 5 * combine_trips + 4
    per_warp["shfl"] += 4
    assert c["per_candidate"] == {k: v / 2 for k, v in per_warp.items()}
    assert c["warp_instructions_per_candidate"] == \
        sum(c["per_candidate"].values())


@pytest.mark.parametrize("read_len", [1, 25, 50, 64])
def test_census_scales_with_read_length(read_len):
    c = sc.census_screen_ops(256, 64, read_len)
    row = sc.row_census(17, 16)["total"]
    full, rest = divmod(read_len, 32)
    flush_dpx = full * sc.flush_census(16, 32)["total"]["dpx"] + \
        (sc.flush_census(16, rest)["total"]["dpx"] if rest else 0)
    assert c["per_candidate"]["dpx"] == \
        (read_len * row["dpx"] + flush_dpx) / 2
    assert c["per_candidate"]["shfl"] == (read_len * row["shfl"] + 4) / 2
    assert c["per_candidate"]["redux"] == 0


def test_census_clips_rows_to_read_width():
    assert sc.census_screen_ops(256, 64, 100) == \
        {**sc.census_screen_ops(256, 64, 64), "read_len": 100}
    assert sc.census_screen_ops(256, 64, 0)["per_candidate"] == \
        {"alu": (5 * 1 + 4) / 2, "dpx": 0, "shfl": 4 / 2, "redux": 0}


def test_census_grows_across_a_column_boundary():
    """R = 255 takes 16 columns a lane of its 16 lanes, R = 256 takes 17:
    every row gains one column's work, the per-row shuffles stay; flanks
    shorter than the table take fewer columns."""
    narrow = sc.census_screen_ops(255, 64, 50)
    wide = sc.census_screen_ops(256, 64, 50)
    assert (narrow["cols_per_lane"], wide["cols_per_lane"]) == (16, 17)
    assert wide["per_row"]["dpx"] - narrow["per_row"]["dpx"] == 4
    assert wide["per_row"]["alu"] - narrow["per_row"]["alu"] == 1
    assert wide["per_row"]["shfl"] == narrow["per_row"]["shfl"]
    short = sc.census_screen_ops(256, 64, 50, ref_len=100)
    assert short["cols_per_lane"] == 7
    assert short["per_candidate"]["dpx"] < 0.5 * wide["per_candidate"]["dpx"]
    with pytest.raises(ValueError, match="flank width"):
        sc.census_screen_ops(1024, 64, 50)


def test_screen_bound_counts_cells_from_the_operands():
    ulen1 = np.array([10, 0, 256], np.int32)
    ulen2 = np.array([20, 5, 256], np.int32)
    idx = np.array([0, 0, 1, 2], np.int32)
    lens = torch.tensor([50, 0, 7, 50], dtype=torch.int32)
    cells = sc.screen_cells(ulen1, ulen2, idx, lens)
    assert cells == 50 * (11 + 21) + 0 + 7 * (1 + 6) + 50 * (257 + 257)
    cost = {"alu": 1e-3, "dpx": 2e-3, "shfl": 2e-3, "redux": 5e-3}
    # 5 instructions a cell (3 alu, 2 dpx), 64 cells a warp instruction
    assert sc.screen_bound_ms(cells, cost) == \
        pytest.approx(cells / 64 * (3 * 1e-3 + 2 * 2e-3) / 1e6)
    assert sc.screen_bound_ms(cells, cost, packed=False) == \
        pytest.approx(2 * sc.screen_bound_ms(cells, cost))


@pytest.mark.parametrize("mix", sc.MIXES)
def test_mix_census_is_unrolled_steps_plus_control(mix):
    trip = sc.mix_census(mix)
    step = sc.MIX_STEP[mix]
    for k in sc.CLASSES:
        assert trip[k] == sc.UNROLL * step.get(k, 0) + \
            sc.LOOP_CONTROL.get(k, 0)


# --- the probe's plain version -----------------------------------------------

def simulate16(seed: np.ndarray, n: int, mix: str) -> np.ndarray:
    """The 16x2 mixes chain by chain in Python integers: each int16 half of
    the four packed chains takes the ``alu`` or ``dpx`` step; the thread's
    result is the largest packed chain as an int32."""
    out = np.empty(len(seed), dtype=np.int64)
    for t, start in enumerate(seed.astype(np.int64) & sc.HALF_MASK):
        chains = [[(int(start) + c) & 0xFFFF, (int(start) + c) >> 16]
                  for c in range(sc.STREAMS)]
        for _ in range(n):
            for c in range(0, sc.STREAMS, 2):
                for h in range(2):
                    x, y = chains[c][h], chains[c + 1][h]
                    if mix == "alu16":
                        chains[c][h], chains[c + 1][h] = \
                            max(x, y) + 1, min(x, y) + 2
                    else:
                        chains[c][h], chains[c + 1][h] = \
                            max(x + 1, y), max(y + 2, x)
        out[t] = max((hi << 16) | lo for lo, hi in chains)
    return out


def closed_form(seed: np.ndarray, n: int, mix: str) -> np.ndarray:
    """Each thread's max over its chains after n steps, in closed form.
    Chains start at seed + s; the largest pair starts at seed + (2, 3)."""
    s = seed.astype(np.int64)
    if mix in ("alu16", "dpx16"):
        return simulate16(seed, n, mix)
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
    "ILi16ELi32EEEvPKhPKiS2_S4_iS4_S2_S4_iS4_PiiNS_6ScoresE"


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
    assert loops[0]["counts"]["redux"] == 1 and loops[0]["nested"] == 0
    # every loop: the outer one is counted without the inner one's body
    inner, outer = sorted(sc.sass_loops(text, innermost=False)[SCREEN],
                          key=lambda lp: lp["end"])
    assert inner == loops[0] and outer["nested"] == 1
    assert outer["counts"] == {"alu": 1, "dpx": 0, "shfl": 2, "redux": 1,
                               "mem": 0, "control": 1}
    # no loop here has the six shuffles a row of a 32-lane group needs
    assert sc.row_loops(text) == {(32, 16): {}}


def row_body(C):
    """A row of dp_rows<C, 32> as the reader sees it: three VIADDMNMX a
    column, six shuffles, one more instruction of each other kind."""
    return ["VIADDMNMX.S16x2 R5, R5, 0x60006, R4, PT"] * (3 * C) + \
        ["SHFL.UP PT, R4, R5, 0x1, RZ"] * 6 + \
        ["VIMNMX.S16x2 R6, R5, R4, PT", "LDS R7, [R8]"]


def test_screen_row_loops_per_row_counts():
    # two row loops (C = 2 and C = 1), the first with the tile flush's
    # reduction loop nested inside
    text = sass(SCREEN, [
        "MOV R2, RZ", *row_body(2), "LDS R9, [R10]",
        "VIMNMX3.S16x2 R9, R9, R11, R12, PT", "@P2 BRA 0xf0",
        "ISETP.NE.AND P1, PT, R2, R7, PT", "@P1 BRA 0x10",
        *row_body(1), "@P1 BRA 0x140", "EXIT"])
    rows = sc.row_loops(text)[32, 16]
    assert sorted(rows) == [1, 2]
    assert rows[2]["rows_per_trip"] == 1 and rows[2]["nested"] == 1
    assert rows[2]["per_row"] == {"alu": 2.0, "dpx": 6.0, "shfl": 6.0,
                                  "redux": 0.0}
    assert rows[1]["per_row"] == {"alu": 1.0, "dpx": 3.0, "shfl": 6.0,
                                  "redux": 0.0}


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
