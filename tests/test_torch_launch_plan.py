"""Launch geometry of the ``bsr_spmbv``, ``fused_gram``, ``block_trisolve``
and ``ecg_tail`` CUDA kernels, on the CPU.

The wrappers take their grid, path and scratch sizes from the pure
functions ``spmbv_plan`` and ``gram_plan``; ``block_trisolve``'s and
``ecg_tail``'s C launchers pick their own geometry, which ``trisolve_plan``
and ``tail_plan`` mirror.  These tests replay each
kernel's loops over the plan in Python (which rows a warp, thread or CTA
visits) and check that every row is visited exactly once, that no CTA or
part is left without work, that the scratch sizes are right, that the
Python constants mirror the CUDA sources, and that the shapes neither path
takes raise in the wrapper before anything is launched.
"""

import importlib
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build

bops = importlib.import_module("repro_torch.kernels.bsr_spmbv.ops")
gops = importlib.import_module("repro_torch.kernels.fused_gram.ops")
tops = importlib.import_module("repro_torch.kernels.block_trisolve.ops")
uops = importlib.import_module("repro_torch.kernels.block_update.ops")

CSRC = Path(_build.CSRC)
F32, F64 = torch.float32, torch.float64


def _strided(starts, stop, step):
    """Every ``start + k·step < stop`` for each of ``starts`` (one loop
    ``for i in range(start, stop, step)`` a start), concatenated."""
    starts = torch.as_tensor(starts, dtype=torch.int64)
    if starts.numel() == 0:
        return starts
    k = torch.arange(max(-(-(stop - int(starts.min())) // step), 0), dtype=torch.int64)
    idx = starts[:, None] + step * k[None, :]
    return idx[idx < stop]


def _once(idx, n) -> bool:
    """``idx`` holds each of 0 … n − 1 exactly once (``sorted(idx) ==
    list(range(n))``), by counting instead of sorting."""
    if idx.numel() != n:
        return False
    return n == 0 or (int(idx.min()) >= 0 and torch.equal(torch.bincount(idx, minlength=n),
                                                           torch.ones(n, dtype=torch.int64)))


def _cuda_constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


# ------------------------------------------------------------------ bsr_spmbv
SPMBV_SHAPES = [
    # (nbr, br, bc, t, n_w): Example 2.1's sequential and width-1 calls, the
    # virtual mesh's stacked call, a short output, tiny and ragged shapes
    (163_840, 8, 8, 8, 1_310_720),
    (163_840, 8, 8, 1, 1_310_720),
    (20_480 * 8, 8, 8, 8, 163_840 * 8),
    (1000, 8, 8, 16, 7993),
    (1, 8, 8, 3, 5),
    (37, 16, 4, 12, 37 * 16),
    (37, 16, 16, 16, 590),
    (50, 4, 8, 5, 200),
    (50, 5, 3, 8, 249),
    (3, 12, 8, 1, 1),
]


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("nbr,br,bc,t,n_w", SPMBV_SHAPES)
@pytest.mark.parametrize("sms", [132, 1])
def test_spmbv_plan_covers_every_output_row_once(nbr, br, bc, t, n_w, dtype, sms):
    plan = bops.spmbv_plan(nbr, br, bc, t, n_w, dtype, sms)
    if plan.path == "mma":
        # one warp per block row; a block row is needed while it holds an
        # output row below n_w
        per_cta, cap = plan.threads // 32, bops._MMA_CTAS_PER_SM
        assert plan.rows == min(nbr, -(-n_w // br))
        assert plan.rows * br >= n_w and (plan.rows - 1) * br < n_w
    else:
        per_cta, cap = plan.threads, bops._FMA_CTAS_PER_SM
        assert plan.rows == n_w
    assert 1 <= plan.grid <= sms * cap
    workers = plan.grid * per_cta
    # the kernel's persistent loop: worker w takes items w, w + workers, ...
    items = _strided(torch.arange(min(workers, plan.rows)), plan.rows, workers)
    visits = torch.bincount(items, minlength=plan.rows)
    assert bool((visits == 1).all())
    assert (plan.grid - 1) * per_cta < max(plan.rows, 1)  # no CTA without work


@pytest.mark.parametrize("br,bc,dtype,aligned,path", [
    (8, 8, F64, True, "mma"), (8, 4, F64, True, "mma"), (8, 16, F64, True, "mma"),
    (16, 4, F64, True, "mma"), (16, 8, F64, True, "mma"), (16, 16, F64, True, "mma"),
    (8, 8, F32, True, "fma"), (16, 16, F32, True, "fma"),
    (4, 8, F64, True, "fma"), (5, 3, F64, True, "fma"), (12, 8, F64, True, "fma"),
    (24, 8, F64, True, "fma"), (8, 12, F64, True, "fma"), (8, 8, F64, False, "fma"),
])
def test_spmbv_plan_path_by_dtype_tile_and_alignment(br, bc, dtype, aligned, path):
    assert bops.spmbv_plan(64, br, bc, 8, 64 * br, dtype, 132, aligned=aligned).path == path
    assert (path == "mma") == (dtype == F64 and br in bops.MMA_BR and bc in bops.MMA_BC and aligned)


@pytest.mark.parametrize("kwargs,error", [
    (dict(t=0), ValueError), (dict(t=33), ValueError), (dict(n_w=8 * 64 + 1), ValueError),
    (dict(n_w=-1), ValueError), (dict(br=0), ValueError), (dict(dtype=torch.float16), TypeError),
    (dict(dtype=torch.int32), TypeError),
])
def test_spmbv_plan_raises_on_what_neither_path_takes(kwargs, error):
    args = dict(nbr=64, br=8, bc=8, t=8, n_w=8 * 64, dtype=F64, sms=132) | kwargs
    with pytest.raises(error):
        bops.spmbv_plan(**args)


def _ell(nbr=4, kmax=3, br=8, bc=8, dtype=F64):
    blocks = torch.zeros(nbr, kmax, br, bc, dtype=dtype)
    return blocks, torch.zeros(nbr, kmax, dtype=torch.int32)


@pytest.mark.parametrize("case,error,match", [
    ("v_1d", ValueError, "rows, t"),
    ("v_dtype", TypeError, "share a dtype"),
    ("idx_int64", TypeError, "int32"),
    ("idx_shape", ValueError, "indices shape"),
    ("not_contiguous", ValueError, "contiguous"),
])
def test_spmbv_wrapper_checks_before_launching(case, error, match):
    blocks, idx = _ell()
    v = torch.zeros(32, 8, dtype=F64)
    if case == "v_1d":
        v = v[:, 0]
    elif case == "v_dtype":
        v = v.float()
    elif case == "idx_int64":
        idx = idx.long()
    elif case == "idx_shape":
        idx = idx[:, :2].contiguous()
    else:
        v = torch.zeros(8, 32, dtype=F64).T
    with pytest.raises(error, match=match):
        bops._bsr_spmbv_cuda(blocks, idx, v, 32)


def test_spmbv_constants_mirror_the_cuda_source():
    assert _cuda_constant("bsr_spmbv.cu", "kMmaWarps") == bops._MMA_WARPS
    assert _cuda_constant("bsr_spmbv.cu", "kFmaThreads") == bops._FMA_THREADS
    src = (CSRC / "bsr_spmbv.cu").read_text()
    assert f"__launch_bounds__(kMmaThreads, {bops._MMA_CTAS_PER_SM})" in src
    for br in bops.MMA_BR:
        assert f"case {br}: return launch_mma_s<{br // 8}>(a);" in src
    for bc in bops.MMA_BC:
        assert f"case {bc}: return launch_mma_nt<MT, {bc // 4}>(a);" in src


# ----------------------------------------------------------------- fused_gram
def _mma_rows(begin, end, t, threads):
    """Rows pass 1's mma loop visits in one CTA (base, then 4-row steps u)."""
    u_steps = 8 if t <= 8 else 4
    warps = threads // 32
    bases = _strided(begin + torch.arange(warps) * 4 * u_steps, end, warps * 4 * u_steps)
    rows = (bases[:, None] + torch.arange(4 * u_steps)[None, :]).flatten()
    return rows[rows < end]


def _fma_rows(begin, end, t, threads, k_rows=4):
    """Rows pass 1's fma loop visits for one tile of one CTA (all groups)."""
    ta = -(-t // 4)
    groups = threads // (3 * ta * ta)
    row0 = _strided(begin + torch.arange(groups), end, k_rows * groups)
    rows = (row0[:, None] + torch.arange(k_rows)[None, :] * groups).flatten()
    return rows[rows < end]


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("ranks", [1, 3, 8])
@pytest.mark.parametrize("t", [1, 3, 8, 12, 16])
@pytest.mark.parametrize("n", [0, 1, 3, 37, 70001])
def test_gram_plan_parts_cover_every_row_once(n, t, ranks, dtype):
    plan = gops.gram_plan(ranks, n, t, dtype, 132)
    assert plan.path == ("mma" if dtype == F64 else "fma")
    assert plan.threads == (gops._MMA_THREADS if dtype == F64 else gops._FMA_THREADS)
    assert plan.rows_per_part % gops.rows_per_step(t, plan.path) == 0
    assert plan.parts >= 1
    if n:
        assert (plan.parts - 1) * plan.rows_per_part < n <= plan.parts * plan.rows_per_part  # none empty
    walk = _mma_rows if plan.path == "mma" else _fma_rows
    visited = torch.cat([walk(begin, min(n, begin + plan.rows_per_part), t, plan.threads)
                         for begin in range(0, plan.parts * plan.rows_per_part, plan.rows_per_part)])
    assert torch.equal(torch.sort(visited).values, torch.arange(n))
    assert plan.partials == ranks * 3 * t * t * plan.parts


@pytest.mark.parametrize("sms", [1, 114, 132])
@pytest.mark.parametrize("ranks,n,t", [(1, 1_310_720, 8), (8, 163_840, 8), (1, 1_310_720, 1),
                                       (1, 1_310_720, 16), (8, 163_840, 16)])
def test_gram_plan_fills_the_card_at_the_main_path_shapes(sms, ranks, n, t):
    for dtype in (F32, F64):
        plan = gops.gram_plan(ranks, n, t, dtype, sms)
        per_rank = -(-sms * gops._CTAS_PER_SM // ranks)
        assert plan.parts <= per_rank
        # rounding each part up to whole loop rounds leaves at most one
        # round per part unused
        step = gops.rows_per_step(t, plan.path)
        assert plan.parts * plan.rows_per_part < n + plan.parts * step
        assert plan.partials * 8 < 64 * 2**20  # float64 scratch stays small


@pytest.mark.parametrize("kwargs,error", [
    (dict(t=0), ValueError), (dict(t=33), ValueError), (dict(ranks=0), ValueError),
    (dict(n=-1), ValueError), (dict(dtype=torch.float16), TypeError),
])
def test_gram_plan_raises_on_what_the_kernel_does_not_take(kwargs, error):
    args = dict(ranks=1, n=100, t=8, dtype=F64, sms=132) | kwargs
    with pytest.raises(error):
        gops.gram_plan(**args)


@pytest.mark.parametrize("case,error,match", [
    ("shape", ValueError, "share one"),
    ("dim", ValueError, "share one"),
    ("dtype", TypeError, "share a dtype"),
    ("not_contiguous", ValueError, "contiguous"),
])
def test_gram_wrapper_checks_before_launching(case, error, match):
    ops = [torch.zeros(40, 4, dtype=F64) for _ in range(4)]
    if case == "shape":
        ops[2] = torch.zeros(41, 4, dtype=F64)
    elif case == "dim":
        ops = [o[None, None] for o in ops]
    elif case == "dtype":
        ops[3] = ops[3].float()
    else:
        ops[1] = torch.zeros(4, 40, dtype=F64).T
    with pytest.raises(error, match=match):
        gops._fused_gram_cuda(*ops)


def test_gram_constants_mirror_the_cuda_source():
    assert 32 * _cuda_constant("fused_gram.cu", "kMmaWarps") == gops._MMA_THREADS
    assert _cuda_constant("fused_gram.cu", "kFmaThreads") == gops._FMA_THREADS
    assert _cuda_constant("fused_gram.cu", "kRows") == gops._FMA_ROWS
    assert "constexpr int U = MT < 4 ? 8 / MT : 1;" in (CSRC / "fused_gram.cu").read_text()


# ------------------------------------------------------------- block_trisolve
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("t", [1, 8, 16])
@pytest.mark.parametrize("bs", [1, 8, 16, 32, 64])
def test_trisolve_plan_fits_shared_memory_and_covers_every_block_once(bs, t, dtype):
    es = 8 if dtype == F64 else 4
    vec = 16 // es
    for nb in (1, 7, 300, 1_310_720 // bs):
        plan = tops.trisolve_plan(nb, bs, t, dtype, 132)
        # every row of a block has a lane: one row a lane up to 32, two above
        assert plan.seg in (8, 16, 32) and plan.per_warp * plan.seg == 32
        assert plan.rows == (2 if bs > 32 else 1) and bs <= plan.rows * plan.seg
        assert plan.seg == 8 or plan.seg // 2 < bs
        assert plan.cols in (1, 2, 4, 8, 16) and t <= plan.cols < 2 * t
        # 16-byte rows whose length in 16-byte units is odd; the forward
        # pass reads up to bs rounded up to vec
        assert plan.ls % vec == 0 and (plan.ls // vec) % 2 == 1 and plan.ls >= -(-bs // vec) * vec
        assert plan.tp >= bs * plan.ls and plan.tp % vec == 0
        assert plan.per_warp == 1 or plan.tp % 32 == plan.seg
        # two stages a warp, each the task's tiles, and a reciprocal for
        # each row of the task (and for the forward steps past bs)
        assert plan.stage == plan.per_warp * plan.tp
        assert (plan.per_warp - 1) * bs + -(-bs // vec) * vec <= tops._RECIP
        assert plan.warp_smem == (2 * plan.stage + tops._RECIP) * es
        # one-warp CTAs: a warp's stages within a CTA's 227 KB, the warps
        # of an SM (1 KB each for the system) within its 228 KB
        assert plan.warp_smem <= 227 * 1024
        assert plan.smem == plan.warps * (plan.warp_smem + 1024) <= 228 * 1024
        assert 1 <= plan.warps <= (16 if plan.rows == 1 else 8)
        assert plan.grid == min(132 * plan.warps, plan.tasks)  # no CTA without work
        # the kernel's walk: CTA w takes tasks w, w + grid, ..., each task
        # per_warp consecutive blocks
        tasks = _strided(torch.arange(plan.grid), plan.tasks, plan.grid)
        blocks = (tasks[:, None] * plan.per_warp + torch.arange(plan.per_warp)[None, :]).flatten()
        visits = torch.bincount(blocks, minlength=plan.tasks * plan.per_warp)
        assert bool((visits[:nb] == 1).all())


def test_trisolve_plan_at_the_block_jacobi_shapes():
    # bs = 16 (the profiled cells): two blocks a warp, 16 warps; bs = 32
    # (the default block): one block a warp, 12 warps; bs = 64: two rows a
    # lane, 3 warps (two stages of 33 KB each)
    p16 = tops.trisolve_plan(81_920, 16, 8, F64, 132)
    p32 = tops.trisolve_plan(40_960, 32, 8, F64, 132)
    p64 = tops.trisolve_plan(20_480, 64, 8, F64, 132)
    assert (p16.rows, p16.seg, p16.per_warp, p16.warps, p16.grid) == (1, 16, 2, 16, 16 * 132)
    assert (p32.rows, p32.seg, p32.per_warp, p32.warps, p32.grid) == (1, 32, 1, 12, 12 * 132)
    assert (p64.rows, p64.seg, p64.per_warp, p64.warps, p64.grid) == (2, 32, 1, 3, 3 * 132)
    assert (p16.ls, p32.ls, p64.ls, p16.tp) == (18, 34, 66, 304)


def _banks(words, width, lanes):
    """Bank conflicts of one shared-memory read: the lanes' 4-byte word
    addresses (None for a lane that reads nothing), ``width`` consecutive
    words each, served ``lanes`` lanes to a 128-byte wavefront.  Returns
    the largest number of distinct addresses that meet on one bank in a
    wavefront."""
    worst = 1
    for w0 in range(0, len(words), lanes):
        seen = {}
        for a in words[w0:w0 + lanes]:
            if a is None:
                continue
            for k in range(width):
                seen.setdefault((a + k) % 32, set()).add(a + k)
        worst = max([worst, *(len(v) for v in seen.values())])
    return worst


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("bs", [5, 8, 13, 16, 32, 48, 64])
def test_trisolve_factor_reads_meet_no_bank_conflict(bs, dtype):
    """Replay the kernel's reads of the staged factors: forward, lane j of a
    block reads L[j, i .. i + vec - 1] as one 16-byte vector (a column
    strip of the tile, rows of ``ls``); backward, L[i, j] (a row); the
    tiles of a warp's blocks lie ``tp`` apart.  No two lanes of a wavefront
    meet on a bank, in either pass and at every step."""
    plan = tops.trisolve_plan(1000, bs, 8, dtype, 132)
    width = 2 if dtype == F64 else 1  # 4-byte words per element
    vec = 16 // (4 * width)
    for h in range(plan.rows):
        for i in range(bs):
            fwd, bwd = [], []
            for lane in range(32):
                b, r = divmod(lane, plan.seg)
                row = r + 32 * h
                ra = min(row, bs - 1)  # the kernel clamps a lane's row into the tile
                fwd.append(width * (b * plan.tp + ra * plan.ls + i // vec * vec))
                bwd.append(width * (b * plan.tp + i * plan.ls + ra) if row < bs else None)
            assert _banks(fwd, 4, 8) == 1, (h, i, fwd)
            assert _banks(bwd, width, 32 // width) == 1, (h, i, bwd)


@pytest.mark.parametrize("kwargs,error", [
    (dict(bs=0), ValueError), (dict(bs=65), ValueError), (dict(t=0), ValueError),
    (dict(t=33), ValueError), (dict(dtype=torch.float16), TypeError),
])
def test_trisolve_plan_raises_on_what_the_kernel_does_not_take(kwargs, error):
    args = dict(nb=100, bs=16, t=8, dtype=F64, sms=132) | kwargs
    with pytest.raises(error):
        tops.trisolve_plan(**args)


def test_trisolve_constants_mirror_the_cuda_source():
    src = (CSRC / "block_trisolve.cu").read_text()
    assert _cuda_constant("block_trisolve.cu", "kSmemSm") == tops._SMEM_SM
    assert _cuda_constant("block_trisolve.cu", "kSmemCta") == tops._SMEM_CTA
    assert "constexpr int max_warps(int rows) { return rows == 1 ? 16 : 8; }" in src
    assert all(tops._max_warps(r) == (16 if r == 1 else 8) for r in (1, 2))
    assert "p.seg = bs <= 8 ? 8 : bs <= 16 ? 16 : 32;" in src
    assert "p.cols = t <= 1 ? 1 : t <= 2 ? 2 : t <= 4 ? 4 : t <= 8 ? 8 : 16;" in src
    assert "p.ls = vec * (((bs + vec - 1) / vec) | 1);" in src
    assert "if (p.per_warp > 1) p.tp += ((p.seg - p.tp) % 32 + 32) % 32;" in src
    assert "p.stage = p.per_warp * p.tp;" in src
    assert _cuda_constant("block_trisolve.cu", "kRecip") == tops._RECIP
    assert "p.warp_smem = (2 * p.stage + kRecip) * static_cast<int>(sizeof(T));" in src
    assert "__launch_bounds__(32, max_warps(R))" in src
    assert "p.warps = std::max(1, std::min(max_warps(p.rows), kSmemSm / (p.warp_smem + kSmemCta)));" in src


# ------------------------------------------------------------------ ecg_tail
def _tail_items(plan, n, grid):
    """What the kernel of ``plan`` writes over n rows with ``grid`` CTAs, in
    the order its loops visit it: rows (the mma kernel writes a row's t
    columns together) or, for the element kernel, elements."""
    if plan.path == "element":
        # one thread an element: CTA b takes the runs of ``threads``
        # elements b, b + grid, ...
        runs = _strided(torch.arange(grid), -(-n * plan.t // plan.threads), grid)
        e = (runs[:, None] * plan.threads + torch.arange(plan.threads)[None, :]).flatten()
        return e[e < n * plan.t]
    # the mma kernel: CTA b takes tiles b, b + grid, ...; warp w of a tile
    # its m-tiles w, w + warps, ... (those that start at or past n it
    # skips); lane row g of an m-tile writes row row0 + 8·mt + g where that
    # is below n
    warps = plan.threads // 32
    offs = torch.tensor([8 * mt + g for w in range(warps) for mt in range(w, plan.rows // 8, warps)
                         for g in range(8)])
    tiles = _strided(torch.arange(grid), -(-n // plan.rows), grid)
    rows = (tiles[:, None] * plan.rows + offs[None]).flatten()
    return rows[rows < n]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("t", range(1, 33))
def test_tail_plan_mirrors_the_launcher_and_covers_every_row_once(t, dtype, aligned):
    plan = uops.tail_plan(t, dtype, aligned, 132)
    es = 8 if dtype == F64 else 4
    want = "mma" if dtype == F64 and t >= _cuda_constant("ecg_tail.cu", "kMmaMinT") else "element"
    assert plan.path == want and plan.t == t
    if plan.path == "mma":
        ks, nt = -(-t // 4), -(-t // 8)
        # staged rows: every k-step's column inside, 4 bank pairs apart
        assert plan.ls == uops.tail_ls(t) and plan.ls >= 4 * ks and plan.ls % 8 == 4
        assert plan.copy_bytes == (16 if aligned and t % 2 == 0 else 8)
        assert plan.rows % 8 == 0 and plan.threads == 32 * uops._MMA_WARPS
        assert plan.smem_bytes == (3 * ks * nt * 32 + plan.stages * 3 * plan.rows * plan.ls) * es
    else:
        assert plan.copy_bytes == plan.rows == plan.stages == plan.ls == 0 and plan.threads == 256
    assert plan.smem_bytes <= 227 * 1024 and plan.opt_in == (plan.smem_bytes > 48 * 1024)
    for n in (1, 37, 530, 70001):
        items = n * plan.t if plan.path == "element" else n
        per_cta = plan.threads if plan.path == "element" else plan.rows
        # the runtime's CTAs an SM (shared memory and registers) set the
        # mma kernel's wave; every grid covers the rows
        for per_sm in (1, 3, 8):
            grid = plan.grid(n, per_sm)
            assert 1 <= grid and (grid - 1) * per_cta < items  # no CTA without work
            for g in sorted({grid, 1, min(grid, 3)}):
                assert _once(_tail_items(plan, n, g), items), (n, g)
    with pytest.raises(ValueError, match="1 <= t <= 32"):
        uops.tail_plan(33, dtype, aligned)


def test_tail_constants_mirror_the_cuda_source():
    src = (CSRC / "ecg_tail.cu").read_text()
    assert _cuda_constant("ecg_tail.cu", "kMmaMinT") == uops._MMA_MIN_T
    assert _cuda_constant("ecg_tail.cu", "kTileRows") == uops._TILE_ROWS
    assert _cuda_constant("ecg_tail.cu", "kStages") == uops._STAGES
    assert _cuda_constant("ecg_tail.cu", "kMmaWarps") == uops._MMA_WARPS
    assert "return (t + 3) / 8 * 8 + 4;" in src and "static constexpr int kStage = 3 * kMat;" in src
    assert ("(3 * static_cast<size_t>(kFrag) + kStages * static_cast<size_t>(kStage)) * "
            "sizeof(double);") in src
    # at the widths the solves run: the main path (one thread an element),
    # Fig 3.2's t = 12, the width-16 pack, t = 20 and the width-32 pack
    plans = {t: uops.tail_plan(t, F64) for t in (8, 12, 16, 20, 32)}
    assert [p.path for p in plans.values()] == ["element"] + ["mma"] * 4
    assert [p.smem_bytes for p in plans.values()][1:] == [41_472, 67_584, 72_960, 135_168]
    assert [p.opt_in for p in plans.values()] == [False, False, True, True, True]


def _kernel_variants():
    spec = importlib.util.spec_from_file_location("kernel_variants", CSRC.parents[3] / "tools" / "kernel_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(_kernel_variants().VARIANTS))
def test_kernel_variants_patch_the_sources_as_they_stand(name):
    # each variant is text substituted into today's sources: a substitution
    # whose text is gone would raise on the card, after the build
    kv = _kernel_variants()
    changed = kv.variant_sources(name)
    assert set(changed) <= {f.name for f in CSRC.glob("*.cu")}
    assert (name == "base") == (not changed)
    for fname, text in changed.items():
        assert text != (CSRC / fname).read_text()


# ---------------------------------------------------------------- the build
@pytest.mark.parametrize("name", ["bsr_spmbv", "fused_gram", "halo_pack", "halo_unpack",
                                  "block_trisolve", "chol_apply", "rank_apply", "drop_mask",
                                  "ecg_tail", "block_update"])
def test_ctypes_signature_matches_the_c_entry_point(name):
    src = (CSRC / f"{_build.SOURCES[name]}.cu").read_text()
    for suffix in ("f32", "f64"):
        m = re.search(rf"REPRO_EXPORT int {name}_{suffix}\(([^)]*)\)", src)
        assert m, f"{name}_{suffix} not exported"
        params = [p.strip() for p in m.group(1).split(",")]
        kinds = [_build._P if "*" in p else _build._L if "long long" in p
                 else _build._D if p.startswith("double") else _build._I for p in params]
        assert kinds == _build.SIGNATURES[name]


def test_parse_ptxas_reads_registers_shared_memory_and_spills():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'
ptxas info    : Function properties for _Z1av
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 114 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    16 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 6144 bytes smem, 400 bytes cmem[0]
"""
    assert _build.parse_ptxas(log, "x") == [
        {"source": "x", "kernel": "_Z1av", "spill_stores": 0, "spill_loads": 0,
         "registers": 114, "smem_bytes": 0},
        {"source": "x", "kernel": "_Z1bv", "spill_stores": 16, "spill_loads": 12,
         "registers": 128, "smem_bytes": 6144},
    ]
    assert "-Xptxas" in _build.NVCC_FLAGS
