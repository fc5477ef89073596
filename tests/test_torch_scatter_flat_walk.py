"""The window plan of the flat sorted scatter-max K4
(lmsu_tpu_torch/csrc/scatter_sorted_fwd_flat.cu), emulated in numpy on the
CPU with the constants the wrapper passes to the kernel
(ops/scatter_sorted.py: FLAT_* and flat_geometry).

The emulation cuts each image's sorted points into windows of window_rows
points, gives each block of a persistent launch a contiguous range of the
flattened (image, window) list, and walks a window as the kernel does: each
walker takes a chunk of chunk_rows points, writes the runs that lie wholly
inside its chunk and the empty cells before each run, and leaves the
partial maxima of a chunk's first and last run where they cross the
chunk's edge; the merge step joins those partials within the window,
carries a run that crosses into the block's next window, and leaves the
partials of the runs crossing the block's edges in the workspace; the
second launch joins those. Coverage is checked on the way: every valid
point read once, no invalid point read, every cell written exactly once
(in the walk, the merge or the join). The result must equal
segment_max_plain bit for bit (NaN where it has NaN), f32 and bf16, on
uniform, skewed, all-invalid and window-edge clouds, at grids from one
block to one block a window.

The kernel itself runs only on the card (chip_smoke.py: kernel_flat and
check_sorted_scatter_edges)."""

import numpy as np
import pytest
import torch

from lmsu_tpu_torch.ops import scatter_sorted as ss

torch.set_num_threads(2)


def flat_walk(f, keys, hw, grid, geo):
    """K4's plan run on f [B, N, C] (float32 values) and sorted keys [B, N]:
    returns (out, writes, reads)."""
    B, N, C = f.shape
    W, R, walkers = geo["window_rows"], geo["chunk_rows"], geo["walkers"]
    S = -(-N // W)
    T = B * S
    out = np.full((B, hw, C), 7.0, np.float32)  # never a result: all cells are written
    writes = np.zeros((B, hw), np.int64)
    reads = np.zeros((B, N), np.int64)
    rec = np.full((grid, 2), -2, np.int64)       # -2: not written
    part = np.zeros((grid, 2, C), np.float32)

    def put(b, c, m):
        out[b, c] = m
        writes[b, c] += 1

    def zero_gap(b, lo, hi):
        for c in range(max(lo + 1, 0), min(hi, hw)):
            put(b, c, 0.0)

    for k in range(grid):
        g0, g1 = ss.flat_block_windows(k, T, grid)
        assert g1 > g0
        carry, open_in = None, False
        for gi in range(g0, g1):
            b, wi = divmod(gi, S)
            p = wi * W
            kw = np.full(W, hw, np.int64)
            kw[:min(W, N - p)] = keys[b, p:p + W]
            a = int(keys[b, p - 1]) if wi > 0 else -1
            z = int(keys[b, p + W]) if p + W < N else hw

            def K(r):
                return a if r < 0 else z if r >= W else int(kw[r])

            first, last = gi == g0, gi == g1 - 1
            if first:
                rec[k, 0] = b * hw + a if (a == K(0) and a < hw) else -1

            def row(r):
                assert K(r) < hw
                reads[b, p + r] += 1
                return f[b, p + r]

            hp = [None] * walkers
            tp = [None] * walkers
            # The walk: each walker its chunk of R points.
            for w in range(walkers):
                r0, r1 = w * R, w * R + R
                zero_gap(b, K(r0 - 1), K(r0))
                r = r0
                while r < r1:
                    c = K(r)
                    if c >= hw:
                        break
                    m = np.full(C, -np.inf, np.float32)
                    e = r
                    while e < r1 and K(e) == c:
                        m = np.maximum(m, row(e))
                        e += 1
                    starts = r > r0 or K(r0 - 1) != c
                    ends = e < r1 or K(r1) != c
                    if starts and ends:
                        put(b, c, m)
                    elif starts:
                        tp[w] = m
                    else:
                        hp[w] = m
                    if e < r1:
                        zero_gap(b, c, K(e))
                    r = e
                if r1 == W and p + W >= N:  # the image's last window: cells after its points
                    zero_gap(b, K(W - 1), hw)

            def back(m, c, j):
                """Joins the partials of chunks j, j-1, ... whose first point
                continues the run c; returns (m, reached the window's start)."""
                while j >= 0 and K(j * R - 1) == c:
                    m = np.maximum(m, hp[j])
                    j -= 1
                if j >= 0:
                    return np.maximum(m, tp[j]), False
                return m, True

            # The merge: the run that ends in chunk w and began before it.
            for w in range(walkers):
                r0, r1 = w * R, w * R + R
                c = K(r0)
                if not (K(r0 - 1) == c and c < hw and K(r1) != c):
                    continue
                m, at_start = back(hp[w], c, w - 1)
                if not at_start:
                    put(b, c, m)
                elif first:
                    part[k, 0] = m
                else:
                    m = np.maximum(m, carry)
                    if open_in:
                        part[k, 0] = m
                    else:
                        put(b, c, m)
            # The run that crosses the window's end: carried, or the block's tail.
            L = walkers - 1
            crosses = K(W - 1) == z and z < hw
            open_out, new_carry = False, None
            if crosses:
                if K(L * R - 1) == z:
                    m, at_start = back(hp[L], z, L - 1)
                else:
                    m, at_start = tp[L], False
                if at_start:
                    if not first:
                        m = np.maximum(m, carry)
                    open_out = first or open_in
                if last:
                    part[k, 1] = m
                    if open_out:
                        part[k, 0] = m
                else:
                    new_carry = m
            if last:
                rec[k, 1] = b * hw + z if crosses else -1
            carry, open_in = new_carry, open_out

    assert (rec >= -1).all()
    # The second launch: each chain of blocks joined by the block that owns it.
    for k in range(grid):
        rt = int(rec[k, 1])
        if rt < 0 or rec[k, 0] == rt:
            continue
        m, j = part[k, 1], k + 1
        while True:
            assert rec[j, 0] == rt
            m = np.maximum(m, part[j, 0])
            if rec[j, 1] != rt:
                break
            j += 1
        put(*divmod(rt, hw), m)
    return out, writes, reads


def cloud(rng, B, N, hw, kind, C=8):
    keys = rng.integers(0, hw, (B, N))
    keys[:, -N // 12:] = hw
    if kind == "skewed":  # a long run in one cell, as zero padding gives
        keys[:, -(2 * N) // 5:] = hw // 2 + 5
    elif kind == "all-invalid":
        keys[0] = hw
    elif kind == "no invalid":
        keys = rng.integers(0, hw, (B, N))
    return features(rng, B, N, C), np.sort(keys, axis=1).astype(np.int32)


def features(rng, B, N, C):
    f = np.round(rng.normal(0, 1, (B, N, C)) * 4) / 4
    f[-1] = -np.abs(f[-1]) - 0.25
    return f.astype(np.float32)


def edge_cloud(rng, B, hw, W, span, C=128):
    """Sorted keys with a run of `span` points in cell 100 that starts three
    points before a window's edge (at W - 3) and one in cell 150 that starts
    at a window's first point; the other points spread over the cells
    around them, the last twelfth invalid. Returns (feats, keys, N)."""
    a0 = W - 3
    b0 = -(-(a0 + span + 1) // W) * W
    N = b0 + span + 300
    keys = np.empty((B, N), np.int64)
    for b in range(B):
        keys[b, :a0] = np.sort(rng.integers(0, 100, a0))
        keys[b, a0:a0 + span] = 100
        keys[b, a0 + span:b0] = np.sort(rng.integers(101, 150, b0 - a0 - span))
        keys[b, b0:b0 + span] = 150
        keys[b, b0 + span:] = np.sort(rng.integers(151, hw, N - b0 - span))
    keys[:, -25:] = hw
    return features(rng, B, N, C), keys.astype(np.int32), N


SLOTS = [ss.FLAT_SLOT_BYTES, ss.FLAT_SLOT_BYTES_SMALL]


def check(f, keys, hw, grid, dtype, slot=ss.FLAT_SLOT_BYTES):
    ft = torch.from_numpy(f).to(dtype)
    geo = ss.flat_geometry(f.shape[2], ft.element_size(), slot)
    out, writes, reads = flat_walk(ft.float().numpy(), keys, hw, grid, geo)
    valid = keys < hw
    assert (reads[valid] == 1).all() and (reads[~valid] == 0).all()
    assert (writes == 1).all()
    want = ss.segment_max_plain(ft, torch.from_numpy(keys), hw).float().numpy()
    nan = np.isnan(want)
    assert (np.isnan(out) == nan).all()
    got = torch.from_numpy(out).to(dtype)
    assert torch.equal(got[torch.from_numpy(~nan)],
                       torch.from_numpy(want).to(dtype)[torch.from_numpy(~nan)])


@pytest.mark.parametrize("slot", SLOTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "all-invalid", "no invalid"])
def test_flat_walk_equals_plain(kind, dtype, slot):
    """Uniform, skewed (40% of the points in one cell), an all-invalid image
    and a cloud without invalid points, at C=128 (the main path's width),
    with either stage size, at grids of 1, 7 and 40 blocks and one a
    window."""
    rng = np.random.default_rng(4)
    B, N, hw = 2, 700, 400
    f, keys = cloud(rng, B, N, hw, kind, C=128)
    geo = ss.flat_geometry(128, 4 if dtype == torch.float32 else 2, slot)
    windows = B * -(-N // geo["window_rows"])
    for grid in (1, 7, min(40, windows), windows):
        check(f, keys, hw, grid, dtype, slot)


@pytest.mark.parametrize("slot", SLOTS)
@pytest.mark.parametrize("span", [1, 2, 3, 4, 5, 31, 32, 33, 47, 48, 49, 255, 256, 257, 2000])
def test_flat_walk_runs_at_window_edges(span, slot):
    """Runs of 1 to 2,000 points that start three points before a window's
    edge and at a window's first point: they cross chunk, window and block
    edges, end on them, and span many windows (C=128 f32: windows of 48
    points in chunks of 6, or of 32 in chunks of 4)."""
    rng = np.random.default_rng(span)
    geo = ss.flat_geometry(128, 4, slot)
    f, keys, N = edge_cloud(rng, 2, 300, geo["window_rows"], span)
    windows = 2 * -(-N // geo["window_rows"])
    for grid in (1, 5, min(33, windows), windows):
        check(f, keys, 300, grid, torch.float32, slot)


@pytest.mark.parametrize("slot", SLOTS)
def test_flat_walk_image_ends_on_a_window_edge(slot):
    """No invalid points and N a multiple of the window: the image's last
    window writes the cells after its last point (no sentinel run does)."""
    rng = np.random.default_rng(48)
    W = ss.flat_geometry(128, 4, slot)["window_rows"]
    N = 9 * W
    keys = np.sort(rng.integers(0, 500, (2, N)), axis=1).astype(np.int32)
    keys[1, -W - 5:] = keys[1, -W - 5]  # image 1 ends in a run across its last window edge
    f = features(rng, 2, N, 128)
    for grid in (1, 4, 18):
        check(f, keys, 600, grid, torch.float32, slot)


@pytest.mark.parametrize("C,N", [(40, 4999), (42, 777), (136, 500), (2, 1000), (1, 600)])
def test_flat_walk_other_widths(C, N):
    """Rows that are not 16-byte multiples (narrower vectors, other chunk
    and window lengths), N not a multiple of the window, f32 and bf16."""
    rng = np.random.default_rng(C)
    for dtype in (torch.float32, torch.bfloat16):
        if C == 1 and dtype == torch.float32:
            continue
        f, keys = cloud(rng, 2, N, 257, "uniform", C=C)
        for slot in SLOTS:
            geo = ss.flat_geometry(C, 4 if dtype == torch.float32 else 2, slot)
            windows = 2 * -(-N // geo["window_rows"])
            for grid in (3, windows):
                check(f, keys, 257, grid, dtype, slot)


def test_flat_walk_keeps_nan_in_its_cell():
    """A NaN of either sign makes its cell NaN, and only its cell, also when
    the cell's run crosses chunk, window and block edges."""
    rng = np.random.default_rng(11)
    geo = ss.flat_geometry(128, 4)
    f, keys, N = edge_cloud(rng, 2, 300, geo["window_rows"], 300)
    f[0, 20, 5] = np.nan
    f[1, 900, 3] = -np.nan
    f[0, np.flatnonzero(keys[0] == 100)[-1], 9] = np.nan  # the last point of a long run
    f[1, np.flatnonzero(keys[1] == 150)[0], 0] = -np.float32(np.nan)
    windows = 2 * -(-N // geo["window_rows"])
    for grid in (1, min(9, windows), windows):
        check(f, keys, 300, grid, torch.float32)


def test_flat_geometry_main_path():
    """The windows the main path takes (C=128 student, C=256 teacher), at
    either stage size, and the narrowest row."""
    want = {(128, 4): (16, 32, 8, 6, 48, 4, 32), (128, 2): (16, 16, 16, 6, 96, 4, 64),
            (256, 4): (16, 32, 8, 3, 24, 2, 16), (256, 2): (16, 32, 8, 6, 48, 4, 32),
            (2, 4): (8, 1, 256, 1, 256, 1, 256)}
    for (C, es), (vec, lanes, walkers, chunk, window, chunk_s, window_s) in want.items():
        g = ss.flat_geometry(C, es)
        assert (g["vec"], g["lanes"], g["walkers"], g["chunk_rows"], g["window_rows"]) == (
            vec, lanes, walkers, chunk, window)
        g = ss.flat_geometry(C, es, ss.FLAT_SLOT_BYTES_SMALL)
        assert (g["chunk_rows"], g["window_rows"]) == (chunk_s, window_s)
