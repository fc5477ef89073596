"""The span walk of the sorted scatter-max kernels K1 and K5
(lmsu_tpu_torch/csrc/scatter_sorted_common.cuh), emulated in numpy on the
CPU with the constants the wrappers pass to the kernels
(ops/scatter_sorted.py: WALK_* and walk_geometry).

The emulation cuts the flattened (image, cell) space into block ranges,
walks each range in groups of whole cells of at most cap rows (a window of
cap + 1 keys), takes a cell of more than cap rows as a long span in chunks
of long_rows rows shared by the walkers (K5 zeroes the invalid points'
cell in one chunk, reading nothing), and runs each kernel's arithmetic on
that decomposition: K1 a max per cell (the walkers' running maxima joined
for a long span), K5 integer tie counts and an f32 division g / ties (the
walkers' counts summed for a long span), the invalid points' rows of d
zeroed in the walk. Coverage is checked on the way: every valid point is
read in exactly one step (K5: one counting step, and a long span's rows
once more to write d), every cell written once, every row of d written
once, the invalid ones as zeros. The results must equal segment_max_plain
bit for bit and segment_max_bwd_plain exactly, f32 and bf16.

The kernels themselves run only on the card (chip_smoke.py,
check_sorted_scatter_edges and the kernel phase)."""

import numpy as np
import pytest
import torch

from lmsu_tpu_torch.ops import scatter_sorted as ss

torch.set_num_threads(2)

HW = 4096


@pytest.fixture
def rng():
    return np.random.default_rng(1010)


def _lower_bound(row, value):
    return int(np.searchsorted(row, value, side="left"))


def walk(keys, ncell, cap, grid):
    """The groups of the walk, block by block, as the kernels take them:
    (b, c, p, ncells, L, longc, lo). keys [B, N] sorted, ncell the cells of
    an image, grid the blocks of the persistent launch."""
    B, N = keys.shape
    Q = B * ncell
    groups = []
    for k in range(grid):
        q0, q1 = Q * k // grid, Q * (k + 1) // grid
        if q0 >= q1:
            continue
        b, c = divmod(q0, ncell)
        p = 0 if c == 0 else _lower_bound(keys[b], c)
        q = q0
        while q < q1:
            limit = min(c + (q1 - q), ncell, c + ss.WALK_CELLS)
            window = np.full(cap + 1, ncell, np.int64)
            got = keys[b, p:p + cap + 1]
            window[:len(got)] = got
            kcap = int(window[cap])
            X = min(kcap, limit)
            E = int((window < X).sum())
            if kcap >= limit or E > 0:
                c_next, L, longc = X, E, False
                lo = np.searchsorted(window[:E], np.arange(c, c_next + 1), side="left")
            else:
                c_next, longc = kcap + 1, True
                L = _lower_bound(keys[b], c_next) - p
                lo = np.zeros(c_next - c + 1, np.int64)
                lo[-1] = L
            assert 0 < c_next - c <= ss.WALK_CELLS and (longc or L <= cap)
            groups.append((b, c, p, c_next - c, L, longc, lo))
            p, c, q = p + L, c_next, q + (c_next - c)
            if c == ncell:
                b, c, p = b + 1, 0, 0
    return groups


def chunks(L, cap):
    return [(r0, min(cap, L - r0)) for r0 in range(0, L, cap)]


def walkers_rows(E, walkers):
    """A long-span chunk's rows by walker: walker w takes rows w, w + walkers, ..."""
    return [np.arange(w, E, walkers) for w in range(walkers)]


def _fwd(f, keys, hw, grid, geo):
    B, N, C = f.shape
    cap, lr = geo["cap"], geo["long_rows"]
    out = np.full((B, hw, C), np.nan, np.float32)
    writes = np.zeros((B, hw), np.int64)
    reads = np.zeros((B, N), np.int64)
    for b, c, p, ncells, L, longc, lo in walk(keys, hw, cap, grid):
        n_short = ncells - 1 if longc else ncells
        for j in range(n_short):
            a, z = lo[j], lo[j + 1]
            out[b, c + j] = f[b, p + a:p + z].max(0) if z > a else 0.0
            writes[b, c + j] += 1
        if longc:
            acc = np.full((geo["walkers"], C), -np.inf, np.float32)
            for r0, E in chunks(L, lr):
                reads[b, p + r0:p + r0 + E] += 1
                for w, rows in enumerate(walkers_rows(E, geo["walkers"])):
                    if len(rows):
                        acc[w] = np.maximum(acc[w], f[b, p + r0 + rows].max(0))
            out[b, c + ncells - 1] = acc.max(0)
            writes[b, c + ncells - 1] += 1
        else:
            reads[b, p:p + L] += 1
    return out, writes, reads


def _bwd(f, keys, out, g, hw, grid, geo):
    B, N, C = f.shape
    cap, lr = geo["cap"], geo["long_rows"]
    d = np.full((B, N, C), np.nan, np.float32)
    d_writes = np.zeros((B, N), np.int64)
    counted = np.zeros((B, N), np.int64)
    for b, c, p, ncells, L, longc, lo in walk(keys, hw + 1, cap, grid):
        if not longc:
            for j in range(ncells):
                a, z = p + lo[j], p + lo[j + 1]
                if z == a:
                    continue
                d_writes[b, a:z] += 1
                if c + j == hw:  # the invalid points: zeros, nothing read
                    d[b, a:z] = 0.0
                    continue
                counted[b, a:z] += 1
                win = f[b, a:z] == out[b, c + j]
                ties = win.sum(0).astype(np.float32)
                d[b, a:z] = np.where(win, g[b, c + j] / np.maximum(ties, 1), np.float32(0))
            continue
        cell = c + ncells - 1
        if cell == hw:  # one chunk of zeros
            d[b, p:p + L] = 0.0
            d_writes[b, p:p + L] += 1
            continue
        cnt = np.zeros((geo["walkers"], C), np.int64)
        for r0, E in chunks(L, lr):  # the counting chunks
            counted[b, p + r0:p + r0 + E] += 1
            for w, rows in enumerate(walkers_rows(E, geo["walkers"])):
                cnt[w] += (f[b, p + r0 + rows] == out[b, cell]).sum(0)
        ties = cnt.sum(0).astype(np.float32)
        for r0, E in chunks(L, lr):  # the writing chunks
            rows = slice(p + r0, p + r0 + E)
            d[b, rows] = np.where(f[b, rows] == out[b, cell], g[b, cell] / ties, np.float32(0))
            d_writes[b, rows] += 1
    return d, d_writes, counted


def _cloud(rng, kind, B=2, N=5000, C=128, dtype=torch.float32):
    """Sorted keys [B, N] (hw = invalid) and coarse features (many ties):
    uniform (400 invalid points an image), skewed (2,000 points of every
    image in one cell), an all-invalid image, N = 4,999, and spans of
    exactly cap - 1, cap, cap + 1 rows of either kernel."""
    keys = rng.integers(0, HW, (B, N))
    keys[:, -400:] = HW
    es = torch.empty((), dtype=dtype).element_size()
    if kind == "skewed":
        keys[:, -2000:] = 31 * 64 + 31
    elif kind == "all_invalid":
        keys[0] = HW
    elif kind.startswith("span"):
        caps = [ss.walk_geometry(C, es, k)["cap"] for k in ("fwd", "bwd")]
        spans = [span for cap in caps for span in (cap - 1, cap, cap + 1)]
        cells = 100 + 10 * np.arange(len(spans))
        keys[np.isin(keys, cells)] = HW  # the span cells take no other point
        at = 0
        for cell, span in zip(cells, spans):
            keys[:, at:at + span] = cell
            at += span
    keys = np.sort(keys, axis=1)
    f = np.round(rng.normal(0, 1, (B, N, C)) * 4) / 4
    f[1] = -np.abs(f[1]) - 0.25  # all-negative features
    feats = torch.from_numpy(f.astype(np.float32)).to(dtype)
    return feats, torch.from_numpy(keys.astype(np.int32))


CLOUDS = [("uniform", 5000), ("skewed", 5000), ("all_invalid", 5000), ("uniform", 4999),
          ("span", 5000)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,N", CLOUDS, ids=[f"{k}{n}" for k, n in CLOUDS])
def test_walk_covers_and_equals_plain(rng, kind, N, dtype):
    feats, keys = _cloud(rng, kind, N=N, dtype=dtype)
    B, _, C = feats.shape
    es = feats.element_size()
    f32 = feats.float().numpy()
    k = keys.numpy()
    valid = k < HW
    want = ss.segment_max_plain(feats, keys, HW)
    g = torch.from_numpy(rng.normal(0, 1, (B, HW, C)).astype(np.float32)).to(dtype)
    want_d = ss.segment_max_bwd_plain(feats, keys, want, g, HW)
    for grid in (1, 7, 264):
        geo = ss.walk_geometry(C, es, "fwd")
        out, writes, reads = _fwd(f32, k, HW, grid, geo)
        assert (writes == 1).all()  # every cell written once
        assert (reads[valid] == 1).all() and (reads[~valid] == 0).all()
        assert torch.equal(torch.from_numpy(out).to(dtype), want)
        geo = ss.walk_geometry(C, es, "bwd")
        d, d_writes, counted = _bwd(f32, k, want.float().numpy(), g.float().numpy(), HW, grid,
                                    geo)
        assert (d_writes == 1).all()  # every row of d once, invalid rows as zeros
        assert (counted[valid] == 1).all() and (counted[~valid] == 0).all()
        assert (d[~valid] == 0).all()
        assert torch.equal(torch.from_numpy(d).to(dtype), want_d)


def test_walk_takes_long_spans_and_thresholds(rng):
    """The span cloud puts cells of exactly cap - 1, cap and cap + 1 rows at
    a window's start: only the cap + 1 cells are long spans; the skewed
    cloud's 2,000-point cell is one in both kernels."""
    C = 128
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.empty((), dtype=dtype).element_size()
        for name in ("fwd", "bwd"):
            cap = ss.walk_geometry(C, es, name)["cap"]
            _, keys = _cloud(rng, "span", dtype=dtype)
            k = keys.numpy()
            ncell = HW if name == "fwd" else HW + 1
            spans = {L for _, _, _, _, L, longc, _ in walk(k, ncell, cap, 7) if longc}
            assert cap + 1 in spans and cap not in spans and cap - 1 not in spans
            _, keys = _cloud(rng, "skewed", dtype=dtype)
            spans = {L for _, _, _, _, L, longc, _ in walk(keys.numpy(), ncell, cap, 7) if longc}
            assert max(spans) >= 2000


def test_walk_geometry_constants():
    """The constants the wrappers pass, and walk_geometry's reading of them
    at the main path's widths and at widths whose rows are not 16-byte
    multiples (narrower vectors, the same walk)."""
    assert ss.WALK_THREADS == 256 and ss.WALK_CELLS >= 1
    g = ss.walk_geometry(128, 4, "fwd")
    assert (g["vec"], g["lanes"], g["walkers"], g["slices"]) == (16, 32, 8, 1)
    assert g["cap"] == g["long_rows"] == ss.WALK_SLOT_BYTES["fwd"] // 512
    g = ss.walk_geometry(128, 2, "bwd")
    assert (g["vec"], g["lanes"], g["walkers"]) == (16, 16, 16)
    assert g["long_rows"] == 3 * g["cap"] == 3 * ss.WALK_SLOT_BYTES["bwd"] // 256
    g = ss.walk_geometry(256, 4, "bwd")  # K5: slices of 32 vectors
    assert (g["rowvec"], g["slices"], g["lanes"]) == (32, 2, 32)
    assert ss.walk_geometry(42, 4, "fwd")["vec"] == 8
    assert ss.walk_geometry(42, 2, "bwd")["vec"] == 4
    assert ss.walk_geometry(3, 2, "fwd")["vec"] == 2
    g = ss.walk_geometry(2, 4, "fwd")
    assert (g["vec"], g["lanes"], g["walkers"], g["cap"]) == (8, 1, 256, 255)
    g = ss.walk_geometry(1000, 4, "fwd")  # 250 vectors: two slices of 128 and 122
    assert (g["rowvec"], g["slices"], g["cw"]) == (128, 2, 512)
