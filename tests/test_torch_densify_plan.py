"""The densify layer's launch plans on the CPU: G3's bands and chunks
(``ops/cuda/densify.densify_plan``) and G5's bin sort and cell tiles
(``ops/cuda/fb_merge.merge_plan``).

The kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Here the plans are held to what the kernels assume:
G3's CTAs cover every output pixel once, stage every cost value from one
band (the chunks' halo columns aside, within the stated share) and fit a
CTA's shared memory; a numpy replay of G3's index arithmetic, CTA by
CTA, equals the plain densify bit for bit.  G5's chunked radix sort
(``bin_sort_model``) is a stable sort by bin, its scratch is what the
wrapper allocates, and a replay of its cell pass (tiles of 2 x 2 bins,
candidates in patch order, windows of patch indices) equals the plain
merge bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch.ops import densify as pdensify
from flowonthego_tpu_torch.ops.cuda import densify as g3
from flowonthego_tpu_torch.ops.cuda import fb_merge as g5
from flowonthego_tpu_torch.ops.dis import PatchState
from flowonthego_tpu_torch.ops.patches import PatchGrid

from test_torch_merge_solve import _merge_state

torch.set_num_threads(1)

F32 = np.float32
CTA_SHARED = 227 * 1024


# ---------------------------------------------------------------- G3

def _levels():
    """(op, h, w): every scale of every operating point at 1024x448, and
    the finest scale of 1024x448, 1920x1080 and 3840x2176 frames."""
    out = []
    for op in (1, 2, 3, 4):
        cfg = port.operating_point(op, width=1024)
        out += [(op, 448 >> s, 1024 >> s)
                for s in range(cfg.finest_scale, cfg.coarsest_scale + 1)]
        out += [(op, 448, 1024), (op, 1080, 1920), (op, 2176, 3840)]
    return sorted(set(out))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("op,h,w", _levels())
def test_densify_plan_covers_and_stages_once(op, h, w, B):
    """Each output pixel lies in exactly one CTA's (band, chunk); each cost
    value whose pixel lands in the frame is staged by exactly one band;
    a patch column is staged by at most 1 + ceil((r - 1) / nc) chunks
    and the halo reads are at most (r - 1) / nc of the columns' reads;
    a CTA's shared memory is within the card's 227 KB and is what the
    kernel computes from the plan; a small level's launch takes chunks
    of a column or two, so that it has more CTAs (B frames add B along
    its third axis)."""
    grid = PatchGrid.create(port.operating_point(op), w, h)
    plan = g3.densify_plan(grid, B)
    ps, st, r, nc = grid.patch_size, grid.steps, plan.r, plan.nc
    assert plan.n_bands <= 65535 and 1 <= nc <= g3.MAX_CHUNK
    assert plan.shared_bytes == (nc + r - 1) * r * st * r * st * 12
    assert plan.shared_bytes <= CTA_SHARED
    if B * plan.n_bands * plan.n_chunks < g3.MIN_CTAS / 2:
        assert plan.nc <= 2      # a small level: narrow chunks, more CTAs

    # output rows and columns: each in one band, one chunk
    bands = plan.yq0 + np.arange(plan.n_bands)
    rows = (bands[:, None] * st + np.arange(st)[None, :]).ravel() + plan.oy
    rows = rows[(rows >= 0) & (rows < h)]
    assert np.array_equal(np.sort(rows), np.arange(h))
    firsts = plan.xq0 + nc * np.arange(plan.n_chunks)
    cols = (firsts[:, None] * st + np.arange(nc * st)[None, :]).ravel()
    cols = cols + plan.ox
    cols = cols[(cols >= 0) & (cols < w)]
    assert np.array_equal(np.sort(cols), np.arange(w))

    # cost rows: (patch row j, py) is staged by band j + py // st
    j, py = np.meshgrid(np.arange(grid.n_h), np.arange(ps), indexing="ij")
    staged = np.zeros(j.shape, int)
    for Yq in bands:
        for m in range(r):
            staged += (j == Yq - m) & (py >= m * st) & (py < (m + 1) * st)
    lands = (j * st + py + plan.oy >= 0) & (j * st + py + plan.oy < h)
    assert (staged[lands] == 1).all() and (staged <= 1).all()

    # patch columns: chunk c stages [first_c - r + 1, first_c + nc - 1]
    per_col = np.zeros(grid.n_w, int)
    for first in firsts:
        lo, hi = max(0, first - r + 1), min(grid.n_w, first + nc)
        per_col[lo:hi] += 1
    i, px = np.meshgrid(np.arange(grid.n_w), np.arange(ps), indexing="ij")
    used = ((i * st + px + plan.ox >= 0)
            & (i * st + px + plan.ox < w)).any(axis=1)
    assert (per_col[used] >= 1).all()
    assert per_col.max() <= 1 + -(-(r - 1) // nc)
    assert per_col.sum() - used.sum() <= (r - 1) / nc * used.sum() + r


def _densify_replay(state, grid, cfg, merge=None):
    """G3's kernel replayed in numpy, CTA by CTA, with its own index
    arithmetic (slots staged [m][pr][q][column][qc], the fold's reads),
    from the plain version's (w, w*u, w*v) of each patch pixel: every
    slot written once, every output pixel once."""
    B = state.p_cur.shape[0]
    plan = g3.densify_plan(grid, B)
    ps, st, r, nc = grid.patch_size, grid.steps, plan.r, plan.nc
    h, w = grid.height, grid.width
    absw = pdensify._pixel_weights(state, cfg).numpy()
    p = state.p_cur.numpy()
    contrib = np.stack([absw, absw * p[..., 0][..., None, None],
                        absw * p[..., 1][..., None, None]], -1)
    B = p.shape[0]
    out = np.full((B, h, w, 2), np.nan, F32)
    R, nci = r * st, nc + r - 1
    L = st * R
    n_slots = r * nci * L
    s = np.arange(n_slots)
    row, within = s // L, s % L
    pr, px = within // R, within % R
    m, ic = row // nci, row % nci
    q, qc = px // st, px % st
    dst = (((m * st + pr) * r + q) * nci + ic) * st + qc
    assert np.array_equal(np.sort(dst), s)          # a slot once
    W = nc * st
    o = np.arange(st * W)
    opr, xl = o // W, o % W
    xq, oqc = xl // st, xl % st
    per_q = nci * st
    per_m = st * r * per_q
    base = opr * r * per_q + (xq + r - 1) * st + oqc
    for b in range(B):
        for t in range(plan.n_bands):
            Yq = plan.yq0 + t
            for c in range(plan.n_chunks):
                Xq0 = plan.xq0 + c * nc
                jj, ii, pyy = Yq - m, Xq0 - (r - 1) + ic, m * st + pr
                ok = ((jj >= 0) & (jj < grid.n_h) & (ii >= 0)
                      & (ii < grid.n_w) & (pyy < ps) & (px < ps))
                shared = np.zeros((n_slots, 3), F32)
                shared[dst[ok]] = contrib[b, jj[ok], ii[ok], pyy[ok], px[ok]]
                a = None
                for qq in range(r):
                    at = base + qq * (per_q - st)
                    tq = shared[at]
                    for mm in range(1, r):
                        tq = tq + shared[at + mm * per_m]
                    a = tq if a is None else a + tq
                y = Yq * st + opr + plan.oy
                x = Xq0 * st + xl + plan.ox
                inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
                a = a[inside]
                y, x = y[inside], x[inside]
                assert np.isnan(out[b, y, x]).all()       # a pixel once
                if merge is not None:
                    a = a + merge[b, y, x].numpy()
                wgt = a[:, :1]
                with np.errstate(divide="ignore", invalid="ignore"):
                    out[b, y, x] = np.where(wgt > 0, a[:, 1:] / wgt,
                                            F32(0))
    return out


@pytest.mark.parametrize("op,h,w,B,C,merge", [
    (4, 40, 100, 1, 3, False),    # a chunk edge inside the patches' reach
    (4, 23, 83, 2, 1, True),
    (2, 30, 44, 1, 3, True),
    (1, 56, 128, 1, 3, False),    # ps % steps != 0 (8, 5)
    (2, 4, 8, 2, 3, False)])      # densify's borders meet
def test_densify_replay_matches_plain(op, h, w, B, C, merge):
    """The replay of G3's index arithmetic equals ``densify_plain`` bit
    for bit (same weights, same canvas order of adds, zeros included),
    where a chunk ends inside a patch's reach and where ps % steps != 0."""
    rng = np.random.default_rng(op * 100 + w)
    cfg = port.operating_point(op)
    grid = PatchGrid.create(cfg, w, h)
    plan = g3.densify_plan(grid, B)
    if op == 4:     # chunk edges inside the patches' reach
        assert plan.n_chunks >= 2
    ps = grid.patch_size
    lead = (B, grid.n_h, grid.n_w)
    p = torch.as_tensor(rng.standard_normal(lead + (2,)).astype(F32) * 3)
    cost = torch.as_tensor((rng.random(lead + (ps, ps, C)) ** 2 * 50)
                           .astype(F32))
    state = PatchState(p, p, None, None, None, None, None, None, cost, None)
    m = None
    if merge:
        m = torch.as_tensor(np.concatenate(
            [rng.random((B, h, w, 1)), rng.standard_normal((B, h, w, 2))],
            -1).astype(F32))
    want = pdensify.densify_plain(state, grid, cfg, m).numpy()
    got = _densify_replay(state, grid, cfg, m)
    assert np.array_equal(got, want)


def test_densify_plan_chunks_smaller_than_the_columns(monkeypatch):
    """With chunks narrower than the patches' reach (one Xq column a
    chunk at op 4: r = 4 > nc), the replay still equals the plain
    version: every halo column is read by up to r chunks."""
    monkeypatch.setattr(g3, "SHARED_BUDGET", 4 * 1728)
    cfg = port.operating_point(4)
    grid = PatchGrid.create(cfg, 31, 20)
    assert g3.densify_plan(grid).nc == 1
    rng = np.random.default_rng(3)
    lead = (1, grid.n_h, grid.n_w)
    p = torch.as_tensor(rng.standard_normal(lead + (2,)).astype(F32))
    cost = torch.as_tensor(rng.random(lead + (12, 12, 3)).astype(F32))
    state = PatchState(p, p, None, None, None, None, None, None, cost, None)
    assert np.array_equal(_densify_replay(state, grid, cfg),
                          pdensify.densify_plain(state, grid, cfg).numpy())


def test_densify_plan_refuses_what_no_cta_holds():
    """A geometry whose one-column CTA needs more than 227 KB of shared
    memory raises ValueError (before any build)."""
    cfg = dataclasses.replace(port.operating_point(2), patch_size=40,
                              patch_stride=0.95)
    grid = PatchGrid.create(cfg, 64, 64)
    assert grid.steps <= 2
    with pytest.raises(ValueError, match="shared memory"):
        g3.densify_plan(grid)


# ---------------------------------------------------------------- G5

@pytest.mark.parametrize("case", ["scattered", "pile-up", "outside"])
@pytest.mark.parametrize("chunk,passes", [(None, None), (64, None), (7, 2)])
def test_bin_sort_model_is_a_stable_sort(case, chunk, passes):
    """The kernels' chunked LSD radix sort, as ``bin_sort_model`` runs it,
    equals ``torch.sort(bins, stable=True)``: the kernel's chunk and
    passes, smaller chunks (many of them, as at op 4's sizes) and more
    passes than the bins need."""
    rng = np.random.default_rng(11)
    h, w = 56, 128
    cfg, grid, state = _merge_state(rng, case, 1, 3, h, w)
    bins = g5.landing_bins(state.p_cur, state.mid_org, grid.patch_size, h,
                           w)[0]
    plan = g5.merge_plan(1, bins.numel(), grid.patch_size, h, w)
    nb = plan.nbx * plan.nby
    got = g5.bin_sort_model(bins, nb, passes or plan.passes,
                            chunk or g5.SORT_CHUNK)
    assert torch.equal(got, torch.sort(bins, stable=True).indices)
    if case == "outside":
        assert (bins == nb).any()
    if case == "pile-up":
        assert bins.unique().numel() <= 4


@pytest.mark.parametrize("op,h,w,B", [(2, 56, 128, 1), (4, 448, 1024, 1),
                                      (4, 448, 1024, 4), (2, 2176, 3840, 1),
                                      (1, 14, 32, 2)])
def test_merge_plan_scratch_is_the_allocation(monkeypatch, op, h, w, B):
    """The wrapper allocates the plan's scratch, which holds the kernels'
    layout: landing cells (2 P, and 2 P in the sorted order), two key and
    patch buffers (4 P), ranks (P), the (digit, chunk) counts (256
    n_chunks) and the bins' starts (nb + 1) a frame, and 4 P bilinear
    weights, 4 P sorted and 2 P sorted flows; bins of S >= ps cells, the
    sort's passes cover the dropped key nb."""
    grid = PatchGrid.create(port.operating_point(op), w, h)
    P = grid.n_patches
    plan = g5.merge_plan(B, P, grid.patch_size, h, w)
    nb = plan.nbx * plan.nby
    assert plan.S >= grid.patch_size and plan.S <= g5.MAX_TILE
    assert nb < 1 << (g5.DIGIT_BITS * plan.passes)
    assert plan.n_chunks == -(-P // g5.SORT_CHUNK)
    assert plan.n_ints == B * (9 * P + 256 * plan.n_chunks + nb + 1)
    assert plan.n_floats == B * P * 10
    assert (plan.tiles_x, plan.tiles_y) == (-(-w // plan.S), -(-h // plan.S))
    assert plan.warp_cells == (h * w <= g5.WARP_CELLS)
    seen = {}

    def launch(lib, p_cur, mid_org, cost_px, grid_, cfg, out_h, out_w, ints,
               wb, out, stream):
        seen.update(ints=ints, wb=wb, out=out)

    monkeypatch.setattr(g5, "launch", launch)
    monkeypatch.setattr(g5._build, "load_library", lambda: None)
    monkeypatch.setattr(g5._build, "stream_handle", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    lead = (B, grid.n_h, grid.n_w)
    ps = grid.patch_size
    mid = torch.zeros(lead + (2,), device="meta")
    state = PatchState(_OnCard.of(torch.zeros(lead + (2,), device="meta")),
                       None, mid, None, None, None, None, None,
                       torch.zeros(lead + (ps, ps, 3), device="meta"), None)
    g5.launches = 0
    g5.fb_merge(state, grid, port.operating_point(op), h, w)
    assert seen["ints"].numel() == plan.n_ints
    assert seen["ints"].dtype == torch.int32
    assert seen["wb"].numel() == plan.n_floats
    assert tuple(seen["out"].shape) == (B, h, w, 3)
    assert g5.launches == 1
    g5.launches = 0


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _OnCard(torch.Tensor):
    """A tensor that says it lies on the card (the wrapper's checks)."""

    @property
    def is_cuda(self):
        return True

    @classmethod
    def of(cls, x):
        return x.as_subclass(cls)


def _merge_replay(state, grid, cfg, h, w, window, entries=5120):
    """G5's cell pass replayed with its own index arithmetic: each tile of
    S x S cells takes the members of its bin and the next along each axis
    from the sorted order, in patch order (``window`` patch indices at a
    time where they are more than ``window``); each position of the
    tile's reach lists its hits (the candidates that cover it, in patch
    order) with their densify weights, position after position, in a
    buffer of ``entries`` hits (the positions cut into the longest runs
    that fit); each cell folds its corners' lists in order.  The weights
    are the plain version's, so a hit the tile's bins miss, one in the
    wrong order or a weight read from the wrong place shows as a
    difference from the plain merge."""
    ps = grid.patch_size
    B = state.p_cur.shape[0]
    P = grid.n_patches
    absw = pdensify._pixel_weights(state, cfg).reshape(B, P, ps, ps).numpy()
    p = state.p_cur.reshape(B, P, 2).numpy()
    pos = (state.mid_org + state.p_cur).reshape(B, P, 2).numpy()
    frac = pos - np.floor(pos)
    rx, ry = frac[..., 0], frac[..., 1]
    wbil = np.stack([rx * ry, (F32(1) - rx) * ry, rx * (F32(1) - ry),
                     (F32(1) - rx) * (F32(1) - ry)], -1)
    plan = g5.merge_plan(B, P, ps, h, w)
    S, nb = plan.S, plan.nbx * plan.nby
    side = S + 1
    lb = -((ps + 1) // 2)
    bins = g5.landing_bins(state.p_cur, state.mid_org, ps, h, w)
    land = torch.ceil(state.mid_org + state.p_cur + 1e-5).to(torch.int64)
    land = land.reshape(B, P, 2).numpy()
    out = np.full((B, h, w, 3), np.nan, F32)
    for b in range(B):
        order = g5.bin_sort_model(bins[b], nb, plan.passes).numpy()
        starts = np.searchsorted(bins[b].numpy()[order], np.arange(nb + 1))
        for ty in range(plan.tiles_y):
            for tx in range(plan.tiles_x):
                x_lo, x_hi = max(tx * S, 1), min(tx * S + S, w - 2)
                y_lo, y_hi = max(ty * S, 1), min(ty * S + S, h - 2)
                lists = [order[starts[by * plan.nbx + bx]:
                               starts[by * plan.nbx + bx + 1]]
                         for by in (ty, ty + 1) for bx in (tx, tx + 1)
                         if bx < plan.nbx and by < plan.nby]
                cand = np.sort(np.concatenate(lists + [[]]).astype(int))
                if x_lo > x_hi or y_lo > y_hi:
                    cand = cand[:0]
                if len(cand) > window:
                    windows = [cand[(cand >= k0) & (cand < k0 + window)]
                               for k0 in range(0, P, window)]
                else:
                    windows = [cand]
                units = []      # (candidates, first hit of each position,
                for win in windows:     # run's positions, hits, weights)
                    fx, fy = land[b, win, 0] + lb, land[b, win, 1] + lb
                    hits = []
                    for q in range(side * side):
                        X, Y = tx * S + q % side, ty * S + q // side
                        if x_lo <= X <= x_hi and y_lo <= Y <= y_hi:
                            hits.append(np.flatnonzero(
                                (X >= fx) & (X < fx + ps) & (Y >= fy)
                                & (Y < fy + ps)))
                        else:
                            hits.append(np.zeros(0, int))
                    first = np.concatenate(
                        [[0], np.cumsum([len(x) for x in hits])])
                    q0 = 0
                    while len(win) and q0 < side * side:
                        q1 = max(q for q in range(q0 + 1, side * side + 1)
                                 if first[q] - first[q0] <= entries)
                        s_w = np.full(entries, np.nan, F32)
                        s_cand = np.full(entries, -1)
                        for q in range(q0, q1):
                            X, Y = tx * S + q % side, ty * S + q // side
                            for e, m in enumerate(hits[q]):
                                at = first[q] - first[q0] + e
                                s_cand[at] = m
                                s_w[at] = absw[b, win[m], Y - fy[m], X - fx[m]]
                        units.append((win, first - first[q0], q0, q1, s_cand,
                                      s_w))
                        q0 = q1
                for yy in range(ty * S, min(h, ty * S + S)):
                    for xx in range(tx * S, min(w, tx * S + S)):
                        acc = np.zeros(3, F32)
                        for c, (ox, oy) in enumerate(((0, 0), (1, 0), (0, 1),
                                                      (1, 1))):
                            xt, yt = xx + ox, yy + oy
                            if not (1 <= xt <= w - 2 and 1 <= yt <= h - 2):
                                continue
                            q = (yt - ty * S) * side + xt - tx * S
                            for win, first, q0, q1, s_cand, s_w in units:
                                if not q0 <= q < q1:
                                    continue
                                for e in range(first[q], first[q + 1]):
                                    m, wt = s_cand[e], s_w[e]
                                    wc = wbil[b, win[m], c]
                                    u, v = p[b, win[m]]
                                    acc = acc + np.array(
                                        [wc * wt, wc * (-u * wt),
                                         wc * (-v * wt)], F32)
                        out[b, yy, xx] = acc
    return out


@pytest.mark.parametrize("case,B,C,window,entries", [
    ("scattered", 2, 3, 256, 5120), ("scattered", 1, 1, 8, 5120),
    ("outside", 2, 3, 256, 5120), ("pile-up", 1, 3, 256, 5120),
    ("pile-up", 2, 3, 64, 5120), ("abs", 1, 3, 256, 5120),
    ("scattered", 1, 3, 256, 100), ("pile-up", 1, 1, 32, 64)])
def test_merge_replay_matches_plain(case, B, C, window, entries):
    """The replay of G5's tiles, bins, windows and runs equals the plain
    merge bit for bit: two frames, patches landing outside the frame and
    across its edges, a pile-up (all at once and in windows of 64), the
    abs weights, C = 1 in windows of 8; hit buffers of 100 and 64
    entries, so that the positions are cut into many runs."""
    rng = np.random.default_rng(5)
    h, w = 40, 60       # above WARP_CELLS: the tile route
    cfg, grid, state = _merge_state(rng, case, B, C, h, w)
    assert not g5.merge_plan(B, grid.n_patches, 8, h, w).warp_cells
    want = pdensify.fb_merge_plain(state, grid, cfg, h, w).numpy()
    got = _merge_replay(state, grid, cfg, h, w, window, entries)
    assert np.array_equal(got, want)


def test_merge_replay_at_op4():
    """The replay at op 4's 12 px patches (tiles of 16 cells, bins of 16
    landing cells, 3 px apart) equals the plain merge."""
    rng = np.random.default_rng(9)
    h, w = 40, 52       # above WARP_CELLS: the tile route
    cfg = port.operating_point(4)
    grid = PatchGrid.create(cfg, w, h)
    lead = (1, grid.n_h, grid.n_w)
    mid = torch.as_tensor(np.stack(grid.midpoints(), -1))[None]
    p = torch.as_tensor(rng.standard_normal(lead + (2,)).astype(F32) * 6)
    cost = torch.as_tensor((rng.random(lead + (12, 12, 3)) ** 2 * 50)
                           .astype(F32))
    state = PatchState(p, None, mid, None, None, None, None, None, cost,
                       None)
    want = pdensify.fb_merge_plain(state, grid, cfg, h, w).numpy()
    assert np.array_equal(_merge_replay(state, grid, cfg, h, w, 256), want)
