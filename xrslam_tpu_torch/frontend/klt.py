"""Pyramidal Lucas-Kanade optical flow, batched over keypoints (port of
`xrslam_tpu/frontend/klt.py` with the semantics of its TPU level
tracker `_track_level_mxu`): 21×21 window, 4 pyramid images, ≤30
iterations, eps 0.01, rotation-predicted seeds, the iterate confined to
a search block (64 px on the top level, 32 px below), forward pass over
all levels and the reverse-consistency pass on level 0 only, with the
level-0 template residual `err`.

The level tracker is kernel K1 of the port:

- `track_level_plain`: the `_track_level_mxu` math in plain PyTorch
  (hat-selector sampling of the search block); taken for CPU tensors.
- `track_level_cuda`: the hand-written CUDA kernel (csrc/klt_level.cu),
  one CTA per point; taken for CUDA tensors. It raises on any input it
  does not take; there is no fallback.
"""

from __future__ import annotations

import torch

from . import image as img_ops
from ..kernels import build as kbuild

SEARCH = 64  # search-block side on the top level


def _sample_window(img: torch.Tensor, centers: torch.Tensor, win: int) -> torch.Tensor:
    """Bilinearly sample (N,win,win) patches of img (H,W) centered at
    centers (N,2) (x,y). The (win+1)² block corner is clamped to the
    image and the fractional offset kept relative to the clamped corner
    (klt._sample_window)."""
    H, W = img.shape
    r = win // 2
    x0f = centers[:, 0] - r
    y0f = centers[:, 1] - r
    ix = torch.clamp(torch.floor(x0f).to(torch.int64), 0, max(W - win - 1, 0))
    iy = torch.clamp(torch.floor(y0f).to(torch.int64), 0, max(H - win - 1, 0))
    fx = (x0f - ix.to(x0f.dtype))[:, None, None]
    fy = (y0f - iy.to(y0f.dtype))[:, None, None]
    ar = torch.arange(win + 1, device=img.device)
    rows = (iy[:, None] + ar[None, :])[:, :, None]
    cols = (ix[:, None] + ar[None, :])[:, None, :]
    blk = img[rows, cols]                                   # (N,win+1,win+1)
    return ((1 - fy) * (1 - fx) * blk[:, :-1, :-1]
            + (1 - fy) * fx * blk[:, :-1, 1:]
            + fy * (1 - fx) * blk[:, 1:, :-1]
            + fy * fx * blk[:, 1:, 1:])


def track_level_plain(prev_img, prev_ix, prev_iy, next_img, pts_prev, guess,
                      valid, win: int, iters: int, eps: float,
                      min_eig_floor: float = 1e-4, final: bool = False,
                      search: int = SEARCH):
    """One pyramid level for all points (the `_track_level_mxu` math):
    per point one (search,search) block of next_img around the guess
    (zero past the edge), each LK step samples its window as R·S·Cᵀ
    with hat-function selectors, the window corner is clamped inside
    the block, a converged point never moves. Returns (new_guess,
    valid, err)."""
    H, W = prev_img.shape
    N = pts_prev.shape[0]
    r = win // 2
    dt = prev_img.dtype
    dev = prev_img.device

    cx = torch.clamp(torch.floor(guess[:, 0]).to(torch.int64) - search // 2,
                     0, max(W - search, 0))
    cy = torch.clamp(torch.floor(guess[:, 1]).to(torch.int64) - search // 2,
                     0, max(H - search, 0))
    ar = torch.arange(search, device=dev)
    rows = cy[:, None] + ar[None, :]
    cols = cx[:, None] + ar[None, :]
    inside = (rows < H)[:, :, None] & (cols < W)[:, None, :]
    S = torch.where(inside, next_img[rows.clamp(max=H - 1)[:, :, None],
                                     cols.clamp(max=W - 1)[:, None, :]], 0.0)
    jx0 = cx.to(dt)
    jy0 = cy.to(dt)

    T = _sample_window(prev_img, pts_prev, win)
    Ix = _sample_window(prev_ix, pts_prev, win)
    Iy = _sample_window(prev_iy, pts_prev, win)
    gxx = torch.sum(Ix * Ix, dim=(1, 2))
    gxy = torch.sum(Ix * Iy, dim=(1, 2))
    gyy = torch.sum(Iy * Iy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    small_eig = 0.5 * (gxx + gyy - torch.sqrt((gxx - gyy) ** 2 + 4 * gxy * gxy))
    cond_ok = ((gxx + gyy) > 0) & (small_eig / (win * win) > min_eig_floor) \
        & (det > 1e-12)
    inv_det = torch.where(det > 1e-12, 1.0 / torch.where(det > 0, det, 1.0), 0.0)
    in_bounds0 = ((pts_prev[:, 0] >= r) & (pts_prev[:, 0] < W - r)
                  & (pts_prev[:, 1] >= r) & (pts_prev[:, 1] < H - r))

    lmax = float(search - win - 1)
    taps = torch.arange(win, dtype=dt, device=dev)
    grid = torch.arange(search, dtype=dt, device=dev)

    def hat_sel(start):
        pos = start[:, None] + taps[None, :]
        return torch.clamp(1.0 - torch.abs(grid[None, None, :] - pos[..., None]),
                           min=0.0)

    def sample(lx, ly):
        R = hat_sel(torch.clamp(ly - r, 0.0, lmax))
        C = hat_sel(torch.clamp(lx - r, 0.0, lmax))
        return R @ S @ C.transpose(-1, -2)

    lx = guess[:, 0] - jx0
    ly = guess[:, 1] - jy0
    conv = ~(cond_ok & in_bounds0 & valid)
    for _ in range(iters):
        diff = sample(lx, ly) - T
        bx = torch.sum(diff * Ix, dim=(1, 2))
        by = torch.sum(diff * Iy, dim=(1, 2))
        dx = -(gyy * bx - gxy * by) * inv_det
        dy = -(-gxy * bx + gxx * by) * inv_det
        lx = torch.where(conv, lx, lx + dx)
        ly = torch.where(conv, ly, ly + dy)
        conv = conv | ((dx * dx + dy * dy) < eps * eps)
        if bool(conv.all()):
            break

    use = valid & cond_ok & in_bounds0
    g_fin = torch.stack([torch.where(use, lx + jx0, guess[:, 0]),
                         torch.where(use, ly + jy0, guess[:, 1])], dim=-1)
    ok_out = use if final else valid
    if final:
        err = torch.mean(torch.abs(sample(lx, ly) - T), dim=(1, 2))
    else:
        err = torch.zeros(N, dtype=dt, device=dev)
    return g_fin, ok_out, err


def _check_cuda_inputs(imgs, pts_prev, guess, valid, win, search):
    H, W = imgs[0].shape
    for x in imgs:
        if x.dim() != 2 or tuple(x.shape) != (H, W):
            raise ValueError("klt_level: images must share one (H,W) shape")
    for x in (*imgs, pts_prev, guess, valid):
        if not x.is_cuda or x.device != imgs[0].device:
            raise ValueError(f"klt_level: every input must be on {imgs[0].device}")
    for x in (*imgs, pts_prev, guess):
        if x.dtype != torch.float32:
            raise ValueError(f"klt_level takes float32, got {x.dtype}")
    N = pts_prev.shape[0]
    if tuple(pts_prev.shape) != (N, 2) or tuple(guess.shape) != (N, 2) \
            or tuple(valid.shape) != (N,) or valid.dtype != torch.bool:
        raise ValueError("klt_level: pts/guess must be (N,2), valid (N,) bool")
    if win % 2 != 1 or H < win + 1 or W < win + 1:
        raise ValueError(f"klt_level: odd win <= image side - 1 required "
                         f"(win={win}, image {H}x{W})")
    if search < win + 2 or 4 * (search * search + 3 * win * win) > 48 * 1024:
        raise ValueError(f"klt_level: search={search} out of range for win={win}")


def track_level_cuda(prev_img, prev_ix, prev_iy, next_img, pts_prev, guess,
                     valid, win: int, iters: int, eps: float,
                     min_eig_floor: float = 1e-4, final: bool = False,
                     search: int = SEARCH, steps_out=None):
    """Launch csrc/klt_level.cu: one CTA per point. Same contract as
    `track_level_plain`. `steps_out`, an (N,) int32 tensor on the card,
    receives the number of LK steps each point took (a measurement
    aid: the work the kernel did depends on it)."""
    imgs = (prev_img, prev_ix, prev_iy, next_img)
    _check_cuda_inputs(imgs, pts_prev, guess, valid, win, search)
    if steps_out is not None and not (
            steps_out.is_cuda and steps_out.device == guess.device
            and steps_out.dtype == torch.int32 and steps_out.is_contiguous()
            and tuple(steps_out.shape) == (pts_prev.shape[0],)):
        raise ValueError("klt_level: steps_out must be a contiguous (N,) "
                         f"int32 tensor on {guess.device}")
    H, W = prev_img.shape
    N = pts_prev.shape[0]
    imgs = tuple(x.contiguous() for x in imgs)
    pts_prev = pts_prev.contiguous()
    guess = guess.contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    g_out = torch.empty((N, 2), dtype=torch.float32, device=guess.device)
    v_out = torch.empty((N,), dtype=torch.uint8, device=guess.device)
    err = torch.empty((N,), dtype=torch.float32, device=guess.device)
    stream = torch.cuda.current_stream(guess.device).cuda_stream
    rc = kbuild.KLT_LEVEL.fn()(
        imgs[0].data_ptr(), imgs[1].data_ptr(), imgs[2].data_ptr(),
        imgs[3].data_ptr(), pts_prev.data_ptr(), guess.data_ptr(),
        valid_u8.data_ptr(), g_out.data_ptr(), v_out.data_ptr(),
        err.data_ptr(), 0 if steps_out is None else steps_out.data_ptr(),
        N, H, W, win, iters, float(eps * eps),
        float(min_eig_floor), 1 if final else 0, search, stream)
    kbuild.check(rc, "klt_level")
    kbuild.KLT_LEVEL.count()
    return g_out, v_out.to(torch.bool), err


def track_level(prev_img, prev_ix, prev_iy, next_img, pts_prev, guess, valid,
                win: int, iters: int, eps: float, min_eig_floor: float = 1e-4,
                final: bool = False, search: int = SEARCH):
    """K1: plain PyTorch for CPU tensors, the CUDA kernel for CUDA
    tensors."""
    fn = track_level_cuda if prev_img.is_cuda else track_level_plain
    if not prev_img.is_cuda and prev_img.device.type != "cpu":
        raise ValueError(f"track_level runs on CPU or CUDA, got {prev_img.device}")
    return fn(prev_img, prev_ix, prev_iy, next_img, pts_prev, guess, valid,
              win=win, iters=iters, eps=eps, min_eig_floor=min_eig_floor,
              final=final, search=search)


def lk_flow(prev_pyr, next_pyr, pts_prev, pts_init, valid_in, win: int = 21,
            iters: int = 30, eps: float = 0.01, search_top: int = SEARCH):
    """Multi-level forward LK; pts are level-0 pixel coords (N,2) and
    `pts_init` seeds the flow. Returns (pts, valid, err)."""
    levels = len(prev_pyr)
    guess = pts_init / float(2 ** (levels - 1))
    valid = valid_in
    err = torch.zeros(pts_prev.shape[0], dtype=prev_pyr[0].dtype,
                      device=pts_prev.device)
    for lev in range(levels - 1, -1, -1):
        s = float(2 ** lev)
        prev_img = prev_pyr[lev]
        ix, iy = img_ops.scharr(prev_img)
        guess, valid, err = track_level(
            prev_img, ix, iy, next_pyr[lev], pts_prev / s, guess, valid,
            win=win, iters=iters, eps=eps, final=(lev == 0),
            search=search_top if lev == levels - 1 else 32)
        if lev > 0:
            guess = guess * 2.0
    return guess, valid, err


def track_keypoints(prev_pyr, next_pyr, pts_prev, pts_init, valid_in,
                    win: int = 21, iters: int = 30, eps: float = 0.01,
                    border: int = 20, reverse_thresh: float = 0.5,
                    max_residual: float = 25.0):
    """Forward + level-0 backward LK with the reference's gates: 20 px
    border, displacement <= rows/4, round trip <= 0.5 px, template
    residual <= 25. Returns (pts_next (N,2), status (N,) bool)."""
    H, W = prev_pyr[0].shape
    fwd, st, err = lk_flow(prev_pyr, next_pyr, pts_prev, pts_init, valid_in,
                           win, iters, eps)
    inb = ((fwd[:, 0] >= border) & (fwd[:, 0] < W - border)
           & (fwd[:, 1] >= border) & (fwd[:, 1] < H - border))
    disp = torch.linalg.norm(fwd - pts_prev, dim=-1)
    st = st & inb & (disp <= H / 4.0) & (err <= max_residual)
    # the reverse pass is seeded at the original points, so only level 0
    # with a small search block matters (klt.track_keypoints)
    bwd, st_b, _ = lk_flow(next_pyr[:1], prev_pyr[:1], fwd, pts_prev, st,
                           win, iters, eps, search_top=32)
    round_trip = torch.linalg.norm(bwd - pts_prev, dim=-1)
    st = st & st_b & (round_trip <= reverse_thresh)
    return torch.where(st[:, None], fwd, pts_init), st
