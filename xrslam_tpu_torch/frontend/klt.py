"""Pyramidal Lucas-Kanade optical flow, batched over keypoints (port of
`xrslam_tpu/frontend/klt.py` with the semantics of its TPU level
tracker `_track_level_mxu`): 21×21 window, 4 pyramid images, ≤30
iterations, eps 0.01, rotation-predicted seeds, the iterate confined to
a search block (64 px on the top level, 32 px below), forward pass over
all levels and the reverse-consistency pass on level 0 only, with the
level-0 template residual `err`.

Kernel K1 of the port (csrc/klt_level.cu) has two entries:

- `track_keypoints` (the main path): `track_keypoints_plain`, the
  per-level composition below with image-wide Scharr gradients, for CPU
  tensors; `track_keypoints_cuda`, the whole forward + backward KLT of a
  frame pair in one launch with the Scharr windows computed per point
  on the card (`scharr_windows` is that stage in plain PyTorch), for
  CUDA tensors.
- `track_level` (one level, the JAX signature, off the main path):
  `track_level_plain` (hat-selector sampling of the search block) for
  CPU tensors, `track_level_cuda` for CUDA tensors.

A wrapper given CUDA tensors launches its kernel or raises; nothing
falls back to the plain version.
"""

from __future__ import annotations

import torch

from . import image as img_ops
from ..kernels import build as kbuild

SEARCH = 64  # search-block side on the top level
SEARCH_LO = 32  # search-block side below it and in the backward pass
MIN_EIG_FLOOR = 1e-4
# what the kernel takes (csrc/klt_level.cu)
MAX_LEVELS = 4
MAX_WIN = 21  # 14 window taps a lane, in registers
MAX_SEARCH = 64
ENTRY_LEVEL = "klt_level_launch"
ENTRY_TRACK = "klt_track_launch"


def _window_corner(shape, centers: torch.Tensor, win: int):
    """Corner (ix, iy) of the (win+1)² sample block of each window
    centered at centers (N,2) (x,y), clamped to an image of `shape`, and
    the fractional offset (fx, fy) against the clamped corner
    (klt._sample_window)."""
    H, W = shape
    r = win // 2
    x0f = centers[:, 0] - r
    y0f = centers[:, 1] - r
    ix = torch.clamp(torch.floor(x0f).to(torch.int64), 0, max(W - win - 1, 0))
    iy = torch.clamp(torch.floor(y0f).to(torch.int64), 0, max(H - win - 1, 0))
    return ix, iy, x0f - ix.to(x0f.dtype), y0f - iy.to(y0f.dtype)


def _blend(blk: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """(N,win,win) bilinear blend of (N,win+1,win+1) blocks, one
    fractional offset per block."""
    fx = fx[:, None, None]
    fy = fy[:, None, None]
    return ((1 - fy) * (1 - fx) * blk[:, :-1, :-1]
            + (1 - fy) * fx * blk[:, :-1, 1:]
            + fy * (1 - fx) * blk[:, 1:, :-1]
            + fy * fx * blk[:, 1:, 1:])


def _sample_window(img: torch.Tensor, centers: torch.Tensor, win: int) -> torch.Tensor:
    """Bilinearly sample (N,win,win) patches of img (H,W) centered at
    centers (N,2) (x,y) (klt._sample_window)."""
    ix, iy, fx, fy = _window_corner(img.shape, centers, win)
    ar = torch.arange(win + 1, device=img.device)
    blk = img[(iy[:, None] + ar)[:, :, None], (ix[:, None] + ar)[:, None, :]]
    return _blend(blk, fx, fy)


def scharr_windows(img: torch.Tensor, centers: torch.Tensor, win: int):
    """The fused kernel's gradient stage in plain PyTorch: per point, the
    (win+3)² block of img around its sample block with indices clamped
    to the image (the replicate border of `image.scharr`), the Scharr
    filter on it, then the bilinear blend. Returns (T, Ix, Iy), each
    (N,win,win): `_sample_window` of img, and of `image.scharr(img)`'s two
    images, computed from the point's block alone."""
    H, W = img.shape
    ix, iy, fx, fy = _window_corner(img.shape, centers, win)
    ar = torch.arange(-1, win + 2, device=img.device)
    rows = torch.clamp(iy[:, None] + ar, 0, H - 1)
    cols = torch.clamp(ix[:, None] + ar, 0, W - 1)
    blk = img[rows[:, :, None], cols[:, None, :]]          # (N,win+3,win+3)
    gx, gy = img_ops.scharr(blk)
    return tuple(_blend(b[:, 1:-1, 1:-1], fx, fy) for b in (blk, gx, gy))


def track_level_plain(prev_img, prev_ix, prev_iy, next_img, pts_prev, guess,
                      valid, win: int, iters: int, eps: float,
                      min_eig_floor: float = MIN_EIG_FLOOR, final: bool = False,
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


def _check_win_search(what: str, win: int, *searches: int) -> None:
    if win % 2 != 1 or not 3 <= win <= MAX_WIN:
        raise ValueError(f"{what}: win must be odd in [3, {MAX_WIN}], got {win}")
    for search in searches:
        if not win + 2 <= search <= MAX_SEARCH:
            raise ValueError(f"{what}: search={search} out of range for win={win} "
                             f"(win + 2 to {MAX_SEARCH})")


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
    if H < win + 1 or W < win + 1:
        raise ValueError(f"klt_level: image {H}x{W} smaller than win + 1 = {win + 1}")
    _check_win_search("klt_level", win, search)


def track_level_cuda(prev_img, prev_ix, prev_iy, next_img, pts_prev, guess,
                     valid, win: int, iters: int, eps: float,
                     min_eig_floor: float = MIN_EIG_FLOOR, final: bool = False,
                     search: int = SEARCH, steps_out=None):
    """Launch entry 1 of csrc/klt_level.cu: one warp per point. Same
    contract as `track_level_plain`. `steps_out`, an (N,) int32 tensor
    on the card, receives the number of LK steps each point took (a
    measurement aid: the work the kernel did depends on it)."""
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
    valid = valid.contiguous()  # a bool is one byte: the kernel reads it as uint8
    g_out = torch.empty((N, 2), dtype=torch.float32, device=guess.device)
    v_out = torch.empty((N,), dtype=torch.bool, device=guess.device)
    err = torch.empty((N,), dtype=torch.float32, device=guess.device)
    stream = torch.cuda.current_stream(guess.device).cuda_stream
    rc = kbuild.KLT_LEVEL.fn(ENTRY_LEVEL)(
        imgs[0].data_ptr(), imgs[1].data_ptr(), imgs[2].data_ptr(),
        imgs[3].data_ptr(), pts_prev.data_ptr(), guess.data_ptr(),
        valid.data_ptr(), g_out.data_ptr(), v_out.data_ptr(),
        err.data_ptr(), None if steps_out is None else steps_out.data_ptr(),
        N, H, W, win, iters, float(eps * eps),
        float(min_eig_floor), 1 if final else 0, search, stream)
    kbuild.check(rc, "klt_level")
    if N:
        kbuild.KLT_LEVEL.count(ENTRY_LEVEL)
    return g_out, v_out, err


def track_level(prev_img, prev_ix, prev_iy, next_img, pts_prev, guess, valid,
                win: int, iters: int, eps: float,
                min_eig_floor: float = MIN_EIG_FLOOR, final: bool = False,
                search: int = SEARCH):
    """K1 entry 1 (one level): plain PyTorch for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    fn = track_level_cuda if prev_img.is_cuda else track_level_plain
    if not prev_img.is_cuda and prev_img.device.type != "cpu":
        raise ValueError(f"track_level runs on CPU or CUDA, got {prev_img.device}")
    return fn(prev_img, prev_ix, prev_iy, next_img, pts_prev, guess, valid,
              win=win, iters=iters, eps=eps, min_eig_floor=min_eig_floor,
              final=final, search=search)


def lk_flow(prev_pyr, next_pyr, pts_prev, pts_init, valid_in, win: int = 21,
            iters: int = 30, eps: float = 0.01, search_top: int = SEARCH,
            level_fn=track_level_plain):
    """Multi-level forward LK; pts are level-0 pixel coords (N,2) and
    `pts_init` seeds the flow. `level_fn` tracks one level from the
    image-wide Scharr gradients. Returns (pts, valid, err)."""
    levels = len(prev_pyr)
    guess = pts_init / float(2 ** (levels - 1))
    valid = valid_in
    err = torch.zeros(pts_prev.shape[0], dtype=prev_pyr[0].dtype,
                      device=pts_prev.device)
    for lev in range(levels - 1, -1, -1):
        s = float(2 ** lev)
        prev_img = prev_pyr[lev]
        ix, iy = img_ops.scharr(prev_img)
        guess, valid, err = level_fn(
            prev_img, ix, iy, next_pyr[lev], pts_prev / s, guess, valid,
            win=win, iters=iters, eps=eps, final=(lev == 0),
            search=search_top if lev == levels - 1 else SEARCH_LO)
        if lev > 0:
            guess = guess * 2.0
    return guess, valid, err


def track_keypoints_plain(prev_pyr, next_pyr, pts_prev, pts_init, valid_in,
                          win: int = 21, iters: int = 30, eps: float = 0.01,
                          border: int = 20, reverse_thresh: float = 0.5,
                          max_residual: float = 25.0, level_fn=track_level_plain):
    """Forward + level-0 backward LK with the reference's gates: 20 px
    border, displacement <= rows/4, round trip <= 0.5 px, template
    residual <= 25; one `level_fn` call per level and pass. Returns
    (pts_next (N,2), status (N,) bool). With `level_fn=track_level_cuda`
    it is the five-launch chain of entry 1."""
    H, W = prev_pyr[0].shape
    fwd, st, err = lk_flow(prev_pyr, next_pyr, pts_prev, pts_init, valid_in,
                           win, iters, eps, level_fn=level_fn)
    inb = ((fwd[:, 0] >= border) & (fwd[:, 0] < W - border)
           & (fwd[:, 1] >= border) & (fwd[:, 1] < H - border))
    disp = torch.linalg.norm(fwd - pts_prev, dim=-1)
    st = st & inb & (disp <= H / 4.0) & (err <= max_residual)
    # the reverse pass is seeded at the original points, so only level 0
    # with a small search block matters (klt.track_keypoints)
    bwd, st_b, _ = lk_flow(next_pyr[:1], prev_pyr[:1], fwd, pts_prev, st,
                           win, iters, eps, search_top=SEARCH_LO,
                           level_fn=level_fn)
    round_trip = torch.linalg.norm(bwd - pts_prev, dim=-1)
    st = st & st_b & (round_trip <= reverse_thresh)
    return torch.where(st[:, None], fwd, pts_init), st


def _check_track_inputs(prev_pyr, next_pyr, pts_prev, pts_init, valid_in,
                        win, steps_out) -> int:
    """Raise on what the fused entry does not take; return the levels."""
    levels = len(prev_pyr)
    if not 1 <= levels <= MAX_LEVELS or len(next_pyr) != levels:
        raise ValueError(f"klt_track: both pyramids need the same 1 to "
                         f"{MAX_LEVELS} levels, got {levels} and {len(next_pyr)}")
    dev = prev_pyr[0].device
    imgs = (*prev_pyr, *next_pyr)
    for x in (*imgs, pts_prev, pts_init, valid_in):
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"klt_track: every input must be on {dev}")
        if not x.is_contiguous():
            raise ValueError("klt_track: every input must be contiguous")
    for x in (*imgs, pts_prev, pts_init):
        if x.dtype != torch.float32:
            raise ValueError(f"klt_track takes float32, got {x.dtype}")
    N = pts_prev.shape[0]
    if tuple(pts_prev.shape) != (N, 2) or tuple(pts_init.shape) != (N, 2) \
            or tuple(valid_in.shape) != (N,) or valid_in.dtype != torch.bool:
        raise ValueError("klt_track: pts_prev/pts_init must be (N,2), valid_in (N,) bool")
    shape = tuple(prev_pyr[0].shape)
    if len(shape) != 2:
        raise ValueError(f"klt_track: images must be (H,W), got {shape}")
    for lev in range(levels):
        if lev:
            shape = ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
        if tuple(prev_pyr[lev].shape) != shape or tuple(next_pyr[lev].shape) != shape:
            raise ValueError(f"klt_track: pyramid level {lev} is "
                             f"{tuple(prev_pyr[lev].shape)} / {tuple(next_pyr[lev].shape)}"
                             f", not {shape}")
        if min(shape) < win + 1:
            raise ValueError(f"klt_track: level {lev} ({shape}) is smaller than "
                             f"win + 1 = {win + 1}")
    _check_win_search("klt_track", win, SEARCH, SEARCH_LO)
    if steps_out is not None and not (
            steps_out.is_cuda and steps_out.device == dev
            and steps_out.dtype == torch.int32 and steps_out.is_contiguous()
            and tuple(steps_out.shape) == (N, levels + 1)):
        raise ValueError(f"klt_track: steps_out must be a contiguous (N, {levels + 1}) "
                         f"int32 tensor on {dev}")
    return levels


def track_keypoints_cuda(prev_pyr, next_pyr, pts_prev, pts_init, valid_in,
                         win: int = 21, iters: int = 30, eps: float = 0.01,
                         border: int = 20, reverse_thresh: float = 0.5,
                         max_residual: float = 25.0, steps_out=None):
    """Launch entry 2 of csrc/klt_level.cu: all of `track_keypoints_plain`
    for a frame pair in one launch, one warp per point, the Scharr
    windows computed per point. Same contract as `track_keypoints_plain`.
    Inputs must be contiguous; no host sync, so the call can be captured
    in a CUDA graph. `steps_out`, an (N, levels + 1) int32 tensor on the
    card, receives the LK steps of each point and pass (the levels from
    the top down, then the backward pass; 0 for a pass not run)."""
    levels = _check_track_inputs(prev_pyr, next_pyr, pts_prev, pts_init,
                                 valid_in, win, steps_out)
    N = pts_prev.shape[0]
    dev = pts_prev.device
    pts_next = torch.empty((N, 2), dtype=torch.float32, device=dev)
    status = torch.empty((N,), dtype=torch.bool, device=dev)
    if N == 0:
        return pts_next, status
    absent = (None,) * (MAX_LEVELS - levels)
    dims = [d for x in prev_pyr for d in x.shape] + [0, 0] * len(absent)
    rc = kbuild.KLT_LEVEL.fn(ENTRY_TRACK)(
        *(x.data_ptr() for x in prev_pyr), *absent,
        *(x.data_ptr() for x in next_pyr), *absent,
        pts_prev.data_ptr(), pts_init.data_ptr(), valid_in.data_ptr(),
        pts_next.data_ptr(), status.data_ptr(),
        None if steps_out is None else steps_out.data_ptr(),
        N, levels, *dims, win, iters, SEARCH, SEARCH_LO, float(eps * eps),
        MIN_EIG_FLOOR, float(border), float(reverse_thresh), float(max_residual),
        torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(rc, "klt_track")
    kbuild.KLT_LEVEL.count(ENTRY_TRACK)
    return pts_next, status


def track_keypoints(prev_pyr, next_pyr, pts_prev, pts_init, valid_in,
                    win: int = 21, iters: int = 30, eps: float = 0.01,
                    border: int = 20, reverse_thresh: float = 0.5,
                    max_residual: float = 25.0):
    """K1 for a frame pair (the main path): `track_keypoints_plain` for
    CPU tensors, the fused kernel for CUDA tensors. Returns (pts_next
    (N,2), status (N,) bool)."""
    img = prev_pyr[0]
    if not img.is_cuda and img.device.type != "cpu":
        raise ValueError(f"track_keypoints runs on CPU or CUDA, got {img.device}")
    fn = track_keypoints_cuda if img.is_cuda else track_keypoints_plain
    return fn(prev_pyr, next_pyr, pts_prev, pts_init, valid_in, win=win,
              iters=iters, eps=eps, border=border, reverse_thresh=reverse_thresh,
              max_residual=max_residual)
