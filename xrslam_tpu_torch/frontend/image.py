"""Image preprocessing and corner detection (port of
`xrslam_tpu/frontend/image.py`): CLAHE, the 5-tap Gaussian pyramid,
Scharr derivatives, Harris/GFTT candidates. Images are float32 in
[0, 255].

All filters are the shift-and-add separable form with an edge pad, as
in the JAX package, so no cuDNN convolution (and no TF32) is involved;
the Harris Sobel and box filters are separable too and use the same
form.
"""

from __future__ import annotations

import numpy as np
import torch


def clahe(image: torch.Tensor, clip_limit: float = 6.0, tiles_x: int = 8,
          tiles_y: int = 8) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of an (H,W)
    image in [0,255] (H, W divisible by the tile grid): per-tile
    256-bin histogram clipped at clip_limit·area/256 with even excess
    redistribution, CDF LUT, bilinear blend of the four neighboring
    tiles' LUTs."""
    H, W = image.shape
    th, tw = H // tiles_y, W // tiles_x
    area = th * tw
    dev = image.device
    img = torch.clamp(image, 0, 255).to(torch.int64)
    ty = torch.arange(H, device=dev) // th
    tx = torch.arange(W, device=dev) // tw
    tile = (ty[:, None] * tiles_x + tx[None, :]).clamp(max=tiles_y * tiles_x - 1)
    hist = torch.bincount((tile * 256 + img).reshape(-1),
                          minlength=tiles_y * tiles_x * 256)
    hist = hist.to(torch.float32).reshape(tiles_y, tiles_x, 256)
    limit = max(1.0, clip_limit * area / 256.0)
    clipped = torch.clamp(hist, max=limit)
    excess = torch.sum(hist - clipped, dim=-1, keepdim=True)
    cdf = torch.cumsum(clipped + excess / 256.0, dim=-1)
    lut = torch.clamp(torch.round(cdf * (255.0 / area)), 0, 255)

    fy = (torch.arange(H, device=dev, dtype=torch.float32) + 0.5) / th - 0.5
    fx = (torch.arange(W, device=dev, dtype=torch.float32) + 0.5) / tw - 0.5
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, tiles_y - 1)
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, tiles_x - 1)
    y1 = torch.clamp(y0 + 1, 0, tiles_y - 1)
    x1 = torch.clamp(x0 + 1, 0, tiles_x - 1)
    wy = torch.clamp(fy - y0, 0.0, 1.0)[:, None]
    wx = torch.clamp(fx - x0, 0.0, 1.0)[None, :]
    Y0, Y1 = y0[:, None], y1[:, None]
    X0, X1 = x0[None, :], x1[None, :]
    ly0 = (1 - wy) * lut[Y0, X0, img] + wy * lut[Y1, X0, img]
    ly1 = (1 - wy) * lut[Y0, X1, img] + wy * lut[Y1, X1, img]
    return (1 - wx) * ly0 + wx * ly1


_GAUSS5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0
_SCHARR_D = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
_SCHARR_S = np.array([3.0, 10.0, 3.0], dtype=np.float32) / 32.0
_SOBEL_D = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
_SOBEL_S = np.array([1.0, 2.0, 1.0], dtype=np.float32)
_BOX3 = np.array([1.0, 1.0, 1.0], dtype=np.float32)


def _sep_filter(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray) -> torch.Tensor:
    """Separable 2D correlation with replicate border of (...,H,W):
    shifted slices and weighted adds (zero taps skipped), rows then
    columns."""
    rx, ry = kx.shape[0] // 2, ky.shape[0] // 2
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    p = torch.nn.functional.pad(img.reshape((-1, 1, H, W)),
                                (rx, rx, ry, ry), mode="replicate")
    p = p.reshape(lead + (H + 2 * ry, W + 2 * rx))
    acc = None
    for i in range(ky.shape[0]):
        w = float(ky[i])
        if w == 0.0:
            continue
        term = w * p[..., i:i + H, :]
        acc = term if acc is None else acc + term
    out = None
    for j in range(kx.shape[0]):
        w = float(kx[j])
        if w == 0.0:
            continue
        term = w * acc[..., :, j:j + W]
        out = term if out is None else out + term
    return out


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown: 5-tap Gaussian blur then 2x decimation (contiguous,
    as K1's fused entry takes it)."""
    return _sep_filter(img, _GAUSS5, _GAUSS5)[..., ::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, levels: int = 3):
    """`levels`+1 float32 images, level 0 = the input."""
    pyr = [img.to(torch.float32)]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def scharr(img: torch.Tensor):
    """Scharr x/y derivatives (OpenCV's LK derivative kernel, /32)."""
    return (_sep_filter(img, _SCHARR_D, _SCHARR_S),
            _sep_filter(img, _SCHARR_S, _SCHARR_D))


def harris_response(img: torch.Tensor, k: float = 0.04,
                    block_size: int = 3) -> torch.Tensor:
    """cv::cornerHarris response (Sobel 3, block 3) with replicate
    borders."""
    assert block_size == 3
    ix = _sep_filter(img, _SOBEL_D, _SOBEL_S)
    iy = _sep_filter(img, _SOBEL_S, _SOBEL_D)
    s = _sep_filter(torch.stack([ix * ix, iy * iy, ix * iy]), _BOX3, _BOX3)
    sxx, syy, sxy = s[0], s[1], s[2]
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def _maxpool3(x: torch.Tensor) -> torch.Tensor:
    p = torch.nn.functional.pad(x[None, None], (1, 1, 1, 1),
                                value=float("-inf"))[0, 0]
    H, W = x.shape
    out = p[0:H, 0:W]
    for dy in range(3):
        for dx in range(3):
            if dy or dx:
                out = torch.maximum(out, p[dy:dy + H, dx:dx + W])
    return out


def _gftt_score(img: torch.Tensor, quality_level: float, border: int,
                k: float) -> torch.Tensor:
    """Harris response at 3x3 peaks above quality·max inside the
    border, -inf elsewhere; flattened (H·W,)."""
    H, W = img.shape
    R = harris_response(img, k=k)
    is_peak = R >= _maxpool3(R)
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    in_border = (xs >= border) & (xs < W - border) & (ys >= border) & (ys < H - border)
    good = is_peak & in_border & (R > quality_level * torch.max(R))
    return torch.where(good, R, float("-inf")).reshape(-1)


def _gftt_select(score: torch.Tensor, max_candidates: int, W: int):
    """Exact top-k of the score (the TPU's approx_max_k is not needed
    here). Returns (pts (N,2) float32 xy, response (N,), valid (N,))."""
    top, idx = torch.topk(score, max_candidates)
    pts = torch.stack([(idx % W).to(torch.float32),
                       (idx // W).to(torch.float32)], dim=-1)
    valid = torch.isfinite(top)
    return pts, torch.where(valid, top, 0.0), valid


def gftt_candidates(img: torch.Tensor, max_candidates: int = 1024,
                    quality_level: float = 1e-3, border: int = 20,
                    k: float = 0.04):
    """Harris corners above quality·max with 3x3 NMS, sorted by
    response descending (fixed capacity + validity mask)."""
    score = _gftt_score(img, quality_level, border, k)
    return _gftt_select(score, max_candidates, img.shape[1])
