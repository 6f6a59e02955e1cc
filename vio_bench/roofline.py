"""The yardstick of the kernel rooflines: the card's published peaks and
the operations and bytes of one call of each hand-written kernel,
counted from the problem's shapes (arithmetic copied from the
repository's `chip_smoke.py`). Each input byte counts as read once and
each output byte as written once, so the count does not change when a
kernel is rewritten.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at the
# 700 W power limit): the memory rate, and float32 and float64 outside
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 33.5e12}
POWER_LIMIT_W = 700.0

# K1: a bilinear tap (7), the difference and two multiply-adds (5) per
# window pixel and LK step; three sampled windows per point up front
# (7 each); each pass filters its (win+1)^2 sample block (24 a pixel).
KLT_FLOPS_PER_TAP = 12
KLT_WINDOW_FLOPS = 21
KLT_SCHARR_FLOPS = 24
KLT_SEARCH = 64      # search-block side on the top level
KLT_SEARCH_LO = 32   # below it and in the backward pass

# K2: per observation the Gram stage's (21 + 6) entries of 4 operations
# and 8 landmark entries of 3; the factor stage's 490 and the anchored
# entries' (63 + 6) of 4 for an active observation, 24 for a masked one.
GRAM_FLOPS_MASKED = 8 * 3


def least_seconds(n_bytes: float, flops: float, itemsize: int):
    """(seconds, bound): the larger of bytes over the memory rate and
    operations over the peak of their type, and which of them it is."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[itemsize]
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def k1_counts(levels, slots: int, win: int = 21):
    """(bytes, operations) of one K1 call (`klt_track`, a frame pair)
    with `slots` keypoint slots over two float32 pyramids of the level
    shapes `levels` [(H, W), ...], level 0 first. Every slot is counted
    as tracked forward through every level and back at level 0; per
    image the smaller of the image and the blocks read from it. The
    operations count one LK step a pass, the least a pass takes: they
    are a floor, and the bytes bind."""
    n_fwd = n_bwd = slots
    blk = (win + 3) ** 2 * 4
    moved = slots * (2 * 4 * 2 + 1) + slots * (2 * 4 + 1)   # pts, init, valid; out
    top = len(levels) - 1
    for lev, (h, w) in enumerate(levels):
        img = h * w * 4
        search = KLT_SEARCH if lev == top else KLT_SEARCH_LO
        prev_need = n_fwd * blk + (n_bwd * KLT_SEARCH_LO ** 2 * 4 if lev == 0 else 0)
        next_need = n_fwd * search ** 2 * 4 + (n_bwd * blk if lev == 0 else 0)
        moved += min(img, prev_need) + min(img, next_need)
    passes = n_fwd * len(levels) + n_bwd
    flops = (win ** 2 * passes * (KLT_FLOPS_PER_TAP + KLT_WINDOW_FLOPS)
             + passes * (win + 1) ** 2 * KLT_SCHARR_FLOPS)
    return moved, flops


def k2_counts(K: int, L: int, itemsize: int, N: int = 1):
    """(bytes, operations) of one K2 entry-2 call (`reproj_factor_gram`,
    both launches) over N windows of K frames and L landmark slots:
    the inputs (q, p, inverse depths, extrinsics, bearings, masks,
    anchors, whitening) read once, the outputs (the frame block, its
    right side, the landmark diagonal, the coupling block, the landmark
    right side, the cost) written once. The operations count every
    observation as masked, a floor: the bytes bind."""
    f = itemsize
    ins = (K * 4 + K * 3 + L + K * 4 + K * 3 + K * L * 3 + K * 2 * 2) * f \
        + K * L + L * 4 + L
    outs = (K * 6 * K * 6 + K * 6 + L + K * 6 * L + L + 1) * f
    return N * (ins + outs), N * K * L * GRAM_FLOPS_MASKED
