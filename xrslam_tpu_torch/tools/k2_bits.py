"""Hold K2's fused entry (`gram.reproj_factor_gram`, one window) bit for
bit across two checkouts of the port on one card.

    # in the other checkout, with this file:
    PYTHONPATH=. python /path/to/k2_bits.py --write OUT.pt
    # in this one:
    python -m xrslam_tpu_torch.tools.k2_bits --compare OUT.pt

The inputs are seeded `io.synthetic.reproj_window`s at the main path's
shapes (K=12 and the subframe path's K=11, L=384; f64 and f32); the
outputs are written to, or compared with, a `torch.save` file. Compare
exits non-zero unless every output is bit-equal. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys

import torch

CASES = [(12, 384, torch.float64, 2), (11, 384, torch.float64, 3),
         (12, 384, torch.float32, 2), (6, 48, torch.float64, 1)]


def outputs(dev) -> dict:
    from xrslam_tpu_torch.estimation import gram
    from xrslam_tpu_torch.io.synthetic import reproj_window

    out = {}
    for K, L, dt, seed in CASES:
        state, data = reproj_window(K, L, seed=seed, dtype=dt, device=dev)
        res = gram.reproj_factor_gram_cuda(state, data)
        out[f"K={K} L={L} {str(dt)[6:]} seed={seed}"] = [x.cpu() for x in res]
    torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--write")
    g.add_argument("--compare")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_bits: needs a CUDA device", file=sys.stderr)
        return 2
    out = outputs(torch.device("cuda", 0))
    if args.write:
        torch.save(out, args.write)
        print(f"k2_bits: wrote {len(out)} cases to {args.write}")
        return 0
    ref = torch.load(args.compare)
    bad = [k for k in ref if not all(torch.equal(a, b) for a, b in zip(ref[k], out[k]))]
    print(f"k2_bits: {len(ref) - len(bad)} of {len(ref)} cases bit-equal to "
          f"{args.compare}" + (f"; differ: {bad}" if bad else ""))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
