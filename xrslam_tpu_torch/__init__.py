"""xrslam_tpu_torch — the visual-inertial SLAM pipeline of `xrslam_tpu`
ported to PyTorch and CUDA.

The package mirrors `xrslam_tpu`'s layout module for module: a reader
finds the counterpart of `xrslam_tpu/frontend/klt.py` at
`xrslam_tpu_torch/frontend/klt.py`. It imports torch and numpy and
never jax or `xrslam_tpu`.

Precision follows the JAX package: the frontend (CLAHE, pyramid, GFTT,
KLT) works in float32, the backend (preintegration, window solves,
marginalization) in float64. TF32 is switched off for matmuls and
convolutions: reduced-precision multiplies in the KLT sampling or the
image filters lose ~10% of tracks per frame to the 0.5 px
reverse-consistency gate.

The two hand-written CUDA kernels of the main path live in `csrc/`
(`klt_level.cu`, `reproj_gram.cu`); `kernels/build.py` compiles them at
first use. Their wrappers (`frontend.klt.track_keypoints`, the fused
entry the tracker calls, and `track_level`;
`estimation.gram.reproj_gram` and `reproj_factor_gram`, the fused entry
`solver.assemble` takes) run the plain PyTorch version for CPU tensors
and the kernel for CUDA tensors. `api.XRSLAM` runs on the card unless
the caller passes `device="cpu"`.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
