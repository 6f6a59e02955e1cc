"""5-point essential matrix (Nistér), batched (port of
`xrslam_tpu/geometry/essential.py`).

1. nullspace basis E(x,y,z) = x·E1 + y·E2 + z·E3 + E4 of the five
   epipolar constraints (eigh of AᵀA through LAPACK's `syevd` from
   scipy, the routine the JAX package's CPU `eigh` calls);
2. the ten cubic constraints (det E = 0, 2EEᵀE − tr(EEᵀ)E = 0) by
   trivariate polynomial arithmetic — each product sums its terms in
   the JAX package's table order (a fixed order on every device);
3. as C(z)·m(x,y) = 0, solutions need det C(z) = 0: a degree-10
   polynomial fitted from determinants at Chebyshev nodes, on the
   charts z and 1/z;
4. real roots by sign-change bisection;
5. per root, (x, y) from the null vector of C(z*).

Convention: x2ᵀ E x1 = 0 for homogeneous normalized image points.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_DEG1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_DEG2 = [(2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1), (0, 0, 2),
         (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_DEG3 = [(3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0), (2, 0, 1), (1, 1, 1),
         (0, 2, 1), (1, 0, 2), (0, 1, 2), (0, 0, 3), (2, 0, 0), (1, 1, 0),
         (0, 2, 0), (1, 0, 1), (0, 1, 1), (0, 0, 2), (1, 0, 0), (0, 1, 0),
         (0, 0, 1), (0, 0, 0)]


def _mul_terms(alist, blist, outlist) -> np.ndarray:
    """(len(outlist), M): for each output monomial, the flat indices
    i·len(blist) + j of the products a_i·b_j that make it, in the JAX
    package's table order ((i, j) lexicographic), padded with the index
    of a zero."""
    idx = {m: i for i, m in enumerate(outlist)}
    terms = [[] for _ in outlist]
    for i, a in enumerate(alist):
        for j, b in enumerate(blist):
            terms[idx[(a[0] + b[0], a[1] + b[1], a[2] + b[2])]].append(i * len(blist) + j)
    pad, width = len(alist) * len(blist), max(map(len, terms))
    return np.array([t + [pad] * (width - len(t)) for t in terms])


_T11 = _mul_terms(_DEG1, _DEG1, _DEG2)
_T21 = _mul_terms(_DEG2, _DEG1, _DEG3)
_XY_MONOS = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2),
             (1, 0), (0, 1), (0, 0)]
# C(z)'s layout: per (xy-monomial column, z power) the DEG3 coefficient
# it takes, or len(_DEG3) (a zero)
_C_TERMS = np.full((10, 4), len(_DEG3))
for _m, (_i, _j, _k) in enumerate(_DEG3):
    _C_TERMS[_XY_MONOS.index((_i, _j)), _k] = _m


@functools.lru_cache(maxsize=None)
def _const(name: str, device) -> torch.Tensor:
    """Static index tables as tensors, once per device."""
    arr = {"T11": _T11, "T21": _T21, "C": _C_TERMS}[name]
    return torch.as_tensor(arr, dtype=torch.long, device=device)


def _with_zero(x: torch.Tensor) -> torch.Tensor:
    """x (...,n) -> (...,n+1), a zero appended (the tables' padding)."""
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)


def _pmul(a, b, name: str):
    """Polynomial product a (...,Na) × b (...,Nb) -> (...,N_out): each
    output coefficient sums its products a_i·b_j in the table's order,
    as the JAX package's `_pmul` does. An einsum against a 0/1 table
    would sum them in the order of the library's kernel, which on the
    CPU follows the processor."""
    prods = _with_zero((a[..., :, None] * b[..., None, :]).flatten(-2))
    g = prods[..., _const(name, a.device)]              # (...,N_out,M)
    out = g[..., 0]
    for m in range(1, g.shape[-1]):
        out = out + g[..., m]
    return out


def _p11(a, b):
    """Degree-1 x degree-1 polynomial product (...,4),(...,4)->(...,10)."""
    return _pmul(a, b, "T11")


def _p21(a, b):
    """Degree-2 x degree-1 product (...,10),(...,4)->(...,20)."""
    return _pmul(a, b, "T21")


def _constraint_polys(basis: torch.Tensor) -> torch.Tensor:
    """The ten cubic constraints as (...,10,20) coefficient arrays;
    basis (...,9,4) holds E1..E4 (row-major 3×3) as columns."""
    Ep = basis.reshape(basis.shape[:-2] + (3, 3, 4))
    # EEt[i][j] = Σ_k E[i,k]·E[j,k] (degree 2); the sums over k in order
    t = _p11(Ep[..., :, None, :, :], Ep[..., None, :, :, :])     # (...,i,j,k,10)
    EEt = t[..., 0, :] + t[..., 1, :] + t[..., 2, :]
    trace = EEt[..., 0, 0, :] + EEt[..., 1, 1, :] + EEt[..., 2, 2, :]
    # (EEt·E)[i][j] − ½·trace·E[i][j] (degree 3)
    t = _p21(EEt[..., :, None, :, :], Ep.transpose(-3, -2)[..., None, :, :, :])
    rows = (t[..., 0, :] + t[..., 1, :] + t[..., 2, :]
            - 0.5 * _p21(trace[..., None, None, :], Ep))
    rows = rows.reshape(rows.shape[:-3] + (9, 20))

    def p1(i, j):
        return Ep[..., i, j, :]

    def d2(a, b, c, d):
        return _p11(p1(*a), p1(*b)) - _p11(p1(*c), p1(*d))

    det = (_p21(d2((1, 1), (2, 2), (1, 2), (2, 1)), p1(0, 0))
           - _p21(d2((1, 0), (2, 2), (1, 2), (2, 0)), p1(0, 1))
           + _p21(d2((1, 0), (2, 1), (1, 1), (2, 0)), p1(0, 2)))
    return torch.cat([rows, det[..., None, :]], dim=-2)


def _c_of_z(polys: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """C(z): polys (...,10,20), z (...,S) -> (...,S,10,10); each entry
    Σ_p coefficient·z^p, summed over the powers in order."""
    g = _with_zero(polys)[..., _const("C", polys.device)][..., None, :, :, :]
    z = z[..., :, None, None]                           # (...,S,1,1)
    out = g[..., 0] + g[..., 1] * z
    zp = z
    for p in (2, 3):
        zp = zp * z
        out = out + g[..., p] * zp
    return out


def _eigh_vectors_lapack(a: torch.Tensor) -> torch.Tensor:
    """Eigenvectors (...,n,n) of symmetric matrices on the CPU by scipy's
    LAPACK `syevd` (lower triangle), one matrix at a time: the routine
    that the JAX package's CPU `eigh` calls (jaxlib takes its LAPACK
    from scipy.linalg.cython_lapack)."""
    from scipy.linalg import lapack

    m = a.detach().numpy().reshape((-1,) + a.shape[-2:])
    syevd = lapack.get_lapack_funcs("syevd", (m,))
    v = np.empty_like(m)
    for i in range(m.shape[0]):
        _, v[i], _ = syevd(m[i], compute_v=1, lower=1)
    return torch.from_numpy(v.reshape(a.shape))


def nullspace_basis(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(...,5,3) points -> (...,9,4) nullspace of x2ᵀ E x1 = 0.

    AᵀA has a (numerically) 4-fold zero eigenvalue, so the basis an
    eigensolver returns is rounding noise: on 4096 such matrices MKL's
    `syevd` (torch's CPU `eigh`), cuSOLVER's and scipy's LAPACK gave no
    two bases alike (an Intel Xeon host). The real roots the bisection
    finds follow the basis, and now and then a hypothesis gains or
    loses one, which can move a RANSAC or PARSAC outcome. So on every
    device the port takes the basis from the one routine the JAX
    package's CPU `eigh` calls, LAPACK's `syevd` through scipy: the
    CPU drives agree with the JAX package's, and the card's with the
    CPU's. On the card that costs one copy of the (...,9,9) stack to
    the host per 5-point solve. AᵀA itself is summed in a fixed order
    (a CPU matmul follows MKL's per-CPU kernel)."""
    A = torch.einsum("...ni,...nj->...nij", x2, x1).reshape(
        x1.shape[:-2] + (5, 9))
    # AᵀA summed over the five constraints in a fixed order: a CPU matmul
    # goes through MKL, whose kernel, and so its rounding, follows the CPU
    ata = A[..., 0, :, None] * A[..., 0, None, :]
    for n in range(1, 5):
        ata = ata + A[..., n, :, None] * A[..., n, None, :]
    v = _eigh_vectors_lapack(ata.cpu()).to(ata.device)
    return v[..., :, 0:4]


def _horner(c: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Evaluate polynomials c (...,D) low-to-high at z (...,G)."""
    out = torch.zeros_like(z)
    for k in range(c.shape[-1] - 1, -1, -1):
        out = out * z + c[..., k][..., None]
    return out


def _poly_roots_real(coeffs: torch.Tensor, grid: int = 64, iters: int = 40):
    """Real roots in [-1, 1] of batched polynomials coeffs (...,11) by
    sign-change bisection. Returns (roots (...,G-1), valid (...,G-1))."""
    z = torch.linspace(-1.0, 1.0, grid, dtype=coeffs.dtype,
                       device=coeffs.device)
    zb = z.expand(coeffs.shape[:-1] + (grid,))
    vals = _horner(coeffs, zb)
    sign_change = (vals[..., :-1] * vals[..., 1:]) < 0
    lo, hi, vlo = zb[..., :-1], zb[..., 1:], vals[..., :-1]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        vmid = _horner(coeffs, mid)
        same = (vlo * vmid) > 0
        lo = torch.where(same, mid, lo)
        hi = torch.where(same, hi, mid)
        vlo = torch.where(same, vmid, vlo)
    return 0.5 * (lo + hi), sign_change


def solve_essential_5pt(x1: torch.Tensor, x2: torch.Tensor,
                        n_samples: int = 16):
    """Batched 5-point solver: x1, x2 (...,5,3) -> (E (...,12,3,3),
    valid (...,12)), the real solutions compacted into 12 slots."""
    dtype, dev = x1.dtype, x1.device
    basis = nullspace_basis(x1, x2)
    polys = _constraint_polys(basis)

    ks = np.arange(n_samples)
    zs_np = np.cos((2 * ks + 1) * np.pi / (2 * n_samples))
    zs = torch.as_tensor(zs_np, dtype=dtype, device=dev)
    pinv = torch.as_tensor(np.linalg.pinv(np.vander(zs_np, 11, increasing=True)),
                           dtype=dtype, device=dev)
    dets = torch.linalg.det(_c_of_z(polys, zs.expand(polys.shape[:-2] + (n_samples,))))
    dets = dets / torch.clamp(torch.amax(torch.abs(dets), dim=-1, keepdim=True),
                              min=1e-300)
    coeffs_a = torch.einsum("cs,...s->...c", pinv, dets)
    coeffs_b = torch.flip(coeffs_a, dims=(-1,))
    cs = torch.stack([coeffs_a, coeffs_b], dim=0)
    roots_ab, val_ab = _poly_roots_real(cs, iters=32)
    roots_a, roots_b = roots_ab[0], roots_ab[1]
    val_b = val_ab[1] & (torch.abs(roots_b) > 1e-8)
    z_all = torch.cat([roots_a, 1.0 / torch.where(torch.abs(roots_b) > 1e-8,
                                                  roots_b, 1.0)], dim=-1)
    valid = torch.cat([val_ab[0], val_b], dim=-1)

    # compact to R slots ranked by |p(root)| in each root's own chart
    R = 12
    resid = torch.abs(_horner(cs, roots_ab))
    res_all = torch.cat([resid[0], resid[1]], dim=-1)
    big = torch.finfo(res_all.dtype).max
    order = torch.argsort(torch.where(valid, res_all, big), dim=-1,
                          stable=True)[..., :R]
    z_all = torch.gather(z_all, -1, order)
    valid = torch.gather(valid, -1, order)

    # per root: fix the "1" monomial, least squares for the other nine
    C = _c_of_z(polys, z_all)                       # (...,R,10,10)
    A = C[..., :, :9]
    rhs = -C[..., :, 9]
    ata = A.transpose(-1, -2) @ A
    atb = (A.transpose(-1, -2) @ rhs[..., None])[..., 0]
    scale = torch.clamp(torch.diagonal(ata, dim1=-2, dim2=-1).sum(-1), min=1e-30)
    reg = (1e-7 if dtype == torch.float32 else 1e-13) * scale
    ata = ata + reg[..., None, None] * torch.eye(9, dtype=dtype, device=dev)
    m, _ = torch.linalg.solve_ex(ata, atb)
    xyz1 = torch.stack([m[..., 7], m[..., 8], z_all, torch.ones_like(z_all)],
                       dim=-1)                       # (...,R,4)
    E = torch.einsum("...ec,...rc->...re", basis, xyz1)
    E = E.reshape(E.shape[:-1] + (3, 3))
    norm = torch.linalg.norm(E.reshape(E.shape[:-2] + (9,)), dim=-1)
    return E / torch.clamp(norm, min=1e-12)[..., None, None], valid


def essential_geometric_error(E: torch.Tensor, x1: torch.Tensor,
                              x2: torch.Tensor) -> torch.Tensor:
    """Symmetric squared epipolar error r²/|l1|² + r²/|l2|² with
    r = x2ᵀ E x1: E (...,3,3), x1/x2 (...,N,3) -> (...,N)."""
    Ex1 = x1 @ E.transpose(-1, -2)
    Etx2 = x2 @ E
    r = torch.sum(x2 * Ex1, dim=-1)
    n1 = torch.sum(Ex1[..., :2] ** 2, dim=-1)
    n2 = torch.sum(Etx2[..., :2] ** 2, dim=-1)
    return r * r / torch.clamp(n1, min=1e-18) + r * r / torch.clamp(n2, min=1e-18)


def decompose_essential(E: torch.Tensor):
    """SVD decomposition into (R1, R2, T), ±T implied."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2]
