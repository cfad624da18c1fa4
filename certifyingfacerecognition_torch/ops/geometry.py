"""Semantic geometry (port of certifyingfacerecognition_tpu/ops/
geometry.py): Sigma-norms, ellipsoid sampling and projection on the
device, and the host part (boundary directions, projection matrices and
the minimum-volume enclosing ellipsoids, numpy float64, run once per
process).

Projecting y onto {x : x^T A x <= c} solves (I + t A) x = y for the t >= 0
with x^T A x = c. With A = V diag(lam) V^T that is, in the rotated basis
y' = V^T y, f(t) = sum_i lam_i y'_i^2 / (1 + t lam_i)^2 - 1 (decreasing in
t), solved by a batched bisection of fixed length; a dense ellipsoid is
reduced to the diagonal case through one host eigendecomposition.

The device matrices are f32; where the JAX package multiplies at
Precision.HIGHEST the products here run in full f32 (TF32 off).
"""

from __future__ import annotations

import os
import os.path as osp
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import ATTRS

# Bisection bracket and length of the JAX package: [float eps, 1e3], 64
# halvings.
_T_LO = 1e-12
_T_HI = 1.0e3
_BISECT_ITERS = 64


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full f32 (TF32 off for the call)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Sigma-norms
# ---------------------------------------------------------------------------

def sq_distance(A: torch.Tensor, x: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched bilinear form x^T A y (y defaults to x). x, y [B, d]; A
    [d, d]. Returns [B]."""
    if y is None:
        y = x
    return (matmul_f32(x, A) * y).sum(-1)


def sq_distance_diag(a: torch.Tensor, x: torch.Tensor,
                     y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Diagonal bilinear form sum_i a_i x_i y_i. x, y [B, d]; a [d]."""
    prod = x * x if y is None else x * y
    return matmul_f32(prod, a)


@dataclass(frozen=True)
class Ellipsoid:
    """An origin-centred ellipsoid {x : x^T A x <= 1}: ``diag`` [d] for a
    diagonal A; otherwise its eigendecomposition A = V diag(lam) V^T and
    inv(chol(A)^T), computed on the host at construction."""

    diag: Optional[torch.Tensor] = None        # [d] if A is diagonal
    eigvals: Optional[torch.Tensor] = None     # [d] if A is dense
    eigvecs: Optional[torch.Tensor] = None     # [d, d]
    chol_inv_t_dense: Optional[torch.Tensor] = None

    @property
    def is_diag(self) -> bool:
        return self.diag is not None

    @property
    def dim(self) -> int:
        return (self.diag if self.is_diag else self.eigvals).shape[0]

    @classmethod
    def from_diag(cls, a, device="cpu") -> "Ellipsoid":
        return cls(diag=torch.as_tensor(np.asarray(a, np.float32),
                                        device=device))

    @classmethod
    def from_dense(cls, A, device="cpu") -> "Ellipsoid":
        A = np.asarray(A, np.float64)
        sym = (A + A.T) / 2.0
        lam, V = np.linalg.eigh(sym)
        chol = np.linalg.cholesky(sym)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa
                                        device=device)
        return cls(eigvals=f32(lam), eigvecs=f32(V),
                   chol_inv_t_dense=f32(np.linalg.inv(chol.T)))

    def mat(self) -> torch.Tensor:
        if self.is_diag:
            return torch.diag(self.diag)
        return matmul_f32(self.eigvecs * self.eigvals, self.eigvecs.t())

    def sq_dist(self, x: torch.Tensor) -> torch.Tensor:
        """x^T A x for x [B, d] -> [B]."""
        if self.is_diag:
            return sq_distance_diag(self.diag, x)
        return sq_distance_diag(self.eigvals, matmul_f32(x, self.eigvecs))

    def cholesky_inv_t(self) -> torch.Tensor:
        """inv(chol(A)^T), the map from the unit ball to the ellipsoid."""
        if self.is_diag:
            return torch.diag(1.0 / torch.sqrt(self.diag))
        return self.chol_inv_t_dense


# ---------------------------------------------------------------------------
# Batched ellipsoid projection
# ---------------------------------------------------------------------------

def _bisect_project_diag(y: torch.Tensor, a: torch.Tensor, c: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Project rows of y [B, d] onto {x: sum_i a_i x_i^2 <= c}. Rows inside
    (or where the bracket does not straddle the root) are returned as they
    are. Returns (projections [B, d], t [B], which_out [B] bool)."""
    a = a / c
    y2 = y * y

    def f(t):                      # [B] -> [B], decreasing in t
        inv = 1.0 / (1.0 + t[:, None] * a[None, :])
        return (a[None, :] * inv * inv * y2).sum(-1) - 1.0

    lo = torch.full(y.shape[:1], _T_LO, dtype=y.dtype, device=y.device)
    hi = torch.full(y.shape[:1], _T_HI, dtype=y.dtype, device=y.device)
    which_out = (f(lo) * f(hi)) < 0.0
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        right = f(mid) > 0.0       # the root is to the right
        lo, hi = torch.where(right, mid, lo), torch.where(right, hi, mid)
    t = 0.5 * (lo + hi)
    proj = y / (1.0 + t[:, None] * a[None, :])
    return torch.where(which_out[:, None], proj, y), t, which_out


def proj_ellipse(y: torch.Tensor, ell: Ellipsoid, c: float = 1.0
                 ) -> torch.Tensor:
    """Project rows of y [B, d] into the ellipsoid (identity if inside)."""
    if ell.is_diag:
        return _bisect_project_diag(y, ell.diag, c)[0]
    outr = _bisect_project_diag(matmul_f32(y, ell.eigvecs), ell.eigvals, c)[0]
    return matmul_f32(outr, ell.eigvecs.t())


def proj_to_surface(v: torch.Tensor, ell: Ellipsoid) -> torch.Tensor:
    """Scale rows of v [B, d] onto the ellipsoid surface (with the
    reference's +1e-4 guard, which leaves them marginally inside)."""
    return v / (torch.sqrt(ell.sq_dist(v))[:, None] + 1e-4)


def proj2region(vs: torch.Tensor, proj_mat: Optional[torch.Tensor],
                ell: Ellipsoid, to_subs: bool = True,
                on_surface: bool = False, max_iters: int = 5
                ) -> torch.Tensor:
    """Project rows of vs [B, d] into (subspace intersect ellipsoid):
    subspace projection, optional surface placement, ellipsoid projection,
    ``max_iters`` alternating refinements, then any row still outside is
    renormalised onto the surface."""
    x = vs
    if to_subs:
        x = matmul_f32(x, proj_mat.t())
    if on_surface:
        x = proj_to_surface(x, ell)
    x = proj_ellipse(x, ell)
    for _ in range(max_iters):
        x = proj_ellipse(x, ell)
        if to_subs:
            x = matmul_f32(x, proj_mat.t())
    outside = (ell.sq_dist(x) > 1.0)[:, None]
    return torch.where(outside, proj_to_surface(x, ell), x)


# ---------------------------------------------------------------------------
# Sampling and attack initialisation
# ---------------------------------------------------------------------------

def sample_ellipsoid(gen: torch.Generator, ell: Ellipsoid, n_vecs: int = 1
                     ) -> torch.Tensor:
    """Uniform samples from the ellipsoid interior [n_vecs, d]: a uniform
    direction, radius U^(1/d), mapped through inv(chol(A)^T). The draws
    come from ``gen`` on the CPU (so a seed gives the same samples on
    every device) and move to the ellipsoid's device."""
    n = ell.dim
    vec = torch.randn((n, n_vecs), generator=gen, dtype=torch.float32)
    vec = vec / torch.linalg.vector_norm(vec, dim=0, keepdim=True)
    rad = torch.rand((n_vecs,), generator=gen, dtype=torch.float32)
    vec = (vec * rad[None, :] ** (1.0 / n)).to(ell.cholesky_inv_t().device)
    return matmul_f32(ell.cholesky_inv_t(), vec).t()


def init_deltas(gen: torch.Generator, n_vecs: int, ell: Ellipsoid,
                proj_mat: Optional[torch.Tensor] = None,
                random_init: bool = True, lin_comb: bool = True,
                on_surface: bool = True, emb_size: int = 512
                ) -> torch.Tensor:
    """Attack initialisation inside or on the feasible region: in the
    reduced attribute space (dim ell.dim) with ``lin_comb``, otherwise in
    the full latent space with a subspace projection."""
    if not random_init:
        dim = ell.dim if lin_comb else emb_size
        device = (ell.diag if ell.is_diag else ell.eigvals).device
        return torch.zeros((n_vecs, dim), dtype=torch.float32, device=device)
    deltas = sample_ellipsoid(gen, ell, n_vecs)
    if lin_comb:
        if on_surface:
            deltas = proj2region(deltas, None, ell, to_subs=False,
                                 on_surface=True)
        return deltas
    return proj2region(deltas, proj_mat, ell, to_subs=True,
                       on_surface=on_surface)


def in_subs(v: torch.Tensor, proj_mat: torch.Tensor, atol: float = 1e-4
            ) -> bool:
    """True when every row of v [B, d] lies in the subspace."""
    dists = torch.linalg.vector_norm(matmul_f32(v, proj_mat.t()) - v, dim=-1)
    return bool((dists <= atol).all())


def in_ellps(v: torch.Tensor, ell: Ellipsoid, atol: float = 1e-4) -> bool:
    """True when every row of v [B, d] lies inside the ellipsoid."""
    return bool((ell.sq_dist(v) <= 1.0 + atol).all())


# ---------------------------------------------------------------------------
# Host-side, run-once matrix construction (numpy, float64)
# ---------------------------------------------------------------------------


def mvee(points: np.ndarray, tol: float = 1e-3
         ) -> Tuple[np.ndarray, np.ndarray]:
    """Khachiyan minimum-volume enclosing ellipsoid of row-stacked points.
    Returns (A, c) with (x-c)^T A (x-c) = 1."""
    points = np.asarray(points, np.float64)
    N, d = points.shape
    Q = np.column_stack((points, np.ones(N))).T  # [d+1, N]
    u = np.ones(N) / N
    err = tol + 1.0
    while err > tol:
        X = (Q * u) @ Q.T
        M = np.einsum("ij,ji->i", Q.T, np.linalg.solve(X, Q))
        jdx = int(np.argmax(M))
        step = (M[jdx] - d - 1.0) / ((d + 1) * (M[jdx] - 1.0))
        new_u = (1 - step) * u
        new_u[jdx] += step
        err = np.linalg.norm(new_u - u)
        u = new_u
    c = u @ points
    A = np.linalg.inv((points.T * u) @ points - np.outer(c, c)) / d
    return A, c


def get_full_points(points: np.ndarray, fill_with_null: bool = False
                    ) -> np.ndarray:
    """Direction columns [d, k], optionally completed with a nullspace
    basis, plus their mirror images: [d, 2k']."""
    import scipy.linalg

    if fill_with_null:
        null = scipy.linalg.null_space(points.T)
        points = np.concatenate([points, null], axis=1)
        assert points.shape[0] == points.shape[1]
    return np.concatenate((points, -points), axis=1)


def get_proj_mat(dirs: np.ndarray) -> np.ndarray:
    """Orthogonal projector onto span(columns of dirs)."""
    return dirs @ np.linalg.pinv(dirs)


def get_ellipse_mat(dirs: np.ndarray) -> np.ndarray:
    """MVEE matrix of +-dirs plus a nullspace fill."""
    A, c = mvee(get_full_points(dirs, fill_with_null=True).T)
    assert np.allclose(c, 0, atol=1e-6), "ellipsoid centre should be origin"
    return A


def default_boundaries_dir() -> str:
    """The InterFaceGAN boundary vectors: CFR_BOUNDARIES_DIR, else
    ./boundaries, else the set vendored at the repository root."""
    vendored = osp.join(osp.dirname(osp.dirname(osp.dirname(
        osp.abspath(__file__)))), "boundaries")
    for c in (os.environ.get("CFR_BOUNDARIES_DIR", ""), "boundaries",
              vendored):
        if c and osp.isdir(c):
            return c
    raise FileNotFoundError(
        "No boundaries directory found; set CFR_BOUNDARIES_DIR or create "
        "./boundaries with {gan}_{dataset}_{attr}_w_boundary.npy files "
        "(the vendored copies should be at " + vendored + ")")


def get_projection_matrices(dataset: str = "ffhq", gan_name: str = "stylegan",
                            attrs2drop: Sequence[str] = (),
                            scale_factor: float = 1.0,
                            boundaries_dir: Optional[str] = None):
    """(proj_mat [512,512], ellipse_mat [512,512], dirs [512,k],
    red_ellipse_diag [k], files), memoised per process."""
    return _get_projection_matrices_impl(
        dataset, gan_name, tuple(attrs2drop), float(scale_factor),
        boundaries_dir or default_boundaries_dir())


@lru_cache(maxsize=8)
def _get_projection_matrices_impl(dataset: str, gan_name: str,
                                  attrs2drop: Tuple[str, ...],
                                  scale_factor: float, boundaries_dir: str):
    attrs = dict(ATTRS)
    for attr in attrs2drop:
        assert attr in attrs, f"Attribute {attr} is NOT valid"
        attrs.pop(attr)

    dirs, files, magns = [], [], []
    for att_name, magn in attrs.items():
        fname = osp.join(boundaries_dir,
                         f"{gan_name}_{dataset}_{att_name}_w_boundary.npy")
        assert osp.isfile(fname), f'Boundary for attr "{att_name}" not found!'
        dirs.append(np.load(fname))
        magns.append(magn)
        files.append(fname)

    dirs = np.concatenate(dirs, axis=0).T  # [d, k]
    assert dirs.shape[1] == len(attrs)

    proj_mat = get_proj_mat(dirs)
    ellipse_mat = scale_factor * get_ellipse_mat(dirs)
    red_ellipse_mat = scale_factor * get_ellipse_mat(np.diag(np.array(magns)))
    assert np.allclose(red_ellipse_mat,
                       np.diag(np.diagonal(red_ellipse_mat)), atol=1e-10), \
        "Reduced ellipse matrix should be diagonal"
    red_ellipse_diag = np.diagonal(red_ellipse_mat).copy()
    return proj_mat, ellipse_mat, dirs, red_ellipse_diag, files


@dataclass(frozen=True)
class RegionMatrices:
    """The region matrices as f32 tensors on one device."""

    proj_mat: torch.Tensor               # [512, 512]
    ellipse_mat: torch.Tensor            # [512, 512] dense ellipsoid matrix
    ellipse: Ellipsoid                   # the same, dense, for projection
    dirs: torch.Tensor                   # [512, k]
    dirs_inv: torch.Tensor               # pinv(dirs) [k, 512]
    red_ellipse: Ellipsoid               # diagonal, k-dim
    red_ellipse_diag: torch.Tensor       # [k]
    red_ellipse_diag_inv: torch.Tensor   # [k]


def get_all_matrices(attrs2drop: Sequence[str] = (), scale_factor: float = 1.0,
                     boundaries_dir: Optional[str] = None, device="cpu"
                     ) -> RegionMatrices:
    proj_mat, ellipse_mat, dirs, red_diag, _ = get_projection_matrices(
        attrs2drop=attrs2drop, scale_factor=scale_factor,
        boundaries_dir=boundaries_dir)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                    device=device)
    return RegionMatrices(
        proj_mat=f32(proj_mat), ellipse_mat=f32(ellipse_mat),
        ellipse=Ellipsoid.from_dense(ellipse_mat, device), dirs=f32(dirs),
        dirs_inv=f32(np.linalg.pinv(dirs)),
        red_ellipse=Ellipsoid.from_diag(red_diag, device),
        red_ellipse_diag=f32(red_diag),
        red_ellipse_diag_inv=f32(1.0 / red_diag))
