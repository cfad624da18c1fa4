"""Host-side semantic geometry: boundary directions, projection matrices
and the minimum-volume enclosing ellipsoids (the numpy part of
certifyingfacerecognition_tpu/ops/geometry.py, in float64, run once per
process)."""

from __future__ import annotations

import os
import os.path as osp
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np

from ..constants import ATTRS


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
    """Host (float32 numpy) bundle of the region matrices."""

    proj_mat: np.ndarray               # [512, 512]
    ellipse_mat: np.ndarray            # [512, 512] dense ellipsoid matrix
    dirs: np.ndarray                   # [512, k]
    dirs_inv: np.ndarray               # pinv(dirs) [k, 512]
    red_ellipse_diag: np.ndarray       # [k]
    red_ellipse_diag_inv: np.ndarray   # [k]


def get_all_matrices(attrs2drop: Sequence[str] = (), scale_factor: float = 1.0,
                     boundaries_dir: Optional[str] = None) -> RegionMatrices:
    proj_mat, ellipse_mat, dirs, red_diag, _ = get_projection_matrices(
        attrs2drop=attrs2drop, scale_factor=scale_factor,
        boundaries_dir=boundaries_dir)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return RegionMatrices(
        proj_mat=f32(proj_mat), ellipse_mat=f32(ellipse_mat), dirs=f32(dirs),
        dirs_inv=f32(np.linalg.pinv(dirs)), red_ellipse_diag=f32(red_diag),
        red_ellipse_diag_inv=f32(1.0 / red_diag))
