"""Plane-layout (SoA) linear algebra for tiny matrices.

Port of the JAX package's ``core/planar.py``.  A mean is ``[D, P, M]`` and a
symmetric matrix its packed upper triangle ``[T, P, M]``, ``T = D (D+1)/2``,
row-major: D=2 -> [(0,0), (0,1), (1,1)].

The JAX package's one-hot ``onehot``/``take_lane``/``put_lane`` exist because
batched scatters serialize on a TPU; here slot gathers are ``torch.gather``
and the order-sensitive top-k is :func:`topk_stable`.
"""

from __future__ import annotations

import torch


def tri_size(d: int) -> int:
    return d * (d + 1) // 2


def tri_index(i: int, j: int, d: int) -> int:
    """Index of (i, j) in the packed upper triangle (order-insensitive)."""
    if i > j:
        i, j = j, i
    return i * d - i * (i - 1) // 2 + (j - i)


def sym_rows(s, d: int):
    """Packed planes ``s[T, ...]`` -> nested list ``rows[i][j]`` of planes."""
    return [[s[tri_index(i, j, d)] for j in range(d)] for i in range(d)]


def pack_sym(S: torch.Tensor) -> torch.Tensor:
    """Dense ``[..., D, D]`` -> packed ``[T, ...]`` (boundary use only)."""
    d = S.shape[-1]
    return torch.stack([S[..., i, j] for i in range(d) for j in range(i, d)])


def unpack_sym(s: torch.Tensor, d: int) -> torch.Tensor:
    """Packed ``[T, ...]`` -> dense ``[..., D, D]`` (boundary use only)."""
    r = sym_rows(s, d)
    return torch.stack([torch.stack(r[i], dim=-1) for i in range(d)], dim=-2)


def pack_vec(v: torch.Tensor) -> torch.Tensor:
    """Dense ``[..., D]`` -> planes ``[D, ...]`` (boundary use only)."""
    return torch.movedim(v, -1, 0)


def unpack_vec(p: torch.Tensor) -> torch.Tensor:
    """Planes ``[D, ...]`` -> dense ``[..., D]`` (boundary use only)."""
    return torch.movedim(p, 0, -1)


def det_sym(s, d: int):
    """Determinant of a packed symmetric ``[T, ...]``, D in 1..3 (the JAX
    package's formulas and summation order: gates flip on them)."""
    m = sym_rows(s, d)
    if d == 1:
        return m[0][0]
    if d == 2:
        return m[0][0] * m[1][1] - m[0][1] * m[0][1]
    if d == 3:
        return (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[1][2])
                - m[0][1] * (m[0][1] * m[2][2] - m[1][2] * m[0][2])
                + m[0][2] * (m[0][1] * m[1][2] - m[1][1] * m[0][2]))
    raise NotImplementedError(f"det_sym: D={d}")


def inv_sym(s, d: int):
    """Inverse of a packed symmetric ``[T, ...]`` via the adjugate, D in 1..3."""
    m = sym_rows(s, d)
    dt = det_sym(s, d)
    if d == 1:
        return torch.stack([1.0 / m[0][0]])
    if d == 2:
        return torch.stack([m[1][1] / dt, -m[0][1] / dt, m[0][0] / dt])
    if d == 3:
        c00 = m[1][1] * m[2][2] - m[1][2] * m[1][2]
        c01 = m[0][2] * m[1][2] - m[0][1] * m[2][2]
        c02 = m[0][1] * m[1][2] - m[0][2] * m[1][1]
        c11 = m[0][0] * m[2][2] - m[0][2] * m[0][2]
        c12 = m[0][2] * m[0][1] - m[0][0] * m[1][2]
        c22 = m[0][0] * m[1][1] - m[0][1] * m[0][1]
        return torch.stack([c00 / dt, c01 / dt, c02 / dt,
                            c11 / dt, c12 / dt, c22 / dt])
    raise NotImplementedError(f"inv_sym: D={d}")


def chol_sym(s, d: int):
    """Lower Cholesky factor (row-list) of a packed symmetric, D in 1..3."""
    m = sym_rows(s, d)
    if d == 1:
        return [[torch.sqrt(m[0][0])]]
    l00 = torch.sqrt(m[0][0])
    l10 = m[0][1] / l00
    l11 = torch.sqrt(torch.clamp(m[1][1] - l10 * l10, min=0.0))
    z = torch.zeros_like(l00)
    if d == 2:
        return [[l00, z], [l10, l11]]
    if d == 3:
        l20 = m[0][2] / l00
        l21 = (m[1][2] - l20 * l10) / l11
        l22 = torch.sqrt(torch.clamp(m[2][2] - l20 * l20 - l21 * l21,
                                     min=0.0))
        return [[l00, z, z], [l10, l11, z], [l20, l21, l22]]
    raise NotImplementedError(f"chol_sym: D={d}")


def quad_sym(s, v, d: int):
    """v^T S v for packed symmetric S and vector planes v (the JAX
    package's summation order)."""
    m = sym_rows(s, d)
    out = 0.0
    for i in range(d):
        out = out + m[i][i] * v[i] * v[i]
        for j in range(i + 1, d):
            out = out + 2.0 * m[i][j] * v[i] * v[j]
    return out


def matmul(A, B):
    """Row-list x row-list matrix product -> row-list."""
    r, k = len(A), len(A[0])
    c = len(B[0])
    return [[sum(A[i][t] * B[t][j] for t in range(k)) for j in range(c)]
            for i in range(r)]


def transpose_rows(A):
    return [[A[i][j] for i in range(len(A))] for j in range(len(A[0]))]


def sandwich_sym(H, s, d_in: int, R=None):
    """H S H^T (+ R) for row-list H (rows x d_in) and packed symmetric s;
    returns the packed upper triangle (MeasurementModel_RngBrg.cpp:96-103)."""
    Sm = sym_rows(s, d_in)
    HS = matmul(H, Sm)
    r = len(H)
    out = []
    for i in range(r):
        for j in range(i, r):
            v = sum(HS[i][t] * H[j][t] for t in range(d_in))
            if R is not None:
                v = v + R[i][j]
            out.append(v)
    return torch.stack(out)


def topk_stable(x: torch.Tensor, k: int, largest: bool = True):
    """Top-k along the last axis with ties broken by the LOWER index first,
    as ``jax.lax.top_k`` does (``torch.topk`` leaves tie order unspecified).

    ``largest=False`` gives the k smallest in ascending order, the lower
    index first among equals.  Ties are the common case on the filter's
    path (births all enter at one weight, dead slots all score -inf), and
    slot order feeds the merge's lowest-index claiming.
    """
    vals, idx = torch.sort(x, dim=-1, descending=largest, stable=True)
    return vals[..., :k], idx[..., :k]
