"""JCBB, Joint Compatibility Branch & Bound, as a fixed-shape beam search
(port of the JAX package's ``ops/jcbb.py``).

Reference: JCBB.hpp:124-208 (the interpretation-tree search, :344-520),
with the joint innovation covariance's inverse grown by block updates
(JCBB.hpp:442-484) and chi-square gating (:463-467).  No reference program
uses JCBB (a library feature).

The depth-first branch & bound becomes a beam search over the
interpretation tree: measurements are taken in order; each hypothesis
assigns the current one to an unused landmark or to "none"; every
expansion is scored by (pairings, joint Mahalanobis distance) and the best
``beam`` survive.  A beam at least as wide as the tree's leaves makes the
search exhaustive (exact JCBB).  The survivors are the first ``beam`` of a
stable descending sort, so among equal scores the lower flat index (beam
slot, then landmark, then the "none" expansions) wins, as
``jax.lax.top_k`` decides.

:func:`jcbb` takes the dense joint covariance ``S [Z, M, Z, M, D, D]``
(correlated landmark estimates) and carries the inverse over the paired
blocks, ``[beam, Z D, Z D]``, through the Schur update.

:func:`jcbb_block_diag` is the independent-landmark case.  The JAX package
writes it into the dense S (``S[z, m, z, m] = S_diag[m]``, zero elsewhere)
and runs :func:`jcbb`; here it never builds that S.  It is exact because
every cross block the dense search gathers is zero: at the step of
measurement ``zi`` the search gathers ``S[zi, m, z, assoc[b, z]]`` for the
paired ``z``; for ``z != zi`` that block is zero by construction, and
``z = zi`` is not paired yet (``assoc[b, zi] = -1`` masks it).  So the
dense step's ``C K`` is zero, its conditional covariance is
``sym(S_diag[m])``, its residual is the innovation itself, and the
increment of a pairing (zi, m) is ``nu[zi, m]^T W_m nu[zi, m]`` with
``W_m = inv(sym(S_diag[m]) + 1e-9 I)``, the dense step's floats (the same
operations in the same order), for every beam slot alike.  The search
then carries ``assoc``, ``used``, the pair count, md2 and liveness only:
O(Z M D + beam M) memory against the dense S's O(Z^2 M^2 D^2).

The inverses are ``torch.linalg.inv_ex``'s: a singular block gives
non-finite entries, as ``jnp.linalg.inv`` does, and no check reads the
device.  Nothing in either search reads the device back.

The chi-square quantile is the Wilson-Hilferty approximation (relative
error < 1% for df >= 1 at the 0.9-0.99 levels used for gating).
"""

from __future__ import annotations

import math

import torch

from rfs_slam_tpu_torch.core import planar

NEG = -1e30


def chi2_quantile(p: float, df, device=None) -> torch.Tensor:
    """Wilson-Hilferty approximation of the chi-square quantile, float32
    (boost::math::quantile(chi_squared(df), p), JCBB.hpp:463-467).  ``df``
    a number (on ``device``) or a tensor."""
    # filled on the device: a host tensor copied there would wait for it
    df = (df.to(torch.float32) if isinstance(df, torch.Tensor)
          else torch.full((), float(df), device=device))
    z = math.sqrt(2.0) * torch.special.erfinv(
        2.0 * torch.full_like(df, p) - 1.0)
    t = 1.0 - 2.0 / (9.0 * df) + z * torch.sqrt(2.0 / (9.0 * df))
    return df * (t * t * t)


class _Beam:
    """The hypotheses every search carries: ``assoc [B, Z]`` (landmark per
    measurement, -1 none), ``used [B, M]``, ``npair [B]``, ``md2 [B]`` and
    ``alive [B]``; slot 0 starts as the empty hypothesis."""

    def __init__(self, B, Z, M, confidence, D, device):
        self.assoc = torch.full((B, Z), -1, dtype=torch.int64, device=device)
        self.used = torch.zeros((B, M), dtype=torch.bool, device=device)
        self.npair = torch.zeros((B,), dtype=torch.int64, device=device)
        self.md2 = torch.zeros((B,), device=device)
        self.alive = torch.arange(B, device=device) == 0
        # lexicographic (pairings, -md2) score: the gate bounds any
        # surviving md2 by the full-cardinality threshold
        self.lex = chi2_quantile(confidence, Z * D, device) + 1.0
        # the gate of n pairings at thresh[n - 1]
        self.thresh = chi2_quantile(
            confidence, D * torch.arange(1, Z + 1, device=device))

    def expand(self, zi, md2_new, feasible):
        """Keep the best ``B`` of the ``B M`` pairings of measurement ``zi``
        (``md2_new [B, M]``, ``feasible [B, M]``) and the ``B`` "none"
        expansions.  Returns ``(b_idx, m_idx, is_none)`` of the kept."""
        B, M = self.used.shape
        n_new = (self.npair + 1).to(md2_new.dtype)
        cand = torch.where(feasible, n_new[:, None] * self.lex - md2_new,
                           NEG)
        none = torch.where(self.alive,
                           self.npair.to(md2_new.dtype) * self.lex - self.md2,
                           NEG)
        _, top = planar.topk_stable(torch.cat([cand.reshape(-1), none]), B)
        is_none = top >= B * M
        b_idx = torch.where(is_none, top - B * M, top // M)
        m_idx = torch.where(is_none, 0, top % M)
        valid = torch.where(is_none, self.alive[b_idx],
                            feasible[b_idx, m_idx])
        self.assoc = self.assoc[b_idx]
        self.assoc[:, zi] = torch.where(is_none, -1, m_idx)
        self.used = self.used[b_idx] | (
            (torch.arange(M, device=m_idx.device) == m_idx[:, None])
            & ~is_none[:, None])
        self.npair = torch.where(is_none, self.npair[b_idx],
                                 self.npair[b_idx] + 1)
        self.md2 = torch.where(is_none, self.md2[b_idx],
                               md2_new[b_idx, m_idx])
        self.alive = valid
        return b_idx, m_idx, is_none

    def feasible(self, md2_new, m_mask, z_ok):
        return (self.alive[:, None] & m_mask[None, :] & ~self.used
                & (md2_new <= self.thresh[self.npair][:, None]) & z_ok)

    def best(self):
        """``(assoc [Z], n_paired, md2)`` of the best live hypothesis (the
        first among equal scores)."""
        score = torch.where(self.alive,
                            self.npair.to(self.md2.dtype) * self.lex
                            - self.md2, NEG)
        # index_select: indexing by a 0-dim tensor would read it back
        b = torch.argmax(score).view(1)
        return tuple(x.index_select(0, b)[0]
                     for x in (self.assoc, self.npair, self.md2))


def jcbb(innov: torch.Tensor, S: torch.Tensor, z_mask: torch.Tensor,
         m_mask: torch.Tensor, confidence: float = 0.95, beam: int = 32):
    """Joint-compatibility data association on the dense joint covariance.

    ``innov [Z, M, D]``: innovation of measurement z against landmark m;
    ``S [Z, M, Z, M, D, D]``: cov(nu[z1, m1], nu[z2, m2]); ``z_mask [Z]``,
    ``m_mask [M]``.  Returns ``(assoc [Z], n_paired, md2)``: the landmark
    of each measurement (-1 unassociated) of the most jointly compatible
    pairings, the smallest joint Mahalanobis distance breaking ties (the
    JCBB objective, JCBB.hpp:344-520).
    """
    Z, M, D = innov.shape
    ZD = Z * D
    B = beam
    dev = innov.device
    h = _Beam(B, Z, M, confidence, D, dev)
    # inverse of the joint S over the paired blocks (identity padding),
    # the stacked innovation, the rows / columns in use
    kinv = torch.eye(ZD, device=dev).expand(B, ZD, ZD)
    nu = torch.zeros((B, ZD), device=dev)
    sel = torch.zeros((B, ZD), dtype=torch.bool, device=dev)
    eye = torch.eye(D, device=dev)
    ar_m = torch.arange(M, device=dev)
    ar_z = torch.arange(Z, device=dev)

    for zi in range(Z):
        nu_zi = innov[zi]                                   # [M, D]
        # cross blocks of candidate (zi, m) and each paired (z, assoc[b, z]):
        # C6[b, m, z] = S[zi, m, z, assoc[b, z]]
        a_clip = h.assoc.clamp(0, M - 1)                    # [B, Z]
        C6 = S[zi][ar_m[None, :, None], ar_z[None, None, :],
                   a_clip[:, None, :]]                      # [B, M, Z, D, D]
        C6 = torch.where((h.assoc >= 0)[:, None, :, None, None], C6, 0.0)
        C = C6.permute(0, 1, 3, 2, 4).reshape(B, M, D, ZD)
        S_new = S[zi, :, zi][ar_m, ar_m]                    # [M, D, D]

        # Schur update: md2 + (nu_n - C K nu_o)^T W (nu_n - C K nu_o),
        # W = inv(S_new - C K C^T)
        K = kinv * (sel[:, :, None] & sel[:, None, :])
        CK = torch.einsum("bmdz,bzy->bmdy", C, K)           # [B, M, D, ZD]
        S_cond = S_new[None] - torch.einsum("bmdz,bmez->bmde", CK, C)
        S_cond = 0.5 * (S_cond + S_cond.transpose(-1, -2))
        W = torch.linalg.inv_ex(S_cond + 1e-9 * eye).inverse
        r = nu_zi[None] - torch.einsum("bmdz,bz->bmd", CK, nu)
        md2_new = h.md2[:, None] + torch.einsum("bmd,bmde,bme->bm", r, W, r)

        feasible = h.feasible(md2_new, m_mask, z_mask[zi])
        kinv_old, nu_old, sel_old = kinv, nu, sel
        b_idx, m_idx, is_none = h.expand(zi, md2_new, feasible)

        # the block update of the paired expansions
        s0, s1 = zi * D, zi * D + D
        KCT = CK[b_idx, m_idx].transpose(-1, -2)            # [B, ZD, D]
        W_b = W[b_idx, m_idx]                               # [B, D, D]
        kinv = K[b_idx] + torch.einsum("bzd,bde,bye->bzy", KCT, W_b, KCT)
        upd_on = -torch.einsum("bzd,bde->bze", KCT, W_b)    # [B, ZD, D]
        kinv[:, :, s0:s1] = upd_on
        kinv[:, s0:s1, :] = upd_on.transpose(-1, -2)
        kinv[:, s0:s1, s0:s1] = W_b
        kinv = torch.where(is_none[:, None, None], kinv_old[b_idx], kinv)
        nu = nu_old[b_idx]
        nu[:, s0:s1] = torch.where(is_none[:, None], 0.0, nu_zi[m_idx])
        sel = sel_old[b_idx]
        sel[:, s0:s1] |= ~is_none[:, None]
    return h.best()


def jcbb_block_diag(innov: torch.Tensor, S_diag: torch.Tensor,
                    z_mask: torch.Tensor, m_mask: torch.Tensor,
                    confidence: float = 0.95, beam: int = 32):
    """JCBB for independent landmark estimates (a block-diagonal joint
    covariance, JCBB.hpp:401-440): ``innov [Z, M, D]``, ``S_diag [M, D, D]``
    the innovation covariance of each landmark.  Returns what :func:`jcbb`
    returns on the equivalent dense S, without building it (see the module
    docstring for why the two agree)."""
    Z, M, D = innov.shape
    dev = innov.device
    h = _Beam(beam, Z, M, confidence, D, dev)
    S_cond = 0.5 * (S_diag + S_diag.transpose(-1, -2))
    W = torch.linalg.inv_ex(S_cond + 1e-9 * torch.eye(D, device=dev)).inverse
    # the md2 increment of every pairing, [Z, M]
    dmd2 = torch.einsum("zmd,mde,zme->zm", innov, W, innov)
    for zi in range(Z):
        md2_new = h.md2[:, None] + dmd2[zi][None, :]
        h.expand(zi, md2_new, h.feasible(md2_new, m_mask, z_mask[zi]))
    return h.best()
