"""Map-integrity self-check, the reference's debug sanity pass (port of
the JAX package's ``utils/integrity.py``).

Reference: ``RBPHDFilter::checkMapIntegrity`` (RBPHDFilter.hpp:1087-1150)
scans every particle's Gaussian mixture for non-finite means and
covariances and for a non-positive quadratic form 1^T S 1 (a cheap
positive-definiteness probe).  Here the scan is one masked reduction over
the plane-major map; a debug tool, not part of the step.
"""

from __future__ import annotations

import torch

from rfs_slam_tpu_torch.core import planar
from rfs_slam_tpu_torch.core.state import GMState


def check_map_integrity(gm: GMState, weights_are_log_odds: bool = False):
    """Return ``(ok, report)`` over the alive Gaussians of every particle.

    ``report`` maps each failure kind to its number of (particle, slot)
    pairs: non-finite mean, non-finite covariance, non-positive 1^T S 1
    (RBPHDFilter.hpp:1126-1135), non-finite weight and (for PHD maps, whose
    weights are not log-odds) negative weight.
    """
    alive = gm.alive
    d = gm.dim
    mean_bad = (~torch.isfinite(gm.mean)).any(dim=0) & alive
    cov_bad = (~torch.isfinite(gm.cov)).any(dim=0) & alive

    # ones^T S ones = the sum of all entries (off-diagonals twice)
    quad = torch.zeros_like(gm.w)
    for i in range(d):
        for j in range(i, d):
            v = gm.cov[planar.tri_index(i, j, d)]
            quad = quad + (v if i == j else 2.0 * v)
    psd_bad = (quad <= 0.0) & alive & ~cov_bad

    # a NaN weight fails explicitly: `w < 0` alone would let it through
    w_nonfinite = (~torch.isfinite(gm.w)) & alive
    w_bad = torch.zeros_like(alive)
    if not weights_are_log_odds:
        w_bad = (gm.w < 0.0) & alive & ~w_nonfinite

    counts = torch.stack([mean_bad.sum(), cov_bad.sum(), psd_bad.sum(),
                          w_nonfinite.sum(), w_bad.sum()]).tolist()
    report = dict(zip(("mean_nonfinite", "cov_nonfinite", "cov_nonpositive",
                       "weight_nonfinite", "weight_negative"), counts))
    return not any(counts), report
