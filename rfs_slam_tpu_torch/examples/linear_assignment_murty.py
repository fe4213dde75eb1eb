"""Murty k-best assignments on a clutter/misdetection-augmented matrix,
cross-checked against brute-force enumeration.

Equivalent of the reference's ``linearAssignment_MurtyAlgorithm`` example
(src/examples/linearAssignment_MurtyAlgorithm.cpp:30-137): build the
(nR+nC)^2 log-likelihood matrix whose top-left block is real landmark x
measurement likelihoods, the off-diagonal blocks are per-row misdetection /
per-column clutter scores (diagonal-only, -1000 elsewhere), enumerate the
k-best assignments with Murty's algorithm (its subproblems solved by the
``hungarian`` kernel on the card), and validate the ranked scores against
``brute_force_assignments`` (the reference's stated test oracle,
BruteForceAssignment.hpp:41-42).
"""

from __future__ import annotations

import numpy as np
import torch

from rfs_slam_tpu_torch.examples import cli, device_of
from rfs_slam_tpu_torch.ops.assignment import brute_force_assignments, murty

BIG_NEG = -1000.0


def augmented_matrix(n_meas: int, n_lmk: int, rng: np.random.Generator):
    """(nR+nC)^2 augmented log-likelihood matrix, reference layout."""
    n = n_meas + n_lmk
    c = np.full((n, n), BIG_NEG)
    c[:n_meas, :n_lmk] = np.log(rng.uniform(size=(n_meas, n_lmk)))
    for i in range(n_meas):           # measurement i <- clutter
        c[i, n_lmk + i] = np.log(rng.uniform())
    for j in range(n_lmk):            # landmark j <- missed
        c[n_meas + j, j] = np.log(rng.uniform())
    c[n_meas:, n_lmk:] = 0.0
    return c


def main(n_meas: int = 3, n_lmk: int = 4, k: int = 20, seed: int = 0,
         verbose: bool = True, device=None):
    rng = np.random.default_rng(seed)
    c = augmented_matrix(n_meas, n_lmk, rng)
    if verbose:
        print(f"{n_lmk} landmarks and {n_meas} measurements")
        print("Augmented log-likelihood matrix "
              f"({n_meas + n_lmk}x{n_meas + n_lmk}):")
        print(np.array_str(c, precision=3))

    # setRealAssignmentBlock(nR1, nC1), as the reference example does
    # (linearAssignment_MurtyAlgorithm.cpp:103)
    cost = torch.as_tensor(c, dtype=torch.float32, device=device_of(device))
    sols, scores, valid = (x.cpu().numpy() for x in murty(
        cost, k, real_rows=n_meas, real_cols=n_lmk))
    if verbose:
        print("\nMurty k-best:")
        for r in range(k):
            if not valid[r] or scores[r] < BIG_NEG:
                break
            print(f"[{r + 1} : {scores[r]:.6f}] "
                  + " ".join(str(int(x)) for x in sols[r]))

    perms, bf_scores = brute_force_assignments(c, k=None)
    # distinct-score ladder, as the reference prints (cpp:119-127)
    distinct = []
    for s in bf_scores:
        if s < BIG_NEG:
            break
        if not distinct or abs(s - distinct[-1]) > 1e-12:
            distinct.append(float(s))
    if verbose:
        print("\nBrute-force validation (distinct scores):")
        for d, s in enumerate(distinct[:k]):
            print(f"[{d + 1} : {s:.6f}]")

    got = [float(s) for s, v in zip(scores, valid) if v and s >= BIG_NEG]
    # with the real-assignment-block restriction the k-best are distinct in
    # the real block, i.e. one hypothesis per distinct score (the aug-row
    # permutation duplicates of the raw brute-force ladder are suppressed)
    np.testing.assert_allclose(got, distinct[: len(got)], rtol=1e-6)
    if verbose:
        print(f"\nOK: Murty top-{len(got)} matches brute force.")
    return got


if __name__ == "__main__":
    cli(main, __doc__)
