"""Lexicographic enumeration of data-association hypotheses.

Equivalent of the reference's ``linearAssignment_LexicographicOrdering``
example (src/examples/linearAssignment_LexicographicOrdering.cpp, driving
PermutationLexicographic.hpp:44-79): enumerate every landmark->measurement
assignment including missed detections (landmark -> n_z) and clutter
(unclaimed measurements), in lexicographic order, and sum the RFS
association likelihood over all hypotheses — the exact-enumeration path the
RB-PHD likelihood takes for small partitions (RBPHDFilter.hpp:961-988).
The hypotheses' weights are formed on the device, in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rfs_slam_tpu_torch.examples import cli, device_of
from rfs_slam_tpu_torch.ops.assignment import permutations_lexicographic


def main(n_m: int = 3, n_z: int = 2, seed: int = 3, verbose: bool = True,
         device=None):
    dev = device_of(device)
    perms = permutations_lexicographic(n_m, n_z)
    if verbose:
        print(f"{n_m} landmarks, {n_z} measurements "
              f"(index {n_z} = missed detection)")
        print(f"{len(perms)} hypotheses, lexicographic:")
        for p in perms:
            print("  " + " ".join(str(int(x)) for x in p))

    # sanity: count matches sum_k C(n_m, k) * P(n_z, k)
    expect = sum(math.comb(n_m, k) * math.perm(n_z, k)
                 for k in range(min(n_m, n_z) + 1))
    assert len(perms) == expect, (len(perms), expect)

    # weight each hypothesis with a random likelihood table + Pd
    rng = np.random.default_rng(seed)
    lik = torch.as_tensor(rng.uniform(size=(n_m, n_z)), device=dev)
    pd = 0.95
    clutter = 1e-3
    p = torch.as_tensor(perms, dtype=torch.int64, device=dev)   # [H, n_m]
    det = p < n_z
    l_pm = lik[torch.arange(n_m, device=dev), p.clamp(max=n_z - 1)]
    w = torch.ones(len(perms), dtype=torch.float64, device=dev)
    for m in range(n_m):            # in landmark order, as the reference
        w = w * torch.where(det[:, m], pd * l_pm[:, m], 1.0 - pd)
    w = w * clutter ** (n_z - det.sum(dim=1)).to(torch.float64)
    total = float(w.sum())
    if verbose:
        print(f"\nRFS association-likelihood sum over all "
              f"{len(perms)} hypotheses: {total:.6e}")
    return perms, total


if __name__ == "__main__":
    cli(main, __doc__)
