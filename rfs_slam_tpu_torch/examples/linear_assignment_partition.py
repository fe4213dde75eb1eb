"""Connected-component partitioning of a gated likelihood table.

Equivalent of the reference's ``linearAssignment_CostMatrixPartitioning``
example (src/examples/linearAssignment_CostMatrixPartitioning.cpp): build a
sparse landmark x measurement likelihood table, partition it into
independent blocks via ``cost_partition`` (the label-propagation replacement
for boost::graph connected components, CostMatrix.cpp:92-157), and show
that each block can be solved independently (by the ``hungarian`` kernel on
the card) — the exact decomposition the RB-PHD single-cluster likelihood
exploits (RBPHDFilter.hpp:845-889).
"""

from __future__ import annotations

import numpy as np
import torch

from rfs_slam_tpu_torch.examples import cli, device_of
from rfs_slam_tpu_torch.ops.assignment import cost_partition, hungarian


def main(n_rows: int = 6, n_cols: int = 7, density: float = 0.25,
         seed: int = 2, verbose: bool = True, device=None):
    dev = device_of(device)
    rng = np.random.default_rng(seed)
    lik = rng.uniform(size=(n_rows, n_cols))
    gate = rng.uniform(size=(n_rows, n_cols)) < density
    lik = np.where(gate, lik, 0.0)
    if verbose:
        print("Gated likelihood table:")
        print(np.array_str(lik, precision=3))

    row_lab, col_lab = (x.cpu().numpy() for x in cost_partition(
        torch.as_tensor(gate, device=dev)))
    if verbose:
        print(f"\nrow labels: {row_lab}\ncol labels: {col_lab}")

    # verify: no gated entry crosses partitions
    r, c = np.nonzero(gate)
    assert np.all(row_lab[r] == col_lab[c]), "gated entry crosses partitions"

    blocks = sorted(set(row_lab) | set(col_lab))
    total = 0.0
    for b in blocks:
        rows = np.nonzero(row_lab == b)[0]
        cols = np.nonzero(col_lab == b)[0]
        if len(rows) == 0 or len(cols) == 0:
            continue  # singleton row/col partition (reference keeps these too)
        sub = lik[np.ix_(rows, cols)]
        n = max(len(rows), len(cols))
        padded = np.zeros((n, n))
        padded[: len(rows), : len(cols)] = sub
        _, score = hungarian(torch.as_tensor(padded, dtype=torch.float32,
                                             device=dev))
        total += float(score)
        if verbose:
            print(f"partition {b}: rows {rows.tolist()} cols {cols.tolist()} "
                  f"best-assignment likelihood sum {float(score):.4f}")
    if verbose:
        print(f"\nsum over independent partitions: {total:.4f}")
    return row_lab, col_lab, total


if __name__ == "__main__":
    cli(main, __doc__)
