"""OSPA metric on hand-made point sets.

Equivalent of the reference's ``ospaError`` example
(src/examples/ospaError.cpp:30-167): compute the OSPA distance (and the
COLA rescaling) between two small 2-D point sets, showing the localization
vs cardinality split for (a) identical sets, (b) a perturbed set, (c) a
set with a missing point, at the analysis defaults cutoff c=0.2, order p=1
(analysis2dSim.cpp:229-249).
"""

from __future__ import annotations

import numpy as np
import torch

from rfs_slam_tpu_torch.examples import cli, device_of
from rfs_slam_tpu_torch.ops.ospa import ospa


def _run(name, x, y, dev, c=0.2, p=1.0, verbose=True):
    nx, ny = len(x), len(y)
    n = nx + ny
    xp = np.zeros((n, 2))
    yp = np.zeros((n, 2))
    xp[:nx] = x
    yp[:ny] = y

    def ten(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    err = ospa(ten(xp), ten(np.arange(n) < nx, torch.bool), ten(yp),
               ten(np.arange(n) < ny, torch.bool), cutoff=c, order=p)
    if verbose:
        print(f"{name}: |X|={nx} |Y|={ny}  OSPA={float(err.ospa):.4f}  "
              f"COLA={float(err.cola):.4f}  loc={float(err.loc):.4f}  "
              f"card={float(err.card):.4f}")
    return err


def main(verbose: bool = True, device=None):
    dev = device_of(device)
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.0, 1.0, size=(5, 2))

    e0 = _run("identical sets   ", x, x.copy(), dev, verbose=verbose)
    assert float(e0.ospa) < 1e-5  # f32 Hungarian noise on identical sets

    y = x + rng.normal(scale=0.02, size=x.shape)
    e1 = _run("perturbed set    ", x, y, dev, verbose=verbose)
    assert 1e-5 < float(e1.ospa) < 0.2

    e2 = _run("one point missing", x, x[:-1], dev, verbose=verbose)
    assert float(e2.card) > 0.1
    return e0, e1, e2


if __name__ == "__main__":
    cli(main, __doc__)
