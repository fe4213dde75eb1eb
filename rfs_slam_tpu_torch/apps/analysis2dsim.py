"""analysis2dSim — post-hoc error analysis of a 2-D sim log directory (a
copy of the JAX package's ``apps/analysis2dsim.py``: numpy and scipy only).

The reference analysis executable's equivalent (analysis2dSim.cpp:46-430):
reads the reference-format ``.dat`` logs (the apps' or the reference's own)
and writes

* ``poseEstError.dat``:       t ex ey erot edist   (best particle)
* ``deadReckoningError.dat``: t ex ey erot edist
* ``landmarkEstError.dat``:   t nObservable cardinalityEstimate colaError

COLA settings per the reference: cutoff 0.2, order 1, landmarks with weight
>= 0.75, against the groundtruth landmarks observed so far
(analysis2dSim.cpp:182-247).

Usage: python -m rfs_slam_tpu_torch.apps.analysis2dsim LOGDIR
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def cola_error(est: np.ndarray, gt: np.ndarray, cutoff=0.2, order=1.0):
    """COLA via scipy's Hungarian (host-side analysis; the batched version
    on the filter's device is ops/ospa.py)."""
    n1, n2 = len(est), len(gt)
    n = max(n1, n2)
    if n == 0:
        return 0.0
    C = np.full((n, n), cutoff)
    if n1 and n2:
        d = np.linalg.norm(est[:, None, :] - gt[None, :, :], axis=-1)
        C[:n1, :n2] = np.minimum(d, cutoff)
    from scipy.optimize import linear_sum_assignment

    r, c = linear_sum_assignment(C)
    total = np.sum(C[r, c] ** order)
    ospa = (total / n) ** (1.0 / order)
    return ospa * n ** (1.0 / order) / cutoff


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("logdir")
    args = ap.parse_args(argv)
    d = args.logdir

    gt = np.loadtxt(os.path.join(d, "gtPose.dat"))        # t x y th
    dr = np.loadtxt(os.path.join(d, "deadReckoning.dat"))
    gtl = np.loadtxt(os.path.join(d, "gtLandmark.dat"))   # x y firstObs
    pp = np.loadtxt(os.path.join(d, "particlePose.dat"))  # t i x y th w
    le = np.loadtxt(os.path.join(d, "landmarkEst.dat"))   # t i x y sxx sxy syy w

    gt_by_t = {round(r[0], 6): r[1:] for r in gt}
    dr_by_t = {round(r[0], 6): r[1:] for r in dr}

    times = np.unique(pp[:, 0])
    le_by_t: dict = {}
    for r in le:
        le_by_t.setdefault(round(r[0], 6), []).append(r)

    f_pose = open(os.path.join(d, "poseEstError.dat"), "w")
    f_dr = open(os.path.join(d, "deadReckoningError.dat"), "w")
    f_map = open(os.path.join(d, "landmarkEstError.dat"), "w")

    pp_by_t: dict = {}
    for r in pp:
        pp_by_t.setdefault(round(r[0], 6), []).append(r)

    for t in times:
        tk = round(float(t), 6)
        if tk not in gt_by_t or tk == 0.0:
            continue
        rx, ry, rz = gt_by_t[tk]
        rows = np.asarray(pp_by_t[tk])
        i_hi = int(rows[np.argmax(rows[:, 5]), 1])
        best = rows[rows[:, 1] == i_hi][0]

        ex, ey = best[2] - rx, best[3] - ry
        er = wrap(best[4] - rz)
        ed = np.hypot(ex, ey)
        f_pose.write("%f   %f   %f   %f   %f\n" % (t, ex, ey, er, ed))

        if tk in dr_by_t:
            dx, dy, dz = dr_by_t[tk]
            ex, ey = dx - rx, dy - ry
            er = wrap(dz - rz)
            f_dr.write("%f   %f   %f   %f   %f\n"
                       % (t, ex, ey, er, np.hypot(ex, ey)))

        # map error: best particle's landmarks with w >= 0.75 vs observed GT
        est_rows = np.asarray(le_by_t.get(tk, np.zeros((0, 8))))
        card_est = 0.0
        est_pts = []
        for r in est_rows:
            if int(r[1]) == i_hi:
                card_est += r[7]
                if r[7] >= 0.75:
                    est_pts.append(r[2:4])
        est_pts = np.asarray(est_pts) if est_pts else np.zeros((0, 2))
        observable = gtl[(gtl[:, 2] >= 0) & (gtl[:, 2] <= t + 1e-9)][:, :2]
        err = cola_error(est_pts, observable)
        f_map.write("%f   %d   %f   %f\n" % (t, len(observable), card_est, err))

    for f in (f_pose, f_dr, f_map):
        f.close()
    print(f"analysis -> {d}/poseEstError.dat, deadReckoningError.dat, "
          f"landmarkEstError.dat")


if __name__ == "__main__":
    main()
