"""convertlogfiles: legacy log format -> current format (port of the JAX
package's ``apps/convertlogfiles.py``; the reference's
src/convertLogFiles.cpp:30-113).  Pure Python.

Renames the old-format ``particlePose.dat`` / ``landmarkEst.dat`` to
``*.bak`` and rewrites them in the current flat column format:

* old particlePose: header ``Timesteps: N``, then per step ``k = t`` /
  ``nParticles = P`` and P rows ``x y theta w`` -> rows ``t i x y theta w``;
* old landmarkEst: header ``Timesteps: N`` / ``nParticles: P``, then blocks
  ``Timestep: t   Particle: i   Map Size: M`` of M rows
  ``x y Sxx Sxy Syx Syy w`` -> rows ``t i x y Sxx Sxy Syy w``.

Usage::

    python -m rfs_slam_tpu_torch.apps.convertlogfiles DATA_DIR/
"""

from __future__ import annotations

import os
import sys


def convert_particle_poses(old_path: str, new_path: str) -> None:
    with open(old_path) as fi, open(new_path, "w") as fo:
        header = fi.readline()
        if not header.startswith("Timesteps:"):
            raise ValueError(f"{old_path}: not an old-format file")
        for _ in range(int(header.split(":")[1])):
            t = float(fi.readline().split("=")[1])
            n_particles = int(fi.readline().split("=")[1])
            for i in range(n_particles):
                x, y, r, w = (float(v) for v in fi.readline().split())
                fo.write(f"{t:f} {i:d} {x:f} {y:f} {r:f} {w:f}\n")


def convert_landmark_estimates(old_path: str, new_path: str) -> None:
    with open(old_path) as fi, open(new_path, "w") as fo:
        if not (fi.readline().startswith("Timesteps:")
                and fi.readline().startswith("nParticles:")):
            raise ValueError(f"{old_path}: not an old-format file")
        for line in fi:
            if not line.strip():
                continue
            # "Timestep: t Particle: i Map Size: M"
            parts = line.replace(":", " ").split()
            t, pid, n_m = float(parts[1]), int(parts[3]), int(parts[6])
            for _ in range(n_m):
                x, y, sxx, sxy, _syx, syy, w = (
                    float(v) for v in fi.readline().split())
                fo.write(f"{t:f} {pid:d} {x:f} {y:f} {sxx:f} {sxy:f} "
                         f"{syy:f} {w:f}\n")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("Change 2d simulation logs from the old format to the new "
              "format")
        print("Usage: python -m rfs_slam_tpu_torch.apps.convertlogfiles "
              "DATA_DIR/")
        return 0
    logdir = argv[0]
    if not os.path.isdir(logdir):
        print(f"Log directory {logdir} does not exist")
        return 0
    for name, fn in (("particlePose.dat", convert_particle_poses),
                     ("landmarkEst.dat", convert_landmark_estimates)):
        new = os.path.join(logdir, name)
        old = new[:-4] + ".bak"
        os.replace(new, old)
        print(f"Processing: {new}")
        fn(old, new)
    return 0


if __name__ == "__main__":
    sys.exit(main())
