"""rfs_slam_tpu_torch — RB-PHD SLAM in PyTorch (the 2-D simulation main path
and the Victoria Park path), with hand-written CUDA kernels for NVIDIA Hopper.

A port of the repository's JAX/Pallas package that keeps its plane-major layout
at every public function (means ``[D, P, M]``, packed covariances
``[T, P, M]``, weights ``[P, M]``), so arrays convert one to one.  The three
Pallas kernels become CUDA C++ kernels under ``csrc/``
(``ops/kernels/map_update2d.py``, ``merge2d.py``, ``merge3d.py``); each has a
plain PyTorch twin that runs for CPU tensors.

This package imports torch and numpy only, never JAX.
"""

__version__ = "0.1.0"
