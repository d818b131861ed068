"""pi3_slam_tpu_torch — the PyTorch / CUDA port of pi3_slam_tpu for NVIDIA Hopper.

The JAX package ``pi3_slam_tpu`` is the reference; this package mirrors its
layout (``data/``, ``models/``, ``ops/``, ``geometry/``, ``utils/``, ``io/``, ``slam/``)
so each module's counterpart is found under the same name. Plain tensor code
is PyTorch; every Pallas TPU kernel on the ported path is a hand-written
Hopper kernel (CUDA C++ under ``csrc/``), with a plain PyTorch version beside
it that the CPU runs and the kernel is tested against.

The package imports neither JAX nor the reference package.
"""

__version__ = "0.1.0"
