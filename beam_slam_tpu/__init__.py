"""beam_slam_tpu — JAX lidar-visual-inertial SLAM framework (beam_slam
parity rebuild), run on an NVIDIA GPU.

Numerical policy: every matmul in this package is part of an estimation
problem (normal equations, Schur complements, Lie-group chains, point-cloud
registration), so f32 matmuls run at full f32 precision ("highest"). Below
"highest", XLA:GPU lowers f32 dots to cuBLAS gemms that may use TF32
(operand_precision HIGH, no explicit algorithm, in the optimized HLO of the
flagship solve). Measured on an NVIDIA H100 80GB HBM3 at a 400 W power
limit, each phase against the same computation on the CPU at f32:

  * flagship LM solve: max position error 7.1e-5 m under "high" vs 7.2e-7 m
    under "highest" (15.3 vs 19.3 ms per solve);
  * B=32 batched refinement: 4.0e-3 m under "high" — over the 1e-4 m bound
    — vs 3.0e-5 m under "highest";
  * LOAM registration: 7.5e-8 m under "highest"; its kNN cross term
    (ops/knn.py) would lose the neighbour ordering at map coordinates of
    tens of metres in TF32;
  * 20 s LVIO session ATE 0.75 vs 0.66 cm.

The reference runs Ceres in f64 (fixed_lag_smoother.cpp); f32 at full
precision is our equivalent floor.
"""

import jax as _jax

_jax.config.update("jax_default_matmul_precision", "highest")
