"""PyTorch + CUDA port of the vloam_tpu engines: LiDAR-only LOAM
(lidar/loam_step.py, LoamEngine, BatchLoamEngine) and combined camera +
LiDAR VLOAM (vloam_step.py, VloamEngine), the per-stage host engine
(pipeline.VloamPipeline / run_sequence over lidar/odometry.LaserOdometry,
lidar/mapping.LaserMapping and vision/vo.VisualOdometry, with the debug
renderers of vision/viz.py), and the host layer around them (pipeline.py,
cli.py: python -m vloam_tpu_torch run|eval; runtime/, data/kitti.py, eval/,
backend/, parallel/pose_graph.py).

The package mirrors vloam_tpu's layout (geometry/, solver/, lidar/, vision/,
fusion/, data/, config.py, vloam_step.py) so each module's JAX counterpart
sits at the same relative path. It imports torch, numpy and scipy, and
nothing of jax or of the JAX package: config.py, data/, fusion/,
eval/kitti_metrics.py, vision/viz.py and runtime/{profiling,native_io}.py
are its own copies of the JAX package's modules (or of the parts it needs), tested
equal to them.

Hand-written Hopper kernels live in kernels/ (CUDA C++ built with nvcc at
first use). Every kernel wrapper takes its plain PyTorch version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""
