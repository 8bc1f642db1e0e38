"""The plain reference that decides a run's `correct`.

A frozen copy of the port's plain PyTorch path (the versions its tests hold
to the JAX package on the CPU): scan registration, LO, the voxel filter,
the hashed map and its solve (`lidar/`, `solver/`, `geometry/`), and the
camera front end and VO solve (`vision/`). Every hand-written kernel of the
port is replaced by its plain version on every device, and nothing here
imports the port or JAX: the docstrings that name a kernel describe the
port's dispatch, which this copy does not have. `frames.py` assembles the
copied stages into one frame of each engine, and `check.py` follows a run's
output rows frame by frame with them.
"""
