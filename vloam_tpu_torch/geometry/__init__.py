from . import so3  # noqa: F401
from .se3 import Pose, pose_from_np_matrix  # noqa: F401
