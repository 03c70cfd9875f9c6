"""interaction_dot kernel package."""
from repro_torch.kernels.interaction_dot.ops import *  # noqa: F401,F403
