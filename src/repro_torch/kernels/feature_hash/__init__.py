"""feature_hash kernel package."""
from repro_torch.kernels.feature_hash.ops import *  # noqa: F401,F403
