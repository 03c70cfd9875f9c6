"""mempool_alloc kernel package."""
from repro_torch.kernels.mempool_alloc.ops import *  # noqa: F401,F403
