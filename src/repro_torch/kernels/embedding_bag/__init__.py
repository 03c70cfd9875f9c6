"""embedding_bag kernel package."""
from repro_torch.kernels.embedding_bag.ops import *  # noqa: F401,F403
