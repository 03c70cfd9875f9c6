"""ws_grad kernel package."""
from repro_torch.kernels.ws_grad.ops import *  # noqa: F401,F403
