"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a machine with the card:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.fe import ops as F  # noqa: E402
from repro_torch.kernels.feature_hash.ops import MAX_OPS, run_hash_layer  # noqa: E402
from repro_torch.kernels.feature_hash.ref import hash_layer_ref  # noqa: E402
from repro_torch.kernels.interaction_dot.ops import pairwise_dots  # noqa: E402
from repro_torch.kernels.interaction_dot.ref import dot_interaction_ref  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 512, 262_144 + 3])
@pytest.mark.parametrize("field_size", [1000, 1 << 20])
def test_feature_hash_kernel_equals_plain_on_card(cuda_device, n, field_size):
    rng = np.random.default_rng(n)
    ids = rng.integers(-(2**33), 2**33, (10, n)).astype(np.int64)
    cols = F.narrow_int32(torch.from_numpy(ids)).to(cuda_device)
    prog = (("cross", 0, 1, field_size), ("cross", 7, 2, field_size),
            ("hash", 3, 0, field_size), ("mod", 4, 0, field_size), ("mod", 9, 0, field_size))
    before = run_hash_layer.launches
    got = run_hash_layer(cols, prog)
    torch.cuda.synchronize()
    assert run_hash_layer.launches == before + 1
    assert torch.equal(got, hash_layer_ref(cols, program=prog))


@pytest.mark.gpu
def test_feature_hash_kernel_max_ops_on_card(cuda_device):
    cols = torch.arange(-40, 40, dtype=torch.int32, device=cuda_device).reshape(2, 40)
    prog = tuple(("mod", i % 2, 0, 7 + i) for i in range(MAX_OPS))
    assert torch.equal(run_hash_layer(cols, prog), hash_layer_ref(cols, program=prog))
    with pytest.raises(ValueError):
        run_hash_layer(cols, prog + (("mod", 0, 0, 3),))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(512, 27, 128), (7, 2, 16), (130, 27, 128), (3, 60, 256)])
def test_interaction_dot_kernel_matches_plain_on_card(cuda_device, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(np.random.default_rng(1).normal(size=shape).astype(np.float32))
    x = x.to(cuda_device)
    before = pairwise_dots.launches
    got = pairwise_dots(x)
    torch.cuda.synchronize()
    assert pairwise_dots.launches == before + 1
    torch.testing.assert_close(got, dot_interaction_ref(x), rtol=1e-5, atol=1e-5)
