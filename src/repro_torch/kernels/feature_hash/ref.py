"""Plain PyTorch version of the feature-hash meta-kernel (shares fe.ops).

Same semantics as ``csrc/feature_hash.cu`` on int32[K, N] columns: ``cross``
and ``hash`` hash the low 32 bits as uint32 and reduce with a uint32
modulo; ``mod`` is a signed int32 floor-mod (``torch.remainder``). The
arithmetic runs in int64 masked to 32 bits (see :mod:`repro_torch.fe.ops`).
"""

from __future__ import annotations

import torch

from repro_torch.fe.ops import fmix32, hash_combine


def hash_layer_ref(cols: torch.Tensor, *, program) -> torch.Tensor:
    outs = []
    for kind, a_idx, b_idx, field_size in program:
        a = cols[a_idx]
        if kind == "cross":
            h = hash_combine(a, cols[b_idx]) % field_size
        elif kind == "hash":
            h = fmix32(a) % field_size
        elif kind == "mod":
            h = torch.remainder(a.to(torch.int64), field_size)
        else:
            raise ValueError(kind)
        outs.append(h.to(torch.int32))
    return torch.stack(outs, dim=0)
