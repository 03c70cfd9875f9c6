"""Published peaks of one NVIDIA H100 SXM (dense rates, no sparsity, at the
full 700 W power limit), and the least time a piece of work can take."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # FMA counted as 2, outside the tensor cores


def least_seconds(nbytes: float, flops: float, flop_rate: float = FP32_FLOPS) -> float:
    """The larger of the bytes over HBM bandwidth and the operations over
    ``flop_rate``: the least time the card could take for this work."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_rate)


def peak_flops(cfg) -> float:
    """The dense peak of the precision the configuration states: fp32
    outside the tensor cores when TF32 is off."""
    if cfg["dtype"] == "float32":
        return 495e12 if cfg.get("tf32", False) else FP32_FLOPS
    return {"bfloat16": 989e12, "float16": 989e12}[cfg["dtype"]]
