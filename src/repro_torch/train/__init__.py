"""Training pieces of the port: the optimizers of the sparse train step,
checkpoints, the shard-lease scheduling of the streaming loader, and the
in-memory training loop (``train.loop``)."""
