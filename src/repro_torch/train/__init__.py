"""Training pieces of the port: the optimizers of the sparse train step,
checkpoints, and the shard-lease scheduling of the streaming loader."""
