"""Training pieces of the port: the optimizers of the sparse train step."""
