"""Plain PyTorch forwards of the benchmark's model kinds, one module each
(found by a configuration's ``kind``): ``param_shapes(cfg)``,
``forward(params, cfg, dense, emb)`` and ``forward_flops_per_row(cfg)``.
They import nothing of the program."""
