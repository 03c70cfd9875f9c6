"""The repository's examples (``examples/*.py``, JAX) as entry points of
the port, each run as ``python -m repro_torch.examples.<name>``:

* :mod:`~repro_torch.examples.quickstart` — raw views -> the ``ads_ctr``
  plan -> 30 AdamW steps of a tiny CTR model;
* :mod:`~repro_torch.examples.serve_ctr` — a warmed CTR model scoring
  request batches from raw views, latency percentiles and the plan's
  dispatch accounting; its scoring pass pools the behaviour sequence with
  the ``embedding_bag`` kernel;
* :mod:`~repro_torch.examples.stream_train` — ``.fbshard`` shards ->
  ``StreamingLoader`` -> ``PipelinedRunner`` (with a ``DeviceFeeder``
  under ``--device-feed on``) -> a checksum step;
* :mod:`~repro_torch.examples.train_ctr_e2e` — column-store chunks leased
  through ``ShardServer``, the hierarchical PS, a dense AdamW step, numpy
  Adagrad on the working set, async checkpoints (the paper's Fig. 1,
  lower, at laptop scale);
* :mod:`~repro_torch.examples.mesh_train` — the streaming driver on a 2x4
  mesh with the bf16 codec.

Each keeps its JAX counterpart's flags, defaults and printed lines, adds
``--device`` (the card unless ``--device cpu`` is given) and ends with a
``<name> OK`` line.
"""
