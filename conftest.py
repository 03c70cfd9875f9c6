"""Test-run settings that change no test's outcome.

* **Hypothesis' files stay out of the tracked ``.hypothesis/``.**
  Hypothesis writes its example database, its unicode tables and a cache
  of the constants of every local module it sees under its storage
  directory, ``./.hypothesis`` unless ``HYPOTHESIS_STORAGE_DIRECTORY``
  names another. That directory is tracked, so a test run would leave the
  tree changed (a unicode table rewritten, a constants file for each
  edited module). Unless the caller chose a directory, the run stores them
  under ``build/``, which git ignores. Hypothesis reads the variable at its
  first write, after collection, so setting it here covers every test and
  every xdist worker.
* **An xdist worker's torch shares the cores.** torch starts one intra-op
  thread per core in every process, and its threads spin at each parallel
  region's barrier. With n workers on c cores that is n x c spinning
  threads: a small-shape test then runs 10-30x slower than alone, and the
  timing tests of other workers miss their marks. Each worker's torch gets
  c // n threads (at least 1). A run without xdist keeps torch's default.
"""
import os
from pathlib import Path

os.environ.setdefault("HYPOTHESIS_STORAGE_DIRECTORY",
                      str(Path(__file__).resolve().parent / "build" / "hypothesis"))


def pytest_configure(config):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return
    try:
        import torch
    except ImportError:
        return
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(workers)))
