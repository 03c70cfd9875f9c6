"""Keep hypothesis' files out of the tracked ``.hypothesis/`` directory.

Hypothesis writes its example database, its unicode tables and a cache of
the constants of every local module it sees under its storage directory,
``./.hypothesis`` unless ``HYPOTHESIS_STORAGE_DIRECTORY`` names another.
That directory is tracked, so a test run would leave the tree changed (a
unicode table rewritten, a constants file for each edited module). Unless
the caller chose a directory, the run stores them under ``build/``, which
git ignores. Hypothesis reads the variable at its first write, after
collection, so setting it here covers every test and every xdist worker.
"""
import os
from pathlib import Path

os.environ.setdefault("HYPOTHESIS_STORAGE_DIRECTORY",
                      str(Path(__file__).resolve().parent / "build" / "hypothesis"))
