"""Drivers of the traffic kinds, one module each (found by a mix's
``kind``): ``run(cell, seed, seconds, trace, device, on_window_closed)``
sets the cell up, measures its window, traces a segment when asked, frees
the program's state and runs the check, returning a ``KindResult``."""
