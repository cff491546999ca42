"""Entries: how a cell's window drives the program (``<entry>.py``, named
by the mix's ``entry``).  Each module's ``Entry(port, cfg, traffic, spec)``
runs the warm-up in ``warm()``, one frame a ``call()`` and lets go of the
program in ``close()``; its spans (``torch.profiler.record_function``)
name what the host does around the program's calls."""
