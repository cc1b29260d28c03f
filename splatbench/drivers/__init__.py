"""Traffic kinds that ``cells.KINDS`` lacks: one file a kind (``<kind>.py``),
loaded by path (``spec.kind``), whose ``run(cell, seed, seconds, trace, dev,
t0)`` returns a ``cells.Run``; see README.md."""
