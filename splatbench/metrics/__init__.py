"""Per-layer metrics: one file a metric (``<name>.py``, its ``read(ctx)``),
found by the metric's name in BENCHMARK.json; ``work.py`` holds the
operation and byte counts they share and ``peaks.json`` the device's
published peaks."""
