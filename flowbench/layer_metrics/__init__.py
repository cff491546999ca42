"""Per-layer metrics: one reader a metric (``<metric>.py``, named as in
``BENCHMARK.json``), whose ``read(summary)`` takes a traced run's summary
(``yardstick/trace.summarize``, with the run's ``counts``, ``params`` and
``shape``) and returns the metric, or None where it finds nothing to
read."""
