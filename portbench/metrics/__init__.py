"""Per-layer metric readers, one file per metric of ``BENCHMARK.json``'s
``per_layer``, named as the metric: ``read(trace)`` takes the run's traced
stretch (None without one) and returns the metric's value, or None where the
stretch holds nothing it reads."""
