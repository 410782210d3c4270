"""Per-layer metric readers, one file per metric of BENCHMARK.json's
`per_layer`, each with `read(readings) -> float | None` over one run's
untraced and traced windows (bench.Readings). A reader that finds
nothing to read returns None, and the run leaves the metric out."""
