"""One reader a metric: `read(run) -> float | None`, where `run` is a
`harness.RunData`. A reader that finds nothing to read returns None, and
the metric is left out of the result line."""
