"""Readers of the metrics, one a file: read(run, part) -> value or None."""
