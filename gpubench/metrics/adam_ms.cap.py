"""`adam_ms` in the cell at the densify cap, where it moves
`train_steps_per_s`: the same reader (gpubench/metrics/adam_ms.py)."""

from gpubench.harness import metric_reader

read = metric_reader("adam_ms")
