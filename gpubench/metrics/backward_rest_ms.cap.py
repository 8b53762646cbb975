"""`backward_rest_ms` in the cell at the densify cap, where it moves
`train_steps_per_s`: the same reader (gpubench/metrics/backward_rest_ms.py)."""

from gpubench.harness import metric_reader

read = metric_reader("backward_rest_ms")
