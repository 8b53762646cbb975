"""`backward_rest_ms` in the host-bound training cells, where it moves
`train_steps_per_s.host_bound`: the same reader (gpubench/metrics/backward_rest_ms.py)."""

from gpubench.harness import metric_reader

read = metric_reader("backward_rest_ms")
