"""`device_busy_ms.train` in the host-bound training cells, where it moves
`train_steps_per_s.host_bound`: the same reader (gpubench/metrics/device_busy_ms.train.py)."""

from gpubench.harness import metric_reader

read = metric_reader("device_busy_ms.train")
