"""`device_idle_share.train` in the host-bound training cells, where it moves
`train_steps_per_s.host_bound`: the same reader (gpubench/metrics/device_idle_share.train.py)."""

from gpubench.harness import metric_reader

read = metric_reader("device_idle_share.train")
