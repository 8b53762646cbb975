"""`device_idle_share.train` in the cell at the densify cap, where it moves
`train_steps_per_s`: the same reader (gpubench/metrics/device_idle_share.train.py)."""

from gpubench.harness import metric_reader

read = metric_reader("device_idle_share.train")
