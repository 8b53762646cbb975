"""`launches_per_step.train` in the host-bound training cells, where it moves
`train_steps_per_s.host_bound`: the same reader (gpubench/metrics/launches_per_step.train.py)."""

from gpubench.harness import metric_reader

read = metric_reader("launches_per_step.train")
