"""`launches_per_step.train` in the cell at the densify cap, where it moves
`train_steps_per_s`: the same reader (gpubench/metrics/launches_per_step.train.py)."""

from gpubench.harness import metric_reader

read = metric_reader("launches_per_step.train")
