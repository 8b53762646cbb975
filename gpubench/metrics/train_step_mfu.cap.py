"""`train_step_mfu` in the cell at the densify cap, where it moves
`train_steps_per_s`: the same reader (gpubench/metrics/train_step_mfu.py)."""

from gpubench.harness import metric_reader

read = metric_reader("train_step_mfu")
