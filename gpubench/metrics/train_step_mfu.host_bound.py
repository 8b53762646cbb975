"""`train_step_mfu` in the host-bound training cells, where it moves
`train_steps_per_s.host_bound`: the same reader (gpubench/metrics/train_step_mfu.py)."""

from gpubench.harness import metric_reader

read = metric_reader("train_step_mfu")
