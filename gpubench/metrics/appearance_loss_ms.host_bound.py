"""`appearance_loss_ms` in the host-bound training cells, where it moves
`train_steps_per_s.host_bound`: the same reader (gpubench/metrics/appearance_loss_ms.py)."""

from gpubench.harness import metric_reader

read = metric_reader("appearance_loss_ms")
