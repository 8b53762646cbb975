"""`appearance_loss_ms` in the cell at the densify cap, where it moves
`train_steps_per_s`: the same reader (gpubench/metrics/appearance_loss_ms.py)."""

from gpubench.harness import metric_reader

read = metric_reader("appearance_loss_ms")
