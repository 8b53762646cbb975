"""`composite_bwd_roofline` in the host-bound training cells, where it moves
`train_steps_per_s.host_bound`: the same reader (gpubench/metrics/composite_bwd_roofline.py)."""

from gpubench.harness import metric_reader

read = metric_reader("composite_bwd_roofline")
