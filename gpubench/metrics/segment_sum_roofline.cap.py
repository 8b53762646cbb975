"""`segment_sum_roofline` in the cell at the densify cap, where it moves
`train_steps_per_s`: the same reader (gpubench/metrics/segment_sum_roofline.py)."""

from gpubench.harness import metric_reader

read = metric_reader("segment_sum_roofline")
