"""`composite_fwd_roofline.train` in the cell at the densify cap, where it
moves `train_steps_per_s`: the same reader
(gpubench/metrics/composite_fwd_roofline.train.py)."""

from gpubench.harness import metric_reader

read = metric_reader("composite_fwd_roofline.train")
