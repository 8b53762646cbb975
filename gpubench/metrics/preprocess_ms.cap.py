"""`preprocess_ms.train` in the cell at the densify cap, where it moves
`train_steps_per_s`: the same reader (gpubench/metrics/preprocess_ms.train.py)."""

from gpubench.harness import metric_reader

read = metric_reader("preprocess_ms.train")
