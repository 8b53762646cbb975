"""`preprocess_ms.train` in the host-bound training cells, where it moves
`train_steps_per_s.host_bound`: the same reader (gpubench/metrics/preprocess_ms.train.py)."""

from gpubench.harness import metric_reader

read = metric_reader("preprocess_ms.train")
