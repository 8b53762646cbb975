"""Experiment tools of the port: ``python -m pcp_tpu_torch.tools.<name>``."""
