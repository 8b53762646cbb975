"""pcp_tpu_torch.viewer -- the SIBR viewer socket server (counterpart of
``pcp_tpu/viewer``; network_gui parity)."""

from pcp_tpu_torch.viewer.network_gui import NetworkGUI, ViewerCamera  # noqa: F401
