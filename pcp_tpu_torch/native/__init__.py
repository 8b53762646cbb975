"""Host C++ libraries, ctypes-bound (counterpart of ``pcp_tpu/native``): the
COLMAP binary codec (``colmap_codec.cpp``) and the point-cloud ops
(``points_native.cpp``: radius outlier filter, compaction, the bisection's
``nth_element`` splits). Built with ``g++`` at first use into
``pcp_tpu_torch/_build/native/``; each caller has a pure-Python or numpy
fallback, so a missing toolchain costs only speed.
"""

from pcp_tpu_torch.native.build import (  # noqa: F401
    load_library,
    load_points_library,
)
