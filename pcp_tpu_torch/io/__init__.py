"""COLMAP and PLY I/O (copies of ``pcp_tpu.io``). ``io.colmap`` reads and
writes through the native C++ codec (``io.colmap_fast``,
``pcp_tpu_torch.native``) where JAX's does, with the pure-Python path as
its fallback."""
