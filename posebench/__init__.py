"""The benchmark of the PyTorch and CUDA port (``dsnt_pose2d_tpu_torch``):
see ``README.md`` and ``BENCHMARK.json`` at the repository's root."""
