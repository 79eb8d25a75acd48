"""The benchmark of the PyTorch/CUDA port; `perfbench/run.py` runs it."""
