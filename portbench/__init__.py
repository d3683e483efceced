"""The benchmark of qmf_tpu_torch, the PyTorch and CUDA port, on NVIDIA
cards: ``python3 -m portbench.run`` (see README.md)."""
