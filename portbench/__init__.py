"""The benchmark of the PyTorch / CUDA path tracer ``loupiote_tpu_torch``
(see ``portbench/README.md``)."""
