"""Hand-written CUDA kernels of the port (sources in ``../csrc``), each with
its plain PyTorch version and a launch counter beside it."""
