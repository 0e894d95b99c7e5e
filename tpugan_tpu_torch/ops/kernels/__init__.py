"""Hand-written CUDA kernels of the port, one module each (knn, edgeconv,
nn1). A module holds the kernel's wrapper, its plain PyTorch version and
``KERNEL``, the library handle whose ``launches`` counts the wrapper's
launches."""
