"""Hand-written CUDA kernels of the port, one module each: knn, edgeconv and
nn1 (the serving path); fps, ball_query, pooled_mlp and interp (the train
step). A module holds the kernel's wrapper, its plain PyTorch version and
the library handle (``KERNEL``; ``FWD`` and ``BWD`` for pooled_mlp) whose
``launches`` counts the wrapper's launches."""
