# Hand-written CUDA kernels for the compute hot-spots of the ported slice:
#   leverage       — row-wise quadratic form x_i^T M x_i (Algorithm 2)
#   weighted_gram  — X^T diag(w) X, deterministic two-stage reduction
# Each <name>.py holds the wrapper, its launch counter and its plain
# version; csrc/<name>.cu the kernel; _build.py builds and loads the
# library; ops.py dispatches by backend; ref.py the plain PyTorch oracles.
# k-means kernels (kmeans_assign, kmeans_assign_update) are not ported yet.
