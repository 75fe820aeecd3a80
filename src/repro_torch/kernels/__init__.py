# Hand-written CUDA kernels for the compute hot-spots of the ported slice:
#   leverage       — row-wise quadratic form x_i^T M x_i (Algorithm 2)
#   weighted_gram  — X^T diag(w) X, deterministic two-stage reduction
#   kmeans_assign  — nearest center and its squared distance (Algorithm 3,
#                    kmeans_cost)
#   kmeans_assign_update — the fused assign + per-cluster sums of one Lloyd
#                    iteration, deterministic two-stage reduction
#   categorical    — the DIS draw: threefry, gumbel and row argmax in one
#                    pass (plain version: repro_torch.rng.categorical_plain)
# Each <name>.py holds the wrapper, its launch counter and its plain
# version; csrc/<name>.cu the kernel; _build.py builds and loads the
# library; ops.py dispatches by backend and lists the counted wrappers;
# ref.py the plain PyTorch oracles.
# The k-means kernels share their distance code (csrc/kmeans_common.cuh) and,
# past their shared-memory layouts, a tiled fp32 assign (csrc/kmeans_tiled.cuh).
