"""The plain reference the benchmark's ``correct`` is decided against.

Plain PyTorch only: nothing here imports the program, JAX or the JAX
package (``bench/test_bench_fence.py`` holds that)."""
