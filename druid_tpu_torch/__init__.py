"""druid_tpu_torch: the native aggregate query path in PyTorch and CUDA.

A port of the `druid_tpu` package to one NVIDIA H100. It imports torch and
never jax, and nothing of `druid_tpu`: the host modules it needs are its own
copies. Entry point: `druid_tpu_torch.engine.QueryExecutor`.
"""
