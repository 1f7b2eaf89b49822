"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.
Kernels build on first use (``ops/_build.py``); importing this package
needs neither ``nvcc`` nor a GPU."""

# the kernel wrappers, by the name of the kernel each counts in its
# ``launches`` attribute (one per launch of its kernel, none for a plain
# run on CPU tensors)
KERNEL_WRAPPERS = (
    ("flash_attention_fwd", "flash_attention"),
    ("flash_attention_bwd", "flash_attention"),
    ("layer_norm_fwd", "fused_layer_norm"),
    ("layer_norm_bwd", "fused_layer_norm"),
    ("fused_ce_fwd", "fused_ce"),
    ("conv_moments", "fused_conv"),
    ("bn_apply", "fused_conv"),
    ("conv_apply", "fused_conv"),
    ("scatter_add", "scatter"))


def launch_counts():
    """{kernel name: launches counted in this process} over every wrapper
    of :data:`KERNEL_WRAPPERS` (the serving worker reports them at exit,
    for a caller that did not start the process)."""
    import importlib

    return {name: getattr(importlib.import_module(__name__ + "." + mod),
                          name).launches
            for name, mod in KERNEL_WRAPPERS}
