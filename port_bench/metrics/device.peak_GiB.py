"""The most device memory PyTorch's allocator held at once in the window
(`torch.cuda.max_memory_allocated()` after `reset_peak_memory_stats()` at
its start), in GiB."""


def read(ctx):
    if not ctx["mem_peak_bytes"]:
        return None
    return ctx["mem_peak_bytes"] / (1 << 30)
