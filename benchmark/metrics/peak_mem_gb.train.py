"""The program's device memory peak in the window, GB:
torch.cuda.max_memory_allocated after a reset at the window's opening,
less the benchmark's inputs held on the device."""

from benchmark import readers


def read(ctx):
    return readers.peak_mem_gb(ctx, "train")
