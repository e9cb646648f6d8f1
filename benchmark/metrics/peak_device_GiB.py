"""Peak device memory over the window (torch.cuda.max_memory_allocated
after reset_peak_memory_stats at the window's start), GiB."""


def read(w):
    return w.memory_peak_bytes / (1 << 30)
