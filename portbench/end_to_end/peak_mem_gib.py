"""peak_mem_gib (GiB): torch.cuda.max_memory_allocated() over set-up and
window."""


def read(w):
    return w.peak_bytes / 2 ** 30
